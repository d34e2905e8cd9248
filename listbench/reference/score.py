"""The plain reference of LIST's score and ranking (paper Eq. 5, 7):

    ST(q, o) = w_t · (q · o) + w_s · ŵ_s[clip(⌊S_in · t⌋, 0, t − 1)],
    S_in = 1 − clip(‖loc_q − loc_o‖ / dist_max, 0, 1),

in float32 (TF32 off), over rows as their tier stores them; and the exact
top-k of each query over the objects of its routed clusters.
"""
from __future__ import annotations

import torch


def st(q, q_loc, w, rows, o_loc, w_hat, dist_max: float) -> torch.Tensor:
    """``(Q, N)`` scores of every query against every row."""
    trel = q @ rows.T
    dx = q_loc[:, None, 0] - o_loc[None, :, 0]
    dy = q_loc[:, None, 1] - o_loc[None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    div = torch.tensor(dist_max, dtype=torch.float32, device=dist.device)
    s_in = 1.0 - torch.clamp(dist / div, 0.0, 1.0)
    t = w_hat.shape[0]
    idx = torch.clamp(torch.floor(s_in * t).to(torch.int64), 0, t - 1)
    return w[:, :1] * trel + w[:, 1:] * w_hat[idx]


def st_pairs(q, q_loc, w, rows, o_loc, w_hat, dist_max: float):
    """Scores of aligned pairs: ``q (Q, d)`` against ``rows (Q, m, d)``."""
    trel = torch.einsum("qd,qmd->qm", q, rows)
    dl = q_loc[:, None, :] - o_loc
    dist = torch.sqrt(dl[..., 0] * dl[..., 0] + dl[..., 1] * dl[..., 1])
    div = torch.tensor(dist_max, dtype=torch.float32, device=dist.device)
    s_in = 1.0 - torch.clamp(dist / div, 0.0, 1.0)
    t = w_hat.shape[0]
    idx = torch.clamp(torch.floor(s_in * t).to(torch.int64), 0, t - 1)
    return w[:, :1] * trel + w[:, 1:] * w_hat[idx]


def topk_over_clusters(routes, members, rows_of, q, q_loc, w, w_hat, *, k,
                       dist_max, query_block: int = 512):
    """The exact top-``k`` of each query over the objects of its clusters.

    ``routes``: one list of cluster ids per query; ``members[c]``: the
    object ids (int64 tensor) placed in cluster ``c``; ``rows_of(ids)`` →
    ``(rows (m, d) f32 as stored, loc (m, 2))``. Each cluster is scored
    once against every query routed to it. → ``(scores (Q, k), ids (Q,
    k))``, ``-inf`` / -1 past the candidates."""
    n_q = len(routes)
    dev = q.device
    by_cluster: dict = {}
    for i, cl in enumerate(routes):
        for c in cl:
            by_cluster.setdefault(int(c), []).append(i)
    best_s = torch.full((n_q, k), float("-inf"), device=dev)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
    for c, qs in sorted(by_cluster.items()):
        ids = members[c]
        if ids.numel() == 0:
            continue
        rows, o_loc = rows_of(ids)
        for s in range(0, len(qs), query_block):
            qi = torch.tensor(qs[s:s + query_block], device=dev)
            sc = st(q[qi], q_loc[qi], w[qi], rows, o_loc, w_hat, dist_max)
            kk = min(k, sc.shape[1])
            top_s, top_p = torch.topk(sc, kk, dim=1)
            cat_s = torch.cat([best_s[qi], top_s], dim=1)
            cat_i = torch.cat([best_i[qi], ids[top_p]], dim=1)
            keep_s, keep_p = torch.topk(cat_s, k, dim=1)
            best_s[qi] = keep_s
            best_i[qi] = torch.gather(cat_i, 1, keep_p)
    return best_s, best_i
