"""Pseudo-negative labels for the cluster classifier (reference:
``repro.core.pseudo_labels.mine_negatives``, paper §4.3, Eq. 13).

neg_q = argsort_{o ∈ D} ST(q, o)[neg_start : neg_end],  s(q, o) = 0

The trained relevance model ranks the whole corpus for each training
query in its serve form (Eq. 5's lookup); ground-truth positives are
masked to −inf; the top ``neg_end`` are taken with ``jax.lax.top_k``'s
tie rule (:func:`~repro_torch.core.index.topk_stable`) and the window
``[neg_start:]`` kept. Query blocks of ``batch_queries`` bound the ``(B,
N)`` score block on the device. The mesh's forms (``mine_negatives_dense``
/ ``_sharded``) wait with the mesh (ROADMAP Queue A 11).
"""
from __future__ import annotations

import torch

from repro_torch.core import relevance
from repro_torch.core.index import topk_stable
from repro_torch.core.relevance import RelevanceModel


def mine_negatives(rel: RelevanceModel, q_emb: torch.Tensor,
                   q_loc: torch.Tensor, obj_emb: torch.Tensor,
                   obj_loc: torch.Tensor, *, pos_mask=None,
                   neg_start: int, neg_end: int, dist_max=1.0,
                   batch_queries: int = 256, spatial_mode: str = "step",
                   weight_mode: str = "mlp") -> torch.Tensor:
    """``(B, neg_end − neg_start)`` int64 object indices on ``obj_emb``'s
    device, the window clamped to the corpus as the reference clamps it.
    ``pos_mask``: optional ``(B, N)`` bool (numpy or tensor, any device),
    the positives to exclude; its blocks are moved to the device one at a
    time."""
    n = obj_emb.shape[0]
    neg_end = min(neg_end, n)
    neg_start = min(neg_start, neg_end - 1)
    dev = obj_emb.device
    outs = []
    for s in range(0, q_emb.shape[0], batch_queries):
        e = min(s + batch_queries, q_emb.shape[0])
        st = relevance.score_corpus(
            rel, q_emb[s:e], q_loc[s:e], obj_emb, obj_loc,
            dist_max=dist_max, spatial_mode=spatial_mode,
            weight_mode=weight_mode)
        if pos_mask is not None:
            pm = torch.as_tensor(pos_mask[s:e]).to(dev)
            st = st.masked_fill(pm, float("-inf"))
        _, idx = topk_stable(st, neg_end)
        outs.append(idx[:, neg_start:])
    return torch.cat(outs, dim=0)
