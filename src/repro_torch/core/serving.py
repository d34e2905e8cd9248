"""The dispatch path and the cluster-major batch plan (reference:
``repro.core.serving``).

The dispatch path ("clusters as experts") routes each query to its top
``cr`` clusters, scatters the (query, route) pairs into a ``(c, Qcap)``
grid of per-cluster slots (:func:`dispatch_queries`; pairs past a
cluster's capacity ``Qcap`` are dropped and counted), scores every slot
against its cluster's resident rows, keeps each slot's top ``k``, scatters
the lists back to their pairs and folds the ``cr`` lists of each query.
On a CUDA device steps 3–4 are the cluster-major kernel
(``kernels.fused_topk_score.fused_topk_score_cluster_major``) given every
cluster as a roster row (``u = arange(c)``) and the dispatch's ``origin``
as the roster: a slot value ``o ∈ [0, B·cr)`` is the pair ``o``, and
``B·cr`` an empty slot, the roster semantics of :func:`roster_query_rows`.
On the CPU they are :func:`dispatch_scan_plain`, the reference's
arithmetic, which is also the kernel's oracle (:func:`dispatch_scan`
picks by the tensors' device).

The cluster-major plan (:func:`cluster_major_plan`) is one roster row per
DISTINCT routed cluster of a batch, so the cluster-major scan streams
each distinct cluster once per batch (the engine's ``cuda-cm`` backend).

:func:`localize_routes` maps global routes to one shard's local rows for
the mesh-sharded engine.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import index as index_lib
from repro_torch.core import relevance
from repro_torch.core.index import topk_stable
from repro_torch.device import full_f32_products

# device bytes one group of clusters of the plain dispatch scan may take
# (its dequantized rows and its scores)
PLAIN_GROUP_BYTES = 2 << 30


def query_capacity(batch: int, n_clusters: int, cr: int,
                   balance: float = 2.0) -> int:
    """Slots per cluster of the dispatch: ``B·cr/c · balance`` rounded up
    to a multiple of 8, at least 8."""
    c = int(batch * cr / n_clusters * balance)
    return max(8, -(-c // 8) * 8)


def _sorted_runs(flat: torch.Tensor):
    """Stable-sort a flat vector of routed cluster ids and mark its runs.

    → ``(sort_idx, sorted_c, is_start, pos)``: the stable argsort, the
    sorted ids, True at the first element of each run, and each
    element's rank within its run."""
    n = flat.shape[0]
    sort_idx = torch.sort(flat, stable=True).indices
    sorted_c = flat[sort_idx]
    ar = torch.arange(n, device=flat.device)
    is_start = torch.ones(n, dtype=torch.bool, device=flat.device)
    is_start[1:] = sorted_c[1:] != sorted_c[:-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    pos = ar - run_start
    return sort_idx, sorted_c, is_start, pos


def dispatch_slots(top_c: torch.Tensor, *, n_clusters: int, capacity: int):
    """The dispatch's slot map: ``top_c (B, cr)`` → ``(origin (c, Qcap)
    int32, n_dropped)``. ``origin[cl, s]`` is the flattened (query, route)
    pair in slot ``s`` of cluster ``cl``, ``B·cr`` an empty slot; the
    pairs of a cluster fill its slots in stable sort order and those past
    ``capacity`` are dropped, counted in the 0-d int32 ``n_dropped``."""
    b, cr = top_c.shape
    n = b * cr
    dev = top_c.device
    sort_idx, sorted_c, _, pos = _sorted_runs(top_c.reshape(n))
    keep = pos < capacity
    spare = n_clusters * capacity                  # where dropped pairs go
    slot = torch.where(keep, sorted_c.long() * capacity + pos,
                       torch.full_like(pos, spare))
    # one static-shaped write of every pair: the dropped ones all land on
    # the spare slot, which is cut off (the reference's static dispatch)
    origin = torch.full((spare + 1,), n, dtype=torch.int32, device=dev)
    origin.scatter_(0, slot, sort_idx.to(torch.int32))
    n_dropped = (~keep).sum().to(torch.int32)
    return origin[:-1].reshape(n_clusters, capacity), n_dropped


def _pair_rows(q_feat: torch.Tensor, cr: int) -> torch.Tensor:
    """``q_feat (B, f)`` as one row per (query, route) pair, ``(B·cr + 1,
    f)``: pair ``o`` reads row ``o``, an empty slot (``B·cr``) the zero
    row."""
    rows = torch.arange(q_feat.shape[0],
                        device=q_feat.device).repeat_interleave(cr)
    return torch.cat([q_feat[rows],
                      torch.zeros((1,) + q_feat.shape[1:], dtype=q_feat.dtype,
                                  device=q_feat.device)])


def dispatch_queries(top_c: torch.Tensor, q_feat: torch.Tensor, *,
                     n_clusters: int, capacity: int):
    """Sort-based dispatch of the payload ``q_feat (B, f)`` to the routed
    clusters ``top_c (B, cr)``. Returns ``(q_buf (c, Qcap, f), origin (c,
    Qcap) int32, n_dropped)`` (:func:`dispatch_slots`); empty slots carry
    a zero payload."""
    origin, n_dropped = dispatch_slots(top_c, n_clusters=n_clusters,
                                       capacity=capacity)
    q_buf = _pair_rows(q_feat, top_c.shape[1])[origin.long()]
    return q_buf, origin, n_dropped


def cluster_major_plan(top_c: torch.Tensor, *, n_clusters: int,
                       qcap: Optional[int] = None,
                       u_max: Optional[int] = None,
                       return_dropped: bool = False):
    """Batch plan for cluster-major scanning.

    ``top_c (B, cr)`` with ids in ``[0, n_clusters)`` → ``(u (u_max,)
    int32`` distinct routed clusters in ascending order (cluster 0 with an
    empty roster past the realized count), ``roster (u_max, qcap) int32``
    flattened (query, route) indices of each distinct cluster with
    ``B·cr`` on empty slots, ``n_distinct)`` as a 0-d int32 tensor, plus
    ``n_dropped`` when ``return_dropped``. ``u_max`` defaults to
    ``min(B·cr, n_clusters)`` and ``qcap`` to ``B·cr``, so every (query,
    route) pair sits in exactly one slot; smaller ones drop the pairs past
    them, counted in ``n_dropped``."""
    b, cr = top_c.shape
    n = b * cr
    dev = top_c.device
    u_max = min(n, n_clusters) if u_max is None else u_max
    qcap = n if qcap is None else qcap
    flat = top_c.reshape(n)
    sort_idx, sorted_c, is_start, pos = _sorted_runs(flat)
    slot_of = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    n_distinct = (slot_of[-1] + 1).to(torch.int32)
    keep = (pos < qcap) & (slot_of < u_max)

    roster = torch.full((u_max * qcap,), n, dtype=torch.int32, device=dev)
    roster[slot_of[keep] * qcap + pos[keep]] = sort_idx[keep].to(torch.int32)
    roster = roster.reshape(u_max, qcap)

    u = torch.zeros(u_max, dtype=torch.int32, device=dev)
    first = is_start & (slot_of < u_max)
    u[slot_of[first]] = sorted_c[first].to(torch.int32)
    if return_dropped:
        return u, roster, n_distinct, (~keep).sum().to(torch.int32)
    return u, roster, n_distinct


def roster_query_rows(roster: torch.Tensor, *, cr: int,
                      n_total: int) -> torch.Tensor:
    """Roster slot value ``o`` → query row ``o // cr``; empty slots
    (``o == n_total``) clamp to row 0 (mask them with ``roster <
    n_total``)."""
    return torch.where(roster < n_total, roster,
                       torch.zeros_like(roster)) // cr


def localize_routes(top_c, shard_of, local_of, shard: int, *,
                    sentinel: int):
    """Map GLOBAL routed cluster ids to one shard's LOCAL buffer rows:
    the route-localization step of mesh-sharded serving.

    ``top_c (B, cr)`` global routed ids; ``shard_of`` / ``local_of`` the
    ``(c,)`` placement maps of ``sharding.ClusterShards``; ``sentinel``
    the shard's appended empty cluster row. Routes owned by ``shard`` map
    to their local row and every other route to the sentinel, so the
    per-shard scan keeps its static ``(B, cr)`` shape and off-shard
    candidates score ``(−1, NEG_INF)`` like padding. Duplicate routes to
    one cluster land on one shard together.

    A tensor ``top_c`` stays on its device (the maps are moved there
    unless they are tensors on it already) → int32 tensor; a numpy one
    goes through the same steps on the CPU → numpy int32."""
    tc = torch.as_tensor(top_c)
    so = torch.as_tensor(shard_of).to(tc.device)
    lo = torch.as_tensor(local_of).to(tc.device)
    tc = tc.long()
    out = torch.where(so[tc] == shard, lo[tc],
                      torch.full_like(tc, sentinel)).to(torch.int32)
    return out if isinstance(top_c, torch.Tensor) else out.numpy()


# ---------------------------------------------------------------------------
# The dispatch path's scan: the cluster-major kernel, or its plain version
# ---------------------------------------------------------------------------


def dispatch_scan_plain(q_emb, q_loc, w_st, origin, buf_emb, buf_loc,
                        buf_ids, w_hat, *, k: int, cr: int, dist_max: float,
                        buf_scale=None):
    """The reference's steps 3–4 of the dispatch path: the payload
    ``[q_emb, q_loc, w_st]`` dispatched by ``origin (c, Qcap)``, every slot
    scored against its cluster's rows (``score_candidates``), a stable
    top-``k`` per (cluster, slot), and the lists scattered back to their
    (query, route) pairs. Returns ``(scores (B·cr, k) f32, ids (B·cr, k)
    int32)``; a pair in no slot (dropped) is ``(-inf, -1)``.

    Only clusters with a live slot are scored (an empty slot's list goes
    nowhere), ``PLAIN_GROUP_BYTES`` of them at a time: the arithmetic of
    each (cluster, slot) is the batched one."""
    from repro_torch.kernels import fused_topk_score as fts
    b, d = q_emb.shape
    n = b * cr
    cap = buf_ids.shape[1]
    dev = q_emb.device
    fpad = _pair_rows(torch.cat([q_emb, q_loc, w_st], dim=-1), cr)
    back_v = torch.full((n + 1, k), -float("inf"), dtype=torch.float32,
                        device=dev)
    back_i = torch.full((n + 1, k), -1, dtype=torch.int32, device=dev)
    live = (origin < n).any(dim=1).nonzero().reshape(-1)
    qcap = origin.shape[1]
    group = max(1, PLAIN_GROUP_BYTES // (cap * (8 * d + 32 * qcap) + 1))
    for s in range(0, live.numel(), group):
        cl = live[s:s + group].long()
        org = origin[cl].long()                            # (g, Qcap)
        q_buf = fpad[org]
        qe, ql, qw = q_buf[..., :d], q_buf[..., d:d + 2], q_buf[..., d + 2:]
        ids = buf_ids[cl]
        st = fts.score_candidates(
            qe, ql, qw, buf_emb[cl], buf_loc[cl], ids[:, None], w_hat,
            dist_max=dist_max,
            cand_scale=None if buf_scale is None else buf_scale[cl])
        vals, pos = topk_stable(st, k)                     # (g, Qcap, k)
        got = torch.gather(ids[:, None, :].expand(st.shape), -1, pos)
        dest = org.reshape(-1)
        back_v[dest] = vals.reshape(-1, k)   # empty slots land on row n
        back_i[dest] = got.reshape(-1, k).to(torch.int32)
    return back_v[:n], back_i[:n]


def dispatch_scan(q_emb, q_loc, w_st, origin, buf_emb, buf_loc, buf_ids,
                  w_hat, *, k: int, cr: int, dist_max: float, buf_scale=None):
    """Steps 3–4 of the dispatch path on the tensors' device: per-pair
    lists ``(scores (B·cr, k), ids (B·cr, k) int32)``, ``(-inf, -1)`` for
    a dropped pair. CPU tensors take :func:`dispatch_scan_plain`, CUDA
    tensors :func:`dispatch_scan_cluster_major` (the kernel; on ``meta``
    tensors its meta path)."""
    fn = (dispatch_scan_cluster_major
          if q_emb.device.type in ("cuda", "meta") else dispatch_scan_plain)
    return fn(q_emb, q_loc, w_st, origin, buf_emb, buf_loc, buf_ids, w_hat,
              k=k, cr=cr, dist_max=dist_max, buf_scale=buf_scale)


def dispatch_scan_cluster_major(q_emb, q_loc, w_st, origin, buf_emb, buf_loc,
                                buf_ids, w_hat, *, k: int, cr: int,
                                dist_max: float, buf_scale=None):
    """The dispatch scan through the cluster-major scan
    (``fused_topk_score_cluster_major``: the kernel on CUDA tensors, which
    raises for a shape it refuses such as ``k`` above ``K_MAX``; its
    plain version on CPU tensors) with every cluster a roster row and
    ``origin`` the roster. The rows of the dropped pairs, which no slot
    writes, are set to ``(-inf, -1)``: :func:`dispatch_scan_plain`'s
    contract."""
    from repro_torch.kernels import fused_topk_score as fts
    n = q_emb.shape[0] * cr
    c = buf_ids.shape[0]
    u = torch.arange(c, dtype=torch.int32, device=q_emb.device)
    ps, pi = fts.fused_topk_score_cluster_major(
        q_emb, q_loc, w_st, u, origin, buf_emb, buf_loc, buf_ids, w_hat,
        k=k, dist_max=dist_max, cr=cr, buf_scale=buf_scale)
    placed = torch.zeros(n + 1, dtype=torch.bool, device=q_emb.device)
    placed[origin.reshape(-1).long()] = True
    placed = placed[:n, None]
    return (torch.where(placed, ps, torch.full_like(ps, -float("inf"))),
            torch.where(placed, pi, torch.full_like(pi, -1)))


def cluster_dispatch_query(snapshot, q_tokens, q_mask, q_loc, *, k: int = 20,
                           cr: int = 1, capacity: Optional[int] = None,
                           return_dropped: bool = False):
    """The dispatch path over an ``IndexSnapshot``'s base buffers, on the
    snapshot's device (its delta segment is not read, as in the
    reference). ``q_tokens (B, L)``, ``q_mask (B, L)``, ``q_loc (B, 2)``
    as numpy or tensors. Returns ``(ids (B, k) int32, scores (B, k) f32)``
    device tensors, plus the 0-d ``n_dropped`` when ``return_dropped``."""
    buf = snapshot.buffers
    return dispatch_query_kernel(
        snapshot.rel, snapshot.index, snapshot.w_hat, snapshot.norm,
        buf["emb"], buf["loc"], buf["ids"], q_tokens, q_mask, q_loc, k=k,
        cr=cr, dist_max=snapshot.meta.dist_max, capacity=capacity,
        buf_scale=buf.get("scale"), precision=snapshot.meta.precision,
        return_dropped=return_dropped)


def dispatch_query_kernel(rel, index, w_hat, norm, buf_emb, buf_loc,
                          buf_ids, q_tokens, q_mask, q_loc, *, k: int = 20,
                          cr: int = 1, dist_max: float = 1.0,
                          capacity: Optional[int] = None, buf_scale=None,
                          precision: str = "f32",
                          return_dropped: bool = False):
    """Explicit-array form of :func:`cluster_dispatch_query`: encode and
    route, dispatch the (query, route) pairs into ``Qcap`` slots per
    cluster (``capacity``, default :func:`query_capacity`), scan
    (:func:`dispatch_scan`), fold each query's ``cr`` lists
    (``engine.merge_cluster_major``). Runs on ``buf_emb``'s device.
    Quantized buffers pass ``precision="int8"`` and ``buf_scale (c,
    cap)``; int8 codes without them raise."""
    from repro_torch.core import engine as engine_lib
    if buf_emb.dtype == torch.int8 and (precision != "int8"
                                        or buf_scale is None):
        raise ValueError(
            "dispatch_query_kernel: buf_emb is int8 but "
            f"precision={precision!r} / buf_scale="
            f"{'set' if buf_scale is not None else 'None'}; quantized "
            "buffers require precision='int8' and their per-row scales")
    dev = buf_emb.device
    full_f32_products(dev)
    c, cap, _ = buf_emb.shape
    if k > cap:
        raise ValueError(f"k={k} exceeds the cluster capacity {cap}")
    as_dev = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    q_tokens, q_mask, q_loc = as_dev(q_tokens), as_dev(q_mask), as_dev(q_loc)
    b = q_tokens.shape[0]
    qcap = capacity or query_capacity(b, c, cr)
    with torch.no_grad():
        # 1. encode + route
        q_emb = relevance.encode_queries(rel, q_tokens, q_mask)
        w = relevance.st_weights(rel, q_emb)
        feats = index_lib.build_features(q_emb, q_loc, norm)
        top_c, _ = index_lib.route_queries(index, feats, cr=cr)
        # 2. dispatch. The reference concatenates [q_emb, q_loc, w] in
        # q_emb's dtype (float32: the encoder's CLS output), so the
        # location and weights are rounded to it, then read back as f32.
        # Its two sharding annotations (constrain) are no-ops on one
        # device and have no counterpart here.
        ql = q_loc.to(q_emb.dtype).float()
        qw = w.to(q_emb.dtype).float()
        origin, n_dropped = dispatch_slots(top_c, n_clusters=c,
                                           capacity=qcap)
        # 3.–4. per-slot top-k scattered back to pairs, then the fold
        ps, pi = dispatch_scan(
            q_emb.float().contiguous(), ql.contiguous(), qw.contiguous(),
            origin, buf_emb, buf_loc, buf_ids, w_hat, k=k, cr=cr,
            dist_max=dist_max,
            buf_scale=buf_scale if precision == "int8" else None)
        scores, ids = engine_lib.merge_cluster_major(ps, pi, b=b, cr=cr, k=k)
    if return_dropped:
        return ids, scores, n_dropped
    return ids, scores
