"""LIST-I (reference: ``repro.core.index``): router features, the
cluster classifier and its MCL loss (Eq. 14), routing, the precision
tiers of the resident buffers, the placement of objects into padded
cluster buffers, and the write half (``insert_objects`` /
``delete_objects``, paper §4.3).

Buffers: ``emb (c, cap, d)`` in the tier's storage dtype (f32, bf16 or
int8), ``loc (c, cap, 2)`` f32, ``ids (c, cap)`` int32 with ``-1`` on
padding slots, ``scale (c, cap)`` f32 per-row dequant scales (all ones
below int8), ``attrs (c, cap, 3)`` int32 filter attributes.
"""
from __future__ import annotations

import heapq
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import filters as filters_lib
from repro_torch.models import layers
from repro_torch.models.layers import MLP

PRECISIONS = ("f32", "bf16", "int8")
STORE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}

# padding sentinel for ``loc`` rows (the reference's value: a padded slot
# can never look spatially relevant)
PAD_LOC = 1e6


class ClusterIndex(nn.Module):
    """The cluster classifier (Eq. 11): an MLP over [L2norm(emb), loĉ]."""

    def __init__(self, mlp: MLP):
        super().__init__()
        self.mlp = mlp

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.mlp(feats)


def index_init(d_emb: int, n_clusters: int, generator: torch.Generator, *,
               hidden=(512, 512)) -> ClusterIndex:
    """A fresh classifier ``(d_emb + 2, *hidden, n_clusters)`` at the
    reference's scales (``repro.core.index.index_init``)."""
    dims = (d_emb + 2,) + tuple(hidden) + (n_clusters,)
    return ClusterIndex(layers.mlp_init(generator, dims))


def loc_normalizer(locs: torch.Tensor) -> dict:
    """Min/max normalization bounds of an ``(N, 2)`` location table."""
    lo = locs.min(dim=0).values
    hi = locs.max(dim=0).values
    return {"lo": lo, "span": torch.clamp(hi - lo, min=1e-9)}


def build_features(emb: torch.Tensor, loc: torch.Tensor, norm: dict
                   ) -> torch.Tensor:
    """x = [L2norm(emb), lat̂, lon̂]: (..., d+2) (Eq. 9–10)."""
    nrm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    e = emb / torch.clamp(nrm, min=1e-9)
    l_hat = (loc - norm["lo"]) / norm["span"]
    return torch.cat([e, l_hat.to(e.dtype)], dim=-1)


def cluster_logits(index: ClusterIndex, x: torch.Tensor) -> torch.Tensor:
    return index(x)


def cluster_probs(index: ClusterIndex, x: torch.Tensor) -> torch.Tensor:
    """Softmax over the clusters, in float32."""
    return torch.softmax(cluster_logits(index, x).float(), dim=-1)


def mcl_loss(index: ClusterIndex, batch: dict, *,
             balance_weight: float = 0.5):
    """Eq. 14, meta-classification likelihood over pairwise pseudo-labels
    (reference ``mcl_loss``): ŝ(q, o) = Prob_q · Prob_o, maximise log ŝ of
    the positive and Σ log(1 − ŝ) of the ``m`` pseudo-negatives (eps
    1e-6). ``balance_weight`` adds that weight times KL(mean assignment ‖
    uniform) over the concatenated query, positive and negative
    assignments (the reference's stabiliser, DESIGN.md §6). ``batch``:
    ``q_feat (B, d+2)``, ``pos_feat (B, d+2)``, ``neg_feat (B, m, d+2)``.
    Returns ``(loss, {"loss", "s_pos", "s_neg"})``, the metrics
    detached."""
    pq = cluster_probs(index, batch["q_feat"])
    pp = cluster_probs(index, batch["pos_feat"])
    pn = cluster_probs(index, batch["neg_feat"])
    s_pos = torch.sum(pq * pp, dim=-1)
    s_neg = torch.einsum("bc,bmc->bm", pq, pn)
    eps = 1e-6
    loss = -(torch.log(s_pos + eps).mean()
             + torch.log(1.0 - s_neg + eps).sum(-1).mean())
    if balance_weight:
        c = pq.shape[-1]
        mean_p = torch.cat([pq, pp, pn.reshape(-1, c)], dim=0).mean(0)
        kl_unif = math.log(c) + torch.sum(mean_p * torch.log(mean_p + eps))
        loss = loss + balance_weight * kl_unif
    return loss, {"loss": loss.detach(), "s_pos": s_pos.mean().detach(),
                  "s_neg": s_neg.mean().detach()}


def topk_stable(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis with ``jax.lax.top_k``'s tie rule:
    on equal values the earlier position ranks first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_queries(index: ClusterIndex, q_feats: torch.Tensor, *,
                  cr: int = 1):
    """Top-``cr`` clusters per query: ``(B, cr)`` int32 ids + probs."""
    p = torch.softmax(cluster_logits(index, q_feats).float(), dim=-1)
    top_p, top_i = topk_stable(p, cr)
    return top_i.to(torch.int32), top_p


def quantize_rows(emb: torch.Tensor, precision: str):
    """Quantize rows ``(..., d)`` f32 → ``(stored, scale (...,) f32)``.

    int8 is symmetric per row: ``scale = max|row| / 127`` (1 for an
    all-zero row), ``q = clip(rint(row / scale), -127, 127)``. f32 and
    bf16 return all-ones scales, so the buffer schema is one shape."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    emb = emb.float()
    scale = torch.ones(emb.shape[:-1], dtype=torch.float32, device=emb.device)
    if precision == "f32":
        return emb, scale
    if precision == "bf16":
        return emb.to(torch.bfloat16), scale
    amax = emb.abs().amax(dim=-1)
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, which can miss the true quotient by an ulp
    div = torch.tensor(127.0, dtype=torch.float32, device=amax.device)
    scale = torch.where(amax > 0, amax / div, torch.ones_like(amax))
    q = torch.clamp(torch.round(emb / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(emb: torch.Tensor, scale: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """The inverse of :func:`quantize_rows` (lossy for int8)."""
    emb = emb.float()
    if precision == "int8":
        emb = emb * scale.float()[..., None]
    return emb


def quantize_buffers(buffers: dict, precision: str) -> dict:
    """A copy of f32 cluster buffers at another tier (loc, ids, counts and
    attrs shared), quantized on the buffers' device 16 clusters at a time
    (no full-size f32 temporary). Only the f32 tier requantizes: any other
    source raises. The input is unchanged."""
    src = buffers.get("precision", "f32")
    if src == precision:
        return dict(buffers)
    if src != "f32":
        raise ValueError(
            f"quantize_buffers: can only requantize from 'f32' buffers, "
            f"these are {src!r}; rebuild the index at f32 first")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    emb = buffers["emb"]
    q = torch.empty(emb.shape, dtype=STORE_DTYPES[precision],
                    device=emb.device)
    scale = torch.empty(emb.shape[:-1], dtype=torch.float32,
                        device=emb.device)
    for s in range(0, emb.shape[0], 16):
        q[s:s + 16], scale[s:s + 16] = quantize_rows(emb[s:s + 16], precision)
    return dict(buffers, emb=q, scale=scale, precision=precision)


def assign_clusters(index: ClusterIndex, feats: torch.Tensor, *,
                    top: int = 1) -> torch.Tensor:
    """The best cluster per object (``top`` = 1, an argmax: the lowest
    index wins a tie) or the best ``top``, best first. ``feats (N,
    d+2)``. Builds no autograd graph."""
    with torch.no_grad():
        logits = cluster_logits(index, feats)
    if top == 1:
        return torch.argmax(logits, dim=-1)
    return topk_stable(logits, top)[1]


def place_objects(assign_top: np.ndarray, *, n_clusters: int,
                  capacity: int, spill: int = 3):
    """The spill walk of ``build_cluster_buffers``: ids only, on the host.

    Object ``i`` (in order) lands in the first of its ``spill`` preferred
    clusters with a free slot; when all are full it goes to the
    least-loaded cluster (lowest index on a tie). Returns ``(ids (c, cap)
    int32, counts (c,) int64, n_spilled)`` — the reference's placement,
    slot for slot."""
    a = np.asarray(assign_top)
    n = a.shape[0]
    hops = min(spill, a.shape[1])
    rows = a[:, :hops].tolist()
    counts = [0] * n_clusters
    slots = [[] for _ in range(n_clusters)]
    heap = None             # (count, cluster), built at the first fallback
    n_spilled = 0
    for i in range(n):
        ci = -1
        for h, cand in enumerate(rows[i]):
            if counts[cand] < capacity:
                ci = cand
                if h > 0:
                    n_spilled += 1
                break
        if ci < 0:
            if heap is None:
                heap = [(cnt, c) for c, cnt in enumerate(counts)]
                heapq.heapify(heap)
            while heap[0][0] != counts[heap[0][1]]:     # stale entry
                heapq.heappop(heap)
            ci = heap[0][1]
            if counts[ci] >= capacity:
                raise ValueError("cluster capacity exhausted; raise capacity")
            n_spilled += 1
        slots[ci].append(i)
        counts[ci] += 1
        if heap is not None:
            heapq.heappush(heap, (counts[ci], ci))
    ids = np.full((n_clusters, capacity), -1, np.int32)
    for c, s in enumerate(slots):
        ids[c, :len(s)] = s
    return ids, np.asarray(counts, np.int64), n_spilled


def default_capacity(n: int, c: int) -> int:
    """``ceil(2n/c)`` rounded up to a multiple of 128."""
    cap = int(math.ceil(n / c * 2.0))
    return -(-cap // 128) * 128


def build_cluster_buffers(assign_top, emb: torch.Tensor, loc: torch.Tensor,
                          *, n_clusters: int, capacity: Optional[int] = None,
                          spill: int = 3, precision: str = "f32",
                          attrs: Optional[torch.Tensor] = None,
                          chunk_clusters: int = 16) -> dict:
    """Pack objects into ``(c, cap)`` padded buffers on ``emb``'s device.

    The spill walk (:func:`place_objects`) decides the ids on the host;
    the rows are gathered on the device ``chunk_clusters`` clusters at a
    time and quantized there, so no full-size float32 copy of the buffer
    is ever staged on the host. Padding slots hold emb 0, scale 1, loc
    :data:`PAD_LOC`, attrs 0 and id -1."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    n, d = emb.shape
    c = n_clusters
    dev = emb.device
    if capacity is None:
        capacity = default_capacity(n, c)
    if attrs is None:
        attrs = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    ids_np, counts, n_spilled = place_objects(
        np.asarray(assign_top), n_clusters=c, capacity=capacity, spill=spill)
    ids = torch.from_numpy(ids_np).to(dev)
    buf_emb = torch.empty((c, capacity, d), dtype=STORE_DTYPES[precision],
                          device=dev)
    buf_scale = torch.empty((c, capacity), dtype=torch.float32, device=dev)
    for s in range(0, c, chunk_clusters):
        part = ids[s:s + chunk_clusters]
        valid = part >= 0
        rows = emb[part.clamp(min=0).long()]
        rows = torch.where(valid[..., None], rows, torch.zeros((), device=dev))
        buf_emb[s:s + chunk_clusters], buf_scale[s:s + chunk_clusters] = \
            quantize_rows(rows, precision)
    valid = ids >= 0
    gather = ids.clamp(min=0).long()
    buf_loc = torch.where(valid[..., None], loc.float()[gather],
                          torch.tensor(PAD_LOC, device=dev))
    buf_attrs = torch.where(valid[..., None], attrs.to(torch.int32)[gather],
                            torch.zeros((), dtype=torch.int32, device=dev))
    return {
        "emb": buf_emb, "loc": buf_loc, "ids": ids,
        "counts": torch.from_numpy(counts.astype(np.int32)).to(dev),
        "scale": buf_scale, "attrs": buf_attrs,
        "n_spilled": n_spilled, "capacity": capacity, "precision": precision,
    }


# ---------------------------------------------------------------------------
# Insertion and deletion (paper §4.3)
# ---------------------------------------------------------------------------

_ROW_KEYS = ("emb", "loc", "ids", "scale", "attrs")


def clone_rows(buffers: dict) -> dict:
    """``buffers`` with its row arrays cloned on their device, for a
    derivation to write in place; the input is never written."""
    return dict(buffers, **{k: buffers[k].clone() for k in _ROW_KEYS})


def ids_mask(ids: torch.Tensor, del_ids) -> torch.Tensor:
    """True where ``ids`` holds one of ``del_ids`` (ids outside the dtype's
    range match nothing)."""
    if isinstance(del_ids, torch.Tensor):
        del_ids = del_ids.cpu().numpy()
    tomb = torch.as_tensor(np.asarray(del_ids, np.int64).reshape(-1))
    info = torch.iinfo(ids.dtype)
    tomb = tomb[(tomb >= info.min) & (tomb <= info.max)]
    return torch.isin(ids, tomb.to(ids.device, ids.dtype))


def delete_rows_(buffers: dict, del_ids) -> dict:
    """:func:`delete_objects` writing into ``buffers``' own row arrays:
    only the deleted rows are written."""
    ids = buffers["ids"]
    at = ids_mask(ids, del_ids).nonzero(as_tuple=True)
    ids[at] = -1
    buffers["emb"][at] = 0
    buffers["loc"][at] = PAD_LOC
    buffers["scale"][at] = 1.0
    buffers["attrs"][at] = 0
    buffers["counts"] = (ids >= 0).sum(dim=-1).to(buffers["counts"].dtype)
    return buffers


def delete_objects(buffers: dict, del_ids) -> dict:
    """Mark deleted ids as padding: a new buffer dict whose deleted slots
    hold exactly the padding of :func:`build_cluster_buffers` (emb 0,
    scale 1, loc :data:`PAD_LOC`, attrs 0, id -1), ``counts`` recounted.
    Written on the buffers' device; the input is unchanged."""
    return delete_rows_(clone_rows(buffers), del_ids)


def route_inserts(index: ClusterIndex, norm: dict, new_emb, new_loc, *,
                  n_clusters: int, spill: int = 3) -> np.ndarray:
    """The spill hops of new objects, best first: ``(n, hops)`` int64 on
    the host, routed on ``norm``'s device."""
    dev = norm["lo"].device
    emb = torch.as_tensor(new_emb).to(dev, torch.float32)
    loc = torch.as_tensor(new_loc).to(dev, torch.float32)
    hops = max(1, min(int(spill), n_clusters))
    with torch.no_grad():
        cl = assign_clusters(index, build_features(emb, loc, norm), top=hops)
    cl = cl.cpu().numpy().astype(np.int64)
    return cl[:, None] if cl.ndim == 1 else cl


def place_inserts(ids: np.ndarray, counts: np.ndarray, hops: np.ndarray,
                  *, capacity: int):
    """The §4.3 placement of new objects, on the host: each walks its
    spill hops best first and takes the first cluster below capacity,
    else the least-loaded cluster (lowest index on a tie); within the
    cluster, the first free slot (``id == -1`` in ``ids``: deletes leave
    holes). ``counts`` is updated in place. Returns ``(cluster, slot)``
    int64 arrays; raises when every cluster is full."""
    n = hops.shape[0]
    ci_out = np.empty(n, np.int64)
    slot_out = np.empty(n, np.int64)
    free = {}                     # cluster -> its free slots, ascending
    for j in range(n):
        ci = -1
        for cand in hops[j]:
            if counts[cand] < capacity:
                ci = int(cand)
                break
        if ci < 0:
            ci = int(np.argmin(counts))
        if counts[ci] >= capacity:
            raise ValueError(
                f"insert_objects: all clusters at capacity {capacity} "
                f"(inserted {j}/{n}); rebuild with higher capacity")
        if ci not in free:        # lazily: a cluster may hold ~cap holes
            free[ci] = iter(np.flatnonzero(ids[ci] < 0))
        slot = next(free[ci], None)
        if slot is None:
            raise ValueError(
                f"insert_objects: cluster {ci} reports {counts[ci]} < "
                f"cap={capacity} but has no free slot; counts/ids "
                f"inconsistent")
        counts[ci] += 1
        ci_out[j], slot_out[j] = ci, slot
    return ci_out, slot_out


def insert_rows_(buffers: dict, index: ClusterIndex, norm: dict, new_emb,
                 new_loc, new_ids, *, spill: int = 3,
                 new_attrs=None) -> dict:
    """:func:`insert_objects` writing into ``buffers``' own row arrays: the
    placement on the host (:func:`route_inserts`, :func:`place_inserts`),
    then the placed rows, quantized to the buffers' tier, and ``counts``
    written on the buffers' device."""
    n = int(np.asarray(new_ids).reshape(-1).shape[0])
    attrs = filters_lib.validate_attrs(new_attrs, n)
    if n == 0:
        return buffers
    counts = buffers["counts"].cpu().numpy().astype(np.int64)
    hops = route_inserts(index, norm, new_emb, new_loc,
                         n_clusters=counts.shape[0], spill=spill)
    cluster, slot = place_inserts(buffers["ids"].cpu().numpy(), counts, hops,
                                  capacity=buffers["capacity"])
    dev = buffers["emb"].device
    at = (torch.from_numpy(cluster).to(dev), torch.from_numpy(slot).to(dev))
    stored, scale = quantize_rows(
        torch.as_tensor(new_emb).to(dev, torch.float32),
        buffers.get("precision", "f32"))
    buffers["emb"].index_put_(at, stored)
    buffers["scale"].index_put_(at, scale)
    buffers["loc"].index_put_(at, torch.as_tensor(new_loc).to(
        dev, torch.float32))
    buffers["ids"].index_put_(at, torch.as_tensor(
        np.asarray(new_ids).reshape(-1).astype(np.int32)).to(dev))
    buffers["attrs"].index_put_(at, attrs.to(dev))
    buffers["counts"] = torch.from_numpy(counts).to(
        dev, buffers["counts"].dtype)
    return buffers


def insert_objects(buffers: dict, index: ClusterIndex, norm: dict, new_emb,
                   new_loc, new_ids, *, spill: int = 3,
                   new_attrs=None) -> dict:
    """Route new objects through the cluster classifier into their
    buffers (paper §4.3), as the reference places them: the decision on
    the host (:func:`route_inserts`, :func:`place_inserts`; only ``ids``
    and ``counts`` come over), the rows written on the buffers' device
    into a clone (:func:`insert_rows_`). ``new_emb`` is float32 and is
    quantized to the buffers' tier on the way in. The input is
    unchanged."""
    return insert_rows_(clone_rows(buffers), index, norm, new_emb, new_loc,
                        new_ids, spill=spill, new_attrs=new_attrs)
