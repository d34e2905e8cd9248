"""LIST-I serve side (reference: ``repro.core.index``): router features,
the cluster classifier, routing, the precision tiers of the resident
buffers, and the placement of objects into padded cluster buffers.

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

    @torch.no_grad()
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.mlp(feats)


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
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(emb / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


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
