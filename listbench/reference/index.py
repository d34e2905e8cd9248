"""The plain reference of LIST's index: each object's preferred clusters
by the router, the spill walk that places objects into ``(c, capacity)``
buffers, and the stored tiers of a row.

Placement (paper §4.3, the port's rule): object ``i``, in order, takes
the first of its ``spill`` preferred clusters (best logit first, the lower
cluster index on an exact tie) that has a free slot; when all are full,
the least-loaded cluster (lowest index on a tie). Slots fill in order.

Tiers: ``bf16`` rounds a row to bfloat16; ``int8`` is symmetric per row,
``scale = max|row| / 127`` (1 for an all-zero row) and ``q = clip(rint(row /
scale), -127, 127)``, read back as ``q · scale``.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from listbench.reference import model

ROUTE_BLOCK = 1 << 18


def object_routes(index: dict, emb: torch.Tensor, loc: torch.Tensor, norm,
                  spill: int) -> torch.Tensor:
    """``(n, spill)`` int64 on the rows' device: each object's best
    clusters, best first."""
    out = []
    with torch.no_grad():
        for s in range(0, emb.shape[0], ROUTE_BLOCK):
            e = min(s + ROUTE_BLOCK, emb.shape[0])
            logits = model.router_logits(
                index, model.features(emb[s:e], loc[s:e], norm))
            order = torch.sort(logits, dim=-1, descending=True, stable=True)
            out.append(order.indices[:, :spill])
    return torch.cat(out)


def place(routes: np.ndarray, *, n_clusters: int, capacity: int):
    """The spill walk → ``ids (c, capacity)`` int32, -1 on free slots."""
    counts = [0] * n_clusters
    slots = [[] for _ in range(n_clusters)]
    heap = None
    for i, prefs in enumerate(np.asarray(routes).tolist()):
        ci = -1
        for cand in prefs:
            if counts[cand] < capacity:
                ci = cand
                break
        if ci < 0:
            if heap is None:
                heap = [(n, c) for c, n in enumerate(counts)]
                heapq.heapify(heap)
            while heap[0][0] != counts[heap[0][1]]:
                heapq.heappop(heap)
            ci = heap[0][1]
            if counts[ci] >= capacity:
                raise ValueError("every cluster is full")
        slots[ci].append(i)
        counts[ci] += 1
        if heap is not None:
            heapq.heappush(heap, (counts[ci], ci))
    ids = np.full((n_clusters, capacity), -1, np.int32)
    for c, members in enumerate(slots):
        ids[c, :len(members)] = members
    return ids


FALLBACK_BLOCK = 1 << 16


def placement_violations(routes: torch.Tensor, ids: torch.Tensor, *,
                         capacity: int) -> int:
    """Slots and objects of a placement ``ids (c, capacity)`` that break the
    spill walk's rule, given each object's preferences ``routes (n,
    hops)``: a slot not packed at the front or out of ascending order, an
    object placed other than once, or an object not in the first of its
    preferences that held fewer than ``capacity`` objects before it (when
    none did, the least-loaded cluster then, the lowest index on a tie).
    Every object checked at once; by induction on the objects, a
    placement with none is the walk's."""
    n, c = routes.shape[0], ids.shape[0]
    dev = ids.device
    live = ids >= 0
    size = live.sum(1)
    slot = torch.arange(ids.shape[1], device=dev)
    bad = int((live != (slot[None] < size[:, None])).sum())
    bad += int((live[:, 1:] & (ids[:, 1:] <= ids[:, :-1])).sum())
    obj = ids[live].long()
    cl = torch.arange(c, device=dev).repeat_interleave(size)
    inside = (obj >= 0) & (obj < n)
    bad += int((~inside).sum())
    obj, cl = obj[inside], cl[inside]
    bad += int((torch.bincount(obj, minlength=n) != 1).sum())
    where = torch.full((n,), -1, dtype=torch.long, device=dev)
    where[obj] = cl
    keys = torch.sort(cl * (n + 1) + obj).values

    def before(cluster, i):
        """Objects placed in ``cluster`` before object ``i``."""
        base = cluster * (n + 1)
        return (torch.searchsorted(keys, base + i)
                - torch.searchsorted(keys, base))

    at = torch.arange(n, device=dev)
    routes = routes.long()
    open_ = before(routes, at[:, None]) < capacity
    has = open_.any(1)
    want = routes.gather(1, open_.to(torch.int8).argmax(1, keepdim=True))[:, 0]
    wrong = has & (where != want)
    fallback = (~has).nonzero()[:, 0]
    every = torch.arange(c, device=dev)
    for s in range(0, fallback.numel(), FALLBACK_BLOCK):
        t = fallback[s:s + FALLBACK_BLOCK]
        loads = before(every[None, :], t[:, None])
        least = loads.argmin(1)
        wrong[t] = (where[t] != least) | (loads.min(1).values >= capacity)
    return bad + int(wrong.sum())


def stored(rows: torch.Tensor, precision: str):
    """``(stored rows in the tier's dtype, scale (n,) f32)`` of f32 rows."""
    scale = torch.ones(rows.shape[:-1], dtype=torch.float32,
                       device=rows.device)
    if precision == "f32":
        return rows, scale
    if precision == "bf16":
        return rows.to(torch.bfloat16), scale
    if precision != "int8":
        raise ValueError(f"unknown tier {precision!r}")
    amax = rows.abs().amax(dim=-1)
    div = torch.tensor(127.0, dtype=torch.float32, device=rows.device)
    scale = torch.where(amax > 0, amax / div, torch.ones_like(amax))
    q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def tier_rows(rows: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 rows as the tier stores them, read back in f32."""
    q, scale = stored(rows, precision)
    return q.float() * scale[..., None] if precision == "int8" else q.float()
