"""The cluster-major batch plan (reference: ``repro.core.serving``).

One roster row per DISTINCT routed cluster of a batch, so the
cluster-major scan streams each distinct cluster once per batch.
"""
from __future__ import annotations

import torch


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


def cluster_major_plan(top_c: torch.Tensor, *, n_clusters: int):
    """Batch plan for cluster-major scanning.

    ``top_c (B, cr)`` with ids in ``[0, n_clusters)`` → ``(u (u_max,)
    int32`` distinct routed clusters in ascending order (cluster 0 with an
    empty roster past the realized count), ``roster (u_max, B·cr) int32``
    flattened (query, route) indices of each distinct cluster with
    ``B·cr`` on empty slots, ``n_distinct)`` as a 0-d int32 tensor.
    ``u_max = min(B·cr, n_clusters)`` and the roster is ``B·cr`` wide, so
    every (query, route) pair sits in exactly one slot."""
    b, cr = top_c.shape
    n = b * cr
    dev = top_c.device
    u_max = min(n, n_clusters)
    flat = top_c.reshape(n)
    sort_idx, sorted_c, is_start, pos = _sorted_runs(flat)
    slot_of = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    n_distinct = (slot_of[-1] + 1).to(torch.int32)

    roster = torch.full((u_max * n,), n, dtype=torch.int32, device=dev)
    roster[slot_of * n + pos] = sort_idx.to(torch.int32)
    roster = roster.reshape(u_max, n)

    u = torch.zeros(u_max, dtype=torch.int32, device=dev)
    u[slot_of[is_start]] = sorted_c[is_start].to(torch.int32)
    return u, roster, n_distinct


def roster_query_rows(roster: torch.Tensor, *, cr: int,
                      n_total: int) -> torch.Tensor:
    """Roster slot value ``o`` → query row ``o // cr``; empty slots
    (``o == n_total``) clamp to row 0 (mask them with ``roster <
    n_total``)."""
    return torch.where(roster < n_total, roster,
                       torch.zeros_like(roster)) // cr
