"""Cluster-quality metrics (paper §4.3, Eq. 15–17): P(C) and IF(C)
(reference: ``repro.core.cluster_metrics``). Host-side numpy."""
from __future__ import annotations

import numpy as np


def imbalance_factor(obj_assign, n_clusters: int) -> float:
    """IF(C) = Σ|C_i|² / (Σ|C_i|)²·c — normalized so perfectly even = 1.0.

    (The paper reports Σ|C_i|²/(Σ|C_i|)², whose floor is 1/c; we multiply
    by c so the floor is 1.0 regardless of c, matching the magnitudes the
    paper tabulates, e.g. 1.3–1.5 for c=20.)
    """
    sizes = np.bincount(np.asarray(obj_assign), minlength=n_clusters)
    return imbalance_factor_from_counts(sizes)


def imbalance_factor_from_counts(counts) -> float:
    """IF(C) from the per-cluster size vector directly (uniform = 1.0).

    The serving stack's compaction trigger uses this on the buffers'
    live ``counts`` (core/server.py) — the assignment vector of
    :func:`imbalance_factor` doesn't exist for a mutated index whose
    objects never lived in one array.
    """
    sizes = np.asarray(counts, np.float64)
    tot = sizes.sum()
    if tot == 0:
        return 0.0
    return float((sizes ** 2).sum() / tot**2 * sizes.shape[0])


def cluster_precision(q_assign, positives, obj_assign, n_clusters: int):
    """P(C) (Eq. 15–16): per-cluster mean fraction of each routed query's
    positives that landed in the same cluster, weighted by queries routed.

    q_assign: (B,) cluster per validation query.
    positives: list of B int arrays (ground-truth object ids per query).
    obj_assign: (N,) cluster per object.
    """
    q_assign = np.asarray(q_assign)
    obj_assign = np.asarray(obj_assign)
    num = np.zeros(n_clusters)
    cnt = np.zeros(n_clusters)
    for qa, pos in zip(q_assign, positives):
        pos = np.asarray(pos)
        if pos.size == 0:
            continue
        frac = (obj_assign[pos] == qa).mean()
        num[qa] += frac
        cnt[qa] += 1
    mask = cnt > 0
    pc_i = np.zeros(n_clusters)
    pc_i[mask] = num[mask] / cnt[mask]
    total_q = cnt.sum()
    if total_q == 0:
        return 0.0, pc_i
    pc = float((pc_i * cnt).sum() / total_q)
    return pc, pc_i


def recall_at_k(retrieved, positives, k: int) -> float:
    """Mean over queries of |top-k ∩ positives| / |positives|."""
    vals = []
    for r, p in zip(retrieved, positives):
        p = set(int(x) for x in np.asarray(p).tolist())
        if not p:
            continue
        r = [int(x) for x in np.asarray(r)[:k].tolist()]
        vals.append(len(p.intersection(r)) / len(p))
    return float(np.mean(vals)) if vals else 0.0


def ndcg_at_k(retrieved, positives, k: int) -> float:
    """Binary-relevance NDCG@k (paper §5.1)."""
    vals = []
    for r, p in zip(retrieved, positives):
        p = set(int(x) for x in np.asarray(p).tolist())
        if not p:
            continue
        r = [int(x) for x in np.asarray(r)[:k].tolist()]
        dcg = sum(1.0 / np.log2(i + 2) for i, x in enumerate(r) if x in p)
        ideal = sum(1.0 / np.log2(i + 2) for i in range(min(len(p), k)))
        vals.append(dcg / ideal if ideal > 0 else 0.0)
    return float(np.mean(vals)) if vals else 0.0
