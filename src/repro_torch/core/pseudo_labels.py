"""Pseudo-negative labels for the cluster classifier (reference:
``repro.core.pseudo_labels.mine_negatives``, paper §4.3, Eq. 13).

neg_q = argsort_{o ∈ D} ST(q, o)[neg_start : neg_end],  s(q, o) = 0

The trained relevance model ranks the whole corpus for each training
query in its serve form (Eq. 5's lookup); ground-truth positives are
masked to −inf; the top ``neg_end`` are taken with ``jax.lax.top_k``'s
tie rule (:func:`~repro_torch.core.index.topk_stable`) and the window
``[neg_start:]`` kept. Query blocks of ``batch_queries`` bound the ``(B,
N)`` score block on the device.

The corpus-sharded forms, :func:`mine_negatives_dense` (per-shard top-k′
oversampling, then a merge) and :func:`mine_negatives_sharded` (per-shard
top ``neg_end``, then a merge), loop over the shards on one device.
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


def _shard_window(vals, idx, *, k: int, neg_start: int) -> torch.Tensor:
    """Merge per-shard ``(B, k')`` survivors: the top ``k`` of their
    concatenation (shard order, then rank, first on a tie), the window
    ``[neg_start:]`` kept."""
    v = torch.cat(vals, dim=1)
    i = torch.cat(idx, dim=1)
    _, merge = topk_stable(v, k)
    return torch.gather(i, 1, merge)[:, neg_start:]


def mine_negatives_dense(rel: RelevanceModel, q_emb: torch.Tensor,
                         q_loc: torch.Tensor, obj_emb: torch.Tensor,
                         obj_loc: torch.Tensor, *, neg_start: int,
                         neg_end: int, dist_max=1.0, shards: int = 256,
                         per_shard_k: int = 0) -> torch.Tensor:
    """The reference's mesh form of the mining step: the corpus in
    ``shards`` equal blocks (``N`` divisible by ``shards``), each block's
    top ``k'`` (default ``min(N/shards, max(64, 4·neg_end/shards))``,
    an oversampling so the true window survives with high probability),
    then a merge of the ``(B, shards·k')`` survivors and the window. The
    reference scores the corpus in one sharded product and annotates it
    with ``constrain``, a no-op on one device; here the blocks are scored
    one after another. → ``(B, ≤ neg_end − neg_start)`` int64."""
    n = obj_emb.shape[0]
    if n % shards:
        raise ValueError(f"mine_negatives_dense: {n} objects do not split "
                         f"into {shards} equal shards")
    ns = n // shards
    per_shard_k = per_shard_k or min(ns, max(64, 4 * neg_end // shards))
    vals, idx = [], []
    for s in range(shards):
        st = relevance.score_corpus(rel, q_emb, q_loc,
                                    obj_emb[s * ns:(s + 1) * ns],
                                    obj_loc[s * ns:(s + 1) * ns],
                                    dist_max=dist_max)
        v, i = topk_stable(st, per_shard_k)
        vals.append(v)
        idx.append(i + s * ns)
    k_merge = min(neg_end, shards * per_shard_k)
    return _shard_window(vals, idx, k=k_merge,
                         neg_start=min(neg_start, k_merge - 1))


def mine_negatives_sharded(rel: RelevanceModel, q_emb: torch.Tensor,
                           q_loc: torch.Tensor, obj_emb: torch.Tensor,
                           obj_loc: torch.Tensor, *, neg_start: int,
                           neg_end: int, dist_max=1.0,
                           shards: int = 1) -> torch.Tensor:
    """Shard-parallel mining: each of ``shards`` equal corpus blocks
    keeps its top ``min(neg_end, N/shards)``, and one merge of those
    lists gives the top ``neg_end`` and the window: ``mine_negatives``'
    window up to ties. → ``(B, neg_end − neg_start)`` int64."""
    n = obj_emb.shape[0]
    if n % shards:
        raise ValueError(f"mine_negatives_sharded: {n} objects do not "
                         f"split into {shards} equal shards")
    ns = n // shards
    k = min(neg_end, ns)
    vals, idx = [], []
    for s in range(shards):
        st = relevance.score_corpus(rel, q_emb, q_loc,
                                    obj_emb[s * ns:(s + 1) * ns],
                                    obj_loc[s * ns:(s + 1) * ns],
                                    dist_max=dist_max)
        v, i = topk_stable(st, k)
        vals.append(v)
        idx.append(i + s * ns)
    return _shard_window(vals, idx, k=neg_end, neg_start=neg_start)
