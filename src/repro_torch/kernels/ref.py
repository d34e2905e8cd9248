"""The plain oracles of the kernels, under the reference's names
(reference: ``repro.kernels.ref``, the allclose targets of its Pallas
kernels).

Each is the port's plain PyTorch version of a kernel twin, the version
the twin is held against on the card and the one a CPU tensor runs:

* :func:`fused_topk_score_ref` — ``fused_topk_score.gather_topk_plain``
  (the gather path);
* :func:`flash_attention_ref` — ``flash_attention.flash_attention_plain``;
* :func:`dot_interaction_ref` — ``dot_interaction.dot_interaction_plain``;
* :func:`embedding_bag_ref` — ``embedding_bag.embedding_bag_plain``.
"""
from __future__ import annotations

from repro_torch.kernels.dot_interaction import dot_interaction_plain
from repro_torch.kernels.embedding_bag import embedding_bag_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.fused_topk_score import gather_topk_plain


def fused_topk_score_ref(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids,
                         w_hat, *, k: int, dist_max: float):
    """Score every materialized candidate (``core/relevance``'s scoring)
    and take one top-k → ``(scores (B, k) f32, positions (B, k) int32)``,
    equal scores in position order. Where the reference's
    ``jax.lax.top_k`` returns a masked candidate's position, past the
    last valid one, this gives -1 (the kernel's contract)."""
    return gather_topk_plain(q_emb, q_loc, w_st, cand_emb, cand_loc,
                             cand_ids, w_hat, k=k, dist_max=dist_max)


# NOTE: the routed (gather-free) kernel's dense oracle is
# core/engine.dense_routed_topk (kernels.fused_topk_score.routed_topk_plain)
# — ONE definition, built on the plain scan's score_candidates, so the
# kernel checks and the engine parity tests certify the same contract;
# the cluster-major kernel's is fused_topk_score.cluster_major_partials_plain.


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense softmax attention with GQA, causal and window masks, f32
    math, output in q's dtype."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def dot_interaction_ref(feats):
    """``feats (B, F, d)`` → the Gram matrix's upper triangle ``(B,
    F(F-1)/2)`` in feats' dtype."""
    return dot_interaction_plain(feats)


def embedding_bag_ref(table, idx):
    """``idx (B, P)`` int32, -1 padded → ``(B, d)`` f32 pooled sums."""
    return embedding_bag_plain(table, idx)
