"""The kernel entry point: the counterpart of ``repro/kernels/ops.py``.

Same function names, and the same positional and keyword arguments for
the data and semantics (``k``, ``dist_max``, ``cand_scale``, ``causal``,
``window``). The reference's TPU tiling and interpret knobs
(``block_m``, ``block_n``, ``block_q``, ``block_k``, ``block_v``,
``interpret``) mean nothing here and are left out: each kernel picks its
own tiling, and the result does not depend on it.

* ``fused_topk_score(q_emb, q_loc, w_st, cand_emb, cand_loc, cand_ids,
  w_hat, *, k, dist_max, cand_scale=None)``: the gather path, local
  positions over a materialized ``(B, N, d)`` candidate copy;
* ``flash_attention(q, k, v, *, causal=True, window=0)``, and its
  backward ``flash_attention_backward(q, k, v, o, lse, do, *, causal,
  window)`` (no reference counterpart: the reference differentiates its
  jnp path; ``flash_attention`` takes it through autograd);
* ``dot_interaction(feats)``, and ``dot_interaction_backward(feats,
  grad)`` likewise;
* ``embedding_bag(table, idx)``;
* ``fused_topk_score_routed`` and ``fused_topk_score_cluster_major``, the
  query engine's wrappers as they are. Unlike the reference's
  ``ops.fused_topk_score_cluster_major`` (roster-gathered query payloads
  and ``n_total``), the port's reads the query rows through the roster
  itself and takes ``cr``.

Each function runs its kernel's plain PyTorch version for a CPU tensor,
launches its hand-written CUDA kernel for a CUDA tensor, takes the meta
path for a ``meta`` tensor (outputs of the kernel's shapes on ``meta``,
its declared ``work()`` recorded to the active ``kernels.meta``
counter; nothing runs), and raises for any other device; there is no
fallback. :func:`launch_counts` reads the
kernels' launch counters (one key per kernel, the two backward kernels
included), :func:`reset_launch_counts` zeroes them.
"""
from __future__ import annotations

from repro_torch.kernels import dot_interaction as _di
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_topk_score as _fts
from repro_torch.kernels.dot_interaction import (  # noqa: F401
    dot_interaction,
    dot_interaction_backward,
)
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_backward,
)
from repro_torch.kernels.fused_topk_score import (  # noqa: F401
    fused_topk_score,
    fused_topk_score_cluster_major,
    fused_topk_score_routed,
)

_MODULES = (_fts, _fa, _di, _eb)


def launch_counts() -> dict:
    """Launches since the last reset, by kernel, over every module."""
    out = {}
    for mod in _MODULES:
        out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    for mod in _MODULES:
        for name in mod.launches:
            mod.launches[name] = 0


def build_all() -> dict:
    """Build every kernel library (one ``nvcc`` per source, side by side)
    → ``{library name: build info}``."""
    from concurrent.futures import ThreadPoolExecutor
    libs = {mod._lib.name: mod._lib for mod in _MODULES}
    with ThreadPoolExecutor(len(libs)) as pool:
        return dict(zip(libs, pool.map(lambda lib: lib.info(),
                                       libs.values())))
