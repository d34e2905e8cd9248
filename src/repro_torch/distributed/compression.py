"""int8 gradient compression for the all-reduce (reference:
``repro.distributed.compression``), with error feedback:

  1. the residual-corrected gradient g' = g + e;
  2. per block of ``block`` values the scale s = max|g'| / 127 (at least
     1e-12) and q = round(g' / s) ∈ [−127, 127] int8, rounded half to
     even;
  3. the all-reduce of q as int32 partial sums and of s: int8 payload,
     4× fewer bytes than f32 on the wire, the scales small beside it;
  4. the dequantization ĝ = mean(q) · mean(s); the new residual e = g' − ĝ.

:func:`compressed_psum` is step 3–4 over a ``torch.distributed`` process
group (a ``DeviceMesh`` axis's: ``mesh.get_group(axis)``), on one
tensor; :func:`compress_tree_for_allreduce` is steps 1–2 and the residual
over a whole gradient tree, for a caller that all-reduces the ``(q, s)``
pairs itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import _unflatten_like, tree_leaves


def quantize_int8(g: torch.Tensor, *, block: int = 256):
    """``g`` any shape → ``(q int8 (n_blocks, block), scales (n_blocks,)
    in g's dtype, n = g.numel())``; the tail block is zero-padded."""
    flat = g.reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % block))
    blocks = flat.reshape(-1, block)
    s = blocks.abs().amax(dim=1) / 127.0
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(blocks / s[:, None]), -127, 127)
    return q.to(torch.int8), s, n


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, n: int, shape
                    ) -> torch.Tensor:
    """``q · s`` per block in float32, the padding cut off, as ``shape``."""
    out = (q.float() * s[:, None]).reshape(-1)[:n]
    return out.reshape(shape)


def compressed_psum(g: torch.Tensor, group=None, *, block: int = 256
                    ) -> torch.Tensor:
    """The int8 mean of ``g`` over the ranks of ``group``: each rank's
    quantized blocks summed as int32 and its scales summed, then
    dequantized as ``(Σq / world) · (Σs / world)`` (float32)."""
    import torch.distributed as dist
    q, s, n = quantize_int8(g, block=block)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = s.clone()
    dist.all_reduce(ssum, group=group)
    world = float(dist.get_world_size(group))
    return dequantize_int8(qsum.float() / world, ssum / world, n, g.shape)


def compress_tree_for_allreduce(grads, residuals, *, block: int = 256):
    """Error-feedback quantization of a gradient tree (dicts and lists of
    tensors) against ``residuals`` of the same structure → ``(tree of (q,
    s), new residuals)``. The caller all-reduces each ``(q, s)`` and
    dequantizes the means (:func:`dequantize_int8`)."""
    out_q, out_res = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(residuals)):
        gc = g.float() + e
        q, s, n = quantize_int8(gc, block=block)
        out_q.append((q, s))
        out_res.append(gc - dequantize_int8(q, s, n, g.shape))
    return (_unflatten_like(grads, iter(out_q)),
            _unflatten_like(grads, iter(out_res)))


def init_residuals(params):
    """Float32 zeros shaped like every leaf of ``params``, on its device."""
    return _unflatten_like(params, iter(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)))
