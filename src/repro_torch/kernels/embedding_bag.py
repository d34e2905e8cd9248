"""Pooled multi-hot embedding lookup (EmbeddingBag, mode sum).

:func:`embedding_bag` launches the hand-written CUDA kernel
``csrc/embedding_bag.cu`` for a CUDA tensor; it replaces the Pallas
kernel ``repro/kernels/embedding_bag.py::embedding_bag``. The TPU kernel
streams the whole table per batch tile (O(V·d)); this one gathers each
bag's rows (O(B·P·d)), one warp per bag. Bound by the bytes of the rows
the bags touch, the indices and the output. For a CPU tensor it runs
:func:`embedding_bag_plain`; any other device raises.

Semantics (the TPU kernel's): ``out[b] = Σ_p table[idx[b, p]]`` in f32
over ``0 <= idx < V``; a duplicate counts each time, a negative index is
padding, and an index ``>= V`` adds nothing.

Forward-only: the kernel has no backward, and no loss of the reference
pools through it. On the card a table that requires a gradient while
autograd is on raises, rather than returning a sum with no gradient; the
CPU's plain version is differentiable.

:func:`work` declares the kernel's FLOPs and bytes; for a ``meta`` tensor
:func:`embedding_bag` launches nothing, returns the ``(B, d)`` f32 output
on ``meta`` and records that work (``kernels.meta``), with every index
counted valid and distinct up to V rows (a meta tensor holds no indices).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta

# kernel launches since the last reset (kernels.ops.reset_launch_counts)
launches = {"embedding_bag": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.embedding_bag.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, i32,
                                  ptr, ptr]
    lib.embedding_bag.restype = i32


_lib = build.KernelLibrary("embedding_bag", ["embedding_bag.cu"], _bind)


def work(v: int, d: int, b: int, p: int, *, dtype=torch.float32,
         rows_touched=None, valid=None):
    """``(flops, bytes)`` of one launch on ``table (v, d)``, ``idx (b,
    p)``: d FLOPs per valid index; each distinct row touched read once
    (``rows_touched``, from HBM: the rest come from L2), the indices read
    and the f32 sums written once. ``valid`` and ``rows_touched`` are the
    data's counts; left out, every index counts valid and distinct up to
    ``v`` rows."""
    valid = b * p if valid is None else valid
    rows = min(v, valid) if rows_touched is None else rows_touched
    return valid * d, rows * d * meta.itemsize(dtype) + b * p * 4 + b * d * 4


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """Gather every bag's rows and sum the valid ones in f32."""
    valid = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(valid, idx, torch.zeros_like(idx)).long()]
    rows = torch.where(valid[..., None], rows.float(),
                       torch.zeros((), device=table.device))
    return rows.sum(dim=1)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table (V, d)`` f32/bf16/f16, ``idx (B, P)`` int32 (-1 padded)
    → pooled sums ``(B, d)`` f32."""
    if table.device.type == "cpu":
        return embedding_bag_plain(table, idx)
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {table.device}")
    if table.dtype not in _DTYPE:
        raise TypeError(f"table dtype {table.dtype} not in {list(_DTYPE)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError("table must be (V, d) and idx (B, P)")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError("embedding_bag is forward-only on the card: the "
                           "kernel has no backward, so a table that "
                           "requires grad would get none; run it under "
                           "torch.no_grad() or on a detached table")
    v, d = table.shape
    b, p = idx.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if table.device.type == "meta":
        meta.record("embedding_bag", work(v, d, b, p, dtype=table.dtype))
        return out
    vec = int((d * table.element_size()) % 16 == 0
              and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with meta.launch_range("embedding_bag"):
        err = _lib().embedding_bag(
            table.data_ptr(), _DTYPE[table.dtype], idx.data_ptr(), b, p, v,
            d, vec, out.data_ptr(),
            torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: cudaError {err}")
    launches["embedding_bag"] += 1
    return out
