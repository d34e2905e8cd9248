"""DLRM pairwise-dot feature interaction: ``(B, F, d) → (B, F(F-1)/2)``.

:func:`dot_interaction` launches the hand-written CUDA kernel
``csrc/dot_interaction.cu`` for a CUDA tensor; it replaces the Pallas
kernel ``repro/kernels/dot_interaction.py::dot_interaction`` and writes
the upper triangle (``np.triu_indices(F, k=1)``, row-major) directly
instead of the full Gram matrix. Bound by the bytes of ``feats``. For a
CPU tensor it runs :func:`dot_interaction_plain`; any other device
raises. Sums are f32, rounded once to ``feats``' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (kernels.ops.reset_launch_counts)
launches = {"dot_interaction": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a block stages as many batch rows as fit in 48 KB of shared memory, at
# most this many; one row may take up to the 227 KB a block can have
_MAX_ROWS = 8
_SMEM_TARGET = 48 * 1024
_SMEM_MAX = 227 * 1024


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dot_interaction.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr,
                                    ptr]
    lib.dot_interaction.restype = i32


_lib = build.KernelLibrary("dot_interaction", ["dot_interaction.cu"], _bind)


def triu_pairs(f: int, device=None):
    """``(i, j)`` of the pairs i < j in ``np.triu_indices(f, k=1)`` order."""
    return tuple(torch.triu_indices(f, f, offset=1, device=device))


def dot_interaction_plain(feats: torch.Tensor) -> torch.Tensor:
    """The Gram matrix X·Xᵀ in f32, its upper triangle, in feats' dtype."""
    x = feats.float()
    gram = x @ x.transpose(-1, -2)
    iu, ju = triu_pairs(feats.shape[1], feats.device)
    return gram[:, iu, ju].to(feats.dtype)


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """``feats (B, F, d)`` f32/bf16/f16 → ``(B, F(F-1)/2)`` pairwise dots."""
    if feats.device.type == "cpu":
        return dot_interaction_plain(feats)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    if feats.dtype not in _DTYPE:
        raise TypeError(f"feats dtype {feats.dtype} not in {list(_DTYPE)}")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous (B, F, d) tensor")
    b, f, d = feats.shape
    row_bytes = f * (d + 1) * 4
    if row_bytes > _SMEM_MAX:
        raise ValueError(f"F={f}, d={d}: one row needs {row_bytes} bytes of "
                         f"shared memory, more than {_SMEM_MAX}")
    out = torch.empty((b, f * (f - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    rows = max(1, min(_MAX_ROWS, _SMEM_TARGET // row_bytes))
    vec = int((d * feats.element_size()) % 16 == 0
              and feats.data_ptr() % 16 == 0)
    err = _lib().dot_interaction(
        feats.data_ptr(), _DTYPE[feats.dtype], b, f, d, rows, vec,
        out.data_ptr(), torch.cuda.current_stream(feats.device).cuda_stream)
    if err:
        raise RuntimeError(f"dot_interaction launch failed: cudaError {err}")
    launches["dot_interaction"] += 1
    return out
