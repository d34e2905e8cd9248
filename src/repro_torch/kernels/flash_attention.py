"""Flash attention (block-wise online softmax) with GQA, causal and
sliding-window masks.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for a CUDA tensor; it replaces the Pallas
kernel ``repro/kernels/flash_attention.py::flash_attention`` with the
same contract: ``q (B, S, H, D)``, ``k``/``v (B, S, KV, D)``, head ``h``
reads KV head ``h // (H // KV)``, f32 accumulation, output in q's dtype,
masked scores at the finite ``NEG_INF`` and ``l`` floored at 1e-30. Bound
by operations: bf16/fp16 inputs run both products on the tensor cores
(``mma.sync``, f32 accumulation, P split into two 16-bit parts so P·V
keeps f32 precision); f32 inputs run f32 FMAs on the CUDA cores. For a
CPU tensor it runs :func:`flash_attention_plain`; any other device
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# kernel launches since the last reset (kernels.ops.reset_launch_counts)
launches = {"flash_attention": 0}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128)


def _bind(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [f32, ptr,
                                                                  ptr]
    lib.flash_attention.restype = i32


_lib = build.KernelLibrary("flash_attention", ["flash_attention.cu"], _bind)


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """``(sq, sk)`` bool, True where query position i may see key j."""
    pos_q = torch.arange(sq, device=device)[:, None]
    pos_k = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_q >= pos_k
    if window > 0:
        mask &= (pos_q - pos_k) < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense softmax attention in f32 (the reference's oracle form)."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float())
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """``q (B, S, H, D)``, ``k``/``v (B, S, KV, D)`` → ``(B, S, H, D)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, S, H, D), k and v (B, S, KV, D)")
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"H={h} is not a multiple of KV={n_kv}")
    if b * h > 65535:
        raise ValueError(f"B·H={b * h} exceeds the grid's y limit")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.element_size() == 2 and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE[q.dtype], b, s, h,
        n_kv, d, int(causal), int(window), 1.0 / math.sqrt(d),
        out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches["flash_attention"] += 1
    return out
