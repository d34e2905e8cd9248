"""Building blocks of the port's models (reference: ``repro.models.layers``):
``dense``, ``mlp_apply``, the norms and their initializers, and the LM
half — ``rope``, full-sequence attention (``attention_full``,
``attention_local_banded``), ``decode_attention`` and
``chunked_softmax_xent``.

Weights keep the reference's layout — a dense kernel is ``(in, out)`` —
so a converted parameter is the reference's array, unchanged, and
``dense(x) = x @ w + b`` in ``x``'s dtype, exactly as the reference does.
Parameters are trainable; a snapshot freezes the modules it holds.

The initializers draw from an explicit ``torch.Generator`` at the
reference's scales (normal(0, 1/√fan_in) kernels, zero biases, unit
norms), on the generator's device. Their streams cannot equal
``jax.random``'s.

Full-sequence attention on a CUDA tensor launches the flash-attention
twin (``kernels.flash_attention.flash_attention``, the entry point's
``kernels.ops.flash_attention``), the kernel the reference's TPU
path runs for the same contract; under autograd it goes through
``FlashAttentionFn``, whose gradient is the flash backward kernel. On a
CPU tensor it runs the reference's chunked online softmax, which
autograd differentiates. ``decode_attention`` and the loss are plain
torch on every device, as the reference computes them in jnp.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.device import require_device
from repro_torch.kernels import flash_attention as flash_kernel

NEG_INF = -1e30


class MetaGenerator(torch.Generator):
    """A generator on the ``meta`` device. The initializers draw on their
    generator's device, so given this one they build every tensor's shape
    and dtype, allocate nothing and draw nothing: the shape path of the
    cell plans (``launch.steps``), where a full kimi-k2 tree must not
    touch memory."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``, or a
    :class:`MetaGenerator` when ``device`` is ``meta``."""
    dev = require_device(device)
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


@contextlib.contextmanager
def meta_init():
    """``with meta_init() as g``: a :class:`MetaGenerator`, with ``meta``
    the default device, so an initializer given ``g`` builds its module's
    shapes only, the factories that name no device included."""
    with torch.device("meta"):
        yield MetaGenerator()


def normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``N(0, 1) · scale`` of ``shape``, float32, from ``generator``, on
    the generator's device (a :class:`MetaGenerator`: shape only)."""
    if isinstance(generator, MetaGenerator):
        return torch.empty(*shape, device="meta")
    x = torch.randn(*shape, generator=generator, device=generator.device)
    return x.mul_(scale)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in ``x``'s dtype, the weight cast on every call
    (reference ``dense``); ``p`` a dict ``{"w", "b"}``, ``b`` optional."""
    y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_apply(params, x: torch.Tensor, *, act=torch.relu,
              final_act=None) -> torch.Tensor:
    """Reference ``mlp_apply``: :func:`dense` layers, ``act`` between them,
    ``final_act`` after the last when given."""
    for i, p in enumerate(params):
        x = dense(p, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def apply_norm(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Reference ``apply_norm``, in f32 and cast back to x's dtype: a
    layer norm when ``p`` has a ``"bias"``, else an RMS norm whose mean
    square is a contraction over the last axis; the scale is read in
    f32."""
    x32 = x.float()
    if p.get("bias") is not None:
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    ms = torch.linalg.vecdot(x32, x32, dim=-1)[..., None] / x32.shape[-1]
    return (x32 * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


class Dense(nn.Module):
    """``y = x @ w (+ b)``, computed in ``x``'s dtype (:func:`dense`)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense({"w": self.w, "b": self.b}, x)


class MLP(nn.Module):
    """Plain MLP over :class:`Dense` layers (:func:`mlp_apply`)."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply([{"w": m.w, "b": m.b} for m in self.layers], x)


class LayerNorm(nn.Module):
    """:func:`apply_norm` with a bias."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm({"scale": self.scale, "bias": self.bias}, x,
                          eps=self.eps)


class RMSNorm(nn.Module):
    """:func:`apply_norm` without a bias: the RMS norm."""

    def __init__(self, scale: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm({"scale": self.scale}, x, eps=self.eps)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, scale: Optional[float] = None) -> Dense:
    """A :class:`Dense` with an ``(in_dim, out_dim)`` kernel drawn at
    ``scale`` (default ``1/√in_dim``) and a zero bias when ``bias``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = normal(generator, (in_dim, out_dim), scale)
    return Dense(w, torch.zeros(out_dim, device=w.device) if bias else None)


def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             bias: bool = True) -> MLP:
    """An :class:`MLP` of ``dims = (in, h1, ..., out)``, layers drawn in
    order."""
    return MLP([dense_init(generator, dims[i], dims[i + 1], bias=bias)
                for i in range(len(dims) - 1)])


def norm_init(dim: int, *, kind: str = "rms", eps: float = 1e-6,
              device=None):
    """A unit-scale norm (draws nothing): :class:`RMSNorm` for ``kind
    "rms"`` (the reference's default), :class:`LayerNorm` with a zero bias
    for ``"layer"``."""
    if kind == "layer":
        return LayerNorm(torch.ones(dim, device=device),
                         torch.zeros(dim, device=device), eps=eps)
    if kind != "rms":
        raise ValueError(f"norm kind {kind!r} is not 'rms' or 'layer'")
    return RMSNorm(torch.ones(dim, device=device), eps=eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)`` op by op in x's dtype, as the reference's
    ``jax.nn.silu`` computes it (``x · (1 / (1 + exp(-x)))``, each step
    rounded): in bf16 a fused SiLU rounds once and differs in about a third
    of the elements."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. ``x (..., S, H, D)``; ``positions`` broadcastable
    to ``(..., S)``. The halves are rotated by f32 cos / sin, so a 16-bit
    ``x`` is promoted to f32 and rounded once back to its dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(x.device)[..., None].float() * freq    # (..., S, half)
    ang = ang[..., None, :]                                   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# Attention. q: (B, S, H, D); k, v: (B, S, KV, D); head h reads KV head
# h // (H // KV) (grouped-query).
# ---------------------------------------------------------------------------


def _flash(q, k, v, *, causal: bool, window: int):
    """The flash-attention twin on the card, through ``FlashAttentionFn``
    when autograd needs a gradient (the backward kernel); it raises for
    what it cannot take (Sq != Sk among them), with no fallback."""
    return flash_kernel.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window)


def attention_full(q, k, v, *, causal: bool = True, window: int = 0,
                   chunk: int = 1024, positions_q=None, positions_k=None):
    """Causal (and, for ``window > 0``, window-limited: pos_q - pos_k <
    window) attention over the whole sequence, f32 scores and softmax,
    output in q's dtype.

    On a CUDA tensor it launches the flash twin, whose own tiling stands
    in for ``chunk``; explicit ``positions_q`` / ``positions_k`` (the
    reference's oracle knobs) raise there. A ``meta`` tensor takes the
    twin's meta path (shapes and its declared work, nothing run). On a
    CPU tensor it runs the reference's chunked online softmax over
    ``chunk`` keys at a time."""
    if q.device.type in ("cuda", "meta"):
        if positions_q is not None or positions_k is not None:
            raise ValueError("the flash kernel takes the positions 0..S-1 "
                             "only; explicit positions_q / positions_k run "
                             "on the CPU")
        return _flash(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"no attention for device {q.device}")
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if positions_q is None:
        positions_q = torch.arange(sq, device=dev)
    if positions_k is None:
        positions_k = torch.arange(sk, device=dev)
    positions_q = torch.as_tensor(positions_q, device=dev).long()
    positions_k = torch.as_tensor(positions_k, device=dev).long()
    qg = q.reshape(b, sq, n_kv, g, d).float() * scale
    chunk = min(chunk, sk)
    if sk % chunk:          # pad keys to a chunk multiple, masked out
        pad = chunk - sk % chunk
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions_k = nn.functional.pad(positions_k, (0, pad),
                                        value=torch.iinfo(torch.int32).max)
        sk += pad
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, sq, d), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for c0 in range(0, sk, chunk):
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk].float()
        pk = positions_k[c0:c0 + chunk]
        s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kc)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= positions_q[:, None] >= pk[None, :]
        if window:
            mask &= (positions_q[:, None] - pk[None, :]) < window
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqj,bjkd->bkgqd", p,
                                                   vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,KV,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attention_local_banded(q, k, v, *, window: int, block=None):
    """Sliding-window causal attention by banded blocks (each query block
    of ``block >= window`` rows attends to its own block and the one
    before), the same function as ``attention_full`` with the window.

    On a CUDA tensor it launches the flash twin with the window (the
    kernel skips the key tiles no row of a query tile can see, the band),
    and a ``meta`` tensor the twin's meta path. On a CPU tensor it runs
    the reference's banded blocks."""
    b, s, h, d = q.shape
    block = block or window
    if block < window or s % block:
        raise ValueError(f"banded attention needs block >= window and S % "
                         f"block == 0 (S {s}, block {block}, window "
                         f"{window})")
    if q.device.type in ("cuda", "meta"):
        return _flash(q, k, v, causal=True, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"no attention for device {q.device}")
    n_kv = k.shape[2]
    g = h // n_kv
    nb = s // block
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qb = q.reshape(b, nb, block, n_kv, g, d).float() * scale
    kb = k.reshape(b, nb, block, n_kv, d)
    vb = v.reshape(b, nb, block, n_kv, d)
    # kv pair = (previous block, own block); previous of block 0 is zeros
    pad = torch.zeros_like(kb[:, :1])
    k2 = torch.cat([torch.cat([pad, kb[:, :-1]], 1), kb], dim=2)
    v2 = torch.cat([torch.cat([pad, vb[:, :-1]], 1), vb], dim=2)
    s_ = torch.einsum("bnqkgd,bnjkd->bnkgqj", qb, k2.float())
    pos_q = torch.arange(block, device=dev)[:, None] + block
    pos_k = torch.arange(2 * block, device=dev)[None, :]
    mask = (pos_q >= pos_k) & (pos_q - pos_k < window)
    first = torch.arange(nb, device=dev) == 0
    mask_first = mask & (pos_k >= block)
    full_mask = torch.where(first[:, None, None], mask_first[None],
                            mask[None])
    s_ = torch.where(full_mask[None, :, None, None], s_,
                     torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bnkgqj,bnjkd->bnkgqd", p, v2.float())
    o = o.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, d)
    return o.to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     ring: bool = False):
    """One new token against a (possibly ring-buffer) KV cache: ``q (B, 1,
    H, D)``, caches ``(B, T, KV, D)``, ``pos (B,)`` the new token's
    absolute position. ``ring`` means slot j holds the absolute position
    p ≡ j (mod T) with p in (pos - T, pos]. Plain torch on every device,
    f32 scores: the flash kernel needs Sq == Sk."""
    b, _, h, d = q.shape
    _, t, n_kv, _ = k_cache.shape
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, n_kv, g, d).float() * scale
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float())
    slot = torch.arange(t, device=q.device)[None, :]          # (1, T)
    p = pos.to(q.device).long()[:, None]
    if ring:
        abs_pos = p - torch.remainder(p - slot, t)   # absolute position of slot j
        valid = abs_pos >= 0
        if window:
            valid &= (p - abs_pos) < window
    else:
        valid = slot <= p
        if window:
            valid &= (p - slot) < window
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", w, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def chunked_softmax_xent(x, unembed, targets, *, chunk: int = 512,
                         mask=None):
    """Mean next-token cross-entropy over (masked) tokens, computed in
    sequence chunks so the ``(B, S, V)`` logits never exist whole. ``x
    (B, S, d)``, ``unembed (d, V)`` cast to x's dtype, ``targets (B, S)``;
    logits, log-sum-exp and the sums in f32."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk}")
    u = unembed.to(x.dtype)
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logits = (x[:, c0:c0 + chunk] @ u).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, c0:c0 + chunk, None].long())[..., 0]
        mi = mask[:, c0:c0 + chunk]
        tot = tot + ((lse - gold) * mi).sum()
        cnt = cnt + mi.sum()
    return tot / torch.clamp(cnt, min=1.0)
