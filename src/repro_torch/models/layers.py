"""Building blocks of the port's models (reference: ``repro.models.layers``
``dense``, ``mlp_apply``, ``apply_norm`` and their initializers).

Weights keep the reference's layout — a dense kernel is ``(in, out)`` —
so a converted parameter is the reference's array, unchanged, and
``dense(x) = x @ w + b`` in ``x``'s dtype, exactly as the reference does.
Parameters are trainable; a snapshot freezes the modules it holds.

The initializers draw from an explicit ``torch.Generator`` on the CPU at
the reference's scales (normal(0, 1/√fan_in) kernels, zero biases, unit
norms). Their streams cannot equal ``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``N(0, 1) · scale`` of ``shape``, float32, from ``generator``."""
    return torch.randn(*shape, generator=generator) * scale


class Dense(nn.Module):
    """``y = x @ w (+ b)``, computed in ``x``'s dtype (reference ``dense``)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class MLP(nn.Module):
    """Plain MLP over :class:`Dense` layers, ReLU between them (reference
    ``mlp_apply`` with its default activation)."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class LayerNorm(nn.Module):
    """LayerNorm computed in float32 and cast back to the input dtype
    (reference ``apply_norm`` with a bias)."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, scale: Optional[float] = None) -> Dense:
    """A :class:`Dense` with an ``(in_dim, out_dim)`` kernel drawn at
    ``scale`` (default ``1/√in_dim``) and a zero bias when ``bias``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = normal(generator, (in_dim, out_dim), scale)
    return Dense(w, torch.zeros(out_dim) if bias else None)


def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             bias: bool = True) -> MLP:
    """An :class:`MLP` of ``dims = (in, h1, ..., out)``, layers drawn in
    order."""
    return MLP([dense_init(generator, dims[i], dims[i + 1], bias=bias)
                for i in range(len(dims) - 1)])


def norm_init(dim: int, *, eps: float = 1e-6) -> LayerNorm:
    """A :class:`LayerNorm` of unit scale and zero bias (draws nothing)."""
    return LayerNorm(torch.ones(dim), torch.zeros(dim), eps=eps)
