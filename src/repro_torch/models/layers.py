"""Building blocks of the port's models (reference: ``repro.models.layers``
``dense``, ``mlp_apply``, ``apply_norm``).

Weights keep the reference's layout — a dense kernel is ``(in, out)`` —
so a converted parameter is the reference's array, unchanged, and
``dense(x) = x @ w + b`` in ``x``'s dtype, exactly as the reference does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ w (+ b)``, computed in ``x``'s dtype (reference ``dense``)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)

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
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)
