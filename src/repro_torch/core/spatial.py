"""The learnable monotonic step-function spatial relevance (reference:
``repro.core.spatial``, paper §4.2, Eq. 4–5) and its ablations.

Training form (Eq. 4): SRel = Σ_i softplus(w_s[i]) · 1[S_in ≥ T[i]] with
T[i] = i/t. The indicator has zero gradient; it is trained with the
reference's straight-through surrogate (:class:`StepIndicator`): the exact
step forward, a sigmoid of temperature ``tau`` backward.

Serving form (Eq. 5): ŵ_s[i] = Σ_{j≤i} softplus(w_s[j]), looked up at
⌊S_in·t⌋.

Distances divide by a tensor on the distance's device: a true division,
as the CUDA kernels divide (PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which can move ⌊S_in·t⌋ across a bucket).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def spatial_init(t: int, generator: torch.Generator) -> dict:
    """``{"w_s": -2 + 0.01·N(0, 1)}`` of length ``t``: small positive
    increments, roughly a linear ramp as a prior."""
    return {"w_s": torch.full((t,), -2.0)
            + 0.01 * torch.randn(t, generator=generator)}


def thresholds(t: int, device=None) -> torch.Tensor:
    """T[i] = i/t, float32, each an exact quotient."""
    return (torch.arange(t, dtype=torch.float32, device=device)
            / torch.tensor(float(t), device=device))


class StepIndicator(torch.autograd.Function):
    """``1[s_in ≥ thr]`` over a new last axis (in ``s_in``'s dtype, float32
    on every path of the port), with the sigmoid surrogate
    gradient ``Σ g·σ(z)(1−σ(z))/tau``, ``z = (s_in − thr)/tau``, to
    ``s_in`` alone (reference ``_step_indicator``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, s_in, thr, tau):
        ctx.save_for_backward(s_in, thr)
        ctx.tau = tau
        return (s_in[..., None] >= thr).to(s_in.dtype)

    @staticmethod
    def backward(ctx, g):
        s_in, thr = ctx.saved_tensors
        tau = ctx.tau
        z = (s_in[..., None] - thr) / tau
        sig = torch.sigmoid(z)
        return (g * sig * (1 - sig) / tau).sum(-1), None, None


def spatial_relevance_train(w_s: torch.Tensor, s_in: torch.Tensor, *,
                            tau: float = 0.05) -> torch.Tensor:
    """Eq. 4: ``s_in (...,)`` in [0, 1] → SRel ``(...,)`` with ``t =
    len(w_s)`` steps; differentiable in ``w_s`` (exactly) and ``s_in``
    (straight through)."""
    w = F.softplus(w_s.float())
    ind = StepIndicator.apply(s_in, thresholds(w.shape[0], s_in.device), tau)
    return ind @ w


def extract_lookup(w_s: torch.Tensor) -> torch.Tensor:
    """Eq. 5 preparation: ŵ_s[i] = Σ_{j≤i} softplus(w_s[j]); (t,) table."""
    return torch.cumsum(F.softplus(w_s.float()), dim=0)


def spatial_relevance_serve(w_hat: torch.Tensor, s_in: torch.Tensor
                            ) -> torch.Tensor:
    """Eq. 5: SRel = ŵ_s[clip(⌊S_in·t⌋, 0, t−1)], an O(1) lookup."""
    t = w_hat.shape[0]
    idx = torch.clamp(torch.floor(s_in * t).to(torch.int64), 0, t - 1)
    return w_hat[idx]


# --- distances -------------------------------------------------------------


def sdist(q_loc: torch.Tensor, o_loc: torch.Tensor, dist_max
          ) -> torch.Tensor:
    """Normalized Euclidean distance ``clip(‖q_loc − o_loc‖ / dist_max, 0,
    1)`` over the last axis (broadcasting), ``sqrt(dx² + dy²)`` divided by
    ``dist_max`` on the distance's device."""
    dl = q_loc.float() - o_loc.float()
    dist = torch.sqrt((dl * dl).sum(-1))
    divisor = torch.as_tensor(dist_max, dtype=torch.float32,
                              device=dist.device)
    return torch.clamp(dist / divisor, 0.0, 1.0)


def s_in_from_locs(q_loc: torch.Tensor, o_loc: torch.Tensor, dist_max
                   ) -> torch.Tensor:
    """S_in = 1 − :func:`sdist`."""
    return 1.0 - sdist(q_loc, o_loc, dist_max)


# --- ablation variants (paper Table 6) -------------------------------------


def linear_srel(s_in: torch.Tensor) -> torch.Tensor:
    """LIST-R + S_in: spatial relevance is S_in itself."""
    return s_in


def exp_init() -> dict:
    """``{"alpha": 0, "beta": 0}`` (0-d float32)."""
    return {"alpha": torch.zeros(()), "beta": torch.zeros(())}


def exp_srel(spatial, s_in: torch.Tensor) -> torch.Tensor:
    """LIST-R + α·S_in^β, α and β kept non-negative by softplus."""
    a = F.softplus(spatial["alpha"].float())
    b = F.softplus(spatial["beta"].float())
    return a * torch.pow(torch.clamp(s_in, min=1e-6), b)
