"""Serve form of the learned step-function spatial relevance (reference:
``repro.core.spatial``, paper Eq. 5)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_lookup(w_s: torch.Tensor) -> torch.Tensor:
    """Eq. 5 preparation: ŵ_s[i] = Σ_{j≤i} softplus(w_s[j]); (t,) table."""
    return torch.cumsum(F.softplus(w_s.float()), dim=0)


def spatial_relevance_serve(w_hat: torch.Tensor, s_in: torch.Tensor
                            ) -> torch.Tensor:
    """Eq. 5: SRel = ŵ_s[clip(⌊S_in·t⌋, 0, t−1)], an O(1) lookup."""
    t = w_hat.shape[0]
    idx = torch.clamp(torch.floor(s_in * t).to(torch.int64), 0, t - 1)
    return w_hat[idx]


def s_in_from_locs(q_loc: torch.Tensor, o_loc: torch.Tensor,
                   dist_max: float) -> torch.Tensor:
    """S_in = 1 − clip(‖q_loc − o_loc‖ / dist_max, 0, 1) over the last
    axis (broadcasting).

    ``dist / dist_max`` must be a true division, as in the CUDA kernels:
    a result one ulp off moves ``⌊S_in·t⌋`` across a bucket of ``w_hat``
    for some rows. PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal instead, so the divisor is a tensor on ``dist``'s
    device."""
    dl = q_loc.float() - o_loc.float()
    dist = torch.sqrt((dl * dl).sum(-1))
    divisor = torch.tensor(dist_max, dtype=torch.float32, device=dist.device)
    return 1.0 - torch.clamp(dist / divisor, 0.0, 1.0)
