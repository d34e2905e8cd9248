"""The control: the reference put in the program's place and computed one
precision below what the configuration states, the step a later change
might be tempted to take.

* The tower's compute type is bfloat16, so the control computes it in fp8
  (e4m3): every activation where the program stores one, and every
  matmul operand, rounded to e4m3 with a scale per row (activations) or
  per output column (weights), products summed in float32 as fp8 tensor
  cores sum them.
* Rows stored in bfloat16 are stored in e4m3 with a scale per row; rows
  stored in int8 are stored in int4 (symmetric per row, ±7).

The router, the mixing weights and the spatial table are float32 in the
configuration and stay float32 here.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def e4m3(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale along ``dim``, read back in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8:
    def act(self, x):
        return e4m3(x, -1)

    def weight(self, w):
        return e4m3(w, -2)


FP8 = Fp8()

# the stored tier one below each tier the configurations state
LOWER_TIER = {"bf16": "e4m3", "int8": "int4"}


def tier_rows(rows: torch.Tensor, tier: str) -> torch.Tensor:
    """f32 rows stored at ``tier`` (``e4m3`` or ``int4``), read back."""
    if tier == "e4m3":
        return e4m3(rows, -1)
    if tier != "int4":
        raise ValueError(f"unknown control tier {tier!r}")
    amax = rows.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return torch.clamp(torch.round(rows / scale), -7, 7) * scale
