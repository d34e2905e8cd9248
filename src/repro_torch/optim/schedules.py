"""Learning-rate schedules as ``step -> lr`` functions of an int step
(reference: ``repro.optim.schedules``), evaluated in float32 as the
reference evaluates them; the result is a Python float."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant_lr(lr: float):
    return lambda step: float(_F(lr))


def cosine_schedule(base_lr: float, total_steps: int, *, final_frac=0.1):
    def fn(step):
        t = np.clip(_F(step) / _F(max(total_steps, 1)), _F(0), _F(1))
        cos = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t))
        return float(_F(base_lr) * (_F(final_frac) + _F(1 - final_frac) * cos))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         *, final_frac=0.1):
    """Linear from 0 (at step 0) to ``base_lr`` over ``warmup`` steps, then
    :func:`cosine_schedule` over the rest."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1),
                          final_frac=final_frac)

    def fn(step):
        s = _F(step)
        if s < warmup:
            return float(_F(base_lr) * s / _F(max(warmup, 1)))
        return cos(step - warmup)
    return fn


def linear_warmup_linear_decay(base_lr: float, warmup: int, total_steps: int):
    def fn(step):
        s = _F(step)
        if s < warmup:
            return float(_F(base_lr) * s / _F(max(warmup, 1)))
        frac = _F(1) - (s - _F(warmup)) / _F(max(total_steps - warmup, 1))
        return float(_F(base_lr) * np.clip(frac, _F(0), _F(1)))
    return fn
