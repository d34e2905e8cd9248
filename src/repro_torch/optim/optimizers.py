"""AdamW and global-norm clipping over lists of tensors (reference:
``repro.optim.optimizers``).

``adamw_update`` writes the new values into the parameters themselves
(under ``torch.no_grad``) and into the state's moment tensors; the
arithmetic is the reference's, in float32, one multi-tensor op per step
of the formula."""
from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ Σ x²)`` over every element of ``tensors``, in float32: a
    0-d tensor on their device."""
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` by ``min(1, max_norm / max(g, 1e-9))``, ``g`` their
    global norm (the reference's floor, not ``clip_grad_norm_``'s).
    Returns ``(scaled grads (new tensors, each in its own dtype), g)``."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return [(x * scale).to(x.dtype) for x in grads], g


def adamw_init(params: Sequence[torch.Tensor]) -> dict:
    """``{"step": 0, "m": [...], "v": [...]}``, moments float32 zeros
    beside each parameter."""
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    return {"step": 0, "m": zeros, "v": [z.clone() for z in zeros]}


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: dict,
                 params: Sequence[torch.Tensor], lr: float, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> dict:
    """One AdamW step: ``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g²``,
    bias corrections ``1 − b^t`` in float32, ``p −= lr·(m̂/(√v̂ + eps) +
    wd·p)`` with the decay on tensors of ``ndim ≥ 2`` only. Updates
    ``params`` and ``state`` in place; returns ``state``."""
    step = state["step"] + 1
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
    c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
    g32 = [g.float() for g in grads]
    m, v = state["m"], state["v"]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g32, 1.0 - b1))
    torch._foreach_mul_(v, b2)
    g2 = torch._foreach_mul(g32, g32)
    del g32
    torch._foreach_mul_(g2, 1.0 - b2)
    torch._foreach_add_(v, g2)
    del g2
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_div(m, c1)
    torch._foreach_div_(delta, denom)
    del denom
    decay = [i for i, p in enumerate(params) if p.ndim >= 2]
    if decay:
        torch._foreach_add_([delta[i] for i in decay], torch._foreach_mul(
            [params[i].float() for i in decay], weight_decay))
    torch._foreach_mul_(delta, lr)
    if all(p.dtype == torch.float32 for p in params):
        torch._foreach_sub_(list(params), delta)
    else:
        for p, dl in zip(params, delta):
            p.copy_(p.float() - dl)
    state["step"] = step
    return state


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    """``(init_fn(params), update_fn(grads, state, params, lr))``. Only
    ``"adamw"`` is ported: Adafactor serves the substrate's kimi config,
    which waits in ROADMAP Queue A 12."""
    if name == "adamw":
        return adamw_init, functools.partial(adamw_update, **kw)
    if name == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported: it serves only the substrate's kimi "
            "config (ROADMAP Queue A 12)")
    raise ValueError(f"unknown optimizer {name!r}")
