"""AdamW, Adafactor and global-norm clipping over lists of tensors
(reference: ``repro.optim.optimizers``).

``adamw_update`` and ``adafactor_update`` write the new values into the
parameters themselves (under ``torch.no_grad``) and into the state's
tensors; the arithmetic is the reference's, in float32, the new value
cast back to each parameter's dtype. AdamW runs one multi-tensor op per
step of its formula, Adafactor one leaf at a time (its factored
reductions differ by shape)."""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

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
                 weight_decay: float = 0.1,
                 decay: Optional[Sequence[bool]] = None) -> dict:
    """One AdamW step: ``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g²``,
    bias corrections ``1 − b^t`` in float32, ``p −= lr·(m̂/(√v̂ + eps) +
    wd·p)`` with the decay on the parameters ``decay`` marks (default:
    those of ``ndim ≥ 2``, the reference's rule on its own leaves). Updates
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
    decay = [i for i, p in enumerate(params)
             if (p.ndim >= 2 if decay is None else decay[i])]
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


# Adafactor's constants (the reference's defaults): β2 = 1 − t^−DECAY_POW,
# the floor EPS under the second moment, the RMS clip of the update
ADAFACTOR_DECAY_POW = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Sequence[torch.Tensor]) -> dict:
    """``{"step": 0, "v": [...]}``: per parameter float32 zeros, factored
    (``{"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}``) when its last
    two axes both exceed 1, else ``{"v": shape}``. No first moment."""
    def leaf(p):
        z = functools.partial(torch.zeros, dtype=torch.float32,
                              device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}
    return {"step": 0, "v": [leaf(p) for p in params]}


def _adafactor_u(p, g, v: dict, beta2: float, rest: float, *,
                 update: bool) -> torch.Tensor:
    """Adafactor's unclipped step ``u = g / √(v + eps)`` of one leaf,
    with its second moment first moved to this step when ``update``."""
    eps = ADAFACTOR_EPS
    g32 = g.float()
    if _factored(p.shape):
        if update:
            g2 = torch.square(g32) + eps
            v["vr"] = beta2 * v["vr"] + rest * g2.mean(dim=-1)
            v["vc"] = beta2 * v["vc"] + rest * g2.mean(dim=-2)
            del g2
        vr, vc = v["vr"], v["vc"]
        r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
        return g32 * torch.rsqrt(r[..., None] * vc[..., None, :] + eps)
    if update:
        v["v"] = beta2 * v["v"] + rest * (torch.square(g32) + eps)
    return g32 * torch.rsqrt(v["v"] + eps)


@torch.no_grad()
def adafactor_update(grads: Sequence[torch.Tensor], state: dict,
                     params: Sequence[torch.Tensor], lr: float, *,
                     weight_decay: float = 0.0,
                     groups: Optional[Sequence] = None) -> dict:
    """One Adafactor step (β1 = 0): ``β2 = 1 − t^−ADAFACTOR_DECAY_POW``
    in float32; the second moment of ``g² + eps`` kept as row and column
    means for a factored leaf (its rank-1 reconstruction ``vr / mean(vr)
    ⊗ vc``), whole otherwise; ``u = g / √(v + eps)`` clipped to an RMS of
    at most ``ADAFACTOR_CLIP``; ``p −= lr·(u + wd·p)``, the decay on
    ``ndim ≥ 2`` only, computed in float32 and cast back to p's dtype.
    ``groups`` (one key per parameter; default each its own) joins the
    parameters whose RMS is taken together, as the reference takes it over
    a leaf that stacks several layers: a group's ``u`` is computed, its
    squares summed, and computed again to be applied. Updates ``params``
    and ``state`` in place; returns ``state``."""
    step = state["step"] + 1
    b2 = np.float32(1.0) - np.power(np.float32(step),
                                    np.float32(-ADAFACTOR_DECAY_POW))
    beta2, rest = float(b2), float(np.float32(1.0) - b2)
    members = {}
    for i, key in enumerate(range(len(params)) if groups is None
                            else groups):
        members.setdefault(key, []).append(i)

    def apply(i, u, rms):
        p = params[i]
        u = u / torch.clamp(rms / ADAFACTOR_CLIP, min=1.0)
        if weight_decay and p.ndim >= 2:
            u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)

    for idx in members.values():
        if len(idx) == 1:
            i = idx[0]
            u = _adafactor_u(params[i], grads[i], state["v"][i], beta2, rest,
                             update=True)
            apply(i, u, torch.sqrt(torch.mean(torch.square(u)) + 1e-12))
            continue
        total, n = 0.0, 0
        for i in idx:
            u = _adafactor_u(params[i], grads[i], state["v"][i], beta2, rest,
                             update=True)
            total = total + torch.sum(torch.square(u))
            n += u.numel()
        rms = torch.sqrt(total / n + 1e-12)
        for i in idx:
            apply(i, _adafactor_u(params[i], grads[i], state["v"][i], beta2,
                                  rest, update=False), rms)
    state["step"] = step
    return state


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    """``(init_fn(params), update_fn(grads, state, params, lr))`` of
    ``"adamw"`` or ``"adafactor"``, ``kw`` bound into the update."""
    if name == "adamw":
        return adamw_init, functools.partial(adamw_update, **kw)
    if name == "adafactor":
        return adafactor_init, functools.partial(adafactor_update, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
