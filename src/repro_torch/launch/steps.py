"""Single-device step builders of the trainer (reference:
``repro.launch.steps``): ``pad_up``, ``_train_step`` and
``_chunked_item_topk``, with the gradient accumulation that
``launch.train`` shares with ``_train_step``.

A model's parameters are what its loss takes: an ``nn.Module`` (the LMs,
GatedGCN) or a nested dict of tensors (the recsys models). Its trainable
leaves are :func:`param_leaves`; gradients come from
``torch.autograd.grad`` over them, so on the card they flow through the
flash and dot twins' backward kernels (``FlashAttentionFn``,
``DotInteractionFn``). The optimizer updates the leaves in place.

The reference's ``plan_*`` cell plans, ``CellPlan`` and mesh helpers
lower to XLA for a TPU mesh; their torch counterpart waits for the
sharded trainer (ROADMAP A 12.6b).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch
from torch import nn

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.optim import clip_by_global_norm, make_optimizer


def pad_up(x: int, m: int) -> int:
    return -(-x // m) * m


def param_leaves(params) -> List[torch.Tensor]:
    """The trainable tensors of ``params``: a module's parameters in its
    own order, or a nested dict's leaves in jax ``tree_flatten`` order."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return tree_leaves(params)


def _stacked(params) -> dict:
    """``{id(leaf): key}`` for the leaves the reference stacks: an LM's
    blocks by its scan (``periods``, all layers of the periods in one leaf
    a name, then ``rem``), a GNN's layers (``blocks``)."""
    keys = {}
    if not isinstance(params, nn.Module):
        return keys
    blocks = getattr(params, "blocks", None)
    if isinstance(blocks, nn.ModuleList):
        from repro_torch.models.transformer import scan_structure
        n, period, _ = scan_structure(params.cfg)
        for i, blk in enumerate(blocks):
            part = "periods" if i < n * len(period) else "rem"
            for name, p in blk.named_parameters():
                keys[id(p)] = (part, name)
    layers = getattr(params, "layers", None)
    if isinstance(layers, nn.ModuleList):
        for layer in layers:
            for name, p in layer.named_parameters():
                keys[id(p)] = ("blocks", name)
    return keys


def decay_mask(params) -> List[bool]:
    """Which :func:`param_leaves` AdamW decays, as the reference decides:
    a leaf of ``ndim ≥ 2`` in the reference's layout, where every leaf of
    a stacked LM block or GNN layer counts, its 1-D norm scales and biases
    too."""
    stacked = _stacked(params)
    return [p.ndim >= 2 or id(p) in stacked for p in param_leaves(params)]


def rms_groups(params) -> list:
    """One key per :func:`param_leaves` leaf: the reference's stacked leaf
    it belongs to, over which Adafactor takes its update's RMS, or its own
    index. (The port factors a leaf's second moment by the layer's own
    shape; the reference's stacked shape differs only for a 1-D leaf of a
    scan period longer than one layer, which no Adafactor config has.)"""
    stacked = _stacked(params)
    return [stacked.get(id(p), i) for i, p in enumerate(param_leaves(params))]


def make_update(optimizer: str, params) -> Callable:
    """``make_optimizer(optimizer)``'s update on ``params``' leaves as the
    reference lays them out: AdamW's weight decay on :func:`decay_mask`,
    Adafactor's RMS over :func:`rms_groups`."""
    _, update = make_optimizer(optimizer)
    if optimizer == "adamw":
        kw = {"decay": decay_mask(params)}
    else:
        kw = {"groups": rms_groups(params)}
    return lambda grads, state, leaves, lr: update(grads, state, leaves, lr,
                                                   **kw)


class StepSplit:
    """Marks the phases of a step: CUDA events on the card (read once the
    step has synchronised), the host clock on the CPU. :meth:`split` sums
    the time before each mark under the mark's name."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def split(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def split_batch(batch: dict, n: int) -> List[dict]:
    """``n`` microbatches: every tensor of ``batch`` with a leading axis
    reshaped to ``(n, -1, ...)`` and sliced, as the reference reshapes its
    batch; scalars (a graph batch's ``n_graphs``) are kept."""
    split = {k: (v.reshape((n, -1) + tuple(v.shape[1:]))
                 if isinstance(v, torch.Tensor) and v.dim() else v)
             for k, v in batch.items()}
    return [{k: (v[i] if isinstance(v, torch.Tensor) and v.dim() else v)
             for k, v in split.items()} for i in range(n)]


def _detach(metrics: dict) -> dict:
    return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in metrics.items()}


def loss_and_grads(loss_fn: Callable, params, batch: dict, *,
                   microbatch: int = 1, timer: Optional[StepSplit] = None):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``, one gradient per :func:`param_leaves` leaf (zeros for a
    leaf the loss does not reach; a leaf that does not require a gradient
    is switched to require one). With ``microbatch > 1`` the batch is
    split (:func:`split_batch`) and, as the reference accumulates: the
    gradients summed in f32 and divided by ``microbatch``, the loss the
    mean, the metrics the last microbatch's. ``timer`` is marked after
    each forward (``"forward"``) and backward (``"backward"``)."""
    leaves = param_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    mbs = [batch] if microbatch == 1 else split_batch(batch, microbatch)
    acc, loss_sum, metrics = None, None, {}
    for mb in mbs:
        loss, metrics = loss_fn(params, mb)
        if timer:
            timer.mark("forward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if microbatch == 1:
            acc, loss_sum = grads, loss.detach()
        elif acc is None:
            acc, loss_sum = [g.float() for g in grads], loss.detach().float()
        else:
            torch._foreach_add_(acc, [g.float() for g in grads])
            loss_sum = loss_sum + loss.detach().float()
        del grads, loss
        if timer:
            timer.mark("backward")
    if microbatch > 1:
        torch._foreach_div_(acc, float(microbatch))
        loss_sum = loss_sum / microbatch
    return loss_sum, _detach(metrics), acc


def _train_step(loss_fn: Callable, cfg, *, lr: float = 3e-4,
                clip: float = 1.0):
    """``(step, opt_init)``: ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` runs the loss and its gradients, clips them to a
    global norm of ``clip`` and applies ``make_optimizer(cfg.optimizer)``'s
    update in place; ``metrics`` gains ``grad_norm``. ``opt_init(params)``
    is the optimizer's state over :func:`param_leaves`. The update treats
    the leaves as the reference's stacked layout does (:func:`make_update`)."""
    opt_init, _ = make_optimizer(cfg.optimizer)

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        make_update(cfg.optimizer, params)(grads, opt_state,
                                           param_leaves(params), lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step, lambda params: opt_init(param_leaves(params))


def _chunked_item_topk(score_chunk: Callable, n_items: int, chunk: int,
                       k: int, batch: int):
    """Running top-k over item chunks (keeps the ``(B, V)`` logits
    virtual): ``score_chunk(ci) -> (B, chunk)`` scores of items ``ci·chunk
    ..``; returns ``(values (B, k) f32, ids (B, k) int32)``. Equal scores
    keep the earlier entry of ``[best so far, chunk]``, as
    ``jax.lax.top_k`` does."""
    n_chunks = n_items // chunk
    best_v = best_i = None
    for ci in range(n_chunks):
        s = score_chunk(ci).float()
        if best_v is None:
            best_v = torch.full((batch, k), -torch.inf, dtype=torch.float32,
                                device=s.device)
            best_i = torch.full((batch, k), -1, dtype=torch.int32,
                                device=s.device)
        ids = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=s.device).expand_as(s)
        cat_v = torch.cat([best_v, s], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        order = torch.sort(cat_v, dim=1, descending=True,
                           stable=True).indices[:, :k]
        best_v = torch.gather(cat_v, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_v, best_i
