"""Token-choice top-k MoE with sort-based (gather / scatter) dispatch
(reference: ``repro.models.moe``).

Per routing group, as the reference computes it:

  1. the router (f32 product and softmax) → top-k expert ids and their
     renormalised weights, ``(G, T, k)``;
  2. a stable sort of the ``T·k`` assignments by expert id;
  3. each assignment's position within its expert's run (the cummax of
     the run starts) → the capacity mask ``pos < C``;
  4. the token of each kept assignment written into an ``(E·C + 1)``
     slot table (slot ``E·C`` takes every dropped assignment and is cut
     off), the pad row ``T`` in every empty slot;
  5. the gather of the slots' activations, three batched products per
     expert (SwiGLU), each scaled by its router weight;
  6. the weighted sum back to the tokens (``index_add_``).

Groups are the sequences for train / prefill (S > 1) and the whole batch
for decode (S == 1): ``C = capacity(T_g)`` stays small, so drops stay
rare. ``aux`` holds the Switch load-balance loss, the router z-loss and
the share of assignments dropped. The gather and scatter are plain torch
on every device (the reference computes them in jnp, outside any Pallas
kernel); the products are matmuls in the activations' dtype with the
expert weights cast on every call, as the reference's
``params["w1"].astype(xin.dtype)``. The slots are laid out expert-major
(E, G·C) so the products are one ``bmm`` each with no copy of the
dispatch buffer; the values are the reference's (G, E, C) ones.

The reference's expert-parallel ``shard_map`` path (``moe.py:175``) is
reached only through the training mesh's rules and is not ported
(ROADMAP Queue A 12.6): ``moe_apply`` takes no mesh.

:func:`moe_dense_plain` is the oracle (every token through its top-k
experts, no capacity; ``tests/test_moe.py``'s ``_dense_moe_ref``); no
serving path calls it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.models import layers


class MoE(nn.Module):
    """The MoE's parameters: ``router (d, E)`` float32 whatever the
    param dtype (the reference's ``moe_init``), ``w1`` / ``w3`` ``(E, d,
    f)`` and ``w2`` ``(E, f, d)``. The spec (``cfg.moe``) is passed to
    :func:`moe_apply`, so one set of weights serves a config and its
    twin with another capacity factor."""

    def __init__(self, router: torch.Tensor, w1: torch.Tensor,
                 w3: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w1 = nn.Parameter(w1)
        self.w3 = nn.Parameter(w3)
        self.w2 = nn.Parameter(w2)


def _normal_into(generator: torch.Generator, shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """``N(0, 1) · scale`` of ``shape`` in ``dtype``, drawn in float32 one
    slice of the leading axis at a time: a kimi layer's expert stack is
    5.6G elements, whose float32 draw whole would be a 22.5 GB
    transient."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        out[i] = layers.normal(generator, shape[1:], scale)
    return out


def moe_init(generator: torch.Generator, d_model: int, spec, *,
             dtype: torch.dtype = torch.float32) -> MoE:
    """A fresh :class:`MoE` at the reference's scales: the router
    ``N(0, 1/d)`` in float32, ``w1`` / ``w3`` ``N(0, 1/d)`` and ``w2``
    ``N(0, 1/f)`` in ``dtype``, drawn in that order on the generator's
    device."""
    e, f = spec.n_experts, spec.d_ff_expert
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(f)
    router = layers.normal(generator, (d_model, e), s_in)
    w1 = _normal_into(generator, (e, d_model, f), s_in, dtype)
    w3 = _normal_into(generator, (e, d_model, f), s_in, dtype)
    w2 = _normal_into(generator, (e, f, d_model), s_out, dtype)
    return MoE(router, w1, w3, w2)


def capacity(tokens_per_group: int, spec) -> int:
    """Slots per expert and group: ``ceil(T·k / E · cf)`` rounded up to a
    multiple of 8, at least 8 (the reference's float expression)."""
    c = math.ceil(tokens_per_group * spec.top_k / spec.n_experts
                  * spec.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _positions_in_expert(sorted_ids: torch.Tensor) -> torch.Tensor:
    """``sorted_ids (G, N)``, the expert id of each sorted slot → each
    slot's position within its expert's run."""
    n = sorted_ids.shape[-1]
    ar = torch.arange(n, device=sorted_ids.device)[None, :]
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    return ar - run_start


def route(router: torch.Tensor, x: torch.Tensor, spec):
    """``x (G, T, d)`` → ``(expert ids (G, T, k), weights (G, T, k),
    aux)``: the router's product and softmax in float32, the top-k
    renormalised; ``aux`` the load-balance loss ``E · Σ_e frac_e ·
    mean_p_e`` (frac: the share of tokens whose top-1 is e) and the
    z-loss ``mean(logsumexp(logits)²)``."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, spec.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e = spec.n_experts
    frac = nn.functional.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    mean_p = probs.mean(dim=(0, 1))
    lb_loss = e * torch.sum(frac * mean_p)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_i, top_p, {"lb_loss": lb_loss, "z_loss": z_loss}


def moe_apply(moe: MoE, x: torch.Tensor, spec
              ) -> Tuple[torch.Tensor, dict]:
    """``x (B, S, d)`` → ``(out (B, S, d) in x's dtype, aux)``: the
    capacity-limited dispatch of the module docstring. With S > 1 each
    sequence is its own routing group; with S == 1 (decode) the whole
    batch is one group. ``aux`` adds ``drop_fraction``, the share of the
    T·k assignments past their expert's capacity."""
    b, s, d = x.shape
    xg = x if s > 1 else x.reshape(1, b, d)
    g, t, _ = xg.shape
    k, e = spec.top_k, spec.n_experts
    c = capacity(t, spec)
    dev = x.device

    top_i, top_p, aux = route(moe.router, xg, spec)             # (G, T, k)
    flat_ids = top_i.reshape(g, t * k)
    sorted_ids, sort_idx = torch.sort(flat_ids, dim=-1, stable=True)
    pos = _positions_in_expert(sorted_ids)
    keep = pos < c
    slot = torch.where(keep, sorted_ids * c + pos, e * c)       # (G, N)
    token_of_sorted = sort_idx // k
    # the slot tables; the overflow slot E·C takes every dropped one
    table = torch.full((g, e * c + 1), t, dtype=torch.long, device=dev)
    table.scatter_(1, slot, token_of_sorted)
    w_sorted = torch.gather(top_p.reshape(g, t * k), 1, sort_idx)
    w_table = torch.zeros((g, e * c + 1), dtype=torch.float32,
                          device=dev).scatter(1, slot, w_sorted)
    # expert-major rows of the flattened (G·(T+1), d) activations; row T
    # of each group is the zero pad row
    rows = table[:, :e * c] + torch.arange(g, device=dev)[:, None] * (t + 1)
    rows = rows.reshape(g, e, c).transpose(0, 1).reshape(-1)    # (E·G·C,)
    w_rows = w_table[:, :e * c].reshape(g, e, c).transpose(0, 1)

    xpad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xin = xpad.reshape(g * (t + 1), d).index_select(0, rows)
    xin = xin.reshape(e, g * c, d)
    h = torch.bmm(xin, moe.w1.to(xin.dtype))
    u = torch.bmm(xin, moe.w3.to(xin.dtype))
    del xin
    h = layers.silu(h) * u
    del u
    out_e = torch.bmm(h, moe.w2.to(h.dtype))
    del h
    out_e = out_e * w_rows.reshape(e, g * c, 1).to(out_e.dtype)

    flat_out = torch.zeros((g * (t + 1), d), dtype=out_e.dtype,
                           device=dev).index_add(0, rows,
                                                 out_e.reshape(-1, d))
    out = flat_out.reshape(g, t + 1, d)[:, :t].reshape(b, s, d)
    aux["drop_fraction"] = 1.0 - keep.float().mean()
    return out.to(x.dtype), aux


def moe_dense_plain(moe: MoE, x: torch.Tensor, spec) -> torch.Tensor:
    """The oracle: every token through its top-k experts, no capacity
    (``tests/test_moe.py``'s ``_dense_moe_ref``): float32 routing, each
    expert's SwiGLU over every token in x's dtype, summed with the
    renormalised top-k weights in float32 → ``(B, S, d)`` float32."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.float() @ moe.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, spec.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(spec.n_experts):
        h = (layers.silu(xf @ moe.w1[e].to(xf.dtype))
             * (xf @ moe.w3[e].to(xf.dtype)))
        y = h @ moe.w2[e].to(h.dtype)
        w = torch.where(top_i == e, top_p, 0.0).sum(-1)
        out = out + w[:, None] * y
    return out.reshape(b, s, d)
