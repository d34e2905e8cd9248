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

**The expert-parallel path** (the reference's ``_moe_apply_shard_map``):
when the bound sharding rules (``distributed.sharding.axis_rules``) carry
a ``DeviceMesh`` with a "model" axis, :func:`moe_apply` runs as one rank
of that mesh, on the rank's blocks as the parameter specs place them: x
its block of the batch (split over the dp axes), the router whole, ``w1``
/ ``w3`` ``(E/n_ep, d/dp, f)`` and ``w2`` ``(E/n_ep, f, d/dp)``. The
expert weights are all-gathered over the dp axes, the routing and the
slot table are computed alike on every rank, each rank runs only its
``E/n_ep`` experts' slots, the outputs are summed over "model" and
``aux`` is averaged over dp. The collectives differentiate as the
reference's do under ``shard_map``: the sum over "model" hands its
cotangent to every rank unchanged (its output is replicated), and a
replicated input that meets rank-varying work (x and the routing weights
over "model", the router over dp) has its cotangent summed there, so each
rank's expert gradients are the local path's gradients of its experts.
When E does not divide by "model" or d by the dp size, the reference
returns to the local path, and so does the port (x is the rank's block
already, so its batch always divides).

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
    if out.is_meta:                    # the shape path draws nothing
        return out
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
    T·k assignments past their expert's capacity. Under bound rules whose
    mesh has a "model" axis, the expert-parallel path."""
    from repro_torch.distributed.sharding import current_rules
    from repro_torch.launch.mesh import axis_names
    rules = current_rules()
    mesh = rules.get("_mesh") if rules else None
    if mesh is not None and "model" in axis_names(mesh):
        return _moe_apply_expert_parallel(moe, x, spec, mesh)
    return _moe_apply_local(moe, x, spec)


def _groups(x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    return x if s > 1 else x.reshape(1, b, d)


def _slot_tables(router, xg, spec):
    """Routing and the slot tables of groups ``xg (G, T, d)``: ``(table
    (G, E·C) token per slot, T in an empty one; w_table (G, E·C) float32
    router weight per slot; keep (G, T·k); aux; C)``. The overflow slot
    E·C takes every dropped assignment and is cut off."""
    g, t, _ = xg.shape
    k, e = spec.top_k, spec.n_experts
    c = capacity(t, spec)
    dev = xg.device
    top_i, top_p, aux = route(router, xg, spec)                 # (G, T, k)
    flat_ids = top_i.reshape(g, t * k)
    sorted_ids, sort_idx = torch.sort(flat_ids, dim=-1, stable=True)
    pos = _positions_in_expert(sorted_ids)
    keep = pos < c
    slot = torch.where(keep, sorted_ids * c + pos, e * c)       # (G, N)
    token_of_sorted = sort_idx // k
    table = torch.full((g, e * c + 1), t, dtype=torch.long, device=dev)
    table.scatter_(1, slot, token_of_sorted)
    w_sorted = torch.gather(top_p.reshape(g, t * k), 1, sort_idx)
    w_table = torch.zeros((g, e * c + 1), dtype=torch.float32,
                          device=dev).scatter(1, slot, w_sorted)
    return table[:, :e * c], w_table[:, :e * c], keep, aux, c


def _experts(xg, table, w_table, w1, w3, w2, c: int) -> torch.Tensor:
    """The experts ``w1 / w3 / w2`` (``n`` of them) over their slots of
    ``table`` / ``w_table`` ``(G, n·C)``: each slot's token through its
    expert's SwiGLU, scaled by its weight and summed back to the tokens →
    ``(G, T, d)`` in the products' dtype."""
    g, t, d = xg.shape
    n = w1.shape[0]
    dev = xg.device
    # expert-major rows of the flattened (G·(T+1), d) activations; row T
    # of each group is the zero pad row
    rows = table + torch.arange(g, device=dev)[:, None] * (t + 1)
    rows = rows.reshape(g, n, c).transpose(0, 1).reshape(-1)    # (n·G·C,)
    w_rows = w_table.reshape(g, n, c).transpose(0, 1)

    xpad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xin = xpad.reshape(g * (t + 1), d).index_select(0, rows)
    xin = xin.reshape(n, g * c, d)
    h = torch.bmm(xin, w1.to(xin.dtype))
    u = torch.bmm(xin, w3.to(xin.dtype))
    del xin
    h = layers.silu(h) * u
    del u
    out_e = torch.bmm(h, w2.to(h.dtype))
    del h
    out_e = out_e * w_rows.reshape(n, g * c, 1).to(out_e.dtype)

    flat_out = torch.zeros((g * (t + 1), d), dtype=out_e.dtype,
                           device=dev).index_add(0, rows,
                                                 out_e.reshape(-1, d))
    return flat_out.reshape(g, t + 1, d)[:, :t]


def _moe_apply_local(moe: MoE, x: torch.Tensor, spec
                     ) -> Tuple[torch.Tensor, dict]:
    """The single-device path: every expert on this device."""
    xg = _groups(x)
    table, w_table, keep, aux, c = _slot_tables(moe.router, xg, spec)
    out = _experts(xg, table, w_table, moe.w1, moe.w3, moe.w2, c)
    aux["drop_fraction"] = 1.0 - keep.float().mean()
    return out.reshape(x.shape).to(x.dtype), aux


class _SumToReplicated(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose result every rank holds
    alike: the cotangent, alike on every rank, passes back unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedToVarying(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds alike, fed
    to work that differs by rank: the cotangents are summed over
    ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` (rank order); the backward
    sums the cotangents over the group and keeps this rank's block (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(x) for _ in range(
            dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        world = dist.get_world_size(ctx.group)
        chunks = [c.contiguous() for c in g.chunk(world, dim=ctx.dim)]
        if dist.get_backend(ctx.group) == "nccl":
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=ctx.group)
        else:   # gloo has no reduce-scatter: sum all, keep this block
            full = g.contiguous().clone()
            dist.all_reduce(full, group=ctx.group)
            out = full.chunk(world, dim=ctx.dim)[
                dist.get_rank(ctx.group)].contiguous()
        return out, None, None


def _gather(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(w, dim, group)


def _moe_apply_expert_parallel(moe: MoE, x: torch.Tensor, spec, mesh
                               ) -> Tuple[torch.Tensor, dict]:
    """One rank of the expert-parallel path (module docstring) on
    ``mesh``, a ``DeviceMesh`` with a "model" axis."""
    from repro_torch.launch.mesh import axis_names, axis_sizes
    if not hasattr(mesh, "get_group"):
        raise TypeError("the expert-parallel MoE runs collectives: the "
                        "bound mesh must be a DeviceMesh, not "
                        f"{type(mesh).__name__}")
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    dp = tuple(n for n in names if n in ("pod", "data"))
    n_ep = sizes["model"]
    e = spec.n_experts
    d = x.shape[-1]
    dp_size = 1
    for n in dp:
        dp_size *= sizes[n]
    if e % n_ep or d % dp_size:
        return _moe_apply_local(moe, x, spec)
    ep_group = mesh.get_group("model")
    dp_group = None
    if len(dp) == 1:
        dp_group = mesh.get_group(dp[0])
    elif dp:
        dp_group = mesh[dp]._flatten().get_group()
    e_loc = e // n_ep

    w1, w3, w2 = moe.w1, moe.w3, moe.w2
    router = moe.router
    if dp_group is not None:
        w1, w3 = _gather(w1, 1, dp_group), _gather(w3, 1, dp_group)
        w2 = _gather(w2, 2, dp_group)
        router = _ReplicatedToVarying.apply(router, dp_group)
    if w1.shape[0] != e_loc or w1.shape[1] != d or w2.shape[2] != d:
        raise ValueError(
            f"expert-parallel MoE: rank blocks w1 {tuple(moe.w1.shape)}, "
            f"w2 {tuple(moe.w2.shape)} are not ({e_loc}, {d}/{dp_size}, f) "
            f"and ({e_loc}, f, {d}/{dp_size})")
    xg = _groups(x)
    g, t, _ = xg.shape
    table, w_table, keep, aux, c = _slot_tables(router, xg, spec)
    # this rank computes only ITS e_loc experts' slots
    lo = mesh.get_local_rank("model") * e_loc * c
    table_loc = table[:, lo:lo + e_loc * c]
    wt_loc = _ReplicatedToVarying.apply(w_table, ep_group)[
        :, lo:lo + e_loc * c]
    out = _experts(_ReplicatedToVarying.apply(xg, ep_group), table_loc,
                   wt_loc, w1, w3, w2, c)
    out = _SumToReplicated.apply(out, ep_group)
    aux["drop_fraction"] = 1.0 - keep.float().mean()
    if dp_group is not None:
        # aux is alike over "model" (from the replicated routing):
        # averaged over the dp axes only
        aux = {k: _SumToReplicated.apply(v, dp_group) / dp_size
               for k, v in aux.items()}
    return out.reshape(x.shape).to(x.dtype), aux


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
