"""A call's work, counted on meta tensors: the counterpart of
``repro/analysis/hlo_cost.py`` (``analyze`` :190).

The reference walks XLA's optimized HLO with the loops' trip counts.
Torch has no HLO, so :func:`count` runs one call on ``meta`` arguments
(nothing is allocated on a device, nothing is computed) under a
``TorchDispatchMode`` that sees every aten op, the backward's included,
and a ``kernels.meta.WorkCounter`` that collects what the kernel twins
declare. The counts differ from the reference's:

* **FLOPs** are the matrix-class aten ops (``mm``, ``bmm``, ``addmm``,
  convolutions, ...: the formulas of ``torch.utils.flop_counter``'s
  registry, 2 per multiply-add like the reference's 2·out·contracted of a
  dot; an op outside the registry is decomposed as ``FlopCounterMode``
  does) plus each kernel's declared ``work()``. Elementwise ops add
  none, as in the reference.
* **Bytes** are each aten op's tensor inputs plus its outputs, each
  once; views and allocations move none, an in-place op's output is its
  input, and an op that only fills its output reads nothing. Without
  fusion that is an upper bound, where the reference counts at XLA's
  fusion boundaries. Kernels add their declared bytes.
* **Collectives** are not in the op stream: the port's model code runs
  on local blocks (``sharding.constrain`` is the identity).
  :func:`plan_collectives` derives them from a plan's spec trees with
  ``roofline.wire_bytes``: for a training cell each parameter's
  gradient reduction over the data-parallel axes (a reduce-scatter over
  the axes that shard it, an all-reduce over the others), and for every
  cell the all-gather of a parameter the data-parallel axes shard. The
  activations' collectives (tensor-parallel products, the dispatch's
  all-to-all, a sharded top-k's merge) are not counted, because the port
  runs no tensor-parallel forward.

:func:`count` is the whole call's work (every card's); :func:`per_card`
splits FLOPs and bytes evenly over a mesh's cards and adds the
collectives, which are per card already; :func:`analyze` is the two
together, the reference's ``{"flops", "bytes", "coll"}``.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline as rl
from repro_torch.kernels import meta as kmeta

_aten = torch.ops.aten
# queries of a tensor's metadata: no work
_METADATA = {_aten.is_contiguous.default, _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default, _aten.size.default,
             _aten.sym_size.default, _aten.stride.default,
             _aten.sym_stride.default, _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}
# allocations and aliases: no traffic
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "resize_", "set_"}
# fills and generators: they write their output and read nothing
_WRITE_ONLY = {"full", "zeros", "ones", "arange", "scalar_tensor",
               "zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "fill_", "zero_", "rand", "randn",
               "randint", "rand_like", "randn_like", "randint_like",
               "normal_", "uniform_", "bernoulli_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_leaves(tree):
    """Every tensor of a tree of dicts, lists and tuples."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _OpCounter(TorchDispatchMode):
    """Every aten op's FLOPs (the registry's formulas) and bytes."""

    def __init__(self, by_op: bool):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op = (collections.defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0}) if by_op else None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        outs = tensor_leaves(out)
        if func.is_view or name in _NO_TRAFFIC or not outs:
            nbytes = 0
        elif name in _WRITE_ONLY:
            nbytes = sum(_nbytes(t) for t in outs)
        else:
            ins = {id(t): t for t in tensor_leaves((args, kwargs))}
            nbytes = (sum(_nbytes(t) for t in ins.values())
                      + sum(_nbytes(t) for t in outs if id(t) not in ins))
        self.flops += flops
        self.bytes += nbytes
        if self.by_op is not None:
            r = self.by_op[name]
            r["calls"] += 1
            r["flops"] += flops
            r["bytes"] += nbytes
        return out


def count(fn: Callable, *args, by_op: bool = False,
          return_output: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once on meta tensors and count its work
    → ``{"flops", "bytes", "kernels": {name: {"launches", "flops",
    "bytes"}}}``, the aten ops' and the kernels' together; with ``by_op``
    also ``"by_op"``, ``{aten op or twin::kernel: {"calls", "flops",
    "bytes"}}``; with ``return_output`` the pair ``(work, fn's output)``.
    Nothing may reach a real device: a tensor that is not on ``meta``
    raises."""
    for t in tensor_leaves((args, kwargs)):
        if t.device.type != "meta":
            raise ValueError(f"op_cost.count runs on meta tensors, got one "
                             f"on {t.device}")
    with kmeta.WorkCounter() as wc, _OpCounter(by_op) as ops:
        result = fn(*args, **kwargs)
    out = {"flops": ops.flops + wc.flops, "bytes": ops.bytes + wc.bytes,
           "kernels": wc.by_kernel}
    if by_op:
        table = dict(ops.by_op)
        for name, r in wc.by_kernel.items():
            table[kmeta.RANGE_PREFIX + name] = {
                "calls": r["launches"], "flops": r["flops"],
                "bytes": r["bytes"]}
        out["by_op"] = table
    return (out, result) if return_output else out


# ---------------------------------------------------------------------------
# The plan's spec trees: arguments' bytes per card and the collectives
# ---------------------------------------------------------------------------


def ref_layout(arg, params):
    """A plan argument in the layout its spec tree describes (the
    reference's): a model through ``convert.param_tree``, an optimizer
    state's per-parameter lists likewise, a per-layer KV cache through
    ``convert.cache_to_tree``; anything else as it is."""
    from repro_torch import convert
    from repro_torch.launch.steps import param_leaves
    if isinstance(arg, torch.nn.Module):
        return convert.param_tree(arg)
    if isinstance(arg, dict) and "step" in arg:
        index = {id(p): i for i, p in enumerate(param_leaves(params))}
        return {k: (v if k == "step" else convert.param_tree(
            params, leaf=lambda p, v=v: v[index[id(p)]]))
            for k, v in arg.items()}
    if isinstance(arg, list) and arg and isinstance(arg[0], dict) \
            and set(arg[0]) == {"k", "v"}:
        return convert.cache_to_tree(arg, params.cfg)
    return arg


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_leaves(tree, specs):
    """``[(tensor, spec or None)]`` of a tree and its spec tree (dicts and
    lists of specs; a spec is a tuple, and ``None`` or a missing branch
    leaves the tensors beneath it replicated)."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(specs, dict) and isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in spec_leaves(v, specs.get(k))]
    if isinstance(specs, list) and isinstance(tree, (list, tuple)):
        return [x for v, s in zip(tree, specs) for x in spec_leaves(v, s)]
    return [(t, None) for t in tensor_leaves(tree)]


def shard_bytes(t: torch.Tensor, spec, sizes: Dict[str, int]) -> float:
    """Bytes of one card's block of ``t`` under ``spec``."""
    n = 1
    for entry in spec or ():
        for ax in _axes(entry):
            n *= sizes.get(ax, 1)
    return _nbytes(t) / n


def argument_bytes(plan, mesh) -> float:
    """Bytes of every argument a card holds: each tensor's bytes over the
    sizes of the mesh axes its spec names."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    params = plan.args[0] if plan.args else None
    total = 0.0
    for arg, sp in zip(plan.args, plan.in_shardings):
        for t, s in spec_leaves(ref_layout(arg, params), sp):
            total += shard_bytes(t, s, sizes)
    return total


def output_bytes(out, plan, mesh) -> float:
    """Bytes of the outputs a card holds: through ``out_shardings`` where
    the plan gives them, whole (replicated) elsewhere, an upper bound."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    params = plan.args[0] if plan.args else None
    outs = out if isinstance(out, tuple) else (out,)
    specs = plan.out_shardings
    if not (isinstance(specs, tuple) and len(specs) == len(outs)):
        specs = (None,) * len(outs)
    total = 0.0
    for o, sp in zip(outs, specs):
        for t, s in spec_leaves(ref_layout(o, params), sp):
            total += shard_bytes(t, s, sizes)
    return total


def is_training(plan) -> bool:
    """A training cell's plan: ``(params, optimizer state, batch)``."""
    return (len(plan.args) == 3 and isinstance(plan.args[1], dict)
            and "step" in plan.args[1])


def plan_collectives(plan, mesh) -> Dict[str, float]:
    """Wire bytes per card of the parameters' collectives (module
    docstring) from the plan's parameter specs (``args[0]`` and its
    ``in_shardings``), split within and beyond a node
    (``roofline.collectives``)."""
    from repro_torch.launch.mesh import axis_names, axis_sizes
    sizes = axis_sizes(mesh)
    dp = [n for n in axis_names(mesh) if n in ("pod", "data")]
    items = []
    if plan.args:
        train = is_training(plan)
        tree = ref_layout(plan.args[0], plan.args[0])
        for t, sp in spec_leaves(tree, plan.in_shardings[0]):
            named = {ax for entry in (sp or ()) for ax in _axes(entry)}
            n_s = n_r = 1
            for ax in dp:
                if ax in named:
                    n_s *= sizes[ax]
                else:
                    n_r *= sizes[ax]
            shard = shard_bytes(t, sp, sizes)
            if n_s > 1:
                items.append(("all-gather", shard * n_s, n_s))
                if train:
                    items.append(("reduce-scatter", shard, n_s))
            if train and n_r > 1:
                items.append(("all-reduce", shard, n_r))
    return rl.collectives(items)


def per_card(work: dict, plan, mesh) -> dict:
    """:func:`count`'s whole-call ``work`` on ``mesh``: FLOPs and bytes
    split evenly over its cards, the collectives per card →
    ``{"flops", "bytes", "coll"}``."""
    from repro_torch.launch.mesh import mesh_chips
    chips = mesh_chips(mesh)
    return {"flops": work["flops"] / chips, "bytes": work["bytes"] / chips,
            "coll": plan_collectives(plan, mesh)}


def analyze(plan, mesh, *, by_op: bool = False) -> dict:
    """One call of ``plan.fn`` on its meta args → per card ``{"flops",
    "bytes", "coll"}`` (the reference's ``analyze``), plus the whole
    call's ``"by_op"`` table when asked."""
    work = count(plan.fn, *plan.args, by_op=by_op)
    out = per_card(work, plan, mesh)
    if by_op:
        out["by_op"] = work["by_op"]
    return out


def top(table: Dict[str, dict], key: str, n: Optional[int] = 20):
    """The ``n`` rows of a ``by_op`` table with the most ``key``."""
    rows = sorted(table.items(), key=lambda kv: -kv[1][key])
    return rows[:n] if n else rows
