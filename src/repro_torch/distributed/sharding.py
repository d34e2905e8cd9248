"""Logical→physical sharding rules and the cluster-axis sharding of the
packed cluster buffers (reference: ``repro.distributed.sharding``).

**The training half.** Models and plans name *logical* axes ("dp", "tp",
"cluster", "all"); :func:`axis_rules` binds them to a mesh's physical
axes (:func:`rules_for_mesh`):

  single-pod (16,16) ("data","model")        : dp=("data",)        tp=("model",)
  multi-pod  (2,16,16) ("pod","data","model"): dp=("pod","data")   tp=("model",)

A *spec* is a tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names (the dim split over several axes, the
first the major one), the content of the reference's ``PartitionSpec``
(a one-name tuple is written as the name, an empty one as ``None``, as
``PartitionSpec`` normalises them). :func:`param_specs` matches the rule
tables against the reference's parameter paths (``convert.param_tree``
gives a port model that layout, stacked layers and all);
:func:`leaf_specs` hands each port parameter its spec with the stacked
dims dropped; :func:`named_shardings` turns specs into DTensor placements
on a mesh (``Shard(d)`` on every mesh dim a tensor dim is split over);
:func:`opt_state_specs` gives the optimizer state's. Outside a binding
:func:`logical_spec` is ``None``; :func:`constrain` is a no-op, so model
code is mesh-agnostic.

**The cluster half.**

Mesh-sharded serving splits the resident cluster buffers along their
cluster axis: each shard holds whole clusters, and the query engine
scans each shard and merges the partial top-k lists on the host
(``engine.merge_shard_topk``).

The reference resolves which axis of each buffer splits through its
logical-axis rules and places the parts with ``NamedSharding``s. Torch
has no counterpart: every buffer key of :data:`CLUSTER_BUFFER_KEYS`
splits along its leading (cluster) axis, which is what those rules
resolve to, and each part is placed with ``.to(device)``.

A :class:`ClusterMesh` is the list of devices the parts go to, one per
shard. :func:`cluster_mesh` takes the first ``n`` cards of a CUDA host
(and raises when there are fewer), or ``n`` logical parts on the CPU.
Several logical shards on one card come only from an explicit device
list, ``ClusterMesh((cuda:0,) * n)``: nothing puts two shards on one card
unasked, and :attr:`ClusterShards.devices` records where each part is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.launch.mesh import axis_names, axis_sizes

# the axis name cluster buffers partition along
CLUSTER_AXIS = "cluster"

# the buffer keys that split across shards, each along its leading
# (cluster) axis, rows whole: emb (c, cap, d), loc (c, cap, 2), ids (c,
# cap), scale (c, cap), attrs (c, cap, 3), counts (c,)
CLUSTER_BUFFER_KEYS = ("emb", "loc", "ids", "scale", "attrs", "counts")

# the fill of an empty cluster per key: the padding of
# ``index.build_cluster_buffers``, so a sentinel or remainder row scores
# NEG_INF through the ids < 0 mask
PART_FILLS = {"emb": 0, "loc": index_lib.PAD_LOC, "ids": -1, "scale": 1,
              "attrs": 0, "counts": 0}

# clusters gathered per copy when a part is built: bounds the transient
# beside the part to 16 clusters' rows
_GATHER_CLUSTERS = 16


@dataclasses.dataclass(frozen=True)
class ClusterMesh:
    """A 1-D mesh along :data:`CLUSTER_AXIS`: the device of each shard."""
    devices: Tuple[torch.device, ...]
    axis_name: str = CLUSTER_AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("ClusterMesh: no devices")
        object.__setattr__(self, "devices", devs)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis_name,)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.n_shards}


def cluster_mesh(n_shards: int, *, device="cuda",
                 devices: Optional[Sequence] = None) -> ClusterMesh:
    """A :class:`ClusterMesh` of ``n_shards`` shards.

    ``devices`` (an explicit list of ``n_shards`` devices, repeats
    allowed) wins. Otherwise by ``device``'s type: ``cuda`` takes the
    first ``n_shards`` cards and raises when the host has fewer; ``cpu``
    makes ``n_shards`` logical CPU parts."""
    n_shards = int(n_shards)
    if devices is not None:
        if len(devices) != n_shards:
            raise ValueError(f"cluster_mesh: {len(devices)} devices given "
                             f"for n_shards={n_shards}")
        return ClusterMesh(tuple(devices))
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        if not 1 <= n_shards <= have:
            raise ValueError(
                f"cluster_mesh: n_shards={n_shards} needs 1..{have} "
                f"available devices (have {have} CUDA devices; several "
                f"logical shards on one card take an explicit device "
                f"list, cluster_mesh(n, devices=['cuda:0'] * n))")
        return ClusterMesh(tuple(torch.device("cuda", i)
                                 for i in range(n_shards)))
    if kind != "cpu":
        raise ValueError(f"cluster_mesh: unsupported device {device!r}")
    if n_shards < 1:
        raise ValueError(f"cluster_mesh: n_shards={n_shards} needs 1 or "
                         f"more devices")
    return ClusterMesh((torch.device("cpu"),) * n_shards)


def as_cluster_mesh(mesh, *, device="cuda") -> ClusterMesh:
    """``mesh`` as a :class:`ClusterMesh`: a shard count goes through
    :func:`cluster_mesh` on ``device``'s type."""
    if isinstance(mesh, (int, np.integer)):
        return cluster_mesh(int(mesh), device=device)
    if not isinstance(mesh, ClusterMesh) or mesh.axis_name != CLUSTER_AXIS:
        raise ValueError(
            f"shard_cluster_buffers: mesh {mesh!r} carries no "
            f"{CLUSTER_AXIS!r} axis; build one with cluster_mesh(n)")
    return mesh


@dataclasses.dataclass(frozen=True)
class ClusterShards:
    """The placement record of one mesh-sharded set of cluster buffers.

    n_shards   shard count
    c_global   real cluster count of the base buffers
    c_local    cluster rows per shard without the sentinel (the largest
               group; shorter shards pad with empty clusters)
    shard_of   (c_global,) int32: global cluster id → owning shard
    local_of   (c_global,) int32: global cluster id → local buffer row
    parts      per-shard dicts of buffer tensors (emb, loc, ids, scale,
               attrs, counts) of ``c_local + 1`` clusters each, on
               ``devices[s]``: row ``c_local`` is the SENTINEL empty
               cluster (ids −1) that off-shard routes localize to
               (``serving.localize_routes``), so every shard scores a
               full static-shape plan
    devices    where each part lies

    Placement only: query results equal the unsharded buffers' (ties
    across shards aside), so deriving one does not bump the snapshot's
    version."""
    n_shards: int
    c_global: int
    c_local: int
    shard_of: np.ndarray
    local_of: np.ndarray
    parts: tuple
    devices: tuple

    @property
    def sentinel(self) -> int:
        """Local row of each shard's empty sentinel cluster."""
        return self.c_local

    def nbytes_per_device(self):
        """Resident buffer bytes of each part (the shards' share of the
        unsharded footprint, padding and sentinel included)."""
        return [int(sum(t.numel() * t.element_size() for t in part.values()))
                for part in self.parts]

    def group(self, s: int) -> np.ndarray:
        """The global clusters of shard ``s``, ascending."""
        return np.flatnonzero(self.shard_of == s)


def shard_part(buffers: dict, group: np.ndarray, rows: int, device, *,
               pin: bool = False) -> dict:
    """One shard's local buffers on ``device``: the clusters ``group`` of
    ``buffers`` (any device) in rows ``[0, len(group))``, empty clusters
    (:data:`PART_FILLS`) above, up to ``rows`` (sentinel included);
    ``counts`` as int32. The rows are gathered where ``buffers`` lie, a
    few clusters at a time, and moved. ``pin`` pins a CPU part's pages (a
    host replica)."""
    device = torch.device(device)
    part = {}
    for key in CLUSTER_BUFFER_KEYS:
        if key not in buffers:
            continue
        src = buffers[key]
        dtype = torch.int32 if key == "counts" else src.dtype
        out = torch.full((rows,) + tuple(src.shape[1:]), PART_FILLS[key],
                         dtype=dtype, device=device)
        idx = torch.from_numpy(group.astype(np.int64)).to(src.device)
        for i in range(0, len(group), _GATHER_CLUSTERS):
            j = min(i + _GATHER_CLUSTERS, len(group))
            out[i:j] = src.index_select(0, idx[i:j]).to(device, dtype)
        if pin and device.type == "cpu" and torch.cuda.is_available():
            out = out.pin_memory()
        part[key] = out
    return part


def shard_cluster_buffers(buffers: dict, mesh, *, assignment=None,
                          device="cuda") -> ClusterShards:
    """Partition packed cluster buffers cluster-major across ``mesh``.

    ``buffers`` is the dict of ``index.build_cluster_buffers`` (any
    precision tier; the storage dtypes ride along); ``mesh`` a shard
    count (a :func:`cluster_mesh` on ``device``'s type) or a
    :class:`ClusterMesh`; ``assignment`` an optional ``(c,)``
    cluster→shard map (default: contiguous blocks of ``ceil(c /
    n_shards)`` clusters). A remainder ``c % n_shards`` pads short shards
    with EMPTY clusters; every part gets one appended sentinel empty
    cluster (local row ``c_local``)."""
    mesh = as_cluster_mesh(mesh, device=device)
    n_shards = mesh.n_shards
    c = int(buffers["ids"].shape[0])
    if assignment is None:
        per = -(-c // n_shards)
        assignment = (np.arange(c) // per).astype(np.int32)
    else:
        assignment = np.asarray(assignment, np.int32)
        if assignment.shape != (c,):
            raise ValueError(
                f"shard_cluster_buffers: assignment shape "
                f"{assignment.shape} != ({c},)")
        if assignment.size and (assignment.min() < 0
                                or assignment.max() >= n_shards):
            raise ValueError(
                f"shard_cluster_buffers: assignment values must lie in "
                f"[0, {n_shards}), got "
                f"[{assignment.min()}, {assignment.max()}]")
    groups = [np.flatnonzero(assignment == s) for s in range(n_shards)]
    c_local = max(1, max((len(g) for g in groups), default=1))
    local_of = np.zeros(c, np.int32)
    for g in groups:
        local_of[g] = np.arange(len(g), dtype=np.int32)
    rows = c_local + 1                     # + the sentinel empty cluster
    parts = tuple(shard_part(buffers, g, rows, dev)
                  for g, dev in zip(groups, mesh.devices))
    return ClusterShards(n_shards=n_shards, c_global=c, c_local=c_local,
                         shard_of=assignment, local_of=local_of,
                         parts=parts, devices=mesh.devices)


# ---------------------------------------------------------------------------
# The training half: logical axis rules, parameter and optimizer specs
# ---------------------------------------------------------------------------

_STATE = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: dict):
    """Bind ``rules`` (``{"dp": ("pod", "data"), "tp": ("model",), ...}``)
    for the block, restoring the previous binding after it."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def rules_for_mesh(mesh) -> dict:
    """The logical axes of ``mesh`` (an ``AbstractMesh``, a
    ``DeviceMesh`` or a :class:`ClusterMesh`): dp = its "pod" and "data"
    axes, tp = "model", cluster = :data:`CLUSTER_AXIS`, all = every axis;
    ``_sizes`` the axes' sizes and ``_mesh`` the mesh itself."""
    names = axis_names(mesh)
    return {"dp": tuple(n for n in names if n in ("pod", "data")),
            "tp": tuple(n for n in names if n == "model"),
            "cluster": tuple(n for n in names if n == CLUSTER_AXIS),
            "all": names, "_sizes": axis_sizes(mesh), "_mesh": mesh}


def _spec_entry(entry):
    """One spec entry as ``PartitionSpec`` holds it: a one-name tuple
    becomes the name, an empty tuple ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class Spec(tuple):
    """A spec: one entry per tensor dim (a tuple, so it compares equal to
    the plain tuple of its entries; its own type marks it as a leaf of a
    spec tree, whose nodes are dicts and lists)."""


def spec(*entries) -> Spec:
    """A spec of ``entries``, each normalised by :func:`_spec_entry`."""
    return Spec(_spec_entry(e) for e in entries)


def logical_spec(*logical) -> Optional[Spec]:
    """The spec of logical axis names under the bound rules (``None``
    outside a binding; an unknown name maps to no axis)."""
    rules = current_rules()
    if rules is None:
        return None
    return spec(*(None if ax is None else rules.get(ax, ())
                  for ax in logical))


def constrain(x, *logical):
    """The reference's sharding constraint on logical axes: ``x`` itself.
    Outside a binding it is a no-op there too; under one, the port's
    model code runs on each rank's local block, whose layout the caller
    chose."""
    return x


# (regex on the joined path, trailing logical axes). Shapes may carry
# leading stacked-layer dims; rules give the trailing dims' specs and the
# leading ones are padded with None.
LM_PARAM_RULES = (
    (r"embed$", ("tp", "dp")),                 # (V, d) vocab-parallel + fsdp
    (r"unembed$", ("dp", "tp")),               # (d, V)
    (r"attn/wq/w$", ("dp", "tp")),             # (d, H·Dh)
    (r"attn/wk/w$", ("dp", "tp")),
    (r"attn/wv/w$", ("dp", "tp")),
    (r"attn/wo/w$", ("tp", "dp")),             # (H·Dh, d)
    (r"attn/w[qkv]/b$", ("tp",)),
    (r"attn/wo/b$", ("dp",)),
    (r"moe/router$", (None, None)),            # small, replicated
    (r"moe/w1$", ("tp", "dp", None)),          # (E, d, f): EP + fsdp
    (r"moe/w3$", ("tp", "dp", None)),
    (r"moe/w2$", ("tp", None, "dp")),          # (E, f, d)
    (r"mlp/w1/w$", ("dp", "tp")),              # (d, f)
    (r"mlp/w3/w$", ("dp", "tp")),
    (r"mlp/w2/w$", ("tp", "dp")),              # (f, d)
    (r"mlp/w./b$", (None,)),
    (r"(ln|norm)", (None,)),                   # norms replicated
    (r"pos_embed$", (None, "dp")),
    (r".*", (None,)),                          # fallback: replicate
)

REC_PARAM_RULES = (
    (r"tables?(/\d+)?$", ("tp", None)),        # big embedding tables row-sharded
    (r"item_embed$", ("tp", None)),
    (r".*", (None,)),
)

GNN_PARAM_RULES = (
    (r".*", (None,)),                          # GatedGCN params are tiny
)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a dict's keys
    and a list's indices make the path; ``None`` is an empty subtree, as
    in jax), the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _axes_size(entry, sizes) -> int:
    if entry is None:
        return 1
    n = 1
    for name in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes.get(name, 1)
    return n


def _dropped(where, i, want, shape, size):
    warnings.warn(
        f"dropping sharding {want!r} on dim {i} of {where} (shape "
        f"{tuple(shape)}): {shape[i]} is not divisible by the mesh axes' "
        f"size {size}; the dim will be REPLICATED", UserWarning,
        stacklevel=3)


def param_specs(params_shape, rules_table):
    """The spec tree of a parameter tree in the reference's layout
    (anything with ``.shape`` as leaves: meta tensors from
    ``convert.param_tree``), under the bound rules: the first rule whose
    pattern the leaf's path matches gives its trailing dims' logical
    axes. A dim the mesh axes do not divide is replicated, with a
    warning. Leaves are ``None`` outside a binding."""
    sizes = (current_rules() or {}).get("_sizes", {})

    def one(path, leaf):
        ps = path_str(path)
        ndim = len(leaf.shape)
        for pat, logical in rules_table:
            if re.search(pat, ps):
                logical = tuple(logical[:ndim])
                sp = logical_spec(*((None,) * (ndim - len(logical))
                                    + logical))
                if sp is None:
                    return None
                padded = sp + (None,) * (ndim - len(sp))
                fixed = []
                for i, e in enumerate(padded):
                    size = _axes_size(e, sizes)
                    if leaf.shape[i] % size:
                        _dropped(f"param_specs: {ps!r}", i, e, leaf.shape,
                                 size)
                        e = None
                    fixed.append(e)
                return Spec(fixed)
        return logical_spec(*((None,) * ndim))

    return tree_map_with_path(one, params_shape)


class _Stacked(tuple):
    """A stack of layers' leaves, as ``convert.param_tree`` builds it with
    ``stack=_Stacked``."""


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def leaf_specs(params, spec_tree) -> list:
    """``[(parameter, spec)]`` for every parameter of the port model (or
    recsys dict) ``params``, in the reference's tree order: the spec of
    its reference leaf (``spec_tree``, from :func:`param_specs` on
    ``convert.param_tree(params)``) with the stacked-layer dims dropped."""
    from repro_torch import convert
    tree = convert.param_tree(params, leaf=lambda p: p, stack=_Stacked)
    out = []

    def walk(node, path, stacked):
        if isinstance(node, _Stacked):
            for x in node:
                walk(x, path, stacked + 1)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), stacked)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,), stacked)
        elif node is not None:
            sp = _lookup(spec_tree, path)
            out.append((node, None if sp is None else Spec(sp[stacked:])))

    walk(tree, (), 0)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh and its DTensor placements (one per mesh axis)."""
    mesh: object
    spec: tuple
    placements: tuple


def placements(mesh, sp, shape=None) -> tuple:
    """The DTensor placements of spec ``sp`` on ``mesh``: ``Replicate()``
    on every mesh axis, ``Shard(d)`` on each axis that tensor dim ``d`` is
    split over (several axes: major to minor in mesh order, as JAX splits
    a dim over a tuple of axes). With ``shape``, a dim the axes do not
    divide stays replicated, with a warning: never an uneven split."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, e in enumerate(sp or ()):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        if shape is not None and shape[d] % _axes_size(e, sizes):
            _dropped("named_shardings", d, e, shape, _axes_size(e, sizes))
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r}: the axes must come in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named_shardings(mesh, spec_tree, shapes=None):
    """Each spec of ``spec_tree`` (dicts and lists of specs; a leaf is a
    tuple, ``None`` = replicated) as a :class:`NamedSharding` on
    ``mesh``; ``shapes``, a tree of the same structure, lets
    :func:`placements` guard divisibility."""
    def walk(sp, shp):
        if sp is None or isinstance(sp, tuple):
            sp = Spec(() if sp is None else sp)
            return NamedSharding(mesh, sp, placements(
                mesh, sp, None if shp is None else tuple(shp.shape)))
        if isinstance(sp, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in sp.items()}
        return [walk(v, None if shp is None else shp[i])
                for i, v in enumerate(sp)]
    return walk(spec_tree, shapes)


def opt_state_specs(params_shapes, params_specs, optimizer: str):
    """The optimizer state's spec tree, mirroring the parameters' (the
    reference's layout): adamw's ``m`` / ``v`` shard as the parameter;
    adafactor's ``vr`` drops the last dim of the parameter's spec, ``vc``
    the second to last (a factored leaf), ``v`` keeps it (otherwise)."""
    if optimizer == "adamw":
        return {"step": Spec(), "m": params_specs, "v": params_specs}
    if optimizer == "adafactor":
        def leaf(p, s):
            shape = p.shape
            if not (len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1):
                return {"v": s}
            if s is None or len(s) < 2:
                return {"vr": None, "vc": None}
            return {"vr": Spec(s[:-1]), "vc": Spec(s[:-2] + s[-1:])}

        def walk(p, s):
            if isinstance(p, dict):
                return {k: walk(p[k], s[k]) for k in p}
            if isinstance(p, (list, tuple)):
                return [walk(a, b) for a, b in zip(p, s)]
            return None if p is None else leaf(p, s)
        return {"step": Spec(), "v": walk(params_shapes, params_specs)}
    raise ValueError(optimizer)


__all__ = ["CLUSTER_AXIS", "CLUSTER_BUFFER_KEYS", "PART_FILLS",
           "ClusterMesh", "ClusterShards", "cluster_mesh",
           "as_cluster_mesh", "shard_part", "shard_cluster_buffers",
           "current_rules", "axis_rules", "rules_for_mesh", "Spec", "spec",
           "logical_spec", "constrain", "LM_PARAM_RULES", "REC_PARAM_RULES",
           "GNN_PARAM_RULES", "param_specs", "leaf_specs", "NamedSharding",
           "placements", "named_shardings", "opt_state_specs"]
