"""Cluster-axis sharding of the packed cluster buffers (reference:
``repro.distributed.sharding``, its cluster half).

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

The training-parameter half of the reference module (logical specs,
``constrain``, parameter and optimizer shardings) is not ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import index as index_lib

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


__all__ = ["CLUSTER_AXIS", "CLUSTER_BUFFER_KEYS", "PART_FILLS",
           "ClusterMesh", "ClusterShards", "cluster_mesh",
           "as_cluster_mesh", "shard_part", "shard_cluster_buffers"]
