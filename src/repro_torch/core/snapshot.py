"""The index artifact (reference: ``repro.core.snapshot``): derivations,
save and load.

An :class:`IndexSnapshot` is everything the query phase needs: the model
config, the relevance model and cluster classifier (as modules), the
location normalizer, the packed cluster buffers, an optional delta
segment, and the identity block :class:`SnapshotMeta`. It lives on one
device; :meth:`IndexSnapshot.to` moves it. It is never written in place:
:meth:`~IndexSnapshot.with_buffers`, :meth:`~IndexSnapshot.with_delta`,
:meth:`~IndexSnapshot.compact` and :meth:`~IndexSnapshot.with_precision`
derive a successor (``meta.version + 1``), and an engine may go on
serving the predecessor.

:meth:`~IndexSnapshot.with_mesh` derives a mesh-sharded snapshot (no
version bump: placement, not content): ``shards`` holds the per-shard
parts of the cluster buffers (``distributed.sharding.ClusterShards``),
and ``buffers`` drops to the host, where saving, compaction and the
engine's host replicas read it. The modules stay where they were, so a
sharded snapshot's :attr:`~IndexSnapshot.device` is theirs, and
:meth:`~IndexSnapshot.to` moves them alone.

On disk a snapshot is one checkpoint step, written by either package
and read by both. The manifest's ``meta.tree_spec`` records the
container structure of the saved tree, whose leaves are stored in
``jax.tree_util.tree_flatten`` order — dict keys sorted, lists in order —
at the dtypes the reference writes. The loader rebuilds that order from
the spec; the schema and precision gates run before any leaf file is
read.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import json
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import DualEncoderConfig
from repro_torch.convert import params_from_numpy, params_to_tree
from repro_torch.core import delta as delta_lib
from repro_torch.core import index as index_lib
from repro_torch.core import spatial as sp
from repro_torch.core.index import ClusterIndex
from repro_torch.core.relevance import RelevanceModel
from repro_torch.device import require_device

# the reference's on-disk schema this loader reads (v5: filter attributes)
SCHEMA_VERSION = 5

_BUFFER_ARRAYS = ("emb", "loc", "ids", "counts", "scale", "attrs")
_BUFFER_SCALARS = ("capacity", "n_spilled")


def cfg_digest(cfg) -> str:
    """The reference's config identity: sha256 of the sorted-key JSON."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _cfg_from_dict(d: dict) -> DualEncoderConfig:
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return DualEncoderConfig(**kw)


def _tree_spec(tree) -> Any:
    """The container structure of ``tree``, leaves as ``None``; dict
    children in sorted-key order (``jax.tree_util``'s flatten order)."""
    if isinstance(tree, dict):
        return {"d": {k: _tree_spec(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        kind = "t" if isinstance(tree, tuple) else "l"
        return {kind: [_tree_spec(v) for v in tree]}
    return None


def _flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in ``tree_flatten`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _spec_leaf_count(spec) -> int:
    if spec is None:
        return 1
    if "d" in spec:
        return sum(_spec_leaf_count(v) for v in spec["d"].values())
    return sum(_spec_leaf_count(v) for v in spec.get("l", spec.get("t", [])))


def _unflatten(spec, leaves: Iterator[torch.Tensor]) -> Any:
    """Rebuild the saved tree from its spec, taking leaves in flatten
    order: dict children by sorted key, lists and tuples in order."""
    if spec is None:
        return next(leaves)
    if "d" in spec:
        return {k: _unflatten(spec["d"][k], leaves) for k in sorted(spec["d"])}
    if "l" in spec:
        return [_unflatten(v, leaves) for v in spec["l"]]
    return tuple(_unflatten(v, leaves) for v in spec["t"])


@dataclasses.dataclass(frozen=True)
class SnapshotMeta:
    """Identity and provenance of a snapshot (fields of the reference)."""
    schema_version: int
    cfg_digest: str
    n_objects: int
    built_at: float
    version: int
    dist_max: float
    spatial_mode: str = "step"
    weight_mode: str = "mlp"
    precision: str = "f32"
    delta_rows: int = 0
    n_tombstones: int = 0
    n_shards: int = 1


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    cfg: DualEncoderConfig
    rel: RelevanceModel
    index: ClusterIndex
    norm: dict
    buffers: dict
    meta: SnapshotMeta
    delta: Optional[delta_lib.DeltaSegment] = None
    shards: Optional[Any] = None

    @classmethod
    def from_parts(cls, cfg, rel: RelevanceModel, index: ClusterIndex,
                   norm: dict, buffers: dict, *, dist_max: float,
                   spatial_mode: str = "step", weight_mode: str = "mlp",
                   version: int = 0, delta=None) -> "IndexSnapshot":
        """A fresh snapshot over in-memory parts (``buffers`` as returned
        by ``index.build_cluster_buffers``). ``rel`` and ``index`` are
        frozen in place (``requires_grad_(False)``): a snapshot never
        builds an autograd graph, whoever trained its parts."""
        missing = [k for k in _BUFFER_ARRAYS + _BUFFER_SCALARS
                   if k not in buffers]
        if missing:
            raise ValueError(f"buffers missing keys {missing}")
        precision = buffers.get("precision", "f32")
        if precision not in index_lib.PRECISIONS:
            raise ValueError(f"buffers carry unknown precision {precision!r}")
        meta = SnapshotMeta(
            schema_version=SCHEMA_VERSION, cfg_digest=cfg_digest(cfg),
            n_objects=int(buffers["counts"].sum()), built_at=time.time(),
            version=int(version), dist_max=float(dist_max),
            spatial_mode=spatial_mode, weight_mode=weight_mode,
            precision=precision,
            delta_rows=0 if delta is None else delta.n_rows,
            n_tombstones=0 if delta is None else delta.n_tombstones)
        return cls(cfg=cfg, rel=rel.requires_grad_(False),
                   index=index.requires_grad_(False), norm=norm,
                   buffers=buffers, meta=meta, delta=delta)

    def with_buffers(self, buffers: dict) -> "IndexSnapshot":
        """The successor with new buffers (``index.insert_objects`` /
        ``delete_objects``), ``meta.version + 1``. The precision tier is
        part of the identity: change it through :meth:`with_precision`."""
        if buffers.get("precision", "f32") != self.meta.precision:
            raise ValueError(
                f"with_buffers: buffers are "
                f"{buffers.get('precision', 'f32')!r} but this snapshot is "
                f"{self.meta.precision!r}; use with_precision to change "
                f"tiers")
        meta = dataclasses.replace(
            self.meta, version=self.meta.version + 1, built_at=time.time(),
            n_objects=int(buffers["counts"].sum()))
        # content changed: a predecessor's mesh parts are stale, re-shard
        out = dataclasses.replace(self, buffers=buffers, meta=meta,
                                  shards=None)
        return out._reshard_like(self)

    def with_mesh(self, mesh, *, assignment=None) -> "IndexSnapshot":
        """The same snapshot with its cluster buffers partitioned across
        a mesh (``distributed.sharding``): ``mesh`` a shard count (the
        first cards of a CUDA snapshot's host, raising when there are
        fewer; logical parts for a CPU snapshot) or a
        :class:`~repro_torch.distributed.sharding.ClusterMesh` (an
        explicit device list, e.g. several logical shards on one card);
        ``assignment`` an optional ``(c,)`` cluster→shard map.

        Placement, not content: no version bump. The parts are gathered
        from the buffers where they lie; ``buffers`` then moves to the
        host. ``with_mesh(None)`` is :meth:`unshard`. A delta segment
        rides along unsharded."""
        from repro_torch.distributed import sharding as sharding_lib

        if mesh is None:
            return self.unshard()
        shards = sharding_lib.shard_cluster_buffers(
            self.buffers, mesh, assignment=assignment, device=self.device)
        host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in self.buffers.items()}
        meta = dataclasses.replace(self.meta, n_shards=shards.n_shards)
        return dataclasses.replace(self, buffers=host, shards=shards,
                                   meta=meta)

    def unshard(self) -> "IndexSnapshot":
        """Drop the mesh placement: the global buffers move back to the
        modules' device. No version bump."""
        if self.shards is None and self.meta.n_shards == 1:
            return self
        dev = self.device
        buffers = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                   for k, v in self.buffers.items()}
        meta = dataclasses.replace(self.meta, n_shards=1)
        return dataclasses.replace(self, buffers=buffers, shards=None,
                                   meta=meta)

    def _reshard_like(self, predecessor: "IndexSnapshot") -> "IndexSnapshot":
        """Re-derive the mesh placement after a content change: the
        predecessor's parts are stale, so shard again onto the same
        devices with the default block assignment (a custom assignment
        cannot survive a cluster-count change)."""
        if predecessor.shards is None:
            return self
        from repro_torch.distributed import sharding as sharding_lib
        return self.with_mesh(
            sharding_lib.ClusterMesh(predecessor.shards.devices))

    def with_delta(self, delta: delta_lib.DeltaSegment) -> "IndexSnapshot":
        """The successor with a new delta segment (the O(batch) write
        path), same base buffers, ``meta.version + 1``."""
        if delta.precision != self.meta.precision:
            raise ValueError(
                f"with_delta: delta is {delta.precision!r} but this "
                f"snapshot is {self.meta.precision!r}; quantization tiers "
                f"must match for pre/post-compaction score parity")
        meta = dataclasses.replace(
            self.meta, version=self.meta.version + 1, built_at=time.time(),
            delta_rows=delta.n_rows, n_tombstones=delta.n_tombstones)
        return dataclasses.replace(self, delta=delta, meta=meta)

    def compact(self, *, spill: int = 3) -> "IndexSnapshot":
        """Fold the delta into the base buffers on the snapshot's device:
        tombstoned rows become padding, pending rows are placed by the
        §4.3 policy and re-quantized from the raw f32 rows the delta kept.
        The row arrays are cloned once and written in place; ``self`` is
        never written. One version bump; ``self`` when there is nothing
        to fold."""
        if self.delta is None or self.delta.is_empty:
            return self
        buf = index_lib.clone_rows(self.buffers)
        if self.delta.tombstones:
            index_lib.delete_rows_(buf, self.delta.tombstone_array())
        arrs = self.delta.arrays()
        if arrs["ids"].shape[0]:
            index_lib.insert_rows_(buf, self.index, self.norm, arrs["raw"],
                                   arrs["loc"], arrs["ids"], spill=spill,
                                   new_attrs=arrs["attrs"])
        meta = dataclasses.replace(
            self.meta, version=self.meta.version + 1, built_at=time.time(),
            n_objects=int(buf["counts"].sum()), delta_rows=0,
            n_tombstones=0)
        out = dataclasses.replace(self, buffers=buf, delta=None, meta=meta,
                                  shards=None)
        return out._reshard_like(self)

    def with_precision(self, precision: str) -> "IndexSnapshot":
        """The same index at another tier (``index.quantize_buffers``:
        only from f32), ``meta.version + 1``; ``self`` when already
        there. A non-empty delta must be compacted first."""
        if precision == self.meta.precision:
            return self
        if self.delta is not None and not self.delta.is_empty:
            raise ValueError(
                "with_precision: snapshot has a non-empty delta segment; "
                "compact() first so pending mutations requantize with the "
                "base instead of being carried at the old tier")
        buffers = index_lib.quantize_buffers(self.buffers, precision)
        meta = dataclasses.replace(
            self.meta, precision=precision, version=self.meta.version + 1,
            built_at=time.time())
        out = dataclasses.replace(self, buffers=buffers, meta=meta,
                                  shards=None)
        return out._reshard_like(self)

    @property
    def device(self) -> torch.device:
        """Where the snapshot is served: its buffers' device, or, when it
        is sharded (its global buffers on the host), its modules'."""
        if self.shards is not None:
            return self.norm["lo"].device
        return self.buffers["emb"].device

    @property
    def scan_view(self) -> "IndexSnapshot":
        """What the base scan reads: ``self``, or, when the delta holds
        tombstones, this snapshot with them set to -1 in ``buffers["ids"]``
        (:func:`~repro_torch.core.delta.mask_tombstones`), so the scans
        skip those rows as padding. The masked ids are built at first use
        on the snapshot's device and live as long as the snapshot."""
        if self.delta is None or not self.delta.n_tombstones:
            return self
        return dataclasses.replace(
            self, buffers={**self.buffers, "ids": self._masked_ids})

    @functools.cached_property
    def _masked_ids(self) -> torch.Tensor:
        return delta_lib.mask_tombstones(self.buffers["ids"],
                                         self.delta.tombstone_array())

    @property
    def scan_parts(self) -> tuple:
        """What the sharded scan reads: ``shards.parts``, with the
        delta's tombstoned ids set to -1 in each part's ``ids`` (as
        :attr:`scan_view` does for the unsharded buffers). The masked ids
        are built at first use on each part's device and live as long as
        this snapshot, which is one placement."""
        if self.delta is None or not self.delta.n_tombstones:
            return self.shards.parts
        return self._masked_parts

    @functools.cached_property
    def _masked_parts(self) -> tuple:
        tomb = self.delta.tombstone_array()
        return tuple({**part, "ids": delta_lib.mask_tombstones(part["ids"],
                                                               tomb)}
                     for part in self.shards.parts)

    @functools.cached_property
    def delta_rows(self) -> Optional[dict]:
        """The delta's rows padded to a multiple of
        :data:`~repro_torch.core.delta.PAD_BUCKET` as one cluster on the
        snapshot's device (``delta.padded_rows``), built at first use and
        held by this snapshot alone; None without delta rows."""
        if self.delta is None or not self.delta.n_rows:
            return None
        return delta_lib.padded_rows(self.delta.arrays(), self.device)

    def to(self, device) -> "IndexSnapshot":
        """The same snapshot with its modules and arrays on ``device``
        (the delta segment stays host-side; a sharded snapshot's buffers
        stay on the host and its parts where the mesh put them). ``self``
        is left as it was: modules are copied before they move."""
        device = require_device(device)
        if self.device == device:
            return self
        return self._moved(device, copy_modules=True)

    def _moved(self, device: torch.device, *, copy_modules: bool):
        def mod(m):
            return (copy.deepcopy(m) if copy_modules else m).to(device)

        buffers = self.buffers
        if self.shards is None:
            buffers = {k: (v.to(device) if isinstance(v, torch.Tensor)
                           else v) for k, v in buffers.items()}
        return dataclasses.replace(
            self, rel=mod(self.rel), index=mod(self.index),
            norm={k: v.to(device) for k, v in self.norm.items()},
            buffers=buffers)

    @property
    def w_hat(self) -> torch.Tensor:
        """Serve-form spatial step table (Eq. 5)."""
        if self.meta.spatial_mode == "step":
            return sp.extract_lookup(self.rel.spatial["w_s"].data)
        return torch.linspace(0, 1, self.cfg.spatial_t, device=self.device)

    @property
    def dist_max(self) -> float:
        return self.meta.dist_max

    def _tree(self) -> dict:
        rel_params, index_params = params_to_tree(self.rel, self.index)
        tree = {"rel_params": rel_params, "index_params": index_params,
                "norm": dict(self.norm),
                "buffers": {k: self.buffers[k] for k in _BUFFER_ARRAYS}}
        if self.delta is not None and not self.delta.is_empty:
            tree["delta"] = self.delta.to_leaves()
        return tree

    def save(self, directory: str, *, keep: int = 3) -> str:
        """Persist as checkpoint step ``meta.version`` (atomic commit,
        keep-``keep`` GC) in the reference's layout, so either package
        loads it. Leaves on the card are copied to the host one at a
        time; a sharded snapshot writes its global host buffers, and its
        ``meta.n_shards`` is provenance only (:meth:`load` sets 1). A
        directory holds one lineage: saving a version older than its
        latest step is refused. Returns the committed path."""
        latest = ckpt.latest_step(directory)
        if latest is not None and latest > self.meta.version:
            raise ValueError(
                f"snapshot.save: {directory} already holds version "
                f"{latest} > this snapshot's {self.meta.version}; load() "
                f"would keep serving the old artifact. Save a successor "
                f"of that lineage, or use a fresh directory")
        tree = self._tree()
        meta = dataclasses.asdict(self.meta)
        meta.update({
            "cfg": dataclasses.asdict(self.cfg),
            "tree_spec": _tree_spec(tree),
            **{k: int(self.buffers[k]) for k in _BUFFER_SCALARS},
        })
        return ckpt.save(directory, self.meta.version, _flatten(tree),
                         treedef="repro_torch: the structure is "
                                 "meta.tree_spec", meta=meta, keep=keep)

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, *,
             device="cuda") -> "IndexSnapshot":
        """Load a committed snapshot (latest unless ``step``) onto
        ``device``, unsharded (``meta.n_shards`` 1: re-shard with
        :meth:`with_mesh`). A schema or precision mismatch raises ``ValueError``
        before any leaf is read; a damaged artifact raises
        :class:`~repro_torch.checkpoint.ckpt.SnapshotCorrupt`."""
        device = require_device(device)
        meta, step = ckpt.read_meta(directory, step=step)
        got = meta.get("schema_version")
        if got != SCHEMA_VERSION:
            raise ValueError(
                f"snapshot schema mismatch in {directory}: artifact has "
                f"schema_version={got!r}, this build reads {SCHEMA_VERSION}")
        precision = meta.get("precision")
        if precision not in index_lib.PRECISIONS:
            raise ValueError(
                f"snapshot precision mismatch in {directory}: artifact "
                f"declares precision={precision!r}, this build understands "
                f"{index_lib.PRECISIONS}")
        cfg = _cfg_from_dict(meta["cfg"])
        if cfg_digest(cfg) != meta["cfg_digest"]:
            raise ckpt.SnapshotCorrupt(
                f"snapshot cfg_digest mismatch in {directory}: manifest says "
                f"{meta['cfg_digest']} but the stored config hashes to "
                f"{cfg_digest(cfg)}")
        leaves, _, _ = ckpt.restore(directory, step=step)
        spec = meta["tree_spec"]
        if _spec_leaf_count(spec) != len(leaves):
            raise ckpt.SnapshotCorrupt(
                f"{directory}: tree_spec has {_spec_leaf_count(spec)} leaves, "
                f"the manifest {len(leaves)}")
        tree = _unflatten(spec, iter(leaves))
        rel, index = params_from_numpy(tree["rel_params"],
                                       tree["index_params"], cfg)
        buffers = dict(tree["buffers"])
        for k in _BUFFER_SCALARS:
            buffers[k] = int(meta[k])
        buffers["precision"] = precision
        delta = None
        if "delta" in tree:
            delta = delta_lib.DeltaSegment.from_leaves(
                int(buffers["emb"].shape[-1]), precision, tree["delta"])
        sm = SnapshotMeta(
            schema_version=meta["schema_version"],
            cfg_digest=meta["cfg_digest"], n_objects=meta["n_objects"],
            built_at=meta["built_at"], version=meta["version"],
            dist_max=meta["dist_max"], spatial_mode=meta["spatial_mode"],
            weight_mode=meta["weight_mode"], precision=precision,
            delta_rows=meta.get("delta_rows", 0),
            n_tombstones=meta.get("n_tombstones", 0), n_shards=1)
        snap = cls(cfg=cfg, rel=rel.requires_grad_(False),
                   index=index.requires_grad_(False), norm=dict(tree["norm"]),
                   buffers=buffers, meta=sm, delta=delta)
        # the modules are this load's own: move them without a copy
        return snap._moved(device, copy_modules=False)


def load(directory: str, step: Optional[int] = None, *,
         device="cuda") -> IndexSnapshot:
    """Module-level alias of :meth:`IndexSnapshot.load`."""
    return IndexSnapshot.load(directory, step=step, device=device)


def load_latest_good(directory: str, *, device="cuda") -> IndexSnapshot:
    """The newest committed snapshot that restores; steps raising
    :class:`SnapshotCorrupt` are skipped, other errors propagate."""
    steps = ckpt.all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed snapshots in {directory}")
    corrupt: List = []
    for step in reversed(steps):
        try:
            return IndexSnapshot.load(directory, step=step, device=device)
        except ckpt.SnapshotCorrupt as e:
            corrupt.append((step, str(e)))
    raise FileNotFoundError(f"no loadable snapshot in {directory}: every "
                            f"committed step is corrupt — {corrupt}")
