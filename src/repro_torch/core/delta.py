"""The delta segment (reference: ``repro.core.delta``): the mutable
overlay in front of a snapshot's immutable base buffers.

* :meth:`DeltaSegment.insert` appends a chunk of rows in O(batch): prior
  chunks are shared, nothing is copied or routed;
* :meth:`DeltaSegment.delete` records ids as tombstones (masked out of
  the base scan at query time) and drops delta-resident rows with those
  ids, so every delta row is live;
* queries scan every delta row unrouted and merge with the base top-k
  (``engine.merge_delta``); compaction (``IndexSnapshot.compact``) folds
  tombstones and rows into the base and clears the delta.

Rows are quantized to the snapshot's tier on the way in (the buffers'
own ``quantize_rows``), so a row scores the same before and after
compaction; the raw f32 rows are kept so compaction re-quantizes from
the exact source. Arrays are host-side CPU tensors; the query path keeps
a padded copy on the snapshot's device (``IndexSnapshot.delta_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import filters as filters_lib
from repro_torch.core.index import (PAD_LOC, PRECISIONS, STORE_DTYPES,
                                    ids_mask, quantize_rows)

# chunk / concatenated-array field names, in canonical order
FIELDS = ("emb", "scale", "loc", "ids", "raw", "attrs")

# the device copy of the rows pads their count to a multiple of this
PAD_BUCKET = 128


def _empty_arrays(d: int, precision: str) -> Dict[str, torch.Tensor]:
    return {
        "emb": torch.zeros((0, d), dtype=STORE_DTYPES[precision]),
        "scale": torch.zeros((0,), dtype=torch.float32),
        "loc": torch.zeros((0, 2), dtype=torch.float32),
        "ids": torch.zeros((0,), dtype=torch.int32),
        "raw": torch.zeros((0, d), dtype=torch.float32),
        "attrs": torch.zeros((0, filters_lib.N_ATTRS), dtype=torch.int32),
    }


def _host(x, dtype) -> torch.Tensor:
    """``x`` (numpy or tensor) as a CPU tensor of ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", dtype)
    return torch.as_tensor(np.asarray(x)).to(dtype)


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """Immutable value type: every mutation returns a new segment.

    ``chunks`` holds one dict over :data:`FIELDS` per insert; ``ids_live``
    the delta-resident ids; ``tombstones`` the ids deleted from the base
    since the last compaction."""

    d: int
    precision: str = "f32"
    chunks: Tuple[Dict[str, torch.Tensor], ...] = ()
    ids_live: frozenset = frozenset()
    tombstones: frozenset = frozenset()

    @classmethod
    def empty(cls, d: int, precision: str = "f32") -> "DeltaSegment":
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {precision!r}")
        return cls(d=int(d), precision=precision)

    @property
    def n_rows(self) -> int:
        return sum(int(c["ids"].shape[0]) for c in self.chunks)

    @property
    def n_tombstones(self) -> int:
        return len(self.tombstones)

    @property
    def is_empty(self) -> bool:
        return not self.chunks and not self.tombstones

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The chunks concatenated (memoized)."""
        memo = self.__dict__.get("_arrays")
        if memo is None:
            if not self.chunks:
                memo = _empty_arrays(self.d, self.precision)
            else:
                memo = {f: torch.cat([c[f] for c in self.chunks])
                        for f in FIELDS}
            object.__setattr__(self, "_arrays", memo)
        return memo

    def tombstone_array(self) -> np.ndarray:
        """Sorted int64 id array."""
        return np.sort(np.fromiter(self.tombstones, np.int64,
                                   len(self.tombstones)))

    def insert(self, new_emb, new_loc, new_ids,
               new_attrs=None) -> "DeltaSegment":
        """Append a batch of rows. O(batch): prior chunks are shared."""
        raw = _host(new_emb, torch.float32).reshape(-1, self.d)
        loc = _host(new_loc, torch.float32).reshape(-1, 2)
        ids = _host(new_ids, torch.int64).reshape(-1)
        attrs = filters_lib.validate_attrs(new_attrs, int(ids.shape[0]))
        if not (raw.shape[0] == loc.shape[0] == ids.shape[0]):
            raise ValueError("insert: emb/loc/ids batch sizes disagree")
        if (ids < 0).any():
            raise ValueError("insert: ids must be non-negative "
                             "(-1 is the padding sentinel)")
        id_list = ids.tolist()
        dup = self.ids_live.intersection(id_list)
        if dup or len(set(id_list)) != len(id_list):
            raise ValueError(f"insert: duplicate ids in delta: "
                             f"{sorted(dup) or 'within batch'}")
        stored, scale = quantize_rows(raw, self.precision)
        chunk = {"emb": stored, "scale": scale, "loc": loc,
                 "ids": ids.to(torch.int32), "raw": raw, "attrs": attrs}
        return dataclasses.replace(
            self, chunks=self.chunks + (chunk,),
            ids_live=self.ids_live.union(id_list))

    def delete(self, del_ids) -> "DeltaSegment":
        """Tombstone ids for the base and drop matching delta rows. An id
        that is not live only adds a (harmless) tombstone."""
        dels = set(int(i) for i in np.asarray(del_ids).reshape(-1))
        in_delta = self.ids_live.intersection(dels)
        chunks = self.chunks
        if in_delta:
            kill = torch.tensor(sorted(in_delta), dtype=torch.int64)
            new_chunks = []
            for c in chunks:
                keep = ~torch.isin(c["ids"].long(), kill)
                if keep.all():
                    new_chunks.append(c)
                elif keep.any():
                    new_chunks.append({f: c[f][keep] for f in FIELDS})
            chunks = tuple(new_chunks)
        return dataclasses.replace(
            self, chunks=chunks, ids_live=self.ids_live.difference(dels),
            tombstones=self.tombstones.union(dels))

    def to_leaves(self) -> Dict[str, torch.Tensor]:
        """The snapshot's ``delta`` subtree: the :data:`FIELDS` arrays in
        one chunk plus the ``tombstones`` id array (int64)."""
        leaves = dict(self.arrays())
        leaves["tombstones"] = torch.from_numpy(self.tombstone_array())
        return leaves

    @classmethod
    def from_leaves(cls, d: int, precision: str, leaves) -> "DeltaSegment":
        """The inverse of :meth:`to_leaves` (numpy arrays or tensors)."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {precision!r}")
        arrs = {f: torch.as_tensor(leaves[f]).cpu() for f in FIELDS}
        arrs["emb"] = arrs["emb"].to(STORE_DTYPES[precision])
        arrs["attrs"] = arrs["attrs"].to(torch.int32)
        tomb = frozenset(int(i) for i in
                         torch.as_tensor(leaves["tombstones"]).tolist())
        chunks = (arrs,) if arrs["ids"].shape[0] else ()
        return cls(d=int(d), precision=precision, chunks=chunks,
                   ids_live=frozenset(arrs["ids"].tolist()),
                   tombstones=tomb)


def padded_rows(arrays: Dict[str, torch.Tensor],
                device) -> Dict[str, torch.Tensor]:
    """The delta's rows as one padded cluster on ``device``: emb ``(1,
    m_pad, d)``, scale ``(1, m_pad)``, loc ``(1, m_pad, 2)``, ids ``(1,
    m_pad)``, attrs ``(1, m_pad, 3)``, with ``m_pad`` the row count
    rounded up to :data:`PAD_BUCKET` and the padding of the buffers on
    the extra rows (emb 0, scale 1, loc ``PAD_LOC``, id -1, attrs 0)."""
    m, d = arrays["emb"].shape
    m_pad = -(-m // PAD_BUCKET) * PAD_BUCKET
    out = {"emb": torch.zeros((1, m_pad, d), dtype=arrays["emb"].dtype),
           "scale": torch.ones((1, m_pad), dtype=torch.float32),
           "loc": torch.full((1, m_pad, 2), PAD_LOC, dtype=torch.float32),
           "ids": torch.full((1, m_pad), -1, dtype=torch.int32),
           "attrs": torch.zeros((1, m_pad, filters_lib.N_ATTRS),
                                dtype=torch.int32)}
    for k, v in out.items():
        v[0, :m] = arrays[k]
    return {k: v.to(device) for k, v in out.items()}


def live_counts(buffers, delta: "DeltaSegment | None") -> np.ndarray:
    """Per-cluster live sizes of the base: counts minus the tombstoned
    rows still resident. O(index)."""
    counts = buffers["counts"].cpu().numpy().astype(np.int64)
    if delta is not None and delta.tombstones:
        ids = buffers["ids"]
        dead = ids_mask(ids, delta.tombstone_array()) & (ids >= 0)
        counts -= dead.sum(dim=-1).cpu().numpy()
    return counts


def mask_tombstones(ids: torch.Tensor, tombstones) -> torch.Tensor:
    """A copy of ``ids`` (the buffers' object ids) with every tombstoned id
    set to -1, so the scans treat those rows as padding.

    The reference over-fetches the base top-k by the tombstone count
    ``n`` rounded up to 32 (capped at the routed rows) and drops
    tombstoned entries afterwards. Each object sits in one buffer row, so
    at most ``n`` of its entries are tombstoned and its first ``k`` live
    ones are the first ``k`` live rows by (score desc, scan position asc):
    what a scan over the masked ids gives, with no extra width."""
    return ids.masked_fill(ids_mask(ids, tombstones), -1)
