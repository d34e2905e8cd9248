"""Read side of the delta segment (reference: ``repro.core.delta``).

A snapshot's delta holds rows inserted since its base buffers were built
(quantized to the snapshot's tier, scored by brute force at query time)
and the tombstoned ids of deleted base rows (filtered out of base results).
Arrays stay host-side CPU tensors; the query path moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.index import PRECISIONS, STORE_DTYPES

FIELDS = ("emb", "scale", "loc", "ids", "raw", "attrs")


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    d: int
    precision: str
    rows: Dict[str, torch.Tensor]
    tombstones: frozenset = frozenset()

    @classmethod
    def from_leaves(cls, d: int, precision: str, leaves) -> "DeltaSegment":
        """From the snapshot's ``delta`` subtree: the :data:`FIELDS` row
        arrays in one chunk plus the ``tombstones`` id array."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {precision!r}")
        rows = {f: torch.as_tensor(leaves[f]) for f in FIELDS}
        rows["emb"] = rows["emb"].to(STORE_DTYPES[precision])
        rows["attrs"] = rows["attrs"].to(torch.int32)
        tomb = frozenset(int(i) for i in
                         torch.as_tensor(leaves["tombstones"]).tolist())
        return cls(d=int(d), precision=precision, rows=rows, tombstones=tomb)

    @property
    def n_rows(self) -> int:
        return int(self.rows["ids"].shape[0])

    @property
    def n_tombstones(self) -> int:
        return len(self.tombstones)

    @property
    def is_empty(self) -> bool:
        return self.n_rows == 0 and not self.tombstones

    def arrays(self) -> Dict[str, torch.Tensor]:
        return self.rows

    def tombstone_array(self) -> np.ndarray:
        """Sorted int64 id array."""
        return np.sort(np.fromiter(self.tombstones, np.int64,
                                   len(self.tombstones)))


def mask_tombstones(ids: torch.Tensor, tombstones) -> torch.Tensor:
    """A copy of ``ids`` (the buffers' object ids) with every tombstoned id
    set to -1, so the scans treat those rows as padding.

    The reference over-fetches the base top-k by the tombstone count
    ``n`` rounded up to 32 (capped at the routed rows) and drops
    tombstoned entries afterwards. Each object sits in one buffer row, so
    at most ``n`` of its entries are tombstoned and its first ``k`` live
    ones are the first ``k`` live rows by (score desc, scan position asc):
    what a scan over the masked ids gives, with no extra width."""
    tomb = torch.as_tensor(np.asarray(tombstones, np.int64))
    info = torch.iinfo(ids.dtype)
    tomb = tomb[(tomb >= info.min) & (tomb <= info.max)]
    return ids.masked_fill(torch.isin(ids, tomb.to(ids.device, ids.dtype)),
                           -1)
