"""repro_torch.api — load a LIST index snapshot and query it.

    from repro_torch import api

    snap = api.load("artifacts/index")          # written by repro.api.save
    searcher = api.Searcher(snap)               # on the CUDA device
    ids, scores = searcher.query(tokens, mask, loc, k=20, cr=2)

Both entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.ckpt import SnapshotCorrupt
from repro_torch.core import engine as engine_lib
from repro_torch.core import snapshot as snapshot_lib
from repro_torch.core.snapshot import IndexSnapshot

__all__ = ["load", "Searcher", "IndexSnapshot", "SnapshotCorrupt"]


def load(directory: str, *, step: Optional[int] = None,
         device="cuda") -> IndexSnapshot:
    """Load the latest (or ``step``) committed snapshot onto ``device``."""
    return snapshot_lib.IndexSnapshot.load(directory, step=step,
                                           device=device)


class Searcher:
    """A query façade over one snapshot, served on ``device``."""

    def __init__(self, snapshot: IndexSnapshot, *, backend: str = "auto",
                 device="cuda"):
        self.engine = engine_lib.QueryEngine(snapshot, backend=backend,
                                             device=device)

    @property
    def snapshot(self) -> IndexSnapshot:
        return self.engine.snapshot

    def query(self, tokens, mask, loc, *, k: int = 10, cr: int = 1,
              batch: int = 256, backend: Optional[str] = None,
              filters=None):
        """Batched spatial-keyword query → ``(ids (n, k), scores (n, k))``
        numpy. ``tokens (n, L)`` int32, ``mask (n, L)`` bool, ``loc (n,
        2)`` float32; ids are global object ids, -1 past the end."""
        return self.engine.query(tokens, mask, loc, k=k, cr=cr, batch=batch,
                                 backend=backend, filters=filters)
