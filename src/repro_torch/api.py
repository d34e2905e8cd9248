"""repro_torch.api — build, save, load and query a LIST index snapshot, and
score it exhaustively.

    from repro_torch import api

    snap = api.build(cfg, corpus, rel_steps=200, idx_steps=400)   # train
    api.save(snap, "artifacts/index")           # the reference loads it too
    snap = api.load("artifacts/index")          # written by either package
    searcher = api.Searcher(snap)               # on the CUDA device
    ids, scores = searcher.query(tokens, mask, loc, k=20, cr=2)
    searcher.publish(snap.with_delta(delta).compact())   # a successor

    ids, scores = api.brute_force(snap, corpus, query_ids, k=20)  # oracle

    server = searcher.serve(ServerConfig(batch_size=64))   # long-lived
    ids, scores = await server.submit(tok_row, msk_row, loc_row)
    server.insert_objects(emb, loc, ids)       # WAL-then-publish
    server = api.recover("artifacts/index", "artifacts/wal")  # after a crash

Writes go through the snapshot's derivations: ``with_delta`` for the
O(batch) delta segment, ``compact`` to fold it into the cluster buffers
on the snapshot's device; a long-lived server
(``core/server.py::StreamingServer``) derives, logs and publishes them
for its callers. The entry points take ``device=`` (default
``"cuda"``) or follow the snapshot's device, and raise when no CUDA
device is present unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import relevance
from repro_torch.core import server as server_lib
from repro_torch.core import snapshot as snapshot_lib
from repro_torch.core.index import topk_stable
from repro_torch.core.snapshot import IndexSnapshot
from repro_torch.device import full_f32_products

# the operational exception surface, the defining classes themselves:
# Overloaded + DeadlineExceeded are the server's shedding responses,
# SnapshotCorrupt is recovery's checksum verdict, ShardUnavailable the
# sharded engine's total loss (raised once the port shards)
from repro_torch.checkpoint.ckpt import SnapshotCorrupt
from repro_torch.core.server import DeadlineExceeded, Overloaded
from repro_torch.distributed.resilience import ShardUnavailable

__all__ = ["build", "save", "load", "recover", "Searcher", "brute_force",
           "IndexSnapshot", "Overloaded", "DeadlineExceeded",
           "SnapshotCorrupt", "ShardUnavailable"]


def build(cfg, corpus, *, rel_steps: int = 200, idx_steps: int = 400,
          batch: int = 64, rel_lr: float = 1.5e-3, idx_lr: float = 3e-3,
          capacity: Optional[int] = None, spill: int = 3,
          spatial_mode: str = "step", weight_mode: str = "mlp",
          precision: str = "f32", attrs=None, seed: int = 0,
          verbose: bool = False, log_every: Optional[int] = None,
          return_retriever: bool = False, device="cuda"):
    """Train LIST end to end on ``device`` and return the built
    :class:`IndexSnapshot` (the reference's ``repro.api.build`` and its
    defaults): relevance training (Eq. 8), index training (Eq. 13
    pseudo-labels + Eq. 14 MCL), buffer packing at ``precision``, through
    :class:`~repro_torch.core.pipeline.ListRetriever`. The snapshot's
    modules are frozen; ``return_retriever=True`` also returns the
    retriever (training histories, object↦cluster assignments). The
    mesh (``mesh=``) waits in ROADMAP Queue A 11."""
    log = log_every if log_every is not None else max(rel_steps, 1)
    r = pipeline_lib.ListRetriever(cfg, corpus, spatial_mode=spatial_mode,
                                   weight_mode=weight_mode, device=device)
    r.train_relevance(steps=rel_steps, batch=batch, lr=rel_lr, seed=seed,
                      verbose=verbose, log_every=log)
    r.train_index(steps=idx_steps, batch=batch, lr=idx_lr, seed=seed,
                  verbose=verbose, log_every=log)
    r.build(capacity=capacity, spill=spill, precision=precision, attrs=attrs)
    snap = r.snapshot()
    return (snap, r) if return_retriever else snap


def save(snapshot: IndexSnapshot, directory: str, *, keep: int = 3) -> str:
    """Persist ``snapshot`` under ``directory`` (atomic commit; one
    checkpoint step per snapshot version) in the reference's layout.
    Returns the committed path."""
    return snapshot.save(directory, keep=keep)


def load(directory: str, *, step: Optional[int] = None,
         device="cuda") -> IndexSnapshot:
    """Load the latest (or ``step``) committed snapshot onto ``device``."""
    return snapshot_lib.IndexSnapshot.load(directory, step=step,
                                           device=device)


def recover(snapshot_dir: str, wal_dir: Optional[str] = None, *,
            config: Optional["server_lib.ServerConfig"] = None,
            backend: str = "auto", device="cuda"):
    """Crash recovery in one call (the reference's ``repro.api.recover``):
    a serving stack on ``device`` whose index equals one that never
    crashed.

        server = api.recover("artifacts/index", "artifacts/wal")

    Loads the newest snapshot under ``snapshot_dir`` that restores
    (corrupt steps are skipped: ``snapshot.load_latest_good``) onto
    ``device``, builds a :class:`Searcher` and its streaming server, and
    replays the write-ahead log's intact records (a torn tail is dropped
    by its checksum): every record newer than the loaded snapshot re-runs
    through the normal write path, compaction triggers included. Either
    package's snapshot and log recover here.

    ``config`` must carry the write-path knobs (``delta_threshold``,
    ``spill``) the crashed server ran with; its ``wal_dir`` defaults to
    ``wal_dir``. Returns the
    :class:`~repro_torch.core.server.StreamingServer` (its
    ``stats.recovered_writes`` counts the replayed records)."""
    import dataclasses as _dc

    snap = snapshot_lib.load_latest_good(snapshot_dir, device=device)
    cfg = config or server_lib.ServerConfig()
    if wal_dir is not None and cfg.wal_dir != wal_dir:
        cfg = _dc.replace(cfg, wal_dir=wal_dir)
    server = Searcher(snap, backend=backend, device=device).serve(cfg)
    server.replay_wal()
    return server


class Searcher:
    """A query façade over one snapshot, served on ``device``."""

    def __init__(self, snapshot: IndexSnapshot, *, backend: str = "auto",
                 device="cuda"):
        self.engine = engine_lib.QueryEngine(snapshot, backend=backend,
                                             device=device)

    @property
    def snapshot(self) -> IndexSnapshot:
        return self.engine.snapshot

    @property
    def last_coverage(self) -> float:
        """Coverage fraction of the most recent :meth:`query`: 1.0 (the
        reference's sharded engine reports less with a shard down)."""
        return self.engine.last_coverage

    def publish(self, snapshot: IndexSnapshot) -> IndexSnapshot:
        """Swap the served snapshot (``cfg_digest`` checked; moved to the
        searcher's device). Returns ``snapshot``."""
        self.engine.publish(snapshot)
        return snapshot

    def query(self, tokens, mask, loc, *, k: int = 10, cr: int = 1,
              batch: int = 256, backend: Optional[str] = None,
              filters=None):
        """Batched spatial-keyword query → ``(ids (n, k), scores (n, k))``
        numpy. ``tokens (n, L)`` int32, ``mask (n, L)`` bool, ``loc (n,
        2)`` float32; ids are global object ids, -1 past the end."""
        return self.engine.query(tokens, mask, loc, k=k, cr=cr, batch=batch,
                                 backend=backend, filters=filters)

    def serve(self, config: Optional["server_lib.ServerConfig"] = None
              ) -> "server_lib.StreamingServer":
        """A streaming server (micro-batcher, caches, write path, WAL,
        DESIGN.md §7) over this searcher's engine, on its device."""
        return server_lib.StreamingServer(self.engine, config)


def brute_force(snapshot: IndexSnapshot, corpus, query_ids, *, k: int = 20,
                batch: int = 256):
    """Exhaustive LIST-R scoring of the whole corpus: the recall oracle of
    a snapshot. Objects are re-embedded with the snapshot's own object
    tower, so the answer is what the artifact would serve at cr = c.
    Runs on the snapshot's device with TF32 off (the towers' and the
    score's f32 products in full f32); ids are corpus positions, ties ranked
    lowest index first (``jax.lax.top_k``'s rule). Returns ``(ids (n,
    k) int32, scores (n, k) f32)`` numpy."""
    rel, meta, dev = snapshot.rel, snapshot.meta, snapshot.device
    full_f32_products(dev)
    obj_emb = torch.from_numpy(
        pipeline_lib.embed_objects(rel, corpus, batch=batch)).to(dev)
    obj_loc = torch.from_numpy(corpus.obj_loc.astype(np.float32)).to(dev)
    q_emb = pipeline_lib.embed_queries(rel, corpus, query_ids, batch=batch)
    q_loc = corpus.q_loc[query_ids].astype(np.float32)

    def score_top(qe, ql):
        st = relevance.score_corpus(
            rel, qe, ql, obj_emb, obj_loc, dist_max=meta.dist_max,
            spatial_mode=meta.spatial_mode, weight_mode=meta.weight_mode)
        sc, ids = topk_stable(st, k)
        return ids.to(torch.int32), sc

    with torch.no_grad():
        return engine_lib.run_batched(score_top, [q_emb, q_loc], batch=batch,
                                      device=dev)
