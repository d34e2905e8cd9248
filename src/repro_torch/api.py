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

``python -m repro_torch.api [--device cpu]`` runs the save → load →
query round-trip self-test on a small random index (on the card unless
``--device cpu``; exit code 0 only when every leg agrees).

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
          return_retriever: bool = False, mesh=None, device="cuda"):
    """Train LIST end to end on ``device`` and return the built
    :class:`IndexSnapshot` (the reference's ``repro.api.build`` and its
    defaults): relevance training (Eq. 8), index training (Eq. 13
    pseudo-labels + Eq. 14 MCL), buffer packing at ``precision``, through
    :class:`~repro_torch.core.pipeline.ListRetriever`. The snapshot's
    modules are frozen; ``return_retriever=True`` also returns the
    retriever (training histories, object↦cluster assignments).
    ``mesh`` (a shard count or a ``sharding.ClusterMesh``) shards the
    built snapshot's cluster buffers (``IndexSnapshot.with_mesh``)."""
    log = log_every if log_every is not None else max(rel_steps, 1)
    r = pipeline_lib.ListRetriever(cfg, corpus, spatial_mode=spatial_mode,
                                   weight_mode=weight_mode, device=device)
    r.train_relevance(steps=rel_steps, batch=batch, lr=rel_lr, seed=seed,
                      verbose=verbose, log_every=log)
    r.train_index(steps=idx_steps, batch=batch, lr=idx_lr, seed=seed,
                  verbose=verbose, log_every=log)
    r.build(capacity=capacity, spill=spill, precision=precision, attrs=attrs)
    snap = r.snapshot()
    if mesh is not None:
        snap = snap.with_mesh(mesh)
    return (snap, r) if return_retriever else snap


def save(snapshot: IndexSnapshot, directory: str, *, keep: int = 3) -> str:
    """Persist ``snapshot`` under ``directory`` (atomic commit; one
    checkpoint step per snapshot version) in the reference's layout.
    Returns the committed path."""
    return snapshot.save(directory, keep=keep)


def load(directory: str, *, step: Optional[int] = None, mesh=None,
         device="cuda") -> IndexSnapshot:
    """Load the latest (or ``step``) committed snapshot onto ``device``.
    Arrays are saved global, so ``mesh`` (a shard count or a
    ``sharding.ClusterMesh``) re-shards the cluster buffers for this
    host, whatever placement the saving process had."""
    snap = snapshot_lib.IndexSnapshot.load(directory, step=step,
                                           device=device)
    if mesh is not None:
        snap = snap.with_mesh(mesh)
    return snap


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
        """Coverage fraction of the most recent :meth:`query`: the share
        of routes a sharded engine scanned (less than 1.0 with a shard
        down), 1.0 unsharded."""
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

    def query_corpus(self, corpus, query_ids, *, k: int = 10, cr: int = 1,
                     batch: int = 256, backend: Optional[str] = None):
        """:meth:`query` of a corpus's queries by id."""
        tokens, mask = corpus.query_tokens(query_ids)
        loc = corpus.q_loc[query_ids].astype(np.float32)
        return self.query(tokens, mask, loc, k=k, cr=cr, batch=batch,
                          backend=backend)

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


# ---------------------------------------------------------------------------
# Round-trip self-test
# ---------------------------------------------------------------------------


def _roundtrip_selftest(directory: Optional[str] = None,
                        device="cuda") -> int:
    """build (random params) → save → load → query, on every backend of
    ``device`` (``cuda``, ``cuda-cm``, ``auto`` on the card; ``dense``,
    ``dense-cm`` on the CPU) and every tier (f32, bf16, int8), unfiltered
    and with a tenant filter, plus a snapshot with a delta segment: each
    leg's answers must be bit-identical before and after the trip (and
    the filtered ones inside the tenant). The mesh leg shards each tier
    into 2 logical parts on ``device`` (``cuda`` on the card, ``dense``
    on the CPU): ids equal to the unsharded ones, before and after a
    save and ``load(mesh=)``. Returns the number of legs that disagree."""
    import dataclasses
    import os
    import tempfile

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import filters as filters_lib
    from repro_torch.core import index as index_lib
    from repro_torch.device import require_device
    from repro_torch.distributed import sharding as sharding_lib

    dev = require_device(device)
    backends = (("cuda", "cuda-cm", "auto") if dev.type == "cuda"
                else ("dense", "dense-cm"))
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=512,
        max_len=8, spatial_t=50, n_clusters=4, index_mlp_hidden=(16,))
    rng = np.random.default_rng(0)
    rel_p, idx_p = convert.random_params(
        cfg, n_clusters=cfg.n_clusters,
        generator=torch.Generator().manual_seed(0))
    rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
    n, c = 64, cfg.n_clusters
    obj_emb = torch.from_numpy(
        rng.normal(size=(n, cfg.d_model)).astype(np.float32))
    obj_loc = torch.from_numpy(rng.uniform(size=(n, 2)).astype(np.float32))
    norm = index_lib.loc_normalizer(obj_loc)
    feats = index_lib.build_features(obj_emb, obj_loc, norm)
    top = index_lib.assign_clusters(index, feats, top=2).numpy()
    attrs = filters_lib.make_attrs(np.arange(n) % 3, 1 << (np.arange(n) % 4),
                                   np.arange(n))
    buf = index_lib.build_cluster_buffers(top, obj_emb, obj_loc,
                                          n_clusters=c, capacity=32,
                                          attrs=torch.from_numpy(attrs))
    snap = IndexSnapshot.from_parts(cfg, rel, index, norm, buf,
                                    dist_max=1.4142)
    fspec = filters_lib.FilterSpec(tenant=1)

    tok = rng.integers(2, cfg.vocab_size, (12, cfg.max_len)).astype(np.int32)
    tok[:, 0] = 1
    msk = np.ones_like(tok, bool)
    loc = rng.uniform(size=(12, 2)).astype(np.float32)

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    root = tempfile.mkdtemp() if directory is None else directory
    failures = 0
    for precision in index_lib.PRECISIONS:
        snap_p = snap.with_precision(precision)
        tmp = os.path.join(root, precision)
        path = save(snap_p, tmp)
        loaded = load(tmp, device=dev)
        assert loaded.meta == snap_p.meta, (loaded.meta, snap_p.meta)
        assert loaded.cfg == snap_p.cfg
        for backend in backends:
            def ask(s, **kw):
                return Searcher(s, backend=backend, device=dev).query(
                    tok, msk, loc, k=5, cr=2, batch=4, **kw)
            ok = same(ask(snap_p), ask(loaded))
            print(f"snapshot-roundtrip [{backend:9s}|{precision:4s}] "
                  f"{'bit-identical' if ok else 'MISMATCH'}  ({path})")
            failures += 0 if ok else 1
            fa, fb = ask(snap_p, filters=fspec), ask(loaded, filters=fspec)
            live = fa[0][fa[0] >= 0]
            ok = same(fa, fb) and bool(np.all(attrs[live, 0] == 1))
            print(f"snapshot-roundtrip [filt {backend:4s}|{precision:4s}] "
                  f"{'bit-identical' if ok else 'MISMATCH'}")
            failures += 0 if ok else 1
        # a snapshot with pending mutations round-trips and serves alike
        seg = delta_lib.DeltaSegment.empty(cfg.d_model, precision)
        seg = seg.insert(rng.normal(size=(3, cfg.d_model)).astype(np.float32),
                         rng.uniform(size=(3, 2)).astype(np.float32),
                         np.arange(9000, 9003))
        seg = seg.delete([0, 1])
        snap_d = snap_p.with_delta(seg)
        tmp_d = os.path.join(root, precision + "-delta")
        save(snap_d, tmp_d)
        loaded_d = load(tmp_d, device=dev)
        assert loaded_d.meta == snap_d.meta, (loaded_d.meta, snap_d.meta)
        a = Searcher(snap_d, backend=backends[0], device=dev).query(
            tok, msk, loc, k=5, cr=2, batch=4)
        b = Searcher(loaded_d, backend=backends[0], device=dev).query(
            tok, msk, loc, k=5, cr=2, batch=4)
        ok = same(a, b)
        print(f"snapshot-roundtrip [delta    |{precision:4s}] "
              f"{'bit-identical' if ok else 'MISMATCH'}")
        failures += 0 if ok else 1
        # mesh leg: 2 logical shards on this device keep the unsharded
        # ids, and the sharded save → load(mesh=) serves them again
        mesh = sharding_lib.ClusterMesh((dev,) * 2)
        snap_m = snap_p.with_mesh(mesh)
        a = Searcher(snap_p, backend=backends[0], device=dev).query(
            tok, msk, loc, k=5, cr=2, batch=4)
        b = Searcher(snap_m, backend=backends[0], device=dev).query(
            tok, msk, loc, k=5, cr=2, batch=4)
        tmp_m = os.path.join(root, precision + "-mesh")
        save(snap_m, tmp_m)
        c_ids, _ = Searcher(load(tmp_m, mesh=mesh, device=dev),
                            backend=backends[0], device=dev).query(
            tok, msk, loc, k=5, cr=2, batch=4)
        ok = (np.array_equal(a[0], b[0]) and np.array_equal(b[0], c_ids)
              and np.allclose(a[1], b[1], rtol=2e-5, atol=1e-6))
        print(f"snapshot-roundtrip [mesh S=2 |{precision:4s}] "
              f"{'ids bit-identical' if ok else 'MISMATCH'}")
        failures += 0 if ok else 1
    return failures


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="save → load → query round-trip self-test")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    failures = _roundtrip_selftest(device=args.device)
    print(f"snapshot-roundtrip: {failures} leg(s) disagree")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(_main())
