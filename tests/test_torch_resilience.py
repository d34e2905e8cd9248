"""The port's chaos tier against the reference's, on the CPU.

Every test of ``tests/test_resilience_serving.py`` runs here as a
scenario on both packages over one artifact (``test_torch_common.
Side``), keeping the reference test's assertions; the port's answers
and counters are then held to the reference's (ids equal, scores within
1e-5, ``test_torch_common.COUNTERS`` equal). The core invariant is the
reference's: zero lost acknowledged writes, zero torn reads — here at
all four crash points (``write.pre_publish``, ``write.post_publish``,
``wal.torn_tail``, and ``ckpt.mid_save`` inside ``server.checkpoint``).

The two packages meet at the WAL as at the snapshot: a log (and
snapshot) written by either is recovered by the other, records decoding
equal, buffers array-equal to the writing server's, answers at cr = c
equal; a torn tail written by one is dropped by the other.

Adapted, not changed in substance: the checkpoint tests call the port's
``ckpt.save(directory, step, leaves, treedef=...)`` (the reference's
takes a pytree), and every load names ``device="cpu"``. The reference's
process-global fault registry and the port's are cleared around every
test.
"""
import asyncio
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.checkpoint import ckpt as port_ckpt
from repro_torch.core import faults as port_faults
from repro_torch.core import server as port_server
from repro_torch.core import wal as port_wal
from repro_torch.distributed import resilience as port_resilience

from test_torch_common import (assert_same, both, make_sides,
                               saved_ref_snapshot)
from test_torch_common import serve_requests as make_requests


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Both registries are process-global: every test starts and ends
    clean, even when an injected Crash propagated out of the body."""
    from repro.core import faults as ref_faults
    ref_faults.clear()
    port_faults.clear()
    yield
    ref_faults.clear()
    port_faults.clear()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return make_sides(saved_ref_snapshot(tmp_path_factory, "resilience",
                                         seed=11, n_obj=96, capacity=64))


def insert_batch(server, rng, *, rows=6, base_id=10_000_000):
    """One acked insert batch; returns (emb, loc, ids) for the oracle."""
    d = int(np.asarray(server.engine.snapshot.buffers["emb"]).shape[-1])
    emb = rng.normal(size=(rows, d)).astype(np.float32)
    loc = rng.uniform(size=(rows, 2)).astype(np.float32)
    ids = np.arange(base_id, base_id + rows)
    server.insert_objects(emb, loc, ids)
    return emb, loc, ids


def full_fanout(server, tok, msk, loc, *, k=5):
    """Full-fanout dense query through the server's engine (every
    cluster scanned: a missing or extra row cannot hide behind
    routing)."""
    c = int(np.asarray(server.engine.snapshot.buffers["emb"]).shape[0])
    return server.engine.query(tok, msk, loc, k=k, cr=c, batch=len(tok),
                               backend="dense")


def _serve_cfg(s, **over):
    kw = dict(batch_size=4, max_delay_ms=30.0, k=5, cr=2, backend="dense",
              delta_threshold=1024)
    kw.update(over)
    return s.server_lib.ServerConfig(**kw)


def _dir(tmp_path, s, name):
    return str(tmp_path / s.which / name)


# ---------------------------------------------------------------------------
# Fault registry
# ---------------------------------------------------------------------------


def _unknown_point_rejected(s):
    with pytest.raises(ValueError, match="unknown fault point"):
        s.faults.inject("flush.typo", error=RuntimeError("x"))


def _error_and_callback_exclusive(s):
    with pytest.raises(ValueError, match="not both"):
        s.faults.inject("flush.engine", error=RuntimeError("x"),
                        callback=lambda: None)


def _times_semantics(s):
    s.faults.inject("flush.engine", error=RuntimeError("boom"), times=2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="boom"):
            s.faults.fire("flush.engine")
    assert s.faults.fire("flush.engine") is None     # disarmed after 2
    assert s.faults.fired("flush.engine") == 2
    assert not s.faults.active("flush.engine")


def _injected_clears_even_on_crash(s):
    with pytest.raises(s.faults.Crash):
        with s.faults.injected("write.pre_publish",
                               error=s.faults.Crash("died")):
            s.faults.fire("write.pre_publish")
    assert not s.faults.active("write.pre_publish")


def _crash_tears_through_except_exception(s):
    with pytest.raises(s.faults.Crash):
        try:
            raise s.faults.Crash("simulated SIGKILL")
        except Exception:                            # noqa: BLE001
            pytest.fail("Crash was caught by an `except Exception`")


@pytest.mark.parametrize("scenario", [
    _unknown_point_rejected, _error_and_callback_exclusive, _times_semantics,
    _injected_clears_even_on_crash, _crash_tears_through_except_exception,
], ids=lambda f: f.__name__.lstrip("_"))
def test_fault_registry(sides, scenario):
    both(sides, scenario)


def test_fault_points_match_reference():
    """The same instrumented sites; the registries are separate."""
    from repro.core import faults as ref_faults
    assert port_faults.POINTS == ref_faults.POINTS
    port_faults.inject("flush.engine")
    assert port_faults.active("flush.engine")
    assert not ref_faults.active("flush.engine")


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------


def _wal_roundtrip(s, tmp_path):
    path = _dir(tmp_path, s, "serving.wal")
    with s.wal_lib.WriteAheadLog(path) as wal:
        wal.append("insert", version=1,
                   emb=np.arange(6, dtype=np.float32).reshape(2, 3),
                   ids=np.array([7, 8]))
        wal.append("delete", version=2, ids=np.array([7]))
        assert wal.n_records == 2 and wal.last_version == 2
        recs = wal.records()
    assert [r["kind"] for r in recs] == ["insert", "delete"]
    assert [r["version"] for r in recs] == [1, 2]
    np.testing.assert_array_equal(
        recs[0]["emb"], np.arange(6, dtype=np.float32).reshape(2, 3))
    with s.wal_lib.WriteAheadLog(path) as wal:       # reopen: nothing lost
        assert wal.n_records == 2 and not wal.dropped_tail
    assert [r["version"] for r in s.wal_lib.replay(path)] == [1, 2]
    return recs


def _wal_torn_tail_dropped_on_reopen(s, tmp_path):
    path = _dir(tmp_path, s, "serving.wal")
    wal = s.wal_lib.WriteAheadLog(path)
    wal.append("insert", version=1, ids=np.array([1]))
    good_end = wal.nbytes()
    s.faults.inject("wal.torn_tail", callback=lambda nbytes, path: nbytes // 2)
    with pytest.raises(s.faults.Crash):
        wal.append("insert", version=2, ids=np.array([2]))
    wal.close()
    assert os.path.getsize(path) > good_end          # torn bytes exist
    wal2 = s.wal_lib.WriteAheadLog(path)             # reopen post-crash
    assert wal2.dropped_tail
    assert wal2.n_records == 1
    assert wal2.nbytes() == good_end                 # tail truncated
    wal2.append("insert", version=3, ids=np.array([3]))
    recs = wal2.records()
    assert [r["version"] for r in recs] == [1, 3]
    wal2.close()
    return dict(recs=recs, good_end=good_end)


def _wal_truncate(s, tmp_path):
    path = _dir(tmp_path, s, "serving.wal")
    with s.wal_lib.WriteAheadLog(path) as wal:
        wal.append("insert", version=1, ids=np.array([1]))
        wal.truncate()
        assert wal.n_records == 0 and wal.last_version == 0
        assert wal.records() == []
        wal.append("delete", version=5, ids=np.array([9]))
        assert [r["version"] for r in wal.records()] == [5]


def _wal_bad_magic(s, tmp_path):
    path = _dir(tmp_path, s, "serving.wal")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"NOTALIST" + b"\x00" * 32)
    with pytest.raises(s.wal_lib.WalCorrupt):
        s.wal_lib.WriteAheadLog(path)


@pytest.mark.parametrize("scenario", [
    _wal_roundtrip, _wal_torn_tail_dropped_on_reopen, _wal_truncate,
    _wal_bad_magic,
], ids=lambda f: f.__name__.lstrip("_"))
def test_wal(sides, tmp_path, scenario):
    both(sides, scenario, tmp_path)


def test_wal_format_matches_reference(tmp_path):
    """The same magic, header and kinds; a record encoded by either
    package decodes equal in the other (``np.savez`` stamps the zip
    entries with the time, so the bytes themselves may differ)."""
    from repro.core import wal as ref_wal
    assert port_wal.MAGIC == ref_wal.MAGIC == b"LISTWAL1"
    assert port_wal._HEADER.format == ref_wal._HEADER.format
    assert port_wal.KINDS == ref_wal.KINDS
    arrays = dict(emb=np.random.default_rng(0).normal(size=(3, 4)).astype(
        np.float32), loc=np.zeros((3, 2), np.float32),
        ids=np.arange(3), attrs=np.ones((3, 3), np.int32))
    for enc, dec in ((port_wal, ref_wal), (ref_wal, port_wal)):
        rec = dec.decode_record(enc.encode_record("insert", 7, arrays))
        assert rec["kind"] == "insert" and rec["version"] == 7
        for k, v in arrays.items():
            np.testing.assert_array_equal(rec[k], v)
            assert rec[k].dtype == v.dtype
    with pytest.raises(ValueError):
        port_wal.encode_record("upsert", 1, {})


# ---------------------------------------------------------------------------
# Checkpoint atomicity + corruption detection
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _ckpt_save(s, d, step, tree):
    if s.which == "ref":
        return s.ckpt.save(d, step, tree)
    return s.ckpt.save(d, step, [tree[k] for k in sorted(tree)],
                       treedef="b, w")


def _ckpt_restore(s, d, like):
    if s.which == "ref":
        return s.ckpt.restore(d, like)
    leaves, step, meta = s.ckpt.restore(d)
    return ({k: leaves[i].numpy() for i, k in enumerate(sorted(like))},
            step, meta)


def _ckpt_crash_mid_save_keeps_prior_step(s, tmp_path):
    d = _dir(tmp_path, s, "ckpt")
    t0 = _tree(0)
    _ckpt_save(s, d, 0, t0)
    s.faults.inject("ckpt.mid_save", error=s.faults.Crash("died mid-save"))
    with pytest.raises(s.faults.Crash):
        _ckpt_save(s, d, 1, _tree(1))
    assert s.ckpt.all_steps(d) == [0]                # never became visible
    got, step, _ = _ckpt_restore(s, d, t0)
    assert step == 0
    np.testing.assert_array_equal(got["w"], t0["w"])
    _ckpt_save(s, d, 1, _tree(1))                    # commits, GCs the .tmp
    assert s.ckpt.all_steps(d) == [0, 1]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    return got


def _ckpt_leaf_corruption_raises_snapshot_corrupt(s, tmp_path):
    d = _dir(tmp_path, s, "ckpt")
    t0 = _tree(0)
    path = _ckpt_save(s, d, 0, t0)
    leaf = next(p for p in sorted(os.listdir(path)) if p.endswith(".npy"))
    with open(os.path.join(path, leaf), "r+b") as f:
        f.seek(0)
        f.write(b"\xff" * 16)                        # bit-rot the header
    with pytest.raises(s.ckpt.SnapshotCorrupt):
        _ckpt_restore(s, d, t0)


def _ckpt_missing_leaf_raises_snapshot_corrupt(s, tmp_path):
    d = _dir(tmp_path, s, "ckpt")
    t0 = _tree(0)
    path = _ckpt_save(s, d, 0, t0)
    leaf = next(p for p in sorted(os.listdir(path)) if p.endswith(".npy"))
    os.remove(os.path.join(path, leaf))
    with pytest.raises(s.ckpt.SnapshotCorrupt, match="committed checkpoint"):
        _ckpt_restore(s, d, t0)


def _ckpt_garbage_manifest_raises_snapshot_corrupt(s, tmp_path):
    d = _dir(tmp_path, s, "ckpt")
    path = _ckpt_save(s, d, 0, _tree(0))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"meta": {"truncated mid-wri')
    with pytest.raises(s.ckpt.SnapshotCorrupt):
        s.ckpt.read_meta(d)


def _ckpt_post_commit_corruption_skipped_on_load(s, tmp_path):
    """``ckpt.post_commit`` hands the committed path to a callback that
    bit-rots a leaf: ``load_latest_good`` walks back to the prior step."""
    d = _dir(tmp_path, s, "snap")
    snap0 = s.snap
    snap0.save(d)
    snap1 = snap0.with_buffers(dict(snap0.buffers))   # version + 1

    def rot(path):
        leaf = sorted(p for p in os.listdir(path) if p.endswith(".npy"))[-1]
        with open(os.path.join(path, leaf), "r+b") as f:
            f.seek(200)
            f.write(b"\x5a" * 8)

    s.faults.inject("ckpt.post_commit", callback=rot)
    snap1.save(d)
    assert s.faults.fired("ckpt.post_commit") == 1
    assert s.ckpt.all_steps(d) == [snap0.meta.version, snap1.meta.version]
    loaded = s.load_latest_good(d)
    assert loaded.meta.version == snap0.meta.version
    return loaded.meta.version


def _load_latest_good_skips_corrupt_newest(s, tmp_path):
    d = _dir(tmp_path, s, "snap")
    snap0 = s.snap
    snap0.save(d)
    snap1 = snap0.with_buffers(dict(snap0.buffers))  # version + 1
    path1 = snap1.save(d)
    with open(os.path.join(path1, "manifest.json"), "w") as f:
        f.write("not json at all")
    loaded = s.load_latest_good(d)
    assert loaded.meta.version == snap0.meta.version
    path0 = os.path.join(d, f"step_{snap0.meta.version:09d}")
    with open(os.path.join(path0, "manifest.json"), "w") as f:
        f.write("also garbage")
    with pytest.raises(FileNotFoundError, match="corrupt"):
        s.load_latest_good(d)
    return loaded.meta.version


def _load_latest_good_empty_dir(s, tmp_path):
    d = _dir(tmp_path, s, "empty")
    os.makedirs(d)
    with pytest.raises(FileNotFoundError, match="no committed"):
        s.load_latest_good(d)


def _load_latest_good_only_corrupt(s, tmp_path):
    d = _dir(tmp_path, s, "snap")
    path0 = s.snap.save(d)
    with open(os.path.join(path0, "manifest.json"), "w") as f:
        f.write("{{{ definitely not a manifest")
    with pytest.raises(FileNotFoundError, match="corrupt"):
        s.load_latest_good(d)


@pytest.mark.parametrize("scenario", [
    _ckpt_crash_mid_save_keeps_prior_step,
    _ckpt_leaf_corruption_raises_snapshot_corrupt,
    _ckpt_missing_leaf_raises_snapshot_corrupt,
    _ckpt_garbage_manifest_raises_snapshot_corrupt,
    _ckpt_post_commit_corruption_skipped_on_load,
    _load_latest_good_skips_corrupt_newest, _load_latest_good_empty_dir,
    _load_latest_good_only_corrupt,
], ids=lambda f: f.__name__.lstrip("_"))
def test_checkpoint(sides, tmp_path, scenario):
    both(sides, scenario, tmp_path)


# ---------------------------------------------------------------------------
# The core invariant: zero lost acked writes, zero torn reads
# ---------------------------------------------------------------------------


def _crash_and_recover(s, tmp_path, crash_point):
    rng = np.random.default_rng(1)
    snap_dir = _dir(tmp_path, s, "snap")
    wal_dir = _dir(tmp_path, s, "wal")
    cfg = _serve_cfg(s, wal_dir=wal_dir)
    s.api.save(s.snap, snap_dir)
    victim = s.searcher().serve(cfg)
    acked = [insert_batch(victim, rng, base_id=10_000_000 + 100 * i)
             for i in range(2)]                      # both batches acked
    if crash_point == "ckpt.mid_save":
        # a delete acked too; the checkpoint dies before its commit
        victim.delete_objects(acked[0][2][:2])
        s.faults.inject(crash_point, error=s.faults.Crash("process died"))
        with pytest.raises(s.faults.Crash):
            victim.checkpoint(snap_dir)
    else:
        if crash_point == "wal.torn_tail":
            s.faults.inject(crash_point,
                            callback=lambda nbytes, path: nbytes // 3)
        else:
            s.faults.inject(crash_point,
                            error=s.faults.Crash("process died"))
        with pytest.raises(s.faults.Crash):
            insert_batch(victim, rng, base_id=10_000_500)
    victim.close()                                   # what a crash leaves
    recovered = s.recover(snap_dir, wal_dir, config=cfg, backend="dense")
    # at-least-once: an acked write is always recovered; an un-acked one
    # iff its WAL record survived intact
    expect = {"wal.torn_tail": 2, "ckpt.mid_save": 3}.get(crash_point, 3)
    assert recovered.stats.recovered_writes == expect
    assert recovered.wal.dropped_tail == (crash_point == "wal.torn_tail")
    # zero torn reads: answers equal a never-crashed server that applied
    # exactly the surviving records
    oracle = s.searcher().serve(_serve_cfg(s))       # same knobs, no WAL
    for rec in recovered.wal.records():
        if rec["kind"] == "insert":
            oracle.insert_objects(rec["emb"], rec["loc"], rec["ids"])
        else:
            oracle.delete_objects(rec["ids"])
    tok, msk, loc = make_requests(rng, 8, s.cfg)
    ids_r, sc_r = full_fanout(recovered, tok, msk, loc)
    ids_o, sc_o = full_fanout(oracle, tok, msk, loc)
    np.testing.assert_array_equal(ids_r, ids_o)
    np.testing.assert_array_equal(sc_r, sc_o)
    logged = [set(np.asarray(r["ids"]).tolist())
              for r in recovered.wal.records()]
    for _, _, batch_ids in acked:
        assert any(int(batch_ids[0]) in ids for ids in logged)
    recovered.close()
    return dict(out=(ids_r, sc_r), server=recovered)


@pytest.mark.parametrize("crash_point", [
    "write.pre_publish",        # WAL has the record, publish never ran
    "write.post_publish",       # published + logged, ack lost in flight
    "wal.torn_tail",            # died mid-append: record torn, dropped
    "ckpt.mid_save",            # checkpoint died before its commit
])
def test_recover_loses_no_acked_write(sides, tmp_path, crash_point):
    both(sides, _crash_and_recover, tmp_path, crash_point)


def _checkpoint_truncates_wal_and_recovers_clean(s, tmp_path):
    rng = np.random.default_rng(2)
    snap_dir = _dir(tmp_path, s, "snap")
    wal_dir = _dir(tmp_path, s, "wal")
    cfg = _serve_cfg(s, wal_dir=wal_dir)
    server = s.searcher().serve(cfg)
    for i in range(2):
        insert_batch(server, rng, base_id=11_000_000 + 100 * i)
    assert server.wal.n_records == 2
    server.checkpoint(snap_dir)
    assert server.wal.n_records == 0                 # log now redundant
    recovered = s.recover(snap_dir, wal_dir, config=cfg, backend="dense")
    assert recovered.stats.recovered_writes == 0
    tok, msk, loc = make_requests(rng, 8, s.cfg)
    ids_a, sc_a = full_fanout(server, tok, msk, loc)
    ids_b, sc_b = full_fanout(recovered, tok, msk, loc)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    server.close()
    recovered.close()
    return dict(out=(ids_b, sc_b), server=server, recovered=recovered)


def _replay_skips_records_already_in_snapshot(s, tmp_path):
    rng = np.random.default_rng(3)
    snap_dir = _dir(tmp_path, s, "snap")
    wal_dir = _dir(tmp_path, s, "wal")
    cfg = _serve_cfg(s, wal_dir=wal_dir)
    server = s.searcher().serve(cfg)
    insert_batch(server, rng, base_id=12_000_000)
    snap = server.compact_now()                      # the checkpoint,
    s.api.save(snap, snap_dir)                       # dying after save
    server.close()                                   # truncate never ran
    assert s.wal_lib.WriteAheadLog(
        s.wal_lib.wal_path(wal_dir)).n_records == 1
    recovered = s.recover(snap_dir, wal_dir, config=cfg, backend="dense")
    assert recovered.stats.recovered_writes == 0     # skipped by version
    tok, msk, loc = make_requests(rng, 8, s.cfg)
    ids_a, _ = full_fanout(server, tok, msk, loc)
    ids_b, sc_b = full_fanout(recovered, tok, msk, loc)
    np.testing.assert_array_equal(ids_a, ids_b)
    recovered.close()
    return dict(out=(ids_b, sc_b), recovered=recovered)


def _recover_with_missing_wal_dir(s, tmp_path):
    snap_dir = _dir(tmp_path, s, "snap")
    wal_dir = _dir(tmp_path, s, os.path.join("never_made", "wal"))
    s.api.save(s.snap, snap_dir)
    assert not os.path.isdir(wal_dir)
    recovered = s.recover(snap_dir, wal_dir, config=_serve_cfg(
        s, wal_dir=wal_dir), backend="dense")
    assert recovered.stats.recovered_writes == 0
    insert_batch(recovered, np.random.default_rng(4), base_id=16_000_000)
    assert recovered.wal.n_records == 1              # log now appendable
    recovered.close()
    return dict(recovered=recovered)


@pytest.mark.parametrize("scenario", [
    _checkpoint_truncates_wal_and_recovers_clean,
    _replay_skips_records_already_in_snapshot, _recover_with_missing_wal_dir,
], ids=lambda f: f.__name__.lstrip("_"))
def test_checkpoint_and_replay(sides, tmp_path, scenario):
    both(sides, scenario, tmp_path)


# ---------------------------------------------------------------------------
# Graceful degradation: breaker, shedding, slow-flush detection
# ---------------------------------------------------------------------------


def _breaker_trips_to_fallback_then_probes(s):
    # "auto" resolves to dense on a CPU engine: the primary and the
    # fallback differ by name, which arms the breaker
    server = s.server(backend="auto", batch_size=1, breaker_threshold=2,
                      breaker_probe_every=2, retry_backoff_ms=0.0)
    assert server._fallback_backend() == "dense"
    tok, msk, loc = make_requests(np.random.default_rng(5), 6, s.cfg)
    s.faults.inject("flush.engine", error=RuntimeError("XLA OOM"), times=2)

    async def go():
        outs = []
        for i in range(6):
            try:
                outs.append(await server.submit(tok[i], msk[i], loc[i]))
            except RuntimeError:
                outs.append(None)
        return outs

    outs = asyncio.run(go())
    assert outs[0] is None and outs[1] is None       # the two failures
    assert server.stats.breaker_trips == 1           # tripped on the 2nd
    assert server.stats.breaker_fallback_flushes == 2
    assert not server.metrics()["breaker"]["open"]
    ids_d, _ = s.engine().query(tok[2:], msk[2:], loc[2:], k=5, cr=2,
                                batch=1, backend="dense")
    for i, out in enumerate(outs[2:]):
        assert out is not None
        np.testing.assert_array_equal(out[0], ids_d[i])
    return dict(out=outs[2:], server=server)


def _breaker_disabled_without_fallback(s):
    server = s.server(batch_size=1, breaker_threshold=1,
                      retry_backoff_ms=0.0)          # backend="dense"
    assert server._fallback_backend() is None
    tok, msk, loc = make_requests(np.random.default_rng(6), 2, s.cfg)
    s.faults.inject("flush.engine", error=RuntimeError("boom"), times=1)

    async def go():
        with pytest.raises(RuntimeError, match="boom"):
            await server.submit(tok[0], msk[0], loc[0])
        return await server.submit(tok[1], msk[1], loc[1])

    out = asyncio.run(go())
    assert out is not None
    assert server.stats.breaker_trips == 0           # nothing to trip to
    return dict(out=out, server=server)


def _deadline_shed_at_flush(s):
    server = s.server(batch_size=8, max_delay_ms=30.0,
                      request_timeout_ms=1.0)
    tok, msk, loc = make_requests(np.random.default_rng(7), 3, s.cfg)

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(3)]
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = asyncio.run(go())
    assert all(isinstance(o, s.server_lib.DeadlineExceeded) for o in out)
    assert server.stats.shed["expired"] == 3
    assert server.stats.engine_batches == 0          # nothing was scored
    return dict(out=out, server=server)


def _deadline_shed_before_enqueue(s):
    server = s.server(request_timeout_ms=5.0)
    tok, msk, loc = make_requests(np.random.default_rng(8), 1, s.cfg)

    async def go():
        with pytest.raises(s.server_lib.DeadlineExceeded):
            await server.submit(tok[0], msk[0], loc[0],
                                t_arrival=time.perf_counter() - 1.0)

    asyncio.run(go())
    assert server.stats.shed["expired"] == 1
    return dict(server=server)


def _admission_shed_on_full_queue(s):
    server = s.server(batch_size=8, max_delay_ms=60_000.0, max_queue=2)
    tok, msk, loc = make_requests(np.random.default_rng(9), 3, s.cfg)

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(2)]
        await asyncio.sleep(0)                       # both now pending
        with pytest.raises(s.server_lib.Overloaded):
            await server.submit(tok[2], msk[2], loc[2])
        server.flush_now()                           # admitted ones finish
        return await asyncio.gather(*tasks)

    out = asyncio.run(go())
    assert len(out) == 2 and all(o is not None for o in out)
    assert server.stats.shed["queue_full"] == 1
    return dict(out=out, server=server)


def _coalesced_waiter_shares_its_shed(s):
    """A duplicate coalesced onto a request that is then shed fails with
    it, and ``stats.shed`` counts the one that held the slot: both
    packages account this way (the reference's behaviour, mirrored)."""
    server = s.server(batch_size=8, max_delay_ms=30.0,
                      request_timeout_ms=1.0)
    tok, msk, loc = make_requests(np.random.default_rng(15), 1, s.cfg)

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[0], msk[0], loc[0]))
                 for _ in range(2)]
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = asyncio.run(go())
    assert all(isinstance(o, s.server_lib.DeadlineExceeded) for o in out)
    assert server.stats.coalesced == 1
    assert server.stats.shed["expired"] == 1         # one of two failures
    return dict(out=out, server=server)


def _open_loop_shed_ok_accounts_for_every_arrival(s):
    server = s.server(batch_size=2, max_queue=2, request_timeout_ms=20.0,
                      cache_size=0)
    n = 24
    tok, msk, loc = make_requests(np.random.default_rng(10), n, s.cfg)
    reqs = [(tok[i], msk[i], loc[i]) for i in range(n)]
    results = asyncio.run(s.server_lib.open_loop(server, reqs, qps=5_000.0,
                                                 shed_ok=True))
    served = sum(1 for r in results if r is not None)
    shed = sum(server.stats.shed.values())
    assert served + shed == n                        # conservation
    assert served > 0                                # it kept serving
    # how many are shed depends on each package's speed: not compared
    return served + shed


def _slow_flush_counted_in_metrics(s):
    server = s.server(batch_size=1)
    for _ in range(20):                              # a steady history
        server._flush_monitor.record("flush", 1e-3)
    s.faults.inject("flush.slow", callback=lambda: time.sleep(0.2))
    tok, msk, loc = make_requests(np.random.default_rng(11), 1, s.cfg)

    async def go():
        return await server.submit(tok[0], msk[0], loc[0])

    out = asyncio.run(go())
    assert out is not None                           # slow, not failed
    assert server.stats.slow_flushes == 1
    assert server.metrics()["last_slow_flush_at"] is not None
    return dict(out=out, slow=server.stats.slow_flushes, server=server)


@pytest.mark.parametrize("scenario", [
    _breaker_trips_to_fallback_then_probes, _breaker_disabled_without_fallback,
    _deadline_shed_at_flush, _deadline_shed_before_enqueue,
    _admission_shed_on_full_queue,
    _coalesced_waiter_shares_its_shed,
    _open_loop_shed_ok_accounts_for_every_arrival,
    _slow_flush_counted_in_metrics,
], ids=lambda f: f.__name__.lstrip("_"))
def test_degradation(sides, scenario):
    both(sides, scenario)


def test_straggler_monitor_slow_unit():
    m = port_resilience.StragglerMonitor(window=8)
    for _ in range(3):
        m.record("flush", 1.0)
    assert not m.slow("flush")                       # not enough history
    for _ in range(5):
        m.record("flush", 1.0)
    assert not m.slow("flush")                       # steady stream
    m.record("flush", 10.0)
    assert m.slow("flush")                           # 10× the window
    m.record("flush", 1.0)
    assert not m.slow("flush")                       # back to normal


def test_straggler_monitor_flags_match_reference():
    """The fleet test (``flagged``) and the single-stream test give the
    reference's verdicts on the same seeded latency streams."""
    from repro.distributed import resilience as ref_resilience
    rng = np.random.default_rng(12)
    a, b = (port_resilience.StragglerMonitor(window=8, patience=2),
            ref_resilience.StragglerMonitor(window=8, patience=2))
    for step in range(30):
        for host in ("h0", "h1", "h2", "h3"):
            lat = float(rng.exponential()) + (5.0 if host == "h2"
                                              and step > 10 else 0.0)
            a.record(host, lat)
            b.record(host, lat)
        assert a.flagged() == b.flagged()
        assert [a.slow(h) for h in ("h0", "h2")] == \
            [b.slow(h) for h in ("h0", "h2")]


# ---------------------------------------------------------------------------
# WAL growth bound: auto-checkpoint off the write path
# ---------------------------------------------------------------------------


def _wal_max_bytes_requires_both_dirs(s, tmp_path):
    with pytest.raises(ValueError, match="wal_max_bytes"):
        s.server(wal_max_bytes=1024, wal_dir=_dir(tmp_path, s, "wal"))
    with pytest.raises(ValueError, match="wal_max_bytes"):
        s.server(wal_max_bytes=1024, snapshot_dir=_dir(tmp_path, s, "snap"))
    s.server(wal_max_bytes=1024, wal_dir=_dir(tmp_path, s, "wal"),
             snapshot_dir=_dir(tmp_path, s, "snap")).close()


def _wal_max_bytes_auto_checkpoints_and_truncates(s, tmp_path):
    rng = np.random.default_rng(13)
    snap_dir = _dir(tmp_path, s, "snap")
    wal_dir = _dir(tmp_path, s, "wal")
    cfg = _serve_cfg(s, wal_dir=wal_dir, snapshot_dir=snap_dir,
                     wal_max_bytes=1)         # any append crosses it
    server = s.searcher().serve(cfg)
    insert_batch(server, rng, base_id=14_000_000)
    assert server.stats.wal_checkpoints == 1
    assert server.wal.n_records == 0          # log truncated by the ckpt
    m = server.metrics()
    assert m["wal"]["max_bytes"] == 1
    assert m["wal"]["auto_checkpoints"] == 1
    insert_batch(server, rng, base_id=14_000_100)
    assert server.stats.wal_checkpoints == 2
    recovered = s.recover(snap_dir, wal_dir, config=cfg, backend="dense")
    assert recovered.stats.recovered_writes == 0     # all in the snapshot
    tok, msk, loc = make_requests(rng, 8, s.cfg)
    ids_a, sc_a = full_fanout(server, tok, msk, loc)
    ids_b, sc_b = full_fanout(recovered, tok, msk, loc)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    server.close()
    recovered.close()
    return dict(out=(ids_b, sc_b), server=server, recovered=recovered)


def _wal_below_threshold_never_checkpoints(s, tmp_path):
    cfg = _serve_cfg(s, wal_dir=_dir(tmp_path, s, "wal"),
                     snapshot_dir=_dir(tmp_path, s, "snap"),
                     wal_max_bytes=1 << 30)
    server = s.searcher().serve(cfg)
    insert_batch(server, np.random.default_rng(14), base_id=15_000_000)
    assert server.stats.wal_checkpoints == 0
    assert server.wal.n_records == 1
    server.close()
    return dict(server=server)


@pytest.mark.parametrize("scenario", [
    _wal_max_bytes_requires_both_dirs,
    _wal_max_bytes_auto_checkpoints_and_truncates,
    _wal_below_threshold_never_checkpoints,
], ids=lambda f: f.__name__.lstrip("_"))
def test_wal_growth_bound(sides, tmp_path, scenario):
    both(sides, scenario, tmp_path)


# ---------------------------------------------------------------------------
# Seeded retry-backoff jitter
# ---------------------------------------------------------------------------


def _backoff_jitter_sequence_is_seeded(s):
    server = s.server(retry_backoff_ms=2.0, retry_backoff_max_ms=20.0,
                      retry_jitter=0.25, retry_seed=123)
    got = [server._backoff_ms(d) for d in range(6)]
    ref_rng = np.random.default_rng(123)
    want = []
    for d in range(6):
        base = min(2.0 * 2 ** d, 20.0)
        want.append(base * (1.0 - 0.25 * float(ref_rng.random())))
    assert got == pytest.approx(want)
    for d, ms in enumerate(got):
        base = min(2.0 * 2 ** d, 20.0)
        assert 0.75 * base <= ms <= base
    twin = s.server(retry_backoff_ms=2.0, retry_backoff_max_ms=20.0,
                    retry_jitter=0.25, retry_seed=123)
    assert [twin._backoff_ms(d) for d in range(6)] == pytest.approx(got)
    return got


def _backoff_without_jitter_doubles_to_cap(s):
    server = s.server(retry_backoff_ms=2.0, retry_backoff_max_ms=20.0,
                      retry_jitter=0.0)
    got = [server._backoff_ms(d) for d in range(5)]
    assert got == [2.0, 4.0, 8.0, 16.0, 20.0]
    return got


@pytest.mark.parametrize("scenario", [
    _backoff_jitter_sequence_is_seeded, _backoff_without_jitter_doubles_to_cap,
], ids=lambda f: f.__name__.lstrip("_"))
def test_backoff(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# api facade: operational exceptions are import-stable
# ---------------------------------------------------------------------------


def test_api_exports_operational_exceptions():
    """Callers catch these by identity: the facade re-exports the
    defining classes, not copies."""
    assert api.Overloaded is port_server.Overloaded
    assert api.DeadlineExceeded is port_server.DeadlineExceeded
    assert api.SnapshotCorrupt is port_ckpt.SnapshotCorrupt
    assert api.ShardUnavailable is port_resilience.ShardUnavailable
    for name in ("Overloaded", "DeadlineExceeded", "SnapshotCorrupt",
                 "ShardUnavailable"):
        assert name in api.__all__
    assert issubclass(api.DeadlineExceeded, TimeoutError)
    assert issubclass(api.Overloaded, RuntimeError)


# ---------------------------------------------------------------------------
# Across the packages: each recovers the other's WAL and snapshot
# ---------------------------------------------------------------------------


def _writes(server, rng, *, crash=None):
    """The cross-package write sequence: two insert batches (with attrs),
    a delete of base and delta ids, a third insert — optionally torn at
    its WAL append."""
    from repro.core import filters as ref_filters
    d = server.engine.snapshot.cfg.d_model
    base = np.asarray(server.engine.snapshot.buffers["ids"])
    base = base[base >= 0]
    for i, first in enumerate((20_000, 20_100)):
        emb = rng.normal(size=(5, d)).astype(np.float32)
        loc = rng.uniform(size=(5, 2)).astype(np.float32)
        attrs = ref_filters.make_attrs(np.arange(5) % 3,
                                       1 << (np.arange(5) % 4), np.arange(5))
        server.insert_objects(emb, loc, np.arange(first, first + 5), attrs)
    server.delete_objects(np.array([int(base[0]), int(base[7]), 20_001]))
    emb = rng.normal(size=(4, d)).astype(np.float32)
    loc = rng.uniform(size=(4, 2)).astype(np.float32)
    if crash is not None:
        crash()
    server.insert_objects(emb, loc, np.arange(20_200, 20_204))


def _buffers_np(snap):
    out = {}
    for k in ("emb", "loc", "ids", "counts", "scale", "attrs"):
        v = snap.buffers[k]
        if isinstance(v, torch.Tensor):
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            v = v.cpu().numpy()
        else:
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                v = v.view(np.int16)
        out[k] = v
    return out


def _delta_np(snap):
    if snap.delta is None or snap.delta.is_empty:
        return None
    arrs = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in snap.delta.to_leaves().items()}
    arrs["emb"] = arrs["emb"].astype(np.float32)
    return arrs


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn_tail"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_package_recovery(sides, tmp_path, writer, torn):
    """The writer's server (WAL on) saves its snapshot, takes the write
    sequence — the last insert torn mid-append when ``torn`` — and dies;
    the other package recovers. Records decode equal in both packages,
    the recovered buffers and delta are array-equal to the writer's
    after replay, and answers at cr = c are equal."""
    w, r = (sides[0], sides[1]) if writer == "ref" else (sides[1], sides[0])
    snap_dir = str(tmp_path / "snap")
    wal_dir = str(tmp_path / "wal")

    def write(s):
        cfg = _serve_cfg(s, wal_dir=wal_dir)
        s.api.save(s.snap, snap_dir)
        srv = s.searcher().serve(cfg)
        crash = None
        if torn:
            def crash():
                s.faults.inject("wal.torn_tail",
                                callback=lambda nbytes, path: nbytes // 2)
        try:
            _writes(srv, np.random.default_rng(30), crash=crash)
        except s.faults.Crash:
            assert torn
        srv.close()
        return srv

    def recover(s):
        return s.recover(snap_dir, wal_dir,
                         config=_serve_cfg(s, wal_dir=wal_dir),
                         backend="dense")

    writer_srv = w.run(write)
    recovered = r.run(recover)
    n = 3 if torn else 4
    assert recovered.stats.recovered_writes == n
    assert recovered.wal.dropped_tail == torn
    # the log decodes equal in both packages
    from repro.core import wal as ref_wal
    path = port_wal.wal_path(wal_dir)
    assert_same(list(port_wal.replay(path)), list(ref_wal.replay(path)))
    assert len(list(port_wal.replay(path))) == n
    # buffers and delta array-equal to the writer's
    got, want = recovered.engine.snapshot, writer_srv.engine.snapshot
    assert got.meta.version == want.meta.version
    for k, v in _buffers_np(want).items():
        np.testing.assert_array_equal(_buffers_np(got)[k], v, err_msg=k)
    dg, dw = _delta_np(got), _delta_np(want)
    assert (dg is None) == (dw is None)
    for k in dw:
        np.testing.assert_array_equal(dg[k], dw[k], err_msg=k)
    # answers at cr = c
    tok, msk, loc = make_requests(np.random.default_rng(31), 8, w.cfg)
    with w.ctx():
        want_q = full_fanout(writer_srv, tok, msk, loc)
    with r.ctx():
        got_q = full_fanout(recovered, tok, msk, loc)
        recovered.close()
    assert_same(got_q, want_q)


def test_recovered_servers_agree_after_compaction(sides, tmp_path):
    """Both packages recover one reference-written WAL (each from its own
    copy: a checkpoint truncates the log), fold the delta with
    ``compact_now`` and checkpoint: the compacted buffers are
    array-equal and each package loads the other's checkpoint."""
    import shutil
    ref, port = sides
    snap_dir = str(tmp_path / "snap")
    wal_dir = str(tmp_path / "wal")

    def write(s):
        s.api.save(s.snap, snap_dir)
        srv = s.searcher().serve(_serve_cfg(s, wal_dir=wal_dir))
        _writes(srv, np.random.default_rng(32))
        srv.close()

    def fold(s):
        own = str(tmp_path / f"wal_{s.which}")
        shutil.copytree(wal_dir, own)
        srv = s.recover(snap_dir, own, config=_serve_cfg(s, wal_dir=own),
                        backend="dense")
        assert srv.stats.recovered_writes == 4
        snap = srv.compact_now()
        srv.checkpoint(str(tmp_path / f"ckpt_{s.which}"))
        assert srv.wal.n_records == 0
        srv.close()
        return snap

    ref.run(write)
    folded = {s.which: s.run(fold) for s in sides}
    a, b = _buffers_np(folded["port"]), _buffers_np(folded["ref"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with ref.ctx():
        from_port = ref.load(str(tmp_path / "ckpt_port"))
    from_ref = port.load(str(tmp_path / "ckpt_ref"))
    assert from_port.meta.version == from_ref.meta.version
    for k, v in _buffers_np(from_ref).items():
        np.testing.assert_array_equal(_buffers_np(from_port)[k], v, err_msg=k)
