"""The port's streaming server against the reference's, on the CPU.

Every test of ``tests/test_server.py`` but one runs here as a scenario
on both packages over one artifact (``test_torch_common.Side``): the
reference's server on ``dense`` under ``ref_on_cpu``, the port's on
``dense`` on the CPU. Each scenario keeps the reference test's own
assertions, so both packages pass them; then the port's answers are
held to the reference's (ids equal, scores within 1e-5) and its
counters (``test_torch_common.COUNTERS``: flushes by reason, hits,
coalesced, invalidations, compactions by trigger, shed, retries, breaker
trips, WAL appends, recovered writes) must be equal.

``test_cli_backend_alias`` has its twin in ``test_torch_cli.py``, with
the port's command line. The ``cuda``-marked tests hold the ``cuda`` /
``cuda-cm`` / ``auto`` servers against a ``dense`` server on a CPU copy
and need a card.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import server as port_server

from test_torch_common import (assert_topk_match, both, make_sides,
                               saved_ref_snapshot)
from test_torch_common import serve_requests as make_requests


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(reference, port) over tests/test_server.py's geometry: 96
    objects in 4 clusters of 64 rows (headroom for inserts)."""
    return make_sides(saved_ref_snapshot(tmp_path_factory, "server",
                                         seed=11, n_obj=96, capacity=64))


def spy_on(eng):
    """Wrap eng.query with a call counter."""
    calls = []
    orig = eng.query

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    eng.query = counted
    return calls


def direct(eng, tok, msk, loc, *, k=5, cr=2, batch=4):
    """The oracle: the same queries straight through the engine."""
    return eng.query(tok, msk, loc, k=k, cr=cr, batch=batch, backend="dense")


def rows(rng, n, d):
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(size=(n, 2)).astype(np.float32))


def gather(server, tok, msk, loc, n):
    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(n)]
        return await asyncio.gather(*tasks)
    return asyncio.run(go())


# ---------------------------------------------------------------------------
# Flush triggers
# ---------------------------------------------------------------------------


def _flush_on_size(s):
    server = s.server(max_delay_ms=60_000.0)          # never fires
    tok, msk, loc = make_requests(np.random.default_rng(0), 4, s.cfg)
    out = gather(server, tok, msk, loc, 4)
    assert server.stats.flushes == {"size": 1, "deadline": 0, "drain": 0}
    ids_d, sc_d = direct(s.engine(), tok, msk, loc)
    for i, (ids, sc) in enumerate(out):
        assert np.array_equal(ids, ids_d[i]) and np.array_equal(sc, sc_d[i])
    return dict(out=out, server=server)


def _flush_on_deadline(s):
    server = s.server(batch_size=8, max_delay_ms=25.0)
    tok, msk, loc = make_requests(np.random.default_rng(1), 3, s.cfg)
    t0 = time.perf_counter()
    out = gather(server, tok, msk, loc, 3)
    assert time.perf_counter() - t0 >= 0.025          # waited for it
    assert server.stats.flushes == {"size": 0, "deadline": 1, "drain": 0}
    assert server.stats.engine_queries == 3           # partial batch
    ids_d, sc_d = direct(s.engine(), tok, msk, loc, batch=8)
    for i, (ids, sc) in enumerate(out):
        assert np.array_equal(ids, ids_d[i]) and np.array_equal(sc, sc_d[i])
    return dict(out=out, server=server)


def _bit_identical_across_flush_boundary(s):
    """10 requests through a batch-4 server → flushes [4, 4, 2]; the
    direct call chunks identically: every id and score bit equal."""
    server = s.server()
    tok, msk, loc = make_requests(np.random.default_rng(2), 10, s.cfg)
    ids_s, sc_s = server.serve_all(tok, msk, loc)
    assert server.stats.flushes["size"] == 2
    assert server.stats.engine_queries == 10
    ids_d, sc_d = direct(s.engine(), tok, msk, loc)
    assert np.array_equal(ids_s, ids_d) and np.array_equal(sc_s, sc_d)
    return dict(out=(ids_s, sc_s), server=server)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _cached_repeat_skips_engine(s):
    server = s.server(batch_size=2)
    calls = spy_on(server.engine)
    tok, msk, loc = make_requests(np.random.default_rng(3), 2, s.cfg)
    ids1, sc1 = server.serve_all(tok, msk, loc)
    assert len(calls) == 1
    ids2, sc2 = server.serve_all(tok, msk, loc)       # exact repeats
    assert len(calls) == 1                            # engine not invoked
    assert server.stats.exact_hits == 2
    assert np.array_equal(ids1, ids2) and np.array_equal(sc1, sc2)
    return dict(out=(ids1, sc1), calls=len(calls), server=server)


def _metrics_expose_raw_hit_counts(s):
    server = s.server(batch_size=1, near_cells=16)
    tok, msk, loc = make_requests(np.random.default_rng(4), 1, s.cfg)
    loc[0] = [0.403, 0.519]
    server.serve_all(tok, msk, loc)                   # miss
    server.serve_all(tok, msk, loc)                   # exact hit
    near = loc.copy()
    near[0] += 0.002                                  # same 1/16 cell
    server.serve_all(tok, msk, near)                  # near hit
    m = server.metrics()
    assert m["exact_hits"] == 1 and m["near_hits"] == 1
    assert m["requests"] == 3
    assert m["exact_hit_rate"] == pytest.approx(m["exact_hits"] / 3)
    assert m["near_hit_rate"] == pytest.approx(m["near_hits"] / 3)
    assert m["hit_rate"] == pytest.approx(
        (m["exact_hits"] + m["near_hits"]) / 3)
    return dict(metrics={k: m[k] for k in (
        "requests", "exact_hits", "near_hits", "hit_rate", "coalesced",
        "engine_batches", "engine_queries", "batch_fill", "flushes",
        "invalidations", "writes", "delta_rows", "tombstones",
        "compactions", "compaction_triggers", "shed", "flush_retries",
        "poisoned_requests", "breaker", "wal", "recovered_writes",
        "coverage", "n_shards")}, server=server)


def _inflight_duplicates_coalesce(s):
    server = s.server(batch_size=3, max_delay_ms=60_000.0)
    tok, msk, loc = make_requests(np.random.default_rng(5), 3, s.cfg)

    async def go():
        dup = asyncio.ensure_future(server.submit(tok[0], msk[0], loc[0]))
        dup2 = asyncio.ensure_future(server.submit(tok[0], msk[0], loc[0]))
        rest = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                for i in (1, 2)]
        return await asyncio.gather(dup, dup2, *rest)

    out = asyncio.run(go())
    assert server.stats.coalesced == 1
    assert server.stats.engine_queries == 3           # 3 unique rows only
    assert server.stats.flushes["size"] == 1
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])
    return dict(out=out, server=server)


def _near_duplicate_tier(s):
    server = s.server(batch_size=1, near_cells=16)
    calls = spy_on(server.engine)
    tok, msk, loc = make_requests(np.random.default_rng(6), 1, s.cfg)
    loc[0] = [0.403, 0.519]
    a = server.serve_all(tok, msk, loc)
    assert len(calls) == 1
    near = loc.copy()
    near[0] += 0.002                                  # same 1/16 cell
    b = server.serve_all(tok, msk, near)
    assert len(calls) == 1 and server.stats.near_hits == 1
    far = loc.copy()
    far[0] = [0.91, 0.08]                             # different cell
    c = server.serve_all(tok, msk, far)
    assert len(calls) == 2 and server.stats.near_hits == 1
    return dict(out=(a, b, c), calls=len(calls), server=server)


def _exact_lru_evicts(s):
    server = s.server(batch_size=1, cache_size=2)
    tok, msk, loc = make_requests(np.random.default_rng(7), 3, s.cfg)
    for i in range(3):                                # fills + evicts row 0
        server.serve_all(tok[i:i + 1], msk[i:i + 1], loc[i:i + 1])
    calls = spy_on(server.engine)
    server.serve_all(tok[0:1], msk[0:1], loc[0:1])    # evicted → recompute
    assert len(calls) == 1
    server.serve_all(tok[2:3], msk[2:3], loc[2:3])    # still resident
    assert len(calls) == 1
    return dict(calls=len(calls), server=server)


@pytest.mark.parametrize("scenario", [
    _flush_on_size, _flush_on_deadline, _bit_identical_across_flush_boundary,
    _cached_repeat_skips_engine, _metrics_expose_raw_hit_counts,
    _inflight_duplicates_coalesce, _near_duplicate_tier, _exact_lru_evicts,
], ids=lambda f: f.__name__.lstrip("_"))
def test_batching_and_caches(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# Invalidation on index mutation
# ---------------------------------------------------------------------------


def _insert_invalidates_and_stays_bit_identical(s):
    rng = np.random.default_rng(8)
    server = s.server(batch_size=2)
    calls = spy_on(server.engine)
    tok, msk, loc = make_requests(rng, 2, s.cfg)
    server.serve_all(tok, msk, loc)
    assert len(calls) == 1
    new_emb, new_loc = rows(rng, 5, s.cfg.d_model)
    server.insert_objects(new_emb, new_loc, np.arange(1000, 1005))
    assert server.stats.invalidations == 1
    ids_s, sc_s = server.serve_all(tok, msk, loc)
    assert len(calls) == 2                            # cache was dropped
    eng2 = s.engine(snap=server.engine.snapshot)      # the oracle
    ids_d, sc_d = direct(eng2, tok, msk, loc, batch=2)
    assert np.array_equal(ids_s, ids_d) and np.array_equal(sc_s, sc_d)
    snap_pub = server.engine.snapshot
    live = set(np.asarray(snap_pub.buffers["ids"]).ravel().tolist())
    if snap_pub.delta is not None:
        live |= snap_pub.delta.ids_live
    assert set(np.unique(ids_s)) <= live
    return dict(out=(ids_s, sc_s), server=server)


def _delete_invalidates(s):
    server = s.server(batch_size=1)
    calls = spy_on(server.engine)
    tok, msk, loc = make_requests(np.random.default_rng(9), 1, s.cfg)
    ids1, _ = server.serve_all(tok, msk, loc)
    victims = [int(i) for i in ids1[0] if i >= 0][:2]
    server.delete_objects(victims)
    ids2, sc2 = server.serve_all(tok, msk, loc)
    assert len(calls) == 2                            # recomputed
    assert not set(victims) & set(ids2[0].tolist())   # victims gone
    return dict(out=(ids1, ids2, sc2), server=server)


def _inflight_key_is_versioned_across_publish(s):
    """A request arriving just after a publish must not coalesce onto a
    pre-publish future: a fresh engine answer comes back."""
    rng = np.random.default_rng(10)
    server = s.server(batch_size=1)
    tok, msk, loc = make_requests(rng, 1, s.cfg)

    async def go():
        server._adopt_loop(asyncio.get_running_loop())
        ver0 = server.engine.snapshot.meta.version
        ekey = s.server_lib.exact_key(
            np.ascontiguousarray(tok[0]), np.ascontiguousarray(msk[0]),
            np.ascontiguousarray(loc[0]), server.cfg.k, server.cfg.cr)
        stale = asyncio.get_running_loop().create_future()
        stale.set_result(("stale-ids", "stale-scores"))
        server._inflight[(ver0, (), ekey)] = stale   # pre-publish in-flight
        emb, pts = rows(rng, 2, s.cfg.d_model)
        server.insert_objects(emb, pts, np.arange(4000, 4002))
        return await server.submit(tok[0], msk[0], loc[0])

    ids, scores = asyncio.run(go())
    assert server.stats.coalesced == 0            # did NOT share the future
    assert isinstance(ids, np.ndarray)            # fresh answer
    ids_d, sc_d = direct(s.engine(snap=server.engine.snapshot), tok, msk,
                         loc, batch=1)
    assert np.array_equal(ids, ids_d[0]) and np.array_equal(scores, sc_d[0])
    return dict(out=(ids, scores), server=server)


@pytest.mark.parametrize("scenario", [
    _insert_invalidates_and_stays_bit_identical, _delete_invalidates,
    _inflight_key_is_versioned_across_publish,
], ids=lambda f: f.__name__.lstrip("_"))
def test_invalidation(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# The LSM write path: delta accumulation, compaction triggers
# ---------------------------------------------------------------------------


def _base_ids(snap):
    return np.asarray(snap.buffers["ids"])


def _delta_accumulates_then_compacts(s):
    rng = np.random.default_rng(11)
    server = s.server(delta_threshold=8)
    snap0 = server.engine.snapshot
    emb, loc = rows(rng, 5, s.cfg.d_model)
    snap1 = server.insert_objects(emb, loc, np.arange(3000, 3005))
    assert snap1.meta.delta_rows == 5
    assert np.array_equal(_base_ids(snap1), _base_ids(snap0))
    victims = _base_ids(snap0)[0, :2].tolist()
    snap2 = server.delete_objects(victims)
    assert snap2.meta.n_tombstones == 2 and server.stats.compactions == 0
    emb, loc = rows(rng, 1, s.cfg.d_model)            # 5 + 2 + 1 = 8
    snap3 = server.insert_objects(emb, loc, np.array([3005]))
    assert server.stats.compactions == 1
    assert server.stats.compaction_triggers["size"] == 1
    assert snap3.delta is None and snap3.meta.delta_rows == 0
    ids = _base_ids(snap3)
    assert ((ids >= 3000) & (ids <= 3005)).sum() == 6
    assert not np.isin(ids, victims).any()
    assert server.stats.writes == 3
    return dict(ids=ids, counts=np.asarray(snap3.buffers["counts"]),
                versions=[x.meta.version for x in (snap1, snap2, snap3)],
                server=server)


def _compaction_defers_to_loop_tick(s):
    rng = np.random.default_rng(12)
    server = s.server(delta_threshold=4)

    async def go():
        server._adopt_loop(asyncio.get_running_loop())
        emb, loc = rows(rng, 4, s.cfg.d_model)
        snap = server.insert_objects(emb, loc, np.arange(3100, 3104))
        assert snap.meta.delta_rows == 4          # not folded in-call
        assert server.stats.compactions == 0
        await asyncio.sleep(0)                    # one tick
        assert server.engine.snapshot.delta is None

    asyncio.run(go())
    assert server.stats.compactions == 1
    ids = _base_ids(server.engine.snapshot)
    assert (ids >= 3100).sum() == 4
    return dict(ids=ids, server=server)


def _imbalance_trigger_compacts(s):
    server = s.server(delta_threshold=10 ** 6, max_imbalance=1.5)
    ids = _base_ids(server.engine.snapshot)
    counts = np.asarray(server.engine.snapshot.buffers["counts"])
    keep = int(counts.argmax())
    victims = [int(i) for c in range(ids.shape[0]) if c != keep
               for i in ids[c][ids[c] >= 0][2:]]   # leave 2 per other cluster
    server.delete_objects(victims)
    assert server.stats.compactions == 1
    assert server.stats.compaction_triggers["imbalance"] == 1
    snap = server.engine.snapshot
    assert snap.delta is None
    assert not np.isin(_base_ids(snap), victims).any()
    return dict(ids=_base_ids(snap), server=server)


def _eager_path_when_delta_disabled(s):
    rng = np.random.default_rng(13)
    server = s.server(delta_threshold=0)
    emb, loc = rows(rng, 3, s.cfg.d_model)
    snap = server.insert_objects(emb, loc, np.arange(3200, 3203))
    assert snap.delta is None and snap.meta.delta_rows == 0
    assert (_base_ids(snap) >= 3200).sum() == 3
    snap2 = server.delete_objects([3200])
    assert not (_base_ids(snap2) == 3200).any()
    assert server.stats.compactions == 0          # nothing to fold
    assert server.stats.writes == 2
    return dict(ids=(_base_ids(snap), _base_ids(snap2)), server=server)


@pytest.mark.parametrize("scenario", [
    _delta_accumulates_then_compacts, _compaction_defers_to_loop_tick,
    _imbalance_trigger_compacts, _eager_path_when_delta_disabled,
], ids=lambda f: f.__name__.lstrip("_"))
def test_write_path(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# Loop hygiene, frozen results, failure isolation, drain, warm-up
# ---------------------------------------------------------------------------


def _stale_loop_state_is_dropped(s):
    server = s.server(batch_size=2, max_delay_ms=25.0)
    tok, msk, loc = make_requests(np.random.default_rng(14), 3, s.cfg)
    orig = server.engine.query
    server.engine.query = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("engine down"))

    async def aborted():
        t = asyncio.ensure_future(server.submit(tok[0], msk[0], loc[0]))
        await asyncio.sleep(0)
        server.flush_now()
        await t

    with pytest.raises(RuntimeError):
        asyncio.run(aborted())
    server._pending.append("stale-sentinel")      # an abort's leftover
    server.engine.query = orig
    ids_s, sc_s = server.serve_all(tok, msk, loc)     # fresh loop: works
    assert server.n_pending == 0
    ids_d, sc_d = direct(s.engine(), tok, msk, loc, batch=2)
    assert np.array_equal(ids_s, ids_d) and np.array_equal(sc_s, sc_d)
    return dict(out=(ids_s, sc_s), server=server)


def _results_are_frozen(s):
    server = s.server(batch_size=1)
    tok, msk, loc = make_requests(np.random.default_rng(15), 1, s.cfg)

    async def go():
        return await server.submit(tok[0], msk[0], loc[0])

    ids1, sc1 = asyncio.run(go())
    with pytest.raises(ValueError):
        ids1[0] = -7
    ids2, _ = asyncio.run(go())                   # exact hit, unpolluted
    assert np.array_equal(ids1, ids2)
    return dict(out=(ids1, sc1), server=server)


def _poisoned_request_fails_alone(s):
    server = s.server(retry_backoff_ms=0.0)
    tok, msk, loc = make_requests(np.random.default_rng(16), 4, s.cfg)
    poison = tok[1]
    orig = server.engine.query

    def flaky(t, m, l, **kw):
        if (np.asarray(t) == poison).all(axis=1).any():
            raise RuntimeError("poisoned row")
        return orig(t, m, l, **kw)

    server.engine.query = flaky

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(4)]
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = asyncio.run(go())
    assert isinstance(out[1], RuntimeError)           # the poison, alone
    server.engine.query = orig
    ids_d, sc_d = direct(s.engine(), tok, msk, loc)
    for i in (0, 2, 3):
        assert np.array_equal(out[i][0], ids_d[i])
        assert np.array_equal(out[i][1], sc_d[i])
    assert server.stats.poisoned_requests == 1
    assert server.stats.flush_retries >= 1
    ids_s, sc_s = server.serve_all(tok, msk, loc)     # healthy afterwards
    assert np.array_equal(ids_s, ids_d) and np.array_equal(sc_s, sc_d)
    return dict(out=out, after=(ids_s, sc_s), server=server)


def _drain_under_load_with_pending_compaction(s):
    rng = np.random.default_rng(17)
    server = s.server(max_delay_ms=60_000.0, delta_threshold=4,
                      request_timeout_ms=10_000.0)
    tok, msk, loc = make_requests(rng, 6, s.cfg)

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(6)]
        await asyncio.sleep(0)       # size flush of 4; 2 queued on timer
        emb, pts = rows(rng, 4, s.cfg.d_model)
        server.insert_objects(emb, pts, np.arange(4000, 4004))
        assert server._compaction_handle is not None  # queued, not run
        return await server._drain(tasks)

    out = asyncio.run(go())
    assert len(out) == 6 and all(o is not None for o in out)
    assert server.n_pending == 0
    assert server.stats.shed == {"expired": 0, "queue_full": 0,
                                 "cancelled": 0}
    assert server.stats.compactions == 1
    assert server.engine.snapshot.delta is None
    return dict(out=out, server=server)


def _cancelled_request_frees_its_slot(s):
    server = s.server(batch_size=8, max_delay_ms=60_000.0)
    tok, msk, loc = make_requests(np.random.default_rng(18), 3, s.cfg)

    async def go():
        tasks = [asyncio.ensure_future(server.submit(tok[i], msk[i], loc[i]))
                 for i in range(3)]
        await asyncio.sleep(0)
        tasks[1].cancel()
        await asyncio.sleep(0)
        server.flush_now()
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = asyncio.run(go())
    assert isinstance(out[1], asyncio.CancelledError)
    assert server.stats.shed["cancelled"] == 1
    assert server.stats.engine_queries == 2           # live rows only
    ids_d, sc_d = direct(s.engine(), tok, msk, loc, batch=8)
    for i in (0, 2):
        assert np.array_equal(out[i][0], ids_d[i])
        assert np.array_equal(out[i][1], sc_d[i])
    return dict(out=out, server=server)


def _warmup_pretraces_the_flush_plan(s):
    server = s.server()
    compiles = server.warmup()
    assert set(compiles) == {"dense@4"} and compiles["dense@4"] > 0
    plans_after_warmup = set(server.engine._plans)
    # key = (batch, k, cr, backend, precision, filtered)
    assert (4, 5, 2, "dense", "f32", False) in plans_after_warmup
    tok, msk, loc = make_requests(np.random.default_rng(19), 4, s.cfg)
    out = server.serve_all(tok, msk, loc)
    # serving built no new plan: the warm-up ran the real flush path
    assert set(server.engine._plans) == plans_after_warmup
    assert server.engine.last_dedup_factor is None
    return dict(out=out, server=server)


@pytest.mark.parametrize("scenario", [
    _stale_loop_state_is_dropped, _results_are_frozen,
    _poisoned_request_fails_alone, _drain_under_load_with_pending_compaction,
    _cancelled_request_frees_its_slot, _warmup_pretraces_the_flush_plan,
], ids=lambda f: f.__name__.lstrip("_"))
def test_failure_isolation_and_warmup(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# The port's own surface
# ---------------------------------------------------------------------------


def test_server_config_matches_reference():
    """Same fields, same defaults (the reference CLI's knobs)."""
    import dataclasses
    from repro.core import server as ref_server
    assert ([(f.name, f.default) for f in
             dataclasses.fields(port_server.ServerConfig)]
            == [(f.name, f.default) for f in
                dataclasses.fields(ref_server.ServerConfig)])
    assert port_server.LATENCY_WINDOW == ref_server.LATENCY_WINDOW


def test_load_generators_and_helpers_match_reference():
    """``zipf_sample``, ``latency_percentiles``, the cache keys and the
    LRU give the reference's values on the same inputs."""
    from repro.core import server as ref_server
    for a in (0.0, 1.05):
        got = port_server.zipf_sample(np.random.default_rng(3), 50, 200, a=a)
        want = ref_server.zipf_sample(np.random.default_rng(3), 50, 200, a=a)
        np.testing.assert_array_equal(got, want)
    lat = np.random.default_rng(4).exponential(size=500)
    assert port_server.latency_percentiles(lat) == \
        ref_server.latency_percentiles(lat)
    assert port_server.latency_percentiles([]) == \
        ref_server.latency_percentiles([])
    tok = np.arange(8, dtype=np.int32)
    msk = tok % 3 != 0
    loc = np.array([0.41, 0.77], np.float32)
    for fsig in (None, (1, 0, -5, 5)):
        assert port_server.exact_key(tok, msk, loc, 5, 2, fsig) == \
            ref_server.exact_key(tok, msk, loc, 5, 2, fsig)
        assert port_server.near_key(tok, msk, loc, 5, 2, 16, fsig) == \
            ref_server.near_key(tok, msk, loc, 5, 2, 16, fsig)
    lru = port_server.LRUCache(2)
    for key in "abc":
        lru.put(key, key)
    assert lru.get("a") is None and lru.get("c") == "c" and len(lru) == 2


def test_filter_signature_matches_reference():
    from repro.core import filters as ref_filters
    from repro_torch.core import filters as port_filters
    cases = [None, "noop", (1, 0), [None, (2, 3)], [None, "noop"]]

    def spec(pkg, c):
        if c is None:
            return None
        if c == "noop":
            return pkg.FilterSpec()
        return pkg.FilterSpec(tenant=c[0], category_mask=c[1])

    for c in cases:
        if isinstance(c, list):
            a = [spec(port_filters, x) for x in c]
            b = [spec(ref_filters, x) for x in c]
        else:
            a, b = spec(port_filters, c), spec(ref_filters, c)
        assert port_filters.filter_signature(a) == \
            ref_filters.filter_signature(b)


def test_port_server_takes_tensors(sides):
    """Write batches and requests may be tensors: the server copies them
    to the host (the WAL logs numpy) and answers as for numpy."""
    port = sides[1]
    rng = np.random.default_rng(20)
    a = port.server(batch_size=2)
    b = port.server(batch_size=2)
    emb, loc = rows(rng, 3, port.cfg.d_model)
    ids = np.arange(5000, 5003)
    a.insert_objects(emb, loc, ids)
    b.insert_objects(torch.from_numpy(emb), torch.from_numpy(loc),
                     torch.from_numpy(ids))
    tok, msk, qloc = make_requests(rng, 2, port.cfg)
    got = b.serve_all(torch.from_numpy(tok), torch.from_numpy(msk),
                      torch.from_numpy(qloc))
    want = a.serve_all(tok, msk, qloc)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_serve_defaults_to_cuda(sides):
    """``Searcher`` and ``api.recover`` default to the CUDA device and
    refuse to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Searcher(sides[1].snap).serve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.recover(sides[1].dir)


def test_fallback_backend_on_the_cpu(sides):
    """On a CPU engine the breaker's fallbacks are the reference's
    mapping; a backend that is its own fallback has none."""
    port = sides[1]
    for backend, want in (("auto", "dense"), ("dense", None),
                          ("dense-cm", None), (None, None)):
        srv = port.server(backend=backend,
                          engine_backend="auto" if backend == "auto"
                          else "dense")
        assert srv._fallback_backend() == want, backend


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda-cm", "auto"])
def test_cuda_server_matches_dense(cuda_device, sides, backend):
    """A server on the card against a ``dense`` server on a CPU copy:
    micro-batched answers, a write, a compaction; ids up to ties."""
    port = sides[1]
    rng = np.random.default_rng(21)
    snap = api.load(port.dir, device=cuda_device)
    gpu = api.Searcher(snap, backend=backend, device=cuda_device).serve(
        port_server.ServerConfig(batch_size=4, max_delay_ms=30.0, k=5,
                                 cr=2, backend=backend, delta_threshold=6))
    cpu = port.server(delta_threshold=6)
    tok, msk, loc = make_requests(rng, 10, port.cfg)
    emb, pts = rows(rng, 5, port.cfg.d_model)
    for srv in (gpu, cpu):
        srv.insert_objects(emb, pts, np.arange(7000, 7005))
    got, want = gpu.serve_all(tok, msk, loc), cpu.serve_all(tok, msk, loc)
    assert_topk_match(got[0], got[1], want[0], want[1], atol=1e-4)
    for srv in (gpu, cpu):
        srv.delete_objects([7000, int(want[0][0, 0])])   # 4 rows + 2: 6
    assert gpu.stats.compactions == cpu.stats.compactions == 1
    got, want = gpu.serve_all(tok, msk, loc), cpu.serve_all(tok, msk, loc)
    assert_topk_match(got[0], got[1], want[0], want[1], atol=1e-4)
    assert gpu.stats.breaker_trips == 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda-cm", "auto", None])
def test_cuda_breaker_has_no_fallback(cuda_device, sides, backend):
    """On a CUDA engine no flush gives way to a plain version."""
    snap = api.load(sides[1].dir, device=cuda_device)
    srv = api.Searcher(snap, device=cuda_device).serve(
        port_server.ServerConfig(backend=backend))
    assert srv._fallback_backend() is None
