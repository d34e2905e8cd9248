"""The port's shard fault tolerance against the reference's, on the CPU.

Every case of ``tests/test_shard_faults.py`` runs here on both packages
(``test_torch_common.Side``) over one artifact of c = 8 clusters, sharded
8 ways: the reference across its 8 forced host devices, the port into 8
logical CPU parts. Each scenario keeps the reference test's assertions
and returns its answers, coverage, ``shard_stats``, shard health (states,
failures, DOWN set) and ``metrics()`` shard block; the port's are held to
the reference's (ids equal, scores within 1e-5, counters equal). The one
exception is the straggler scenario, whose hedge and probe counts follow
wall-clock timing: it compares answers, coverage and the hedged set.

``TestShardHealth`` (pure host logic) runs every state-machine case on
both classes side by side. All failure branches are taken through the
real fault points (``shard.scan_error``, ``shard.scan_slow``,
``shard.device_lost``) of each package.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import index as ref_index
from repro.core import relevance as ref_relevance
from repro.core.snapshot import IndexSnapshot as RefSnapshot
from repro.distributed import resilience as ref_resilience
from repro_torch.core import faults as port_faults
from repro_torch.distributed import resilience as port_resilience

from test_torch_common import both, make_sides, ref_on_cpu, serve_requests

DIST_MAX = 1.4142
N_SHARDS = 8


@pytest.fixture(autouse=True)
def _disarm_faults():
    from repro.core import faults as ref_faults
    ref_faults.clear()
    port_faults.clear()
    yield
    ref_faults.clear()
    port_faults.clear()


def _build_ref_snap(n_clusters=8, seed=0, n=96, cap=32):
    """``tests/test_shard_faults.py``'s ``_build_snap``, with f32 compute
    so that both packages encode and route alike."""
    cfg = dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=512,
        max_len=8, spatial_t=50, n_clusters=n_clusters,
        index_mlp_hidden=(16,), compute_dtype="float32")
    rng = np.random.default_rng(seed)
    rel = ref_relevance.relevance_init(jax.random.PRNGKey(0), cfg)
    obj_emb = rng.normal(size=(n, cfg.d_model)).astype(np.float32)
    obj_loc = rng.uniform(size=(n, 2)).astype(np.float32)
    norm = ref_index.loc_normalizer(jnp.asarray(obj_loc))
    iparams = ref_index.index_init(jax.random.PRNGKey(1), cfg.d_model,
                                   n_clusters, hidden=(16,))
    feats = ref_index.build_features(jnp.asarray(obj_emb),
                                     jnp.asarray(obj_loc), norm)
    top = np.asarray(ref_index.assign_clusters(iparams, feats, top=2))
    buf = ref_index.build_cluster_buffers(top, obj_emb, obj_loc,
                                          n_clusters=n_clusters,
                                          capacity=cap)
    return RefSnapshot.from_parts(cfg, rel, iparams, norm, buf,
                                  dist_max=DIST_MAX)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shard_faults"))
    with ref_on_cpu():
        _build_ref_snap().save(d)
    return make_sides(d)


# ---------------------------------------------------------------------------
# ShardHealth state machine (pure host logic), both classes
# ---------------------------------------------------------------------------


@pytest.fixture(params=["ref", "port"])
def health_cls(request):
    return (ref_resilience if request.param == "ref"
            else port_resilience).ShardHealth


class TestShardHealth:
    def test_up_suspect_down_transitions(self, health_cls):
        h = health_cls(4, down_after=3)
        assert h.state(0) == "up" and not h.is_down(0)
        assert h.record_failure(0) == "suspect"
        assert h.record_failure(0) == "suspect"
        assert h.record_failure(0) == "down"
        assert h.is_down(0) and h.down_shards() == (0,)
        assert h.state(1) == "up"

    def test_success_clears_suspect_but_not_down(self, health_cls):
        h = health_cls(2, down_after=2)
        h.record_failure(0)
        assert h.state(0) == "suspect"
        h.record_success(0, 0.01)
        assert h.state(0) == "up"
        h.record_failure(1)
        h.record_failure(1)
        assert h.is_down(1)
        h.record_success(1, 0.01)
        assert h.is_down(1)                 # DOWN is sticky
        h.mark_up(1)
        assert h.state(1) == "up" and h.ewma(1) is None

    def test_failure_streak_resets_on_success(self, health_cls):
        h = health_cls(1, down_after=3)
        h.record_failure(0)
        h.record_failure(0)
        h.record_success(0, 0.01)
        h.record_failure(0)
        h.record_failure(0)
        assert h.state(0) == "suspect"

    def test_mark_down_is_immediate(self, health_cls):
        h = health_cls(3)
        h.mark_down(2)
        assert h.down_shards() == (2,)

    def test_ewma(self, health_cls):
        h = health_cls(1, alpha=0.5)
        h.record_success(0, 0.1)
        assert h.ewma(0) == pytest.approx(0.1)
        h.record_success(0, 0.2)
        assert h.ewma(0) == pytest.approx(0.15)

    def test_snapshot_shape(self, health_cls):
        h = health_cls(2)
        h.mark_down(1)
        view = h.snapshot()
        assert view["states"] == ["up", "down"]
        assert view["down"] == [1]
        assert len(view["ewma_s"]) == len(view["failures"]) == 2

    def test_validation(self, health_cls):
        with pytest.raises(ValueError):
            health_cls(0)
        with pytest.raises(ValueError):
            health_cls(2, down_after=0)


def test_shard_health_traces_match():
    """One random event stream through both classes: every state, streak
    and EWMA equal after every event."""
    rng = np.random.default_rng(0)
    ref = ref_resilience.ShardHealth(3, alpha=0.3, down_after=2)
    port = port_resilience.ShardHealth(3, alpha=0.3, down_after=2)
    for _ in range(200):
        s, ev = int(rng.integers(0, 3)), int(rng.integers(0, 4))
        u = float(rng.uniform())
        for h in (ref, port):
            if ev == 0:
                h.record_failure(s)
            elif ev == 1:
                h.record_success(s, u)
            elif ev == 2 and u < 0.1:
                h.mark_down(s)
            elif ev == 3 and u < 0.2:
                h.mark_up(s)
        assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# Helpers: each takes the side it runs on
# ---------------------------------------------------------------------------


def _sharded_searcher(s):
    """A fresh dense searcher over an 8-shard placement."""
    return s.searcher(s.snap.with_mesh(N_SHARDS), backend="dense")


def _full_fanout(searcher, tok, msk, loc, *, k=5):
    """cr = c, batch = n: coverage under one DOWN shard is exactly its
    share of clusters, with no padding rows."""
    c = int(searcher.snapshot.buffers["emb"].shape[0])
    return searcher.query(tok, msk, loc, k=k, cr=c, batch=len(tok))


def _masked_oracle(s, down_shard, shard_of):
    """The unsharded searcher whose view of ``down_shard``'s clusters is
    EMPTY: the corpus a degraded query serves."""
    g = np.flatnonzero(np.asarray(shard_of) == down_shard)
    buf = dict(s.snap.buffers)
    fills = {"ids": -1, "emb": 0, "loc": s.index_lib.PAD_LOC, "scale": 1,
             "counts": 0}
    for key, fill in fills.items():
        arr = np.array(buf[key])
        arr[g] = fill
        buf[key] = (torch.from_numpy(arr) if s.which == "port"
                    else arr)
    return s.searcher(dataclasses.replace(s.snap, buffers=buf),
                      backend="dense")


def _fail_shard(s, target):
    """Persistent scan_error on one shard (device AND replica attempts)."""
    def boom(shard):
        if shard == target:
            raise RuntimeError(f"injected: shard {shard} unscannable")
    s.faults.inject("shard.scan_error", callback=boom, times=None)


def _queries(s, n, seed):
    return serve_requests(np.random.default_rng(seed), n, s.cfg)


def _shard_view(engine):
    """What the two packages must agree on after a scenario."""
    h = engine._shard_health
    return dict(stats=dict(engine.shard_stats),
                coverage=engine.last_coverage,
                down=tuple(engine.last_down_shards),
                health=None if h is None else
                {k: v for k, v in h.snapshot().items() if k != "ewma_s"})


# ---------------------------------------------------------------------------
# Degraded partial-result serving
# ---------------------------------------------------------------------------


def _scan_error_degrades_coverage(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 16, 0)
    healthy = _full_fanout(searcher, tok, msk, loc)
    assert searcher.last_coverage == 1.0
    _fail_shard(s, 3)
    ids, scores = _full_fanout(searcher, tok, msk, loc)   # must not raise
    eng = searcher.engine
    health = eng._shard_health
    assert searcher.last_coverage == pytest.approx((N_SHARDS - 1) / N_SHARDS)
    assert eng.last_down_shards == (3,)
    assert eng.down_signature() == (3,)
    assert health.is_down(3)
    assert all(health.state(x) == "up" for x in range(N_SHARDS) if x != 3)
    oracle = _masked_oracle(s, 3, searcher.snapshot.shards.shard_of)
    o_ids, o_scores = _full_fanout(oracle, tok, msk, loc)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(scores, o_scores)
    assert not np.array_equal(ids, healthy[0])
    view1 = _shard_view(eng)
    retries = eng.shard_stats["scan_retries"]
    skips = eng.shard_stats["down_skips"]
    _full_fanout(searcher, tok, msk, loc)
    assert searcher.last_coverage == pytest.approx((N_SHARDS - 1) / N_SHARDS)
    assert eng.shard_stats["scan_retries"] == retries
    assert eng.shard_stats["down_skips"] > skips
    return dict(healthy=healthy, degraded=(ids, scores), view1=view1,
                view2=_shard_view(eng))


def _transient_error_recovers_via_host_retry(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 8, 1)
    healthy = _full_fanout(searcher, tok, msk, loc)

    def boom_once(shard):
        if shard == 0:
            raise RuntimeError("transient blip")
    s.faults.inject("shard.scan_error", callback=boom_once, times=1)
    ids, scores = _full_fanout(searcher, tok, msk, loc)
    eng = searcher.engine
    assert eng.shard_stats["scan_retries"] == 1
    assert eng.shard_stats["host_scans"] == 1
    assert searcher.last_coverage == 1.0
    assert eng._shard_health.state(0) == "up"
    np.testing.assert_array_equal(ids, healthy[0])
    np.testing.assert_array_equal(scores, healthy[1])
    return dict(out=(ids, scores), view=_shard_view(eng))


def _device_lost_marks_down_immediately(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 8, 2)

    def lost(shard):
        if shard == 1:
            raise RuntimeError("device pulled")
    s.faults.inject("shard.device_lost", callback=lost, times=None)
    out = _full_fanout(searcher, tok, msk, loc)
    eng = searcher.engine
    assert eng._shard_health.is_down(1)
    assert searcher.last_coverage == pytest.approx((N_SHARDS - 1) / N_SHARDS)
    assert eng.shard_stats["scan_retries"] == 0
    return dict(out=out, view=_shard_view(eng))


def _all_shards_down_raises_shard_unavailable(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 8, 3)
    s.faults.inject("shard.scan_error",
                    error=RuntimeError("everything is on fire"), times=None)
    with pytest.raises(s.api.ShardUnavailable) as e:
        _full_fanout(searcher, tok, msk, loc)
    return dict(err=e.value, view=_shard_view(searcher.engine))


@pytest.mark.parametrize("scenario", [
    _scan_error_degrades_coverage, _transient_error_recovers_via_host_retry,
    _device_lost_marks_down_immediately,
    _all_shards_down_raises_shard_unavailable,
], ids=lambda f: f.__name__.lstrip("_"))
def test_degraded(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# Hedged scans
# ---------------------------------------------------------------------------


def _straggler_shard_is_hedged_with_identical_results(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 8, 4)
    healthy = _full_fanout(searcher, tok, msk, loc)
    for _ in range(12):                       # slow() needs a history
        _full_fanout(searcher, tok, msk, loc)

    def crawl(shard):
        if shard == 2:
            time.sleep(0.25)
    s.faults.inject("shard.scan_slow", callback=crawl, times=None)
    _full_fanout(searcher, tok, msk, loc)     # the slow sample flags 2
    eng = searcher.engine
    assert 2 in eng._hedged
    ids, scores = _full_fanout(searcher, tok, msk, loc)   # now hedged
    assert eng.shard_stats["hedged_scans"] >= 1
    assert eng.shard_stats["host_scans"] >= 1
    assert searcher.last_coverage == 1.0
    assert eng._shard_health.state(2) == "up"
    np.testing.assert_array_equal(ids, healthy[0])
    np.testing.assert_array_equal(scores, healthy[1])
    return dict(out=(ids, scores), coverage=searcher.last_coverage,
                hedged_2=2 in eng._hedged)


def _hedge_probe_returns_to_fast_device(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 8, 5)
    eng = searcher.engine
    _full_fanout(searcher, tok, msk, loc)

    class NeverSlow(s.resilience.StragglerMonitor):
        def slow(self, host):
            return False
    eng._shard_monitor = NeverSlow()
    eng._hedged = {2: eng.hedge_probe_every - 1}
    out = _full_fanout(searcher, tok, msk, loc)
    assert 2 not in eng._hedged
    return dict(out=out, view=_shard_view(eng), hedged=dict(eng._hedged))


@pytest.mark.parametrize("scenario", [
    _straggler_shard_is_hedged_with_identical_results,
    _hedge_probe_returns_to_fast_device,
], ids=lambda f: f.__name__.lstrip("_"))
def test_hedging(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# Online shard recovery
# ---------------------------------------------------------------------------


def _recover_shard_restores_bit_parity(s):
    searcher = _sharded_searcher(s)
    tok, msk, loc = _queries(s, 16, 6)
    healthy = _full_fanout(searcher, tok, msk, loc)
    ver = searcher.snapshot.meta.version
    _fail_shard(s, 3)
    _full_fanout(searcher, tok, msk, loc)
    assert searcher.engine._shard_health.is_down(3)
    s.faults.clear()
    old_part = searcher.snapshot.shards.parts[3]
    searcher.engine.recover_shard(3)
    assert searcher.engine._shard_health.state(3) == "up"
    assert searcher.engine.down_signature() == ()
    assert searcher.engine.shard_stats["recoveries"] == 1
    assert searcher.snapshot.shards.parts[3] is not old_part
    assert searcher.snapshot.meta.version == ver
    ids, scores = _full_fanout(searcher, tok, msk, loc)
    assert searcher.last_coverage == 1.0
    np.testing.assert_array_equal(ids, healthy[0])
    np.testing.assert_array_equal(scores, healthy[1])
    fresh = _sharded_searcher(s)
    f_ids, f_scores = _full_fanout(fresh, tok, msk, loc)
    np.testing.assert_array_equal(ids, f_ids)
    np.testing.assert_array_equal(scores, f_scores)
    return dict(out=(ids, scores), view=_shard_view(searcher.engine))


def _recover_shard_validation(s):
    with pytest.raises(ValueError, match="not mesh-sharded"):
        s.searcher(backend="dense").engine.recover_shard(0)
    searcher = _sharded_searcher(s)
    with pytest.raises(ValueError, match="out of range"):
        searcher.engine.recover_shard(N_SHARDS)
    return True


@pytest.mark.parametrize("scenario", [
    _recover_shard_restores_bit_parity, _recover_shard_validation,
], ids=lambda f: f.__name__.lstrip("_"))
def test_recovery(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# Server integration: coverage surfacing, degraded-result cache keys
# ---------------------------------------------------------------------------


def _mk_server(s, **over):
    eng = _sharded_searcher(s).engine
    kw = dict(batch_size=1, max_delay_ms=5.0, k=5,
              cr=int(s.snap.buffers["emb"].shape[0]), backend="dense",
              near_cells=0)
    kw.update(over)
    return s.server_lib.StreamingServer(eng, s.server_lib.ServerConfig(**kw))


def _metrics_view(m):
    out = {k: m[k] for k in ("coverage", "n_shards",
                             "shard_bytes_per_device", "shard_stats",
                             "shard_recoveries")}
    out["shard_health"] = {k: v for k, v in m["shard_health"].items()
                           if k != "ewma_s"}
    return out


def _degraded_results_never_served_as_full_coverage(s):
    server = _mk_server(s)
    tok, msk, loc = _queries(s, 2, 7)
    oracle = _sharded_searcher(s)
    o_ids, _ = _full_fanout(oracle, tok, msk, loc)
    ids_b, _ = server.serve_all(tok[:1], msk[:1], loc[:1])
    assert server.stats.degraded_flushes == 0
    _fail_shard(s, 3)
    ids_c1, _ = server.serve_all(tok[1:], msk[1:], loc[1:])
    m1 = server.metrics()
    assert m1["coverage"]["last"] == pytest.approx((N_SHARDS - 1) / N_SHARDS)
    assert m1["coverage"]["degraded_flushes"] == 1
    assert m1["shard_health"]["down"] == [3]
    assert not np.array_equal(ids_c1[0], o_ids[1])
    hits = server.stats.exact_hits
    batches = server.stats.engine_batches
    ids_c2, _ = server.serve_all(tok[1:], msk[1:], loc[1:])
    assert server.stats.exact_hits == hits + 1
    assert server.stats.engine_batches == batches
    np.testing.assert_array_equal(ids_c1, ids_c2)
    s.faults.clear()
    server.recover_shard(3)
    batches = server.stats.engine_batches
    ids_c3, _ = server.serve_all(tok[1:], msk[1:], loc[1:])
    assert server.stats.engine_batches == batches + 1
    np.testing.assert_array_equal(ids_c3[0], o_ids[1])
    m2 = server.metrics()
    assert m2["coverage"]["last"] == 1.0
    assert m2["coverage"]["min"] == pytest.approx((N_SHARDS - 1) / N_SHARDS)
    assert m2["shard_recoveries"] == 1
    assert m2["shard_health"]["down"] == []
    return dict(ids=(ids_b, ids_c1, ids_c2, ids_c3), m1=_metrics_view(m1),
                m2=_metrics_view(m2), server=server)


def _subscription_dispatch_exactly_once_across_recovery(s):
    server = _mk_server(s, delta_threshold=10_000)
    tok, msk, loc = _queries(s, 1, 8)
    sub = server.subscribe(tok[0], msk[0], loc[0], threshold=-1e9)
    rng = np.random.default_rng(9)
    d = int(s.snap.buffers["emb"].shape[-1])

    def insert(base):
        emb = rng.normal(size=(4, d)).astype(np.float32)
        xy = rng.uniform(size=(4, 2)).astype(np.float32)
        ids = np.arange(base, base + 4)
        server.insert_objects(emb, xy, ids)
        return set(ids.tolist())

    ids1 = insert(30_000_000)
    notes1 = {n.object_id for n in sub.drain()}
    assert notes1
    _fail_shard(s, 2)
    server.serve_all(tok, msk, loc)
    s.faults.clear()
    server.recover_shard(2)
    assert sub.drain() == []
    ids2 = insert(31_000_000)
    notes2 = {n.object_id for n in sub.drain()}
    assert notes2 and notes2.isdisjoint(notes1)
    assert notes1 <= ids1 and notes2 <= ids2
    return dict(notes=(sorted(notes1), sorted(notes2)),
                m=_metrics_view(server.metrics()), server=server)


@pytest.mark.parametrize("scenario", [
    _degraded_results_never_served_as_full_coverage,
    _subscription_dispatch_exactly_once_across_recovery,
], ids=lambda f: f.__name__.lstrip("_"))
def test_server(sides, scenario):
    both(sides, scenario)


def test_fault_points_fire_in_the_sharded_scan(sides):
    """The three ``shard.*`` points fire once per shard per chunk on the
    port's sharded path (device_lost and scan_error always, scan_slow
    before device scans), as on the reference's."""
    def scenario(s):
        searcher = _sharded_searcher(s)
        tok, msk, loc = _queries(s, 8, 10)
        for point in ("shard.device_lost", "shard.scan_error",
                      "shard.scan_slow"):
            s.faults.inject(point, callback=lambda shard: None, times=None)
        searcher.query(tok, msk, loc, k=5, cr=2, batch=4)
        return {p: s.faults.fired(p) for p in
                ("shard.device_lost", "shard.scan_error", "shard.scan_slow")}

    want, got = both(sides, scenario)
    assert got == {p: 2 * N_SHARDS for p in got}


# ---------------------------------------------------------------------------
# The hedge floor (port only): a hedge must beat a replica scan
# ---------------------------------------------------------------------------


def _flag_shard_2(searcher, tok, msk, loc, s, sleep_s):
    """Slow shard 2's device scans by ``sleep_s`` for one query."""
    def crawl(shard):
        if shard == 2:
            time.sleep(sleep_s)
    s.faults.inject("shard.scan_slow", callback=crawl, times=None)
    try:
        return _full_fanout(searcher, tok, msk, loc)
    finally:
        s.faults.clear()


def test_replica_cost_floor_suppresses_spurious_hedges(sides):
    """On logical CPU parts nothing is measured (the reference's rule);
    with a replica cost of 1 s set for every shard, a device scan slowed
    by 0.3 s is flagged by the monitor but not hedged (a replica
    scan would cost more), and one slowed by 1.5 s is hedged, with the
    healthy answers bit for bit."""
    s = sides[1]
    assert s.which == "port"
    searcher = _sharded_searcher(s)
    eng = searcher.engine
    tok, msk, loc = _queries(s, 8, 11)
    healthy = _full_fanout(searcher, tok, msk, loc)
    for _ in range(12):                       # slow() needs a history
        _full_fanout(searcher, tok, msk, loc)
    assert eng.replica_scan_s == {}
    eng._hedged = {}                          # what host jitter flagged
    eng.replica_scan_s = {x: 1.0 for x in range(N_SHARDS)}
    before = dict(eng.shard_stats)
    _flag_shard_2(searcher, tok, msk, loc, s, 0.3)
    assert eng._shard_monitor.slow("shard2")
    assert eng._hedged == {}
    out = _full_fanout(searcher, tok, msk, loc)
    assert eng.shard_stats == before
    np.testing.assert_array_equal(out[0], healthy[0])
    _flag_shard_2(searcher, tok, msk, loc, s, 1.5)
    assert 2 in eng._hedged
    ids, scores = _full_fanout(searcher, tok, msk, loc)   # now hedged
    assert eng.shard_stats["hedged_scans"] >= 1
    np.testing.assert_array_equal(ids, healthy[0])
    np.testing.assert_array_equal(scores, healthy[1])


def test_hedge_floors_follow_the_placement(sides):
    """The floors hold for the placement they were measured on: a query
    on the same placement keeps them, and a new placement at the same
    shard count (a re-shard or a recovery publishes one) drops them."""
    s = sides[1]
    searcher = _sharded_searcher(s)
    eng = searcher.engine
    tok, msk, loc = _queries(s, 8, 13)
    healthy = _full_fanout(searcher, tok, msk, loc)
    floors = {x: 1.0 for x in range(N_SHARDS)}
    eng.replica_scan_s = dict(floors)
    _full_fanout(searcher, tok, msk, loc)
    assert eng.replica_scan_s == floors
    eng.publish(s.snap.with_mesh(N_SHARDS))
    ids, scores = _full_fanout(searcher, tok, msk, loc)
    assert eng.replica_scan_s == {}
    np.testing.assert_array_equal(ids, healthy[0])
    np.testing.assert_array_equal(scores, healthy[1])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_no_spurious_hedges(sides, cuda_device):
    """4 logical shards on one card, no fault: 0 hedged scans over 20
    chunks (host jitter may flag a 1 ms scan, but a replica scan copies
    the whole part and costs more). A shard slowed by 0.5 s is still
    hedged, its replica cost measured once, with the same answers."""
    from repro_torch.distributed import sharding as sh
    s = sides[1]
    snap = s.api.load(s.dir, device=cuda_device).with_mesh(
        sh.ClusterMesh((cuda_device,) * 4))
    searcher = s.api.Searcher(snap, backend="cuda", device=cuda_device)
    eng = searcher.engine
    tok, msk, loc = _queries(s, 80, 12)
    want = searcher.query(tok, msk, loc, k=5, cr=2, batch=4)
    assert eng.shard_stats["hedged_scans"] == 0
    c = int(searcher.snapshot.buffers["emb"].shape[0])
    healthy = searcher.query(tok[:8], msk[:8], loc[:8], k=5, cr=c, batch=8)
    _flag_shard_2(searcher, tok[:8], msk[:8], loc[:8], s, 0.5)
    assert 2 in eng._hedged and 2 in eng.replica_scan_s
    assert 0 < eng.replica_scan_s[2] < 0.5
    got = searcher.query(tok[:8], msk[:8], loc[:8], k=5, cr=c, batch=8)
    assert eng.shard_stats["hedged_scans"] >= 1
    np.testing.assert_array_equal(got[0], healthy[0])
    np.testing.assert_array_equal(got[1], healthy[1])
    assert want[0].shape == (80, 5)
