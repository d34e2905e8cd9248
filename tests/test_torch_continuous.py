"""The port's standing queries against the reference's, on the CPU.

Every test of ``tests/test_continuous.py`` runs here as a scenario on
both packages over one artifact (``test_torch_common.Side``), with the
reference test's own assertions and oracle (argmax assignment, the
predicate, the serve-form score of the QUANTIZED rows — written per
package with its own functions). The port's notifications are then
held to the reference's: the same (subscription, object, version)
triples in the same order, scores within 1e-5; server counters equal.

A ``cuda``-marked test dispatches on the card against a CPU copy.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import both, make_sides, saved_ref_snapshot
from test_torch_common import serve_requests as mk_queries


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(reference, port) over tests/test_continuous.py's geometry: 96
    objects in 4 clusters of 96 rows, filter attributes."""
    return make_sides(saved_ref_snapshot(tmp_path_factory, "continuous",
                                         seed=19, n_obj=96, capacity=96))


def mk_server(s, **over):
    kw = dict(batch_size=4, max_delay_ms=30.0, k=8, cr=2, backend="dense")
    kw.update(over)
    return s.server(**kw)


def mk_batch(s, rng, m, first_id, *, tenant=None, ts=None):
    emb = rng.normal(size=(m, s.cfg.d_model)).astype(np.float32)
    loc = rng.uniform(size=(m, 2)).astype(np.float32)
    ids = np.arange(first_id, first_id + m, dtype=np.int32)
    from repro.core import filters as ref_filters       # numpy only
    attrs = ref_filters.make_attrs(
        np.arange(m) % 3 if tenant is None else np.full(m, tenant),
        np.full(m, 0b1),
        np.arange(m) if ts is None else np.full(m, ts))
    return emb, loc, ids, attrs


def oracle_matches(s, server, sub, emb, loc, ids, attrs):
    """The match semantics computed independently of the registry, with
    the side's own functions: argmax assignment, the predicate, the
    serve-form score of the QUANTIZED rows."""
    snap = server.engine.snapshot
    m = len(ids)
    il, fl, el = s.index_lib, s.filters, s.engine_lib
    fv = (sub.filters or fl.NOOP_FILTER).to_fvals()
    int8 = snap.meta.precision == "int8"
    if s.which == "ref":
        feats = il.build_features(np.asarray(emb, np.float32),
                                  np.asarray(loc, np.float32), snap.norm)
        assign = np.asarray(il.assign_clusters(snap.index_params, feats,
                                               top=1)).reshape(m)
        stored, scale = il.quantize_rows(np.asarray(emb, np.float32),
                                         snap.meta.precision)
        pred = fl.predicate_mask_np(attrs, fv[None])
        sc = np.asarray(el.score_candidates(
            sub.q_emb[None], sub.loc[None], sub.w_st[None], stored[None],
            np.asarray(loc, np.float32)[None],
            np.asarray(ids, np.int32)[None], np.asarray(snap.w_hat),
            dist_max=snap.meta.dist_max,
            cand_scale=scale[None] if int8 else None))[0]
    else:
        e, l_ = torch.from_numpy(emb), torch.from_numpy(loc)
        feats = il.build_features(e, l_, snap.norm)
        assign = il.assign_clusters(snap.index, feats, top=1).numpy()
        stored, scale = il.quantize_rows(e, snap.meta.precision)
        pred = fl.predicate_mask(torch.from_numpy(attrs),
                                 torch.from_numpy(fv)[None]).numpy()
        sc = el.score_candidates(
            torch.from_numpy(sub.q_emb)[None],
            torch.from_numpy(sub.loc)[None],
            torch.from_numpy(sub.w_st)[None], stored, l_,
            torch.from_numpy(ids)[None], snap.w_hat,
            dist_max=snap.meta.dist_max,
            cand_scale=scale if int8 else None)[0].numpy()
    routed = set(int(c) for c in sub.routes)
    return {int(ids[j]): float(sc[j]) for j in range(m)
            if int(assign[j]) in routed and pred[j]
            and sc[j] >= sub.threshold}


def triples(notes):
    return [(n.sub_id, n.object_id, n.score, n.version) for n in notes]


# ---------------------------------------------------------------------------
# One dispatch vs the match-semantics oracle
# ---------------------------------------------------------------------------


def _dispatch_matches_semantics_oracle(s):
    rng = np.random.default_rng(0)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 3, s.cfg)
    subs = [
        server.subscribe(tok[0], msk[0], qloc[0], threshold=-1e9),
        server.subscribe(tok[1], msk[1], qloc[1],
                         filters=s.filters.FilterSpec(tenant=1),
                         threshold=-1e9),
        server.subscribe(tok[2], msk[2], qloc[2], threshold=0.5),
    ]
    emb, loc, ids, attrs = mk_batch(s, rng, 12, 1000)
    server.insert_objects(emb, loc, ids, attrs)
    version = int(server.engine.snapshot.meta.version)
    out = []
    for sub in subs:
        want = oracle_matches(s, server, sub, emb, loc, ids, attrs)
        got = sub.drain()
        assert {n.object_id for n in got} == set(want)
        for n in got:
            assert n.sub_id == sub.sub_id
            assert n.version == version
            assert np.isclose(n.score, want[n.object_id],
                              rtol=1e-6, atol=1e-6)
        out.append(triples(got))
    assert subs[0].n_notified > 0
    return dict(notes=out, routes=[sub.routes for sub in subs],
                server=server)


def _attrs_default_to_zero(s):
    rng = np.random.default_rng(1)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 2, s.cfg)
    s0 = server.subscribe(tok[0], msk[0], qloc[0],
                          filters=s.filters.FilterSpec(tenant=0),
                          threshold=-1e9)
    s1 = server.subscribe(tok[1], msk[1], qloc[1],
                          filters=s.filters.FilterSpec(tenant=1),
                          threshold=-1e9)
    emb, loc, ids, _ = mk_batch(s, rng, 8, 2000)
    server.insert_objects(emb, loc, ids)          # no attrs
    got0 = s0.drain()
    assert {n.object_id for n in got0} == set(
        oracle_matches(s, server, s0, emb, loc, ids,
                       np.zeros((8, 3), np.int32)))
    assert s1.drain() == []
    return dict(notes=triples(got0), server=server)


# ---------------------------------------------------------------------------
# Replay parity vs the one-shot re-query oracle, across a hot-swap
# ---------------------------------------------------------------------------


def _replay_parity_one_shot_oracle_across_hot_swap(s):
    rng = np.random.default_rng(2)
    c = s.cfg.n_clusters
    server = mk_server(s, cr=c, k=256, delta_threshold=1024)
    tok, msk, qloc = mk_queries(rng, 2, s.cfg)
    thr = 0.4
    subs = [
        server.subscribe(tok[0], msk[0], qloc[0], threshold=thr),
        server.subscribe(tok[1], msk[1], qloc[1],
                         filters=s.filters.FilterSpec(tenant=2),
                         threshold=thr),
    ]
    seen = {sub.sub_id: [] for sub in subs}
    next_id = 5000
    for step in range(6):
        m = 6 + step
        emb, loc, ids, attrs = mk_batch(s, rng, m, next_id)
        next_id += m
        server.insert_objects(emb, loc, ids, attrs)
        for sub in subs:
            got = sub.drain()
            ids_q, sc_q = server.engine.query(
                sub.tokens[None], sub.mask[None], sub.loc[None],
                k=256, cr=c, batch=1, filters=sub.filters)
            new_scores = {int(i): float(v)
                          for i, v in zip(ids_q[0], sc_q[0])
                          if int(i) in set(ids.tolist())}
            want = {i: v for i, v in new_scores.items() if v >= thr}
            assert {n.object_id for n in got} == set(want), (
                f"step {step} sub {sub.sub_id}")
            for n in got:
                assert np.isclose(n.score, want[n.object_id],
                                  rtol=1e-6, atol=1e-6)
            seen[sub.sub_id].extend(got)
        if step == 2:                             # the mid-replay hot-swap
            v_before = int(server.engine.snapshot.meta.version)
            server.compact_now()
            assert int(server.engine.snapshot.meta.version) > v_before
            assert len(server.subscriptions) == 2
            assert server.subscriptions.n_reroutes == 0
    for sub in subs:
        pairs = [(n.sub_id, n.object_id) for n in seen[sub.sub_id]]
        assert len(pairs) == len(set(pairs))      # exactly-once
        versions = [n.version for n in seen[sub.sub_id]]
        assert versions == sorted(versions)
    return dict(notes={k: triples(v) for k, v in seen.items()},
                server=server)


# ---------------------------------------------------------------------------
# Routing residency: reroutes happen exactly when params change
# ---------------------------------------------------------------------------


def _reroute_only_on_param_change(s):
    import jax
    from repro.core import index as ref_index
    rng = np.random.default_rng(3)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 1, s.cfg)
    sub = server.subscribe(tok[0], msk[0], qloc[0], threshold=-1e9)
    routes0 = sub.routes.copy()
    emb, loc, ids, attrs = mk_batch(s, rng, 4, 3000)
    server.insert_objects(emb, loc, ids, attrs)
    server.compact_now()
    assert server.subscriptions.n_reroutes == 0
    assert np.array_equal(sub.routes, routes0)
    # a publish with NEW routing params re-encodes and re-routes; the
    # port takes the reference's params through its converter
    iparams2 = ref_index.index_init(jax.random.PRNGKey(99), s.cfg.d_model,
                                    s.cfg.n_clusters, hidden=(16,))
    snap = server.engine.snapshot
    if s.which == "ref":
        snap2 = dataclasses.replace(snap, index_params=iparams2)
    else:
        from repro_torch import convert
        snap2 = dataclasses.replace(
            snap, index=convert.index_from_numpy(
                jax.tree_util.tree_map(np.array, iparams2)))
    server.publish(snap2)
    assert server.subscriptions.n_reroutes == 1
    reg2 = s.continuous.SubscriptionRegistry(server.engine, cr=server.cfg.cr)
    fresh = reg2.register(tok[0], msk[0], qloc[0], threshold=-1e9)
    assert np.array_equal(sub.routes, fresh.routes)
    np.testing.assert_allclose(sub.q_emb, fresh.q_emb)
    return dict(routes=(routes0, sub.routes), q_emb=sub.q_emb,
                w_st=sub.w_st, server=server)


# ---------------------------------------------------------------------------
# Async iteration, close, unregister
# ---------------------------------------------------------------------------


def _async_iteration_and_close(s):
    rng = np.random.default_rng(4)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 1, s.cfg)

    async def go():
        sub = server.subscribe(tok[0], msk[0], qloc[0], threshold=-1e9)
        emb, loc, ids, attrs = mk_batch(s, rng, 6, 4000)
        server.insert_objects(emb, loc, ids, attrs)
        server.unsubscribe(sub.sub_id)            # closes the stream
        return sub, [n async for n in sub]

    sub, notes = asyncio.run(go())
    assert len(notes) == sub.n_notified > 0
    assert all(isinstance(n, s.continuous.Notification) for n in notes)
    assert sub.drain() == []                      # stays ended
    return dict(notes=triples(notes), server=server)


def _unregister_stops_delivery(s):
    rng = np.random.default_rng(5)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 2, s.cfg)
    keep = server.subscribe(tok[0], msk[0], qloc[0], threshold=-1e9)
    gone = server.subscribe(tok[1], msk[1], qloc[1], threshold=-1e9)
    server.unsubscribe(gone.sub_id)
    assert len(server.subscriptions) == 1
    emb, loc, ids, attrs = mk_batch(s, rng, 8, 4500)
    server.insert_objects(emb, loc, ids, attrs)
    assert gone.n_notified == 0
    assert keep.n_notified > 0
    return dict(notes=triples(keep.drain()), server=server)


def _register_validates_filters(s):
    server = mk_server(s)
    tok, msk, qloc = mk_queries(np.random.default_rng(6), 1, s.cfg)
    with pytest.raises(TypeError):
        server.subscribe(tok[0], msk[0], qloc[0], filters={"tenant": 1})


# ---------------------------------------------------------------------------
# Dispatch economics and metrics
# ---------------------------------------------------------------------------


def _dispatch_cost_scales_with_distinct_clusters(s):
    rng = np.random.default_rng(7)
    server = mk_server(s)
    tok, msk, qloc = mk_queries(rng, 12, s.cfg)
    for i in range(12):                           # a 12-strong roster
        server.subscribe(tok[i], msk[i], qloc[i], threshold=-1e9)
    calls = []
    cont_engine = s.continuous.engine_lib
    orig = cont_engine.score_candidates

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    cont_engine.score_candidates = counted
    try:
        emb, loc, ids, attrs = mk_batch(s, rng, 16, 6000)
        server.insert_objects(emb, loc, ids, attrs)
    finally:
        cont_engine.score_candidates = orig
    reg = server.subscriptions
    assert reg.n_dispatches == 1
    assert len(calls) == reg.n_distinct_clusters <= s.cfg.n_clusters
    m = server.metrics()["subscriptions"]
    assert m["subscriptions"] == 12
    assert m["objects_seen"] == 16
    assert m["distinct_clusters_per_dispatch"] == reg.n_distinct_clusters
    assert m["notifications"] == reg.n_notifications > 0
    return dict(metrics=m, calls=len(calls), server=server)


def _metrics_without_registry(s):
    server = mk_server(s)
    m = server.metrics()
    assert "subscriptions" not in m
    assert m["exact_hits"] == 0 and m["near_hits"] == 0
    return dict(server=server)


@pytest.mark.parametrize("scenario", [
    _dispatch_matches_semantics_oracle, _attrs_default_to_zero,
    _replay_parity_one_shot_oracle_across_hot_swap,
    _reroute_only_on_param_change, _async_iteration_and_close,
    _unregister_stops_delivery, _register_validates_filters,
    _dispatch_cost_scales_with_distinct_clusters, _metrics_without_registry,
], ids=lambda f: f.__name__.lstrip("_"))
def test_continuous(sides, scenario):
    both(sides, scenario)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_dispatch_parity_quantized(sides, tmp_path, precision):
    """The quantized tiers: rows are quantized before they are scored,
    so the notified triples still equal the reference's."""
    ref, port = sides
    d = str(tmp_path / precision)
    with ref.ctx():
        ref.snap.with_precision(precision).save(d)

    def scenario(s):
        rng = np.random.default_rng(8)
        server = mk_server(s, snap=s.load(d))
        tok, msk, qloc = mk_queries(rng, 6, s.cfg)
        subs = [server.subscribe(tok[i], msk[i], qloc[i],
                                 threshold=-1e9 if i % 2 else 0.2)
                for i in range(6)]
        emb, loc, ids, attrs = mk_batch(s, rng, 24, 8000)
        server.insert_objects(emb, loc, ids, attrs)
        notes = [triples(sub.drain()) for sub in subs]
        assert sum(map(len, notes)) > 0
        for sub, got in zip(subs, notes):
            want = oracle_matches(s, server, sub, emb, loc, ids, attrs)
            assert {n[1] for n in got} == set(want)
        return dict(notes=notes, server=server)

    both(sides, scenario)


@pytest.mark.cuda
def test_cuda_dispatch_matches_cpu(sides):
    """Subscriptions on a card engine notify the pairs a CPU copy's
    notify, scores within 1e-4 (bf16-free f32 config)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import api
    from repro_torch.core import server as port_server
    port = sides[1]
    rng = np.random.default_rng(9)
    cfg = port_server.ServerConfig(k=8, cr=2, backend="cuda")
    gpu = api.Searcher(api.load(port.dir, device="cuda"), backend="cuda",
                       device="cuda").serve(cfg)
    cpu = mk_server(port)
    tok, msk, qloc = mk_queries(rng, 16, port.cfg)
    pairs = []
    for srv in (gpu, cpu):
        subs = [srv.subscribe(tok[i], msk[i], qloc[i], threshold=-1e9)
                for i in range(16)]
        emb, loc, ids, attrs = mk_batch(port, np.random.default_rng(10), 32,
                                        9000)
        srv.insert_objects(emb, loc, ids, attrs)
        pairs.append({(n.sub_id, n.object_id): n.score
                      for sub in subs for n in sub.drain()})
    assert set(pairs[0]) == set(pairs[1]) and pairs[0]
    for key, score in pairs[1].items():
        assert abs(pairs[0][key] - score) <= 1e-4
