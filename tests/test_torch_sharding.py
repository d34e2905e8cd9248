"""The port's mesh-sharded serving against the reference's, on the CPU.

One artifact (``tests/test_mesh_sharding.py``'s c = 8 snapshot, f32
compute) is loaded by both packages and sharded S ∈ {1, 2, 4, 8} ways:
the reference across its 8 forced host devices, the port into S logical
CPU parts. The mirrors of ``test_mesh_sharding.py`` hold

* the port's sharded answers to the reference's sharded answers AND to
  the port's own unsharded ones: ids equal up to cross-shard ties (an
  exact tie across shards resolves in shard order), scores within 1e-5,
  the reference's tolerance between programs;
* the port's answers across shard counts to each other, bit for bit.

Also: placement-not-content, re-sharding content derivations,
non-divisible remainders, random assignments, elastic save / load across
S (the artifact served by both packages), a delta with more tombstones
than k, ``merge_shard_topk`` and ``localize_routes`` against the
reference's, a shard of padding clusters only (the premise built
explicitly), the open-loop re-shard swap with none failed or torn, the
cluster half of ``test_sharding_rules.py`` (layout, sentinel, placement,
validation, bytes per part) and the corpus-sharded minings against the
reference's. Cases marked ``cuda`` hold the ``cuda`` / ``cuda-cm``
sharded engine and its host replica to the unsharded engine on the card.
"""
import asyncio
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import api as ref_api
from repro.configs import get_config
from repro.core import engine as ref_engine
from repro.core import index as ref_index
from repro.core import pseudo_labels as ref_pl
from repro.core import relevance as ref_relevance
from repro.core import serving as ref_serving
from repro.core.snapshot import IndexSnapshot as RefSnapshot
from repro.distributed import sharding as ref_sharding
from repro_torch import api
from repro_torch import convert
from repro_torch.core import delta as port_delta
from repro_torch.core import engine as port_engine
from repro_torch.core import index as port_index
from repro_torch.core import pseudo_labels as port_pl
from repro_torch.core import server as port_server
from repro_torch.core import serving as port_serving
from repro_torch.distributed import sharding as sh

from test_torch_common import assert_topk_match, np_tree, ref_on_cpu

DIST_MAX = 1.4142
SHARD_COUNTS = (1, 2, 4, 8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_clusters):
    return dataclasses.replace(
        get_config("list-dual-encoder"),
        n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=512,
        max_len=8, spatial_t=50, n_clusters=n_clusters,
        index_mlp_hidden=(16,), compute_dtype="float32")


def _build_ref_snap(n_clusters, seed=0, n=96, cap=32):
    """``test_mesh_sharding.py``'s ``_build_snap`` (f32 compute)."""
    cfg = _cfg(n_clusters)
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


def _make_queries(cfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(2, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    tok[:, 0] = 1
    msk = np.ones_like(tok, bool)
    loc = rng.uniform(size=(n, 2)).astype(np.float32)
    return tok, msk, loc


class Artifact:
    """One reference-built snapshot saved once, loaded by both packages."""

    def __init__(self, tmp_path_factory, name, n_clusters, seed=0):
        self.dir = str(tmp_path_factory.mktemp(name))
        with ref_on_cpu():
            _build_ref_snap(n_clusters, seed=seed).save(self.dir)
            self.ref = RefSnapshot.load(self.dir)
        self.port = api.load(self.dir, device="cpu")
        self.cfg = self.port.cfg


@pytest.fixture(scope="module")
def art8(tmp_path_factory):
    return Artifact(tmp_path_factory, "mesh8", 8)


@pytest.fixture(scope="module")
def queries(art8):
    return _make_queries(art8.cfg)


def port_query(snap, backend, queries, **kw):
    tok, msk, loc = queries
    kw = dict(dict(k=5, cr=2, batch=4), **kw)
    return api.Searcher(snap, backend=backend, device="cpu").query(
        tok, msk, loc, **kw)


def ref_query(snap, backend, queries, **kw):
    tok, msk, loc = queries
    kw = dict(dict(k=5, cr=2, batch=4), **kw)
    with ref_on_cpu():
        return ref_api.Searcher(snap, backend=backend).query(tok, msk, loc,
                                                             **kw)


_cache = {}


def _port_run(art8, precision, backend, n_shards, queries):
    key = ("port", precision, backend, n_shards)
    if key not in _cache:
        snap = art8.port.with_precision(precision)
        if n_shards:
            snap = snap.with_mesh(n_shards)
        _cache[key] = port_query(snap, backend, queries)
    return _cache[key]


def _ref_run(art8, precision, backend, n_shards, queries):
    key = ("ref", precision, backend, n_shards)
    if key not in _cache:
        with ref_on_cpu():
            snap = art8.ref.with_precision(precision).with_mesh(n_shards)
        _cache[key] = ref_query(snap, backend, queries)
    return _cache[key]


# ---------------------------------------------------------------------------
# The parity matrix: {1, 2, 4, 8} shards × backends × tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", port_index.PRECISIONS)
@pytest.mark.parametrize("backend", ["dense", "dense-cm"])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_parity_matrix(art8, queries, precision, backend, n_shards):
    ids, sc = _port_run(art8, precision, backend, n_shards, queries)
    r_ids, r_sc = _ref_run(art8, precision, backend, n_shards, queries)
    assert_topk_match(ids, sc, r_ids, r_sc)            # the reference's
    u_ids, u_sc = _port_run(art8, precision, backend, 0, queries)
    assert_topk_match(ids, sc, u_ids, u_sc)            # the unsharded port
    one = _port_run(art8, precision, backend, 1, queries)
    np.testing.assert_array_equal(ids, one[0])         # every bit across S
    np.testing.assert_array_equal(sc, one[1])


def test_with_mesh_is_placement_not_content(art8):
    s = art8.port.with_mesh(2)
    assert s.meta.version == art8.port.meta.version
    assert s.meta.n_shards == 2
    assert s.shards is not None and s.shards.n_shards == 2
    for k in ("emb", "loc", "ids", "scale", "attrs", "counts"):
        assert s.buffers[k].device == CPU
        assert torch.equal(s.buffers[k], art8.port.buffers[k])
    assert s.device == art8.port.device
    u = s.unshard()
    assert u.shards is None and u.meta.n_shards == 1
    assert torch.equal(u.buffers["ids"], art8.port.buffers["ids"])
    assert s.with_mesh(None).shards is None


def test_content_derivations_reshard(art8):
    rng = np.random.default_rng(0)
    s = art8.port.with_mesh(2)
    p = s.with_precision("int8")
    assert p.shards is not None and p.shards.n_shards == 2
    assert p.meta.n_shards == 2
    assert p.shards.parts[0]["emb"].dtype == torch.int8
    new_emb = rng.normal(size=(3, art8.cfg.d_model)).astype(np.float32)
    new_loc = rng.uniform(size=(3, 2)).astype(np.float32)
    buf = port_index.insert_objects(s.buffers, s.index, s.norm, new_emb,
                                    new_loc, np.arange(8000, 8003))
    g = s.with_buffers(buf)
    assert g.shards is not None and g.shards.n_shards == 2
    assert (g.buffers["ids"] >= 8000).any()
    got = torch.cat([part["ids"].reshape(-1) for part in g.shards.parts])
    assert np.isin(np.arange(8000, 8003), got.numpy()).all()
    # compact folds a delta into the host buffers and shards again
    seg = port_delta.DeltaSegment.empty(art8.cfg.d_model, "f32")
    seg = seg.insert(new_emb, new_loc, np.arange(8100, 8103))
    c = s.with_delta(seg).compact()
    assert c.shards is not None and c.meta.n_shards == 2
    got = torch.cat([part["ids"].reshape(-1) for part in c.shards.parts])
    assert np.isin(np.arange(8100, 8103), got.numpy()).all()


@pytest.mark.parametrize("n_shards", (4, 8))
def test_nondivisible_remainder_parity(tmp_path_factory, n_shards):
    art6 = _cached_art(tmp_path_factory, "mesh6", 6, seed=2)
    q = _make_queries(art6.cfg, seed=2)
    want = port_query(art6.port, "dense", q)
    s = art6.port.with_mesh(n_shards)
    assert s.shards.c_local == -(-6 // n_shards)
    got = port_query(s, "dense", q)
    assert_topk_match(*got, *want)
    with ref_on_cpu():
        rs = art6.ref.with_mesh(n_shards)
    assert_topk_match(*got, *ref_query(rs, "dense", q))


_arts = {}


def _cached_art(tmp_path_factory, name, c, seed=0):
    if name not in _arts:
        _arts[name] = Artifact(tmp_path_factory, name, c, seed=seed)
    return _arts[name]


@pytest.mark.parametrize("seed", range(6))
def test_random_assignment_parity(tmp_path_factory, seed):
    """Any cluster→shard map (balanced, skewed, or starving shards) gives
    the unsharded answers; seed 0 puts every cluster on one shard."""
    art = _cached_art(tmp_path_factory, "mesh8_prop", 8, seed=4)
    q = _make_queries(art.cfg, seed=4)
    want = port_query(art.port, "dense", q, batch=12)
    rng = np.random.default_rng(100 + seed)
    n_shards = int(rng.integers(2, 9))
    assignment = (np.zeros(8, np.int32) if seed == 0
                  else rng.integers(0, n_shards, size=8).astype(np.int32))
    s = art.port.with_mesh(n_shards, assignment=assignment)
    np.testing.assert_array_equal(s.shards.shard_of, assignment)
    assert_topk_match(*port_query(s, "dense", q, batch=12), *want)


# ---------------------------------------------------------------------------
# Elastic persistence
# ---------------------------------------------------------------------------


def test_sharded_persistence_elastic(art8, queries, tmp_path):
    """Arrays persist global: a snapshot sharded 8 ways re-shards at load
    to 4, 2, 1 or none with the unsharded answers; the reference serves
    the port's sharded artifact alike."""
    ref = _port_run(art8, "f32", "dense", 0, queries)
    s = art8.port.with_mesh(8)
    api.save(s, str(tmp_path))
    for n_shards in (4, 2, 1):
        loaded = api.load(str(tmp_path), mesh=n_shards, device="cpu")
        assert loaded.meta.n_shards == n_shards
        out = port_query(loaded, "dense", queries)
        assert_topk_match(*out, *ref)
        mem = _port_run(art8, "f32", "dense", n_shards, queries)
        np.testing.assert_array_equal(mem[0], out[0])
        np.testing.assert_array_equal(mem[1], out[1])
    plain = api.load(str(tmp_path), device="cpu")
    assert plain.shards is None and plain.meta.n_shards == 1
    out = port_query(plain, "dense", queries)
    np.testing.assert_array_equal(ref[0], out[0])
    np.testing.assert_array_equal(ref[1], out[1])
    with ref_on_cpu():
        r = ref_api.load(str(tmp_path), mesh=2)
    assert r.meta.n_shards == 2
    assert_topk_match(*out, *ref_query(r, "dense", queries))


def test_sharded_persistence_with_delta(art8, queries, tmp_path):
    """A NON-EMPTY delta (pending inserts and a tombstone) round-trips
    sharded and serves as the unsharded snapshot with that delta: the
    delta merge composes after the sharded base scan."""
    # the premise, built: the inserted rows are the first four queries'
    # best objects with their embeddings doubled, so they rank
    base = _port_run(art8, "f32", "dense", 0, queries)
    ids = art8.port.buffers["ids"]
    at = [tuple(int(x) for x in (ids == int(i)).nonzero()[0])
          for i in base[0][:4, 0]]
    emb = torch.stack([art8.port.buffers["emb"][a] for a in at]).numpy()
    loc = torch.stack([art8.port.buffers["loc"][a] for a in at]).numpy()
    seg = port_delta.DeltaSegment.empty(art8.cfg.d_model, "f32")
    seg = seg.insert(2 * emb, loc, np.arange(9000, 9004))
    live_id = int(art8.port.buffers["ids"].reshape(-1)[0])
    seg = seg.delete([live_id])
    snap_d = art8.port.with_delta(seg)
    ref = port_query(snap_d, "dense", queries, cr=8)
    assert (ref[0] >= 9000).any()
    assert not (ref[0] == live_id).any()
    s = snap_d.with_mesh(4)
    assert_topk_match(*port_query(s, "dense", queries, cr=8), *ref)
    api.save(s, str(tmp_path))
    loaded = api.load(str(tmp_path), mesh=2, device="cpu")
    assert loaded.meta.delta_rows == 4 and loaded.meta.n_tombstones == 1
    assert_topk_match(*port_query(loaded, "dense", queries, cr=8), *ref)


@pytest.mark.parametrize("backend", ["dense", "dense-cm"])
def test_more_tombstones_than_k(art8, queries, backend):
    """A delta of more tombstones than k: each part's ids are masked, so
    the sharded answer is the compacted snapshot's (no tombstoned id,
    no hole)."""
    held = art8.port.buffers["ids"].reshape(-1).numpy()
    held = held[held >= 0]
    dead = np.random.default_rng(3).choice(held, 12, replace=False)
    seg = port_delta.DeltaSegment.empty(art8.cfg.d_model, "f32")
    snap_t = art8.port.with_delta(seg.delete(dead))
    want = port_query(snap_t.compact(), backend, queries, k=5, cr=3)
    s = snap_t.with_mesh(4)
    got = port_query(s, backend, queries, k=5, cr=3)
    assert not np.isin(got[0], dead).any()
    assert_topk_match(*got, *want)
    assert_topk_match(*got, *port_query(snap_t, backend, queries, k=5, cr=3))


# ---------------------------------------------------------------------------
# The tree merge and route localization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_merge_shard_topk_equals_global_topk(ties):
    rng = np.random.default_rng(1)
    k, n, parts = 6, 9, 5
    ids = rng.integers(0, 100_000, size=(parts, n, k)).astype(np.int32)
    sc = (rng.integers(0, 4, size=(parts, n, k)).astype(np.float32) if ties
          else rng.normal(size=(parts, n, k)).astype(np.float32))
    sc = -np.sort(-sc, axis=-1)
    lists = [(ids[p], sc[p]) for p in range(parts)]
    got_ids, got_sc = port_engine.merge_shard_topk(lists, k=k)
    all_sc = sc.transpose(1, 0, 2).reshape(n, parts * k)
    all_ids = ids.transpose(1, 0, 2).reshape(n, parts * k)
    order = np.argsort(-all_sc, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got_sc,
                                  np.take_along_axis(all_sc, order, -1))
    if not ties:
        np.testing.assert_array_equal(
            got_ids, np.take_along_axis(all_ids, order, -1))
    assert got_ids.dtype == np.int32 and got_sc.dtype == np.float32
    want = ref_engine.merge_shard_topk(lists, k=k)
    np.testing.assert_array_equal(got_ids, want[0])     # ties: shard order
    np.testing.assert_array_equal(got_sc, want[1])
    with pytest.raises(ValueError):
        port_engine.merge_shard_topk([])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_localize_routes_all_off_shard(as_tensor):
    shard_of = np.array([0, 0, 1, 1, 2, 2], np.int32)
    local_of = np.array([0, 1, 0, 1, 0, 1], np.int32)
    top_c = np.array([[0, 1], [0, 5], [4, 5]], np.int32)
    sentinel = 2
    arg = torch.from_numpy(top_c) if as_tensor else top_c
    for s in range(3):
        out = port_serving.localize_routes(arg, shard_of, local_of, s,
                                           sentinel=sentinel)
        want = ref_serving.localize_routes(top_c, shard_of, local_of, s,
                                           sentinel=sentinel)
        if as_tensor:
            assert isinstance(out, torch.Tensor)
            assert out.dtype == torch.int32
            out = out.numpy()
        assert out.dtype == np.int32 and out.shape == top_c.shape
        np.testing.assert_array_equal(out, want)
    out1 = port_serving.localize_routes(top_c, shard_of, local_of, 1,
                                        sentinel=sentinel)
    assert (out1 == sentinel).all()


def test_shard_holding_only_padding_clusters(art8, queries):
    """A shard whose clusters are ALL empty contributes only padding: the
    sharded answer equals the unsharded one, and any route into those
    clusters reads ids −1. The premise (clusters 2+ empty) is built
    explicitly."""
    buf = dict(art8.port.buffers)
    for key, fill in sh.PART_FILLS.items():
        arr = buf[key].clone()
        arr[2:] = fill
        buf[key] = arr
    snap = dataclasses.replace(art8.port, buffers=buf)
    assert (snap.buffers["ids"][2:] == -1).all()
    assert (snap.buffers["ids"][:2] >= 0).any()
    assignment = np.array([0, 0, 1, 1, 1, 1, 1, 1], np.int32)
    s = snap.with_mesh(2, assignment=assignment)
    sh_ = s.shards
    want = port_query(snap, "dense", queries)
    got = port_query(s, "dense", queries)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-6)
    top_c = np.array([[2, 3], [0, 1]], np.int32)
    local = port_serving.localize_routes(top_c, sh_.shard_of, sh_.local_of,
                                         1, sentinel=sh_.sentinel)
    assert (sh_.parts[1]["ids"].numpy()[local] == -1).all()
    local0 = port_serving.localize_routes(top_c, sh_.shard_of, sh_.local_of,
                                          0, sentinel=sh_.sentinel)
    assert local0.tolist() == [[sh_.sentinel, sh_.sentinel], [0, 1]]


def test_engine_caches_do_not_keep_a_placement_alive(art8, queries):
    """The engine's per-placement caches (device maps, host replicas)
    hold their placement weakly: once a new placement is published, the
    old one's parts are freed."""
    import gc
    import weakref
    s1 = art8.port.with_mesh(2)
    eng = port_engine.QueryEngine(s1, backend="dense", device="cpu")
    eng.query(*queries, k=5, cr=2, batch=4)
    eng._host_shard_part(s1, s1.shards, 0)
    gone = weakref.ref(s1.shards)
    eng.publish(art8.port.with_mesh(4))
    del s1
    gc.collect()
    assert gone() is None
    ids, _ = eng.query(*queries, k=5, cr=2, batch=4)
    np.testing.assert_array_equal(
        ids, _port_run(art8, "f32", "dense", 4, queries)[0])


# ---------------------------------------------------------------------------
# Server hot-swap of a re-sharded snapshot under open-loop load
# ---------------------------------------------------------------------------


def test_open_loop_swap_resharded_zero_failed_or_torn(art8):
    rng = np.random.default_rng(0)
    s1 = art8.port.with_mesh(2)
    server = port_server.StreamingServer(
        port_engine.QueryEngine(s1, backend="dense", device="cpu"),
        port_server.ServerConfig(batch_size=4, max_delay_ms=1.0, k=5, cr=2,
                                 backend="dense"))
    n = 32
    tok, msk, loc = _make_queries(art8.cfg, n=n, seed=9)
    requests = [(tok[i], msk[i], loc[i]) for i in range(n)]
    new_emb = rng.normal(size=(5, art8.cfg.d_model)).astype(np.float32)
    new_loc = rng.uniform(size=(5, 2)).astype(np.float32)
    buf = port_index.insert_objects(s1.buffers, s1.index, s1.norm, new_emb,
                                    new_loc, np.arange(5000, 5005))
    s2 = s1.with_buffers(buf).with_mesh(4)
    assert s2.meta.version == s1.meta.version + 1
    versions = []
    orig = server.engine.query

    def spy_then_swap(*a, **kw):
        versions.append(kw["snapshot"].meta.version)
        res = orig(*a, **kw)
        if len(versions) == 2:
            server.publish(s2)
        return res

    server.engine.query = spy_then_swap
    results = asyncio.run(port_server.open_loop(server, requests,
                                                qps=4000.0))
    assert len(results) == n
    assert server.engine.snapshot.meta.version == s2.meta.version
    assert server.engine.snapshot.shards is s2.shards
    assert set(versions) <= {s1.meta.version, s2.meta.version}
    o1 = port_engine.QueryEngine(s1, backend="dense", device="cpu")
    o2 = port_engine.QueryEngine(s2, backend="dense", device="cpu")
    ids1, sc1 = o1.query(tok, msk, loc, k=5, cr=2, batch=4)
    ids2, sc2 = o2.query(tok, msk, loc, k=5, cr=2, batch=4)
    for i, (ids, sc) in enumerate(results):
        old = np.array_equal(ids, ids1[i]) and np.array_equal(sc, sc1[i])
        new = np.array_equal(ids, ids2[i]) and np.array_equal(sc, sc2[i])
        assert old or new, f"request {i} matches NEITHER snapshot (torn)"
    assert s1.meta.version in versions and s2.meta.version in versions
    m = server.metrics()
    assert m["n_shards"] == s2.meta.n_shards
    assert len(m["shard_bytes_per_device"]) == s2.meta.n_shards


# ---------------------------------------------------------------------------
# The cluster half of test_sharding_rules.py
# ---------------------------------------------------------------------------


def _tiny_buffers(rng, c=6, cap=8, d=16):
    counts = rng.integers(1, cap + 1, size=c)
    ids = np.full((c, cap), -1, np.int32)
    for g in range(c):
        ids[g, :counts[g]] = np.arange(counts[g]) + 100 * g
    return {
        "emb": rng.normal(size=(c, cap, d)).astype(np.float32),
        "loc": rng.uniform(size=(c, cap, 2)).astype(np.float32),
        "ids": ids,
        "scale": np.ones((c, cap), np.float32),
        "attrs": rng.integers(0, 5, size=(c, cap, 3)).astype(np.int32),
        "counts": counts.astype(np.int64),
        "capacity": cap,
        "n_spilled": 0,
    }


def _torch_buffers(buf):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in buf.items()}


def test_cluster_mesh_rejects_bad_counts(monkeypatch):
    with pytest.raises(ValueError, match="devices"):
        sh.cluster_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        sh.cluster_mesh(2, devices=["cpu"])
    # the CPU twin of the card case: a host of 2 cards refuses 3 shards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 1..2 available devices"):
        sh.cluster_mesh(3, device="cuda")
    mesh = sh.cluster_mesh(2, device="cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    # several logical shards on one card only from an explicit list
    mesh = sh.cluster_mesh(4, devices=["cuda:0"] * 4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    assert sh.cluster_mesh(3, device="cpu").devices == (CPU,) * 3


@pytest.mark.cuda
def test_cluster_mesh_raises_past_the_cards(cuda_device):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices"):
        sh.cluster_mesh(n + 1, device="cuda")
    assert len(sh.cluster_mesh(n, device="cuda").devices) == n


def test_cluster_mesh_requires_cluster_axis():
    bad = dataclasses.replace(sh.ClusterMesh((CPU,)), axis_name="model")
    with pytest.raises(ValueError, match=sh.CLUSTER_AXIS):
        sh.as_cluster_mesh(bad)
    with pytest.raises(ValueError, match=sh.CLUSTER_AXIS):
        sh.as_cluster_mesh("two")


def test_cluster_buffer_rules_shard_leading_axis():
    """Every buffer key splits along its leading (cluster) axis, as the
    reference's rules resolve them."""
    assert set(sh.CLUSTER_BUFFER_KEYS) == {"emb", "loc", "ids", "scale",
                                           "attrs", "counts"}
    ref_rules = {key.rstrip("$"): spec
                 for key, spec in ref_sharding.CLUSTER_BUFFER_RULES}
    for name in sh.CLUSTER_BUFFER_KEYS:
        assert ref_rules[name][0] == ref_sharding.CLUSTER_AXIS \
            == sh.CLUSTER_AXIS
    buf = _torch_buffers(_tiny_buffers(np.random.default_rng(0)))
    out = sh.shard_cluster_buffers(buf, 2, device="cpu")
    for part in out.parts:
        for name in sh.CLUSTER_BUFFER_KEYS:
            assert part[name].shape[1:] == buf[name].shape[1:]


def test_shard_cluster_buffers_validates_assignment():
    buf = _torch_buffers(_tiny_buffers(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="assignment shape"):
        sh.shard_cluster_buffers(buf, 2, assignment=np.zeros(3, np.int32),
                                 device="cpu")
    with pytest.raises(ValueError, match="must lie in"):
        sh.shard_cluster_buffers(buf, 2, assignment=np.full(6, 5, np.int32),
                                 device="cpu")


@pytest.mark.parametrize("n_shards", (2, 4))
def test_shard_cluster_buffers_layout_and_placement(n_shards):
    """c = 6 over S shards: blocks of ⌈6/S⌉, every real row bit-identical
    on its owner, sentinel and remainder rows empty, each part on its
    recorded device, counts int32, bytes per part summing to the global
    bytes plus padding and sentinels; the layout equals the
    reference's."""
    np_buf = _tiny_buffers(np.random.default_rng(1), c=6)
    buf = _torch_buffers(np_buf)
    shards = sh.shard_cluster_buffers(buf, n_shards, device="cpu")
    assert shards.n_shards == n_shards and shards.c_global == 6
    assert shards.c_local == -(-6 // n_shards)
    assert shards.sentinel == shards.c_local
    for g in range(6):
        s, r = int(shards.shard_of[g]), int(shards.local_of[g])
        for key in ("emb", "loc", "ids", "scale", "attrs"):
            assert torch.equal(shards.parts[s][key][r], buf[key][g])
        assert int(shards.parts[s]["counts"][r]) == int(buf["counts"][g])
    for s, part in enumerate(shards.parts):
        ids = part["ids"]
        assert ids.shape[0] == shards.c_local + 1
        n_real = int(np.sum(shards.shard_of == s))
        assert (ids[n_real:] == -1).all()
        assert (part["loc"][shards.sentinel] == port_index.PAD_LOC).all()
        assert (part["scale"][n_real:] == 1).all()
        assert (part["emb"][n_real:] == 0).all()
        assert part["counts"].dtype == torch.int32
        for t in part.values():
            assert t.device == shards.devices[s]
    rows = shards.c_local + 1
    per_cluster = sum(t[0].numel() * t.element_size()
                      for t in shards.parts[0].values())
    assert sum(shards.nbytes_per_device()) == n_shards * rows * per_cluster
    global_bytes = 6 * per_cluster
    assert sum(shards.nbytes_per_device()) == (
        global_bytes + (n_shards * shards.c_local - 6) * per_cluster
        + n_shards * per_cluster)
    assert max(shards.nbytes_per_device()) < global_bytes
    with ref_on_cpu():
        ref = ref_sharding.shard_cluster_buffers(np_buf, n_shards)
    np.testing.assert_array_equal(shards.shard_of, ref.shard_of)
    np.testing.assert_array_equal(shards.local_of, ref.local_of)
    assert shards.c_local == ref.c_local
    for part, rpart in zip(shards.parts, ref.parts):
        for key in ("emb", "loc", "ids", "scale", "attrs", "counts"):
            np.testing.assert_array_equal(part[key].numpy(),
                                          np.asarray(rpart[key]))
    assert shards.nbytes_per_device() == ref.nbytes_per_device()


def test_shard_cluster_buffers_random_assignment_covers_all():
    rng = np.random.default_rng(3)
    buf = _torch_buffers(_tiny_buffers(rng, c=9))
    assignment = rng.integers(0, 4, size=9).astype(np.int32)
    shards = sh.shard_cluster_buffers(buf, 4, assignment=assignment,
                                      device="cpu")
    np.testing.assert_array_equal(shards.shard_of, assignment)
    seen = set()
    for g in range(9):
        s, r = int(shards.shard_of[g]), int(shards.local_of[g])
        assert torch.equal(shards.parts[s]["ids"][r], buf["ids"][g])
        seen.add((s, r))
    assert len(seen) == 9


# ---------------------------------------------------------------------------
# Corpus-sharded mining against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mining():
    cfg = dataclasses.replace(get_config("list-dual-encoder"), d_model=8,
                              spatial_t=20, compute_dtype="float32")
    rng = np.random.default_rng(0)
    b, n, d = 6, 512, 8
    arrays = dict(q_emb=rng.normal(size=(b, d)).astype(np.float32),
                  q_loc=rng.uniform(size=(b, 2)).astype(np.float32),
                  obj_emb=rng.normal(size=(n, d)).astype(np.float32),
                  obj_loc=rng.uniform(size=(n, 2)).astype(np.float32))
    with ref_on_cpu():
        params = ref_relevance.relevance_init(jax.random.PRNGKey(0), cfg)
        scores = np.asarray(ref_relevance.score_corpus(
            params, *(jnp.asarray(arrays[k]) for k in
                      ("q_emb", "q_loc", "obj_emb", "obj_loc")), cfg,
            dist_max=1.414, train=False))
    rel = convert.relevance_from_numpy(np_tree(params), cfg)
    return cfg, params, rel, arrays, scores


def _assert_ranked_equal(got, want, scores):
    for i in range(want.shape[0]):
        for r in np.flatnonzero(got[i] != want[i]):
            assert scores[i, got[i, r]] == scores[i, want[i, r]], (i, r)


@pytest.mark.parametrize("form,kw", [
    ("sharded", dict(shards=1)), ("sharded", dict(shards=8)),
    ("dense", dict(shards=8, per_shard_k=64)),
    ("dense", dict(shards=4, per_shard_k=0)),
])
def test_sharded_minings_match_reference(mining, form, kw):
    cfg, params, rel, a, scores = mining
    window = dict(neg_start=20, neg_end=60, dist_max=1.414)
    with ref_on_cpu():
        fn = getattr(ref_pl, f"mine_negatives_{form}")
        want = np.asarray(fn(params, cfg, *(jnp.asarray(a[k]) for k in
                                            ("q_emb", "q_loc", "obj_emb",
                                             "obj_loc")), **window, **kw))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = getattr(port_pl, f"mine_negatives_{form}")(
        rel, t["q_emb"], t["q_loc"], t["obj_emb"], t["obj_loc"], **window,
        **kw).numpy()
    assert got.shape == want.shape
    _assert_ranked_equal(got, want, scores)
    exact = port_pl.mine_negatives(
        rel, t["q_emb"], t["q_loc"], t["obj_emb"], t["obj_loc"],
        **window).numpy()
    if form == "sharded":                   # the exact window, up to ties
        _assert_ranked_equal(got, exact, scores)
    with pytest.raises(ValueError, match="equal shards"):
        getattr(port_pl, f"mine_negatives_{form}")(
            rel, t["q_emb"], t["q_loc"], t["obj_emb"][:511],
            t["obj_loc"][:511], **window, shards=8)


# ---------------------------------------------------------------------------
# On the card: the kernels behind the sharded scan
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", port_index.PRECISIONS)
@pytest.mark.parametrize("backend", ["cuda", "cuda-cm"])
def test_cuda_sharded_engine_matches_unsharded(art8, queries, cuda_device,
                                               precision, backend):
    """4 logical shards on one card through the CUDA kernels: the
    unsharded kernel's answers up to cross-shard ties; the global buffers
    stay on the host."""
    snap = api.load(art8.dir, device=cuda_device).with_precision(precision)
    want = port_query_on(snap, backend, queries, cuda_device)
    s = snap.with_mesh(sh.ClusterMesh((cuda_device,) * 4))
    assert s.buffers["emb"].device == CPU
    assert all(p["emb"].device.type == "cuda" for p in s.shards.parts)
    searcher = api.Searcher(s, backend=backend, device=cuda_device)
    assert searcher.snapshot.buffers["emb"].device == CPU
    got = searcher.query(*queries, k=5, cr=2, batch=4)
    assert_topk_match(*got, *want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda-cm"])
def test_cuda_replica_scan_equals_device_scan(art8, queries, cuda_device,
                                              backend):
    """A hedged shard's scans run on its host replica through the same
    kernel on the card: bit-equal to the device scans."""
    snap = api.load(art8.dir, device=cuda_device).with_mesh(
        sh.ClusterMesh((cuda_device,) * 4))
    searcher = api.Searcher(snap, backend=backend, device=cuda_device)
    want = searcher.query(*queries, k=5, cr=2, batch=4)
    eng = searcher.engine
    eng._hedged = {s: 0 for s in range(4)}     # every shard hedged
    eng.hedge_probe_every = 10 ** 9
    got = searcher.query(*queries, k=5, cr=2, batch=4)
    assert eng.shard_stats["hedged_scans"] == 4 * 3
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def port_query_on(snap, backend, queries, device):
    return api.Searcher(snap, backend=backend, device=device).query(
        *queries, k=5, cr=2, batch=4)
