"""The port's dispatch path ("clusters as experts") against the reference.

Every case of ``tests/test_dispatch_roundtrip.py`` runs here on both
packages (``pkg``), keeping the reference test's assertions; on the port
the outputs must also equal the reference's. Then
``cluster_dispatch_query`` on one artifact the reference saved and the
port loads, at f32 / bf16 / int8, with capacity drops and queries whose
every route dropped (their rows are ``(-1, -inf)``): ids equal, scores
within 1e-5. The kernel branch of the dispatch scan
(``serving.dispatch_scan_cluster_major``: every cluster a roster row of
the cluster-major scan, ``origin`` its roster, the dropped pairs' rows
overwritten) is held against the plain dispatch scan on the CPU, where
it runs the cluster-major kernel's plain version, and on the card
(``cuda``) through the kernel itself.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import index as ref_index
from repro.core import serving as ref_serving
from repro_torch import api
from repro_torch.core import serving as port_serving
from repro_torch.kernels import fused_topk_score as fts

from test_torch_common import (make_ref_snapshot, ref_on_cpu,
                               serve_requests, tiny_cfg)

PKGS = ("ref", "port")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and beside the suite's other workers a team of threads waits on
    every barrier for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _dispatch(pkg, top_c, feat, c, cap):
    if pkg == "ref":
        q_buf, origin, nd = ref_serving.dispatch_queries(
            jnp.asarray(top_c), jnp.asarray(feat), n_clusters=c,
            capacity=cap)
    else:
        q_buf, origin, nd = port_serving.dispatch_queries(
            torch.from_numpy(top_c), torch.from_numpy(feat), n_clusters=c,
            capacity=cap)
    return np.asarray(q_buf), np.asarray(origin), int(nd)


def _checked_dispatch(pkg, top_c, feat, c, cap):
    """``_dispatch`` on ``pkg``; the port's outputs equal the reference's."""
    out = _dispatch(pkg, top_c, feat, c, cap)
    if pkg == "port":
        want = _dispatch("ref", top_c, feat, c, cap)
        np.testing.assert_array_equal(out[0], want[0])
        np.testing.assert_array_equal(out[1], want[1])
        assert out[2] == want[2]
    return out


def _unique_payload(b, cr):
    return np.arange(b, dtype=np.float32)[:, None] + 1000.0


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("b,cr,c,cap", [
    (16, 2, 4, 16),      # ample capacity
    (32, 1, 8, 8),       # tight
    (8, 4, 2, 32),       # few clusters, heavy multi-route
])
def test_roundtrip_invariants(b, cr, c, cap, seed, pkg):
    rng = np.random.default_rng(seed)
    top_c = rng.integers(0, c, size=(b, cr)).astype(np.int32)
    feat = _unique_payload(b, cr)
    q_buf, origin, n_dropped = _checked_dispatch(pkg, top_c, feat, c, cap)

    n = b * cr
    placed = origin[origin < n]
    assert len(set(placed.tolist())) == len(placed)
    assert len(placed) + n_dropped == n
    flat = top_c.reshape(-1)
    for ci in range(c):
        demand = int((flat == ci).sum())
        landed = int((origin[ci] < n).sum())
        assert landed == min(demand, cap)
    for ci in range(c):
        for s in range(cap):
            o = origin[ci, s]
            if o < n:
                assert flat[o] == ci
                assert q_buf[ci, s, 0] == feat[o // cr, 0]
    assert (q_buf[origin >= n] == 0).all()


@pytest.mark.parametrize("pkg", PKGS)
def test_overflow_is_counted_not_silent(pkg):
    b, c, cap = 16, 4, 8
    top_c = np.zeros((b, 1), np.int32)
    q_buf, origin, n_dropped = _checked_dispatch(
        pkg, top_c, _unique_payload(b, 1), c, cap)
    assert n_dropped == b - cap
    assert int((origin < b).sum()) == cap
    assert sorted(origin[0][origin[0] < b].tolist()) == list(range(cap))


@pytest.mark.parametrize("pkg", PKGS)
def test_no_drops_when_capacity_suffices(pkg):
    b, cr, c, cap = 12, 2, 3, 24
    rng = np.random.default_rng(3)
    top_c = rng.integers(0, c, size=(b, cr)).astype(np.int32)
    _, origin, n_dropped = _checked_dispatch(
        pkg, top_c, _unique_payload(b, cr), c, cap)
    assert n_dropped == 0
    assert int((origin < b * cr).sum()) == b * cr


@pytest.mark.parametrize("pkg", PKGS)
def test_dispatch_degenerate_all_distinct(pkg):
    b, cr, c = 4, 2, 8
    top_c = np.arange(8, dtype=np.int32).reshape(b, cr)
    _, origin, n_dropped = _checked_dispatch(
        pkg, top_c, _unique_payload(b, cr), c, 1)
    assert n_dropped == 0
    assert ((origin < b * cr).sum(axis=1) == 1).all()


# ---------------------------------------------------------------------------
# cluster_major_plan: the DISTINCT-cluster roster
# ---------------------------------------------------------------------------


def _plan_of(pkg, top_c, c, **kw):
    if pkg == "ref":
        out = ref_serving.cluster_major_plan(jnp.asarray(top_c),
                                             n_clusters=c, **kw)
    else:
        out = port_serving.cluster_major_plan(torch.from_numpy(top_c),
                                              n_clusters=c,
                                              return_dropped=True, **kw)
    u, roster, n_distinct, n_dropped = out
    return (np.asarray(u), np.asarray(roster), int(n_distinct),
            int(n_dropped))


def _plan(pkg, top_c, c, **kw):
    out = _plan_of(pkg, top_c, c, **kw)
    if pkg == "port":
        want = _plan_of("ref", top_c, c, **kw)
        for got, ref in zip(out, want):
            np.testing.assert_array_equal(got, ref)
    return out


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("b,cr,c", [(16, 2, 4), (8, 4, 2), (6, 1, 8)])
def test_cluster_major_plan_roundtrip_invariants(b, cr, c, seed, pkg):
    rng = np.random.default_rng(seed)
    top_c = rng.integers(0, c, size=(b, cr)).astype(np.int32)
    u, roster, n_distinct, n_dropped = _plan(pkg, top_c, c)
    n = b * cr
    flat = top_c.reshape(-1)
    distinct = np.unique(flat)
    assert n_distinct == len(distinct)
    assert (u[:n_distinct] == distinct).all()
    placed = roster[roster < n]
    assert len(set(placed.tolist())) == len(placed)
    assert len(placed) + n_dropped == n
    assert n_dropped == 0
    for slot in range(len(u)):
        entries = roster[slot][roster[slot] < n]
        if slot < n_distinct:
            assert sorted(entries.tolist()) == sorted(
                np.flatnonzero(flat == u[slot]).tolist())
        else:
            assert entries.size == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_cluster_major_plan_single_cluster_saturation(pkg):
    b, cr, c = 8, 2, 4
    n = b * cr
    top_c = np.full((b, cr), 2, np.int32)
    u, roster, n_distinct, n_dropped = _plan(pkg, top_c, c)
    assert n_distinct == 1 and n_dropped == 0 and u[0] == 2
    assert sorted(roster[0].tolist()) == list(range(n))
    assert (roster[1:] == n).all()
    u, roster, n_distinct, n_dropped = _plan(pkg, top_c, c, qcap=n - 1)
    assert n_distinct == 1 and n_dropped == 1
    assert sorted(roster[0].tolist()) == list(range(n - 1))


@pytest.mark.parametrize("pkg", PKGS)
def test_cluster_major_plan_all_distinct(pkg):
    b, cr, c = 4, 2, 8
    top_c = np.arange(8, dtype=np.int32).reshape(b, cr)
    u, roster, n_distinct, n_dropped = _plan(pkg, top_c, c, qcap=1)
    assert n_distinct == b * cr and n_dropped == 0
    assert (u == np.arange(8)).all()
    assert ((roster < b * cr).sum(axis=1) == 1).all()


@pytest.mark.parametrize("pkg", PKGS)
def test_cluster_major_plan_u_max_truncation_counted(pkg):
    b, cr, c = 4, 1, 8
    top_c = np.array([[0], [2], [5], [7]], np.int32)
    u, roster, n_distinct, n_dropped = _plan(pkg, top_c, c, u_max=2)
    assert n_distinct == 4
    assert n_dropped == 2
    assert (u == np.array([0, 2])).all()


# ---------------------------------------------------------------------------
# cluster_dispatch_query end to end, both packages over one artifact
# ---------------------------------------------------------------------------


def _small_snapshots(tmp_path, n_layers):
    """The reference test's snapshot (d 16, c 2, cap 32, 64 objects):
    ``(ref snapshot, port snapshot loaded from its save)``."""
    cfg = tiny_cfg(n_layers=n_layers, d_model=16, n_heads=2, d_ff=32,
                   vocab_size=256, max_len=8, spatial_t=20, n_clusters=2,
                   index_mlp_hidden=(8,), compute_dtype="float32")
    with ref_on_cpu():
        snap = make_ref_snapshot(cfg, seed=0, n_obj=64, capacity=32)
        snap.save(str(tmp_path))
    return snap, api.load(str(tmp_path), device="cpu")


def _ref_dispatch(snap, tok, msk, loc, **kw):
    with ref_on_cpu():
        out = ref_serving.cluster_dispatch_query(
            snap, jnp.asarray(tok), jnp.asarray(msk), jnp.asarray(loc), **kw)
        return tuple(np.asarray(x) for x in out)


def _port_dispatch(snap, tok, msk, loc, **kw):
    out = port_serving.cluster_dispatch_query(snap, tok, msk, loc, **kw)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("pkg", PKGS)
def test_cluster_dispatch_query_surfaces_drops(pkg, tmp_path):
    """return_dropped reports the overflow; dropped queries come back as
    (-1, -inf) rows, not wrong results (capacity 1 on 2 clusters)."""
    ref_snap, port_snap = _small_snapshots(tmp_path, n_layers=1)
    rng = np.random.default_rng(0)
    tok = rng.integers(2, 256, (8, 8)).astype(np.int32)
    msk = np.ones((8, 8), bool)
    ql = rng.uniform(size=(8, 2)).astype(np.float32)
    kw = dict(k=4, cr=1, capacity=1, return_dropped=True)
    want = _ref_dispatch(ref_snap, tok, msk, ql, **kw)
    ids, sc, nd = (want if pkg == "ref"
                   else _port_dispatch(port_snap, tok, msk, ql, **kw))
    with ref_on_cpu():
        q_emb = np.asarray(ref_serving.relevance.encode_queries(
            ref_snap.rel_params, jnp.asarray(tok), jnp.asarray(msk),
            ref_snap.cfg))
        top = np.asarray(ref_index.route_queries(
            ref_snap.index_params, ref_index.build_features(
                jnp.asarray(q_emb), jnp.asarray(ql), ref_snap.norm),
            cr=1)[0])
    assert int(nd) == 8 - len(np.unique(top))
    dropped_rows = ids[(sc == -np.inf).all(1)]
    assert len(dropped_rows) and (dropped_rows == -1).all()
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(sc, want[1], atol=1e-5, rtol=1e-5)
    assert int(nd) == int(want[2])


@pytest.mark.parametrize("pkg", PKGS)
def test_dispatch_quantized_snapshot_and_int8_guard(pkg, tmp_path):
    """int8 snapshots serve through the shared dequant (scores within
    quantization error of f32); int8 buffers without precision / scales
    raise."""
    ref_snap, port_snap = _small_snapshots(tmp_path, n_layers=2)
    rng = np.random.default_rng(1)
    tok = rng.integers(2, 256, (8, 8)).astype(np.int32)
    msk = np.ones((8, 8), bool)
    ql = rng.uniform(size=(8, 2)).astype(np.float32)
    run = _ref_dispatch if pkg == "ref" else _port_dispatch
    snap = ref_snap if pkg == "ref" else port_snap
    ids_f, sc_f = run(snap, tok, msk, ql, k=4)
    ids_q, sc_q = run(snap.with_precision("int8"), tok, msk, ql, k=4)
    np.testing.assert_allclose(sc_q, sc_f, rtol=0.05, atol=0.05)
    if pkg == "ref":
        qbuf = snap.with_precision("int8").buffers
        with ref_on_cpu(), pytest.raises(ValueError, match="int8"):
            ref_serving.dispatch_query_kernel(
                snap.rel_params, snap.index_params, snap.w_hat, snap.norm,
                qbuf["emb"], qbuf["loc"], qbuf["ids"], jnp.asarray(tok),
                jnp.asarray(msk), jnp.asarray(ql), snap.cfg, k=4,
                dist_max=1.414)
    else:
        qbuf = snap.with_precision("int8").buffers
        with pytest.raises(ValueError, match="int8"):
            port_serving.dispatch_query_kernel(
                snap.rel, snap.index, snap.w_hat, snap.norm, qbuf["emb"],
                qbuf["loc"], qbuf["ids"], tok, msk, ql, k=4, dist_max=1.414)
        want_f = _ref_dispatch(ref_snap, tok, msk, ql, k=4)
        np.testing.assert_array_equal(ids_f, want_f[0])
        np.testing.assert_allclose(sc_f, want_f[1], atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A reference snapshot (f32 compute, d 32, c 4, cap 64, 160 objects)
    at each tier, saved by the reference: ``{tier: (ref, port)}``."""
    from test_torch_common import serve_cfg
    cfg = serve_cfg()
    out = {}
    with ref_on_cpu():
        base = make_ref_snapshot(cfg)
        for p in ("f32", "bf16", "int8"):
            snap = base.with_precision(p)
            d = str(tmp_path_factory.mktemp(f"dispatch_{p}"))
            snap.save(d)
            out[p] = (snap, api.load(d, device="cpu"))
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cr,capacity", [(2, 8), (1, 8), (2, None), (3, 192)])
def test_dispatch_query_matches_reference(artifact, precision, cr, capacity):
    """Ids equal and scores within 1e-5 of the reference's, the dropped
    pairs' -inf included; at capacity 8 some query loses every route."""
    ref_snap, port_snap = artifact[precision]
    tok, msk, loc = serve_requests(np.random.default_rng(5), 64,
                                   ref_snap.cfg)
    kw = dict(k=5, cr=cr, capacity=capacity, return_dropped=True)
    want = _ref_dispatch(ref_snap, tok, msk, loc, **kw)
    got = _port_dispatch(port_snap, tok, msk, loc, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    assert int(got[2]) == int(want[2])
    if capacity == 8:
        assert int(want[2]) > 0
        assert (want[1] == -np.inf).all(1).any()     # every route dropped
    if capacity == 192:                     # B·cr: nothing can drop
        assert int(want[2]) == 0 and np.isfinite(want[1]).all()


def _scan_inputs(port_snap, cr, capacity, dev="cpu"):
    """The dispatch scan's inputs for 64 requests on ``port_snap``."""
    from repro_torch.core import engine as engine_lib
    snap = port_snap.to(dev)
    tok, msk, loc = serve_requests(np.random.default_rng(5), 64, snap.cfg)
    args = [torch.from_numpy(a).to(dev) for a in (tok, msk, loc)]
    q_emb, w, top_c = engine_lib.make_prefix_fn(cr=cr)(
        snap.rel, snap.index, snap.norm, *args)
    c = snap.buffers["emb"].shape[0]
    origin, nd = port_serving.dispatch_slots(top_c, n_clusters=c,
                                             capacity=capacity)
    buf = snap.buffers
    scale = buf["scale"] if snap.meta.precision == "int8" else None
    return (q_emb, args[2], w, origin, buf["emb"], buf["loc"], buf["ids"],
            snap.w_hat), scale, int(nd)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cr,capacity", [(2, 8), (2, 64)])
def test_kernel_branch_roster_semantics(artifact, precision, cr, capacity):
    """The kernel branch (``dispatch_scan_cluster_major``) on the CPU: the
    cluster-major scan's plain version over ``u = arange(c)`` and ``roster
    = origin``, the dropped pairs' rows set to (-inf, -1), equals the
    plain dispatch scan."""
    args, scale, nd = _scan_inputs(artifact[precision][1], cr, capacity)
    kw = dict(k=5, cr=cr, dist_max=1.414, buf_scale=scale)
    want = port_serving.dispatch_scan_plain(*args, **kw)
    got = port_serving.dispatch_scan_cluster_major(*args, **kw)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5,
                               rtol=1e-5)
    assert (nd > 0) == (capacity == 8)
    assert port_serving.dispatch_scan(*args, **kw)[1].equal(want[1])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the cluster-major kernel has no CPU mode")
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_dispatch_kernel_matches_plain_on_card(artifact, precision):
    """The kernel branch of ``dispatch_scan`` on the card against
    ``dispatch_scan_plain`` on the same CUDA tensors, with drops."""
    dev = torch.device("cuda")
    for cr, capacity in ((2, 8), (2, 64)):
        args, scale, _ = _scan_inputs(artifact[precision][1], cr, capacity,
                                      dev=dev)
        fts.reset_launch_counts()
        got = port_serving.dispatch_scan(*args, k=5, cr=cr, dist_max=1.414,
                                         buf_scale=scale)
        assert fts.launches["cluster_major"] == 1
        want = port_serving.dispatch_scan_plain(*args, k=5, cr=cr,
                                                dist_max=1.414,
                                                buf_scale=scale)
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].cpu().numpy())
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), atol=1e-4,
                                   rtol=1e-5)
