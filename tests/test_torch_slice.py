"""The whole slice: one snapshot directory served by both packages.

``repro.api.Searcher`` and ``repro_torch.api.Searcher`` answer the same
requests from the same directory. With float32 compute the two prefixes
pick the same routes (tests/test_torch_prefix.py), so the final ids must
be equal up to ties and the scores allclose at 1e-5: per backend pair,
per precision tier, with a delta segment (tombstones masked out of the
base scan, delta scan, host merge) and with filters; and with 300
tombstones, where the reference over-fetches its base list past the
kernels' old k limit and the port masks them instead.
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import filters as ref_filters
from repro.core import index as ref_index
from repro_torch import api
from repro_torch.core import delta as port_delta
from repro_torch.core import engine as port_engine
from repro_torch.core import filters as port_filters
from repro_torch.core import index as port_index

from test_torch_common import (assert_topk_match, make_ref_snapshot,
                               make_requests, ref_prefix, tiny_cfg,
                               with_delta, with_tombstones)

PRECISIONS = ("f32", "bf16", "int8")
K, CR, BATCH, N_Q = 6, 2, 8, 20

# (tenant, category mask) per request row; None = no filter
_SPECS = [None, (1, 0), (-1, 0b0101), (0, 0b0011)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(precision, delta?) → (reference snapshot, directory)."""
    base = make_ref_snapshot(tiny_cfg(compute_dtype="float32"))
    out = {}
    for p in PRECISIONS:
        tier = base.with_precision(p)
        for has_delta in (False, True):
            snap = with_delta(tier) if has_delta else tier
            d = str(tmp_path_factory.mktemp(f"{p}_{has_delta}"))
            ref_api.save(snap, d)
            out[(p, has_delta)] = (snap, d)
    return out


def _filters(pkg, n):
    specs = [_SPECS[i % len(_SPECS)] for i in range(n)]
    return [None if s is None else pkg.FilterSpec(tenant=s[0],
                                                  category_mask=s[1])
            for s in specs]


@pytest.mark.parametrize("has_delta", [False, True], ids=["base", "delta"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backends", [("dense", "dense"),
                                      ("dense-cm", "pallas-cm")],
                         ids=lambda b: f"{b[0]}~{b[1]}")
def test_searcher_matches_reference(saved, precision, has_delta, backends):
    port_backend, ref_backend = backends
    snap, d = saved[(precision, has_delta)]
    tok, msk, loc = make_requests(np.random.default_rng(4), N_Q, snap.cfg)
    want = ref_api.Searcher(ref_api.load(d), backend=ref_backend).query(
        tok, msk, loc, k=K, cr=CR, batch=BATCH)
    got = api.Searcher(api.load(d, device="cpu"), backend=port_backend,
                       device="cpu").query(tok, msk, loc, k=K, cr=CR,
                                           batch=BATCH)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    assert_topk_match(got[0], got[1], want[0], want[1])
    if has_delta:                       # tombstoned ids never come back
        assert not np.isin(got[0], [0, 1, 2]).any()


@pytest.mark.parametrize("precision", ["f32"])
def test_filtered_and_auto(saved, precision):
    snap, d = saved[(precision, True)]
    tok, msk, loc = make_requests(np.random.default_rng(5), N_Q, snap.cfg)
    ref_s = ref_api.Searcher(ref_api.load(d), backend="auto")
    port_s = api.Searcher(api.load(d, device="cpu"), device="cpu")
    # float32 compute: the port routes exactly as the reference does
    np.testing.assert_array_equal(
        port_s.engine.route(tok, msk, loc, cr=CR).numpy(),
        ref_prefix(snap, tok, msk, loc, cr=CR)[2])
    for filters in (None, "mixed"):
        fa = None if filters is None else _filters(ref_filters, N_Q)
        fb = None if filters is None else _filters(port_filters, N_Q)
        want = ref_s.query(tok, msk, loc, k=K, cr=CR, batch=BATCH, filters=fa)
        got = port_s.query(tok, msk, loc, k=K, cr=CR, batch=BATCH, filters=fb)
        assert_topk_match(got[0], got[1], want[0], want[1])
    # auto picks what the reference's auto picks on the same batch
    for batch in (2, BATCH):
        want_b = ref_s.engine.pick_backend(tok, msk, loc, cr=CR, batch=batch)
        got_b = port_s.engine.pick_backend(tok, msk, loc, cr=CR, batch=batch)
        assert got_b == want_b.replace("pallas", "cuda")
        assert port_s.engine.last_dedup_factor == pytest.approx(
            ref_s.engine.last_dedup_factor)


def test_backends_bound_to_their_device(saved):
    snap, d = saved[("f32", False)]
    psnap = api.load(d, device="cpu")
    for backend in ("cuda", "cuda-cm"):
        with pytest.raises(ValueError):
            api.Searcher(psnap, backend=backend, device="cpu")
    assert port_engine.resolve_backend("auto", "cpu") == "dense"
    assert port_engine.resolve_backend("auto", "cuda") == "cuda"
    with pytest.raises(ValueError):
        port_engine.resolve_backend("dense", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            api.Searcher(psnap)                     # default device: cuda


def test_merge_delta_matches_reference():
    from repro.core import engine as ref_engine
    rng = np.random.default_rng(6)
    b, kb, kd, k = 5, 12, 6, 8
    base_i = rng.permutation(100)[:b * kb].reshape(b, kb).astype(np.int32)
    base_s = np.sort(rng.normal(size=(b, kb)).astype(np.float32))[:, ::-1]
    base_s[0, 3] = base_s[0, 4]                     # an exact tie
    d_i = (1000 + np.arange(b * kd)).reshape(b, kd).astype(np.int32)
    d_s = rng.normal(size=(b, kd)).astype(np.float32)
    d_s[0, 0] = base_s[0, 2]                        # base wins the tie
    tomb = np.sort(base_i[:, 1])
    want = ref_engine.merge_delta(base_i, base_s, d_i, d_s,
                                  tombstones=tomb, k=k)
    got = port_engine.merge_delta(base_i, base_s, d_i, d_s,
                                  tombstones=tomb, k=k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("capacity,spill", [(64, 2), (48, 1), (41, 3)])
def test_placement_matches_reference(capacity, spill):
    """The spill walk places every object in the reference's slot,
    including spills and least-loaded fallbacks."""
    rng = np.random.default_rng(capacity)
    n, c, d = 160, 4, 16
    # skewed preferences so clusters fill and objects spill / fall back
    top = np.stack([rng.choice(c, size=3, replace=False,
                               p=[0.55, 0.25, 0.15, 0.05])
                    for _ in range(n)]).astype(np.int32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    loc = rng.uniform(size=(n, 2)).astype(np.float32)
    attrs = ref_filters.make_attrs(rng.integers(0, 3, n), 1, np.arange(n))
    for precision in PRECISIONS:
        want = ref_index.build_cluster_buffers(
            top, emb, loc, n_clusters=c, capacity=capacity, spill=spill,
            precision=precision, attrs=attrs)
        got = port_index.build_cluster_buffers(
            top, torch.from_numpy(emb), torch.from_numpy(loc), n_clusters=c,
            capacity=capacity, spill=spill, precision=precision,
            attrs=torch.from_numpy(attrs), chunk_clusters=3)
        assert got["n_spilled"] == want["n_spilled"] > 0
        for key in ("ids", "counts", "loc", "attrs", "scale"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), key)
        we = np.asarray(want["emb"])
        ge = got["emb"]
        if precision == "bf16":
            ge = ge.view(torch.int16).numpy()
            we = we.view(np.int16)
        np.testing.assert_array_equal(np.asarray(ge), we)
    assert port_index.default_capacity(2_849_754, 300) == 19_072


# ---------------------------------------------------------------------------
# Tombstones masked out of the base scan
# ---------------------------------------------------------------------------

# 300 of 500 objects tombstoned; the reference over-fetches k 20 to 340
# (k + 10 buckets of 32) of its 640 routed rows
N_TOMB, TOMB_OBJ, TOMB_CAP, TOMB_K = 300, 500, 320, 20


def ref_on_cpu():
    """Run the reference's jax on the CPU. On a machine where jax also sees
    a GPU, its f32 products there default to TF32 and miss the port's f32
    scores by ~1e-3."""
    return jax.default_device(jax.devices("cpu")[0])


@pytest.fixture(scope="module")
def tombstoned(tmp_path_factory):
    """precision → (reference snapshot with 300 tombstones, directory)."""
    with ref_on_cpu():
        base = make_ref_snapshot(tiny_cfg(compute_dtype="float32"),
                                 n_obj=TOMB_OBJ, capacity=TOMB_CAP)
        out = {}
        for p in PRECISIONS:
            snap = with_tombstones(base.with_precision(p), N_TOMB)
            d = str(tmp_path_factory.mktemp(f"tomb_{p}"))
            ref_api.save(snap, d)
            out[p] = (snap, d)
    return out


@pytest.mark.parametrize("backend", ["dense", "dense-cm"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_tombstone_mask_matches_reference(tombstoned, precision, backend):
    """The port scans at k 20 over ids with the tombstones masked to -1;
    the reference scans at k 340 and drops them. Equal ids, scores at
    1e-5, no tombstoned id, k live entries per row."""
    snap, d = tombstoned[precision]
    assert snap.delta.n_tombstones == N_TOMB
    tok, msk, loc = make_requests(np.random.default_rng(8), N_Q, snap.cfg)
    want = ref_api.Searcher(ref_api.load(d), backend=backend).query(
        tok, msk, loc, k=TOMB_K, cr=CR, batch=BATCH)
    searcher = api.Searcher(api.load(d, device="cpu"), backend=backend,
                            device="cpu")
    got = searcher.query(tok, msk, loc, k=TOMB_K, cr=CR, batch=BATCH)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    assert not np.isin(got[0], snap.delta.tombstone_array()).any()
    assert (got[0] >= 0).all()
    # one scan width: the plans are keyed (batch, k, ...)
    assert {key[1] for key in searcher.engine._plans} == {TOMB_K}


def test_mask_tombstones_sets_exactly_the_dead_ids():
    ids = torch.tensor([[5, -1, 7, 2 ** 31 - 1], [0, 9, 5, 3]],
                       dtype=torch.int32)
    got = port_delta.mask_tombstones(ids, np.array([5, 3, -1, 2 ** 40]))
    np.testing.assert_array_equal(
        got.numpy(), [[-1, -1, 7, 2 ** 31 - 1], [0, 9, -1, -1]])
    assert ids[0, 0] == 5                       # a copy: the buffer is kept


def test_scan_view_masks_once_per_snapshot(tombstoned, saved):
    """A snapshot whose delta holds tombstones scans a view with them
    masked, built once and kept by that snapshot alone; one without
    tombstones scans itself."""
    snap = api.load(tombstoned["f32"][1], device="cpu")
    view = snap.scan_view
    assert view is not snap
    assert view.buffers["ids"] is snap.scan_view.buffers["ids"]
    assert view.buffers["emb"] is snap.buffers["emb"]
    dead = snap.delta.tombstone_array()
    assert not np.isin(view.buffers["ids"].numpy(), dead).any()
    assert np.isin(snap.buffers["ids"].numpy(), dead).sum() == N_TOMB
    plain = api.load(saved[("f32", False)][1], device="cpu")
    assert plain.scan_view is plain


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "cuda-cm", "auto"])
def test_cuda_tombstones_match_reference(cuda_device, tombstoned, backend):
    """The CUDA backends with 300 tombstones, at k 20 and at k 300 (both
    past the old over-fetch's kernel limit of 256), against the
    reference's dense backend on the rows whose routes agree."""
    for precision in PRECISIONS:
        snap, d = tombstoned[precision]
        tok, msk, loc = make_requests(np.random.default_rng(8), N_Q,
                                      snap.cfg)
        port = api.Searcher(api.load(d, device=cuda_device), backend=backend,
                            device=cuda_device)
        with ref_on_cpu():
            top_ref = ref_prefix(snap, tok, msk, loc, cr=CR)[2]
            ref = ref_api.Searcher(ref_api.load(d), backend="dense")
        same = (port.engine.route(tok, msk, loc, cr=CR).cpu().numpy()
                == top_ref).all(axis=1)
        assert same.mean() >= 0.9
        for k in (TOMB_K, 300):
            with ref_on_cpu():
                want = ref.query(tok, msk, loc, k=k, cr=CR, batch=BATCH)
            got = port.query(tok, msk, loc, k=k, cr=CR, batch=BATCH)
            assert_topk_match(got[0][same], got[1][same], want[0][same],
                              want[1][same], atol=1e-4, rtol=1e-5)
            assert not np.isin(got[0], snap.delta.tombstone_array()).any()
