"""The whole slice: one snapshot directory served by both packages.

``repro.api.Searcher`` and ``repro_torch.api.Searcher`` answer the same
requests from the same directory. With float32 compute the two prefixes
pick the same routes (tests/test_torch_prefix.py), so the final ids must
be equal up to ties and the scores allclose at 1e-5: per backend pair,
per precision tier, with a delta segment (tombstone over-fetch, delta
scan, host merge) and with filters.
"""
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import filters as ref_filters
from repro.core import index as ref_index
from repro_torch import api
from repro_torch.core import engine as port_engine
from repro_torch.core import filters as port_filters
from repro_torch.core import index as port_index

from test_torch_common import (assert_topk_match, make_ref_snapshot,
                               make_requests, ref_prefix, tiny_cfg,
                               with_delta)

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
