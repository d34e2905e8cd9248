"""The port's scan kernel module against the reference's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels.fused_topk_score`` runs
its plain PyTorch version; it is held against the reference's
``pallas``/``pallas-cm`` kernels (interpret mode) and ``dense``/``dense-cm``
backends, fed the reference's own ``(q_emb, w, top_c)``, for 3 precision
tiers × filtered/unfiltered. The reference's own engine disagrees with
the numpy oracle on its bf16/int8 filtered legs (tests/test_filters.py),
so those legs are held against the numpy oracle instead. Ids must be
equal up to ties; scores allclose at 1e-5.

The CUDA kernels themselves are compared with the plain versions on the
card (``@pytest.mark.cuda``, skipped without one).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import filters as ref_filters
from repro_torch.core import engine as port_engine
from repro_torch.core import serving as port_serving
from repro_torch.kernels import fused_topk_score as fts

from test_torch_common import (DIST_MAX, assert_topk_match, make_ref_snapshot,
                               make_requests, numpy_oracle, ref_buffers_np,
                               ref_prefix, tiny_cfg, to_torch)

PRECISIONS = ("f32", "bf16", "int8")
REF_BACKENDS = ("pallas", "pallas-cm", "dense", "dense-cm")
B, K, CR = 10, 7, 2

_CACHE = {}


def _specs(b):
    roster = [None, ref_filters.FilterSpec(tenant=1),
              ref_filters.FilterSpec(category_mask=0b0101),
              ref_filters.FilterSpec(t_min=200, t_max=700),
              ref_filters.FilterSpec(tenant=0, category_mask=0b0011,
                                     t_min=100)]
    return [roster[i % len(roster)] for i in range(b)]


def _inputs(precision):
    """The reference snapshot at ``precision`` and its prefix outputs."""
    key = ("in", precision)
    if key not in _CACHE:
        if "snap" not in _CACHE:
            _CACHE["snap"] = make_ref_snapshot(tiny_cfg())
        snap = _CACHE["snap"]
        snap = snap if precision == "f32" else snap.with_precision(precision)
        rng = np.random.default_rng(11)
        tok, msk, loc = make_requests(rng, B, snap.cfg)
        q_emb, w, top_c = ref_prefix(snap, tok, msk, loc, cr=CR)
        fvals, _ = ref_filters.compile_filters(_specs(B), B)
        _CACHE[key] = (snap, q_emb, w, top_c, loc, fvals)
    return _CACHE[key]


def _reference(precision, filtered, backend):
    key = ("ref", precision, filtered, backend)
    if key not in _CACHE:
        snap, q_emb, w, top_c, loc, fvals = _inputs(precision)
        buf = snap.buffers
        ids, sc = ref_engine._routed_topk(
            jnp.asarray(q_emb), jnp.asarray(loc), jnp.asarray(w),
            jnp.asarray(top_c), buf["emb"], buf["loc"], buf["ids"],
            buf["scale"], snap.w_hat, k=K, backend=backend,
            interpret=True, dist_max=DIST_MAX, block_n=32,
            precision=precision,
            buf_attrs=buf["attrs"] if filtered else None,
            q_filt=jnp.asarray(fvals) if filtered else None)
        _CACHE[key] = (np.asarray(ids), np.asarray(sc))
    return _CACHE[key]


def _oracle(precision, filtered):
    snap, q_emb, w, top_c, loc, fvals = _inputs(precision)
    return numpy_oracle(q_emb, w, top_c, loc, ref_buffers_np(snap),
                        np.asarray(snap.w_hat), fvals if filtered else None,
                        k=K, precision=precision)


def _port(precision, filtered, kernel):
    """The port's kernel module on CPU tensors (its plain versions)."""
    snap, q_emb, w, top_c, loc, fvals = _inputs(precision)
    nb = ref_buffers_np(snap)
    buf = {k: to_torch(v) for k, v in nb.items()}
    args = dict(k=K, dist_max=DIST_MAX,
                buf_scale=buf["scale"] if precision == "int8" else None,
                buf_attrs=buf["attrs"] if filtered else None,
                q_filt=to_torch(fvals) if filtered else None)
    q, l, ww, tc = (to_torch(x) for x in (q_emb, loc, w, top_c))
    w_hat = to_torch(np.asarray(snap.w_hat))
    if kernel == "routed":
        sc, ids = fts.fused_topk_score_routed(
            q, l, ww, tc, buf["emb"], buf["loc"], buf["ids"], w_hat, **args)
    else:
        u, roster, _ = port_serving.cluster_major_plan(
            tc, n_clusters=buf["emb"].shape[0])
        ps, pi = fts.fused_topk_score_cluster_major(
            q, l, ww, u, roster, buf["emb"], buf["loc"], buf["ids"], w_hat,
            cr=CR, **args)
        sc, ids = port_engine.merge_cluster_major(ps, pi, b=B, cr=CR, k=K)
    return ids.numpy(), sc.numpy()


@pytest.mark.parametrize("ref_backend", REF_BACKENDS)
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kernel", ["routed", "cluster_major"])
def test_kernel_module_matches_reference(kernel, precision, filtered,
                                         ref_backend):
    before = dict(fts.launches)
    ids, sc = _port(precision, filtered, kernel)
    assert fts.launches == before          # CPU tensors never launch
    if filtered and precision != "f32":
        want_i, want_s = _oracle(precision, filtered)
        assert_topk_match(ids, sc, want_i, want_s, atol=2e-4, rtol=2e-4)
    else:
        want_i, want_s = _reference(precision, filtered, ref_backend)
        assert_topk_match(ids, sc, want_i, want_s)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_plain_versions_match_numpy_oracle(precision):
    """Both plain versions, unfiltered and filtered, against the oracle."""
    for filtered in (False, True):
        want_i, want_s = _oracle(precision, filtered)
        for kernel in ("routed", "cluster_major"):
            ids, sc = _port(precision, filtered, kernel)
            assert_topk_match(ids, sc, want_i, want_s, atol=2e-4, rtol=2e-4)


def test_cluster_major_plan_matches_reference():
    from repro.core import serving as ref_serving
    rng = np.random.default_rng(5)
    for b, cr, c in ((6, 2, 4), (16, 3, 5), (1, 1, 3)):
        top_c = rng.integers(0, c, (b, cr)).astype(np.int32)
        want = ref_serving.cluster_major_plan(jnp.asarray(top_c),
                                              n_clusters=c)
        got = port_serving.cluster_major_plan(torch.from_numpy(top_c),
                                              n_clusters=c)
        assert int(want[3]) == 0           # the reference drops nothing
        assert len(got) == 3
        for w_, g_ in zip(want[:3], got):
            np.testing.assert_array_equal(np.asarray(w_), g_.numpy())
        np.testing.assert_array_equal(
            np.asarray(ref_serving.roster_query_rows(want[1], cr=cr,
                                                     n_total=b * cr)),
            port_serving.roster_query_rows(got[1], cr=cr,
                                           n_total=b * cr).numpy())


def test_wrappers_reject_half_a_filter():
    snap, q_emb, w, top_c, loc, fvals = _inputs("f32")
    buf = {k: to_torch(v) for k, v in ref_buffers_np(snap).items()}
    with pytest.raises(ValueError):
        fts.fused_topk_score_routed(
            to_torch(q_emb), to_torch(loc), to_torch(w), to_torch(top_c),
            buf["emb"], buf["loc"], buf["ids"],
            to_torch(np.asarray(snap.w_hat)), k=K, dist_max=DIST_MAX,
            buf_attrs=buf["attrs"])


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kernels_match_plain(cuda_device, precision, filtered):
    rng = np.random.default_rng(7)
    c, cap, d, b, cr, k, t = 6, 96, 64, 12, 2, 40, 50
    emb = rng.normal(size=(c, cap, d)).astype(np.float32)
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.uniform(size=(c, cap)) < 0.3] = -1
    buf = {"emb": torch.from_numpy(emb), "ids": torch.from_numpy(ids),
           "loc": torch.from_numpy(rng.uniform(size=(c, cap, 2))
                                   .astype(np.float32)),
           "attrs": torch.from_numpy(make_attrs_np(rng, c * cap)
                                     .reshape(c, cap, 3))}
    from repro_torch.core import index as port_index
    buf["emb"], buf["scale"] = port_index.quantize_rows(buf["emb"], precision)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    q_loc = torch.from_numpy(rng.uniform(size=(b, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.2, 1.0, (b, 2)).astype(np.float32))
    top_c = torch.from_numpy(rng.integers(0, c, (b, cr)).astype(np.int32))
    w_hat = torch.cumsum(torch.rand(t, generator=torch.Generator()
                                    .manual_seed(0)), 0)
    fvals, _ = ref_filters.compile_filters(_specs(b), b)
    kw = dict(k=k, dist_max=DIST_MAX,
              buf_scale=buf["scale"] if precision == "int8" else None,
              buf_attrs=buf["attrs"] if filtered else None,
              q_filt=torch.from_numpy(fvals) if filtered else None)
    dev = {key: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
           for key, v in kw.items()}
    args = (q, q_loc, w, top_c, buf["emb"], buf["loc"], buf["ids"], w_hat)
    dargs = tuple(a.to(cuda_device) for a in args)
    want = fts.routed_topk_plain(*dargs, **dev)
    got = fts.fused_topk_score_routed(*dargs, **dev)
    torch.cuda.synchronize()
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)
    u, roster, _ = port_serving.cluster_major_plan(dargs[3], n_clusters=c)
    got = fts.fused_topk_score_cluster_major(
        dargs[0], dargs[1], dargs[2], u, roster, *dargs[4:], cr=cr, **dev)
    want = fts.cluster_major_partials_plain(
        dargs[0], dargs[1], dargs[2], u, roster, *dargs[4:], cr=cr, **dev)
    torch.cuda.synchronize()
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)


def make_attrs_np(rng, n):
    return ref_filters.make_attrs(rng.integers(0, 3, n),
                                  rng.integers(0, 16, n),
                                  rng.integers(0, 1000, n))


def test_spatial_bucket_uses_true_division():
    """S_in divides by dist_max exactly (IEEE), never by multiplying with
    its reciprocal, which lands one ulp off for about a third of inputs."""
    from repro_torch.core import spatial as port_spatial
    x = np.random.default_rng(9).uniform(0, 2, 20000).astype(np.float32)
    q = np.zeros((x.size, 2), np.float32)
    o = np.stack([x, np.zeros_like(x)], -1)
    true = np.float32(1) - np.clip(x / np.float32(DIST_MAX), 0, 1)
    recip = np.float32(1) - np.clip(x * np.float32(1 / np.float32(DIST_MAX)),
                                    0, 1)
    assert (true != recip).any()
    got = port_spatial.s_in_from_locs(torch.from_numpy(q), torch.from_numpy(o),
                                      DIST_MAX).numpy()
    np.testing.assert_array_equal(got, true)


def test_jitted_reference_bucket_witness():
    """One distance on which the reference's jitted S_in lands in another
    bucket of ⌊S_in·t⌋ than its eager (true-division) S_in: XLA turns the
    division by the constant dist_max into a reciprocal multiply. The
    port takes the eager bucket. ŵ = arange(t), so SRel is the bucket."""
    import jax
    from repro.core import spatial as ref_spatial
    from repro_torch.core import spatial as port_spatial
    dist_max, t = 1.4142, 1000
    x = np.array([0x3F4A0401], np.uint32).view(np.float32)   # 0.78912359…
    q = np.zeros((1, 2), np.float32)
    o = np.stack([x, np.zeros_like(x)], -1)
    w_hat = np.arange(t, dtype=np.float32)

    def ref_srel(a, b):
        return ref_spatial.spatial_relevance_serve(
            jnp.asarray(w_hat), ref_spatial.s_in_from_locs(a, b, dist_max))

    eager = float(ref_srel(jnp.asarray(q), jnp.asarray(o))[0])
    jitted = float(jax.jit(ref_srel)(q, o)[0])
    port = float(port_spatial.spatial_relevance_serve(
        torch.from_numpy(w_hat), port_spatial.s_in_from_locs(
            torch.from_numpy(q), torch.from_numpy(o), dist_max))[0])
    assert (eager, jitted) == (441.0, 442.0)
    assert port == eager
