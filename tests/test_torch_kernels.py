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
from repro_torch.core import index as port_index
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
# The tiled scans' launch shape, work items and chunk-partial merge
# ---------------------------------------------------------------------------


ELEM_SIZES = dict(int8=1, bf16=2, f32=4)


@pytest.mark.parametrize("elem_size", list(ELEM_SIZES.values()),
                         ids=list(ELEM_SIZES))
def test_launch_shape_fits_shared_memory(elem_size):
    """The engine scans' layout fits a block's 227 KB at every capacity,
    width and k up to K_MAX; chunks tile the buffer in 64-row tiles."""
    for cap in (16, 64, 640, 2600, 19072, 100_000):
        for d in (16, 64, 768, fts.D_MAX):
            for k in (1, 20, 84, 255, fts.K_MAX):
                sh = fts.launch_shape(cap=cap, d=d, k=k, elem_size=elem_size)
                assert sh["smem_bytes"] <= fts.SMEM_MAX == 227 * 1024
                assert sh["smem_bytes"] == fts.scan_smem(
                    d, k, elem_size, sh["slots"], sh["stages"], sh["wgs"])
                assert sh["wgs"] in fts.WARPGROUPS
                assert sh["chunk_rows"] % fts.SCAN_TILE == 0
                assert sh["tiles"] * fts.SCAN_TILE == sh["chunk_rows"] <= 1024
                assert (sh["n_chunks"] - 1) * sh["chunk_rows"] < cap
                assert sh["n_chunks"] * sh["chunk_rows"] >= cap
                assert sh["n"] == max(8, sh["slots"]) and sh["n"] % 8 == 0
    # the main path (d 768, k 20): two warpgroups, 16 slots an item, rings
    # of 7 stages; narrow rows take 32 slots
    sh = fts.launch_shape(cap=19072, d=768, k=20, elem_size=elem_size)
    assert (sh["wgs"], sh["slots"], sh["stages"], sh["n_chunks"]) == (
        2, 16, 7, 19)
    sh = fts.launch_shape(cap=19072, d=64, k=20, elem_size=elem_size)
    assert (sh["wgs"], sh["slots"], sh["n"], sh["stages"]) == (2, 32, 32, 8)


def _k_with_slots(slots, elem_size):
    """``(d, k)``: the smallest k at which launch_shape takes ``slots``
    slots at d 768, or else at d 64."""
    for d in (768, 64):
        for k in range(1, fts.K_MAX + 1):
            if fts.launch_shape(cap=19072, d=d, k=k,
                                elem_size=elem_size)["slots"] == slots:
                return d, k
    raise AssertionError(f"no k gives {slots} slots")


@pytest.mark.parametrize("slots", fts.SLOT_COUNTS)
@pytest.mark.parametrize("elem_size", list(ELEM_SIZES.values()),
                         ids=list(ELEM_SIZES))
def test_launch_shape_fits_at_every_slot_count(elem_size, slots):
    """Every slot count is taken for some k (at d 768, or d 64 for 32
    slots), its layout fits 227 KB with rings of at least RING_MIN
    stages (fewer only for the single slot of the largest k) and as deep
    as fits up to RING_MAX, and the next wider one does not fit there
    with as many warpgroups."""
    d, k = _k_with_slots(slots, elem_size)
    sh = fts.launch_shape(cap=19072, d=d, k=k, elem_size=elem_size)
    w = sh["wgs"]
    assert sh["smem_bytes"] <= fts.SMEM_MAX
    assert sh["stages"] >= fts.RING_MIN or (slots, w) == (1, 1)
    assert (sh["stages"] == fts.RING_MAX or fts.scan_smem(
        d, k, elem_size, slots, sh["stages"] + 1, w) > fts.SMEM_MAX)
    if slots < fts.SLOT_MAX:
        wider = fts.SLOT_COUNTS[fts.SLOT_COUNTS.index(slots) - 1]
        assert fts.scan_smem(d, k, elem_size, wider, fts.RING_MIN,
                             w) > fts.SMEM_MAX


@pytest.mark.parametrize("elem_size", list(ELEM_SIZES.values()),
                         ids=list(ELEM_SIZES))
def test_launch_shape_slots_follow_k(elem_size):
    """Slots per item shrink as k grows (32, 16, 8, 4, 2, 1; a single
    warpgroup where two no longer fit) and the rings stay at least
    RING_MIN deep until one warpgroup with one slot is left; K_MAX is
    served at the widest row (d 1024) and k outside [1, K_MAX] raises."""
    for d in (64, 768, fts.D_MAX):
        prev = 2 * fts.SLOT_MAX
        for k in list(range(1, fts.K_MAX, 97)) + [fts.K_MAX]:
            sh = fts.launch_shape(cap=19072, d=d, k=k, elem_size=elem_size)
            # the lists a block keeps (warpgroups × slots) shrink with k
            assert sh["slots"] in fts.SLOT_COUNTS
            assert sh["wgs"] * sh["slots"] <= prev
            assert fts.RING_FLOOR <= sh["stages"] <= fts.RING_MAX
            if sh["stages"] < fts.RING_MIN:
                assert sh["wgs"] == 1 and all(
                    fts.scan_smem(d, k, elem_size, g, fts.RING_MIN,
                                  w) > fts.SMEM_MAX
                    for g in fts.SLOT_COUNTS for w in fts.WARPGROUPS)
            prev = sh["wgs"] * sh["slots"]
    assert fts.K_MAX == 9978
    for bad in (0, fts.K_MAX + 1):
        with pytest.raises(ValueError, match=str(fts.K_MAX)):
            fts.launch_shape(cap=19072, d=768, k=bad, elem_size=elem_size)


@pytest.mark.parametrize("elem_size", list(ELEM_SIZES.values()),
                         ids=list(ELEM_SIZES))
def test_gather_launch_shape(elem_size):
    """The gather scan keeps its tiled layout: 256-row tiles, chunks
    of at most 1024 rows, one slot; K_MAX is the k whose lists fill its
    block at a full chunk of int8 rows."""
    for cap in (16, 640, 2600, 19072):
        for k in (1, 20, 300, fts.K_MAX):
            sh = fts.gather_launch_shape(cap=cap, k=k, elem_size=elem_size)
            assert sh["smem_bytes"] == fts._tile_smem(sh["chunk_rows"], k,
                                                      elem_size)
            assert sh["smem_bytes"] <= fts.SMEM_MAX
            assert sh["chunk_rows"] % fts.TILE_ROWS == 0
            assert (sh["n_chunks"] - 1) * sh["chunk_rows"] < cap
    assert (fts._tile_smem(fts.CHUNK_ROWS, fts.K_MAX, 1) <= fts.SMEM_MAX
            < fts._tile_smem(fts.CHUNK_ROWS, fts.K_MAX + 1, 1))
    with pytest.raises(ValueError, match=str(fts.K_MAX)):
        fts.gather_launch_shape(cap=100, k=fts.K_MAX + 1, elem_size=elem_size)


def _rosters():
    """Plans of skewed and uniform routes, and a roster with holes."""
    rng = np.random.default_rng(13)
    c, b, cr = 50, 64, 2
    skewed = np.where(rng.uniform(size=(b, cr)) < 0.6, 7,
                      rng.integers(0, c, (b, cr)))
    skewed[:, 1] = np.where(skewed[:, 1] == skewed[:, 0],
                            (skewed[:, 0] + 1) % c, skewed[:, 1])
    uniform = np.stack([rng.permutation(c)[:cr] for _ in range(b)])
    p = np.arange(1, c + 1, dtype=np.float64) ** -1.05
    zipf = np.stack([rng.choice(c, cr, replace=False, p=p / p.sum())
                     for _ in range(b)])
    out = {}
    for name, tc in (("skewed", skewed), ("uniform", uniform), ("zipf", zipf)):
        top_c = torch.from_numpy(tc.astype(np.int32))
        u, roster, _ = port_serving.cluster_major_plan(top_c, n_clusters=c)
        out[name] = (roster, b * cr, top_c)
    holes = out["skewed"][0].clone()
    holes[0, 3:40:2] = b * cr                 # empty slots between live ones
    out["holes"] = (holes, b * cr, None)
    return out


@pytest.mark.parametrize("roster_name", ["skewed", "uniform", "zipf",
                                         "holes"])
def test_cluster_major_items_cover_every_pair_row_once(roster_name):
    roster, n_total, _ = _rosters()[roster_name]
    cap, chunk = 700, 256
    n_chunks = -(-cap // chunk)
    live = ((roster >= 0) & (roster < n_total)).numpy()
    covered = np.unique(roster.numpy()[live])
    for g_slots in (16, 4):                    # 4: the slots of a larger k
        groups, offsets = fts.cluster_major_items(
            roster, n_total=n_total, n_chunks=n_chunks, slots=g_slots)
        seen = np.zeros((n_total, cap), np.int64)
        for item in range(int(offsets[-1])):
            i, g, ch = fts.scan_item(item, groups, offsets)
            slots = roster[i, g * g_slots:(g + 1) * g_slots].numpy()
            pairs = slots[(slots >= 0) & (slots < n_total)]
            seen[pairs, ch * chunk:min(cap, (ch + 1) * chunk)] += 1
        # every pair the plan holds, every row, exactly once; nothing else
        assert (seen[covered] == 1).all()
        assert seen.sum() == covered.size * cap
        # a hot cluster spreads over several items, a cold one takes one
        assert int(groups.max()) == -(-int(live.sum(axis=1).max())
                                      // g_slots)
    if roster_name != "holes":
        assert covered.size == n_total


@pytest.mark.parametrize("cr", [1, 2, 3, 16, 17, 20, "c"])
@pytest.mark.parametrize("routes", ["skewed", "uniform", "zipf"])
def test_routed_items_cover_every_pair_row_once(routes, cr):
    """The device counting sort's items: every (pair, row) exactly once,
    one cluster and at most SLOT_MAX pairs an item, the slot groups of a
    cluster chunk side by side (chunk-major within a cluster), and each
    cluster read once per slot group, whatever cr (up to c = 50)."""
    base = _rosters()[routes][2]
    c = 50
    if cr == "c":
        cr = c
    if cr <= 2:
        top_c = base[:, :cr]
    elif cr == 3:                             # distinct routes
        top_c = torch.stack([base[:, 0], (base[:, 0] + 1) % c,
                             (base[:, 0] + 7) % c], dim=1)
    else:                                     # 7·j mod 50: distinct for j < 50
        top_c = ((base[:, :1] + 7 * torch.arange(cr)) % c).to(torch.int32)
    b = top_c.shape[0]
    cap, chunk = 700, 256
    n_chunks = -(-cap // chunk)
    items = fts.routed_items(top_c, c=c, n_chunks=n_chunks)
    flat = top_c.reshape(-1)
    seen = np.zeros((b * cr, cap), np.int64)
    reads = {}
    for cluster, ch, pairs in items:
        assert 1 <= len(pairs) <= fts.SLOT_MAX
        assert all(int(flat[p]) == cluster for p in pairs)
        seen[pairs, ch * chunk:min(cap, (ch + 1) * chunk)] += 1
        reads[(cluster, ch)] = reads.get((cluster, ch), 0) + 1
    assert (seen == 1).all()
    loads = torch.bincount(flat.long(), minlength=c)
    for (cluster, ch), n in reads.items():
        assert n == -(-int(loads[cluster]) // fts.SLOT_MAX)
    # within a cluster, its items run chunk-major
    order = [(cl, ch) for cl, ch, _ in items]
    for cl in set(x for x, _ in order):
        chs = [ch for x, ch in order if x == cl]
        assert chs == sorted(chs)


def test_routed_items_route_strays_and_split_hot_clusters():
    """Routes to no cluster (< 0 or >= c) form the last row, whose items
    have cluster -1 (empty partials); a cluster holding more pairs than
    the widest slot group takes ceil(load / 32) groups per chunk."""
    c = 5
    top_c = torch.full((40, 2), 3, dtype=torch.int32)
    top_c[::4, 1] = -1
    top_c[1::4, 1] = c
    count, start, order = fts.routed_rows(top_c, c=c)
    assert count.tolist() == [0, 0, 0, 60, 0, 20]
    assert start.tolist() == [0, 0, 0, 0, 60, 60, 80]
    assert order[:60].tolist() == [p for p in range(80)
                                   if int(top_c.reshape(-1)[p]) == 3]
    items = fts.routed_items(top_c, c=c, n_chunks=2)
    assert [(cl, ch, len(p)) for cl, ch, p in items] == [
        (3, 0, 32), (3, 0, 28), (3, 1, 32), (3, 1, 28),
        (-1, 0, 20), (-1, 1, 20)]
    groups, offsets = fts.cluster_major_items(
        torch.tensor([[0, 1, 9, 9], [9, 9, 9, 9]]), n_total=9, n_chunks=3,
        slots=fts.SLOT_MAX)
    assert groups.tolist() == [1, 0] and offsets.tolist() == [0, 3, 3]


def test_merge_list_cap_admits_full_fan_out():
    """The merge takes as many partial lists per output row as its list
    heads fit in shared memory: at least cr = c = 300 routes × 19 chunks
    of phase 3's full-width index."""
    shape = fts.launch_shape(cap=19072, d=768, k=20, elem_size=1)
    cap_lists = shape["merge_lists_max"]
    assert cap_lists == fts.SMEM_MAX // (fts.MERGE_WARPS * 4)
    assert 300 * shape["n_chunks"] == 5700 <= cap_lists
    fts._check_grid(1, 300 * shape["n_chunks"], 300 * 19072, 300 * 19072)
    with pytest.raises(ValueError, match="merge"):
        fts._check_grid(1, cap_lists + 1, 1)
    with pytest.raises(ValueError, match="31-bit"):
        fts._check_grid(1, 1, 1, 2 ** 31)


def _query_cases():
    rng = np.random.default_rng(41)
    return {"normal": rng.normal(size=(6, 768)),
            "unit": rng.normal(size=(6, 768)) / np.sqrt(768),
            "wide": rng.normal(size=(6, 768)) * 10.0 ** rng.integers(
                -30, 30, (6, 768)),
            "integers": rng.integers(-3, 4, (6, 768))}


@pytest.mark.parametrize("case", ["normal", "unit", "wide", "integers"])
def test_query_split_residual(case):
    """q = q_hi + q_mid + q_lo + r with |r| <= 2^-24 |q| (each term the
    rounded residue of the last, bf16 keeping 8 significant bits; f32 rows
    are split alike); two terms leave at most 2^-16 |q|; small integers
    are one term."""
    q = torch.from_numpy(_query_cases()[case].astype(np.float32))
    for n, bound in ((3, 2.0 ** -24), (2, 2.0 ** -16)):
        terms = fts.split_terms(q, n)
        assert all(t.dtype == torch.bfloat16 for t in terms)
        total = sum(t.double() for t in terms)
        r = (q.double() - total).abs()
        assert (r <= bound * q.double().abs()).all()
        # each term is the rounding of what the earlier ones left
        left = q.double()
        for t in terms:
            assert torch.equal(t, left.float().to(torch.bfloat16))
            left = left - t.double()
    if case == "integers":
        hi, mid, lo = fts.split_terms(q, 3)
        assert torch.equal(hi.float(), q) and not mid.any() and not lo.any()


@pytest.mark.parametrize("elem_size", list(ELEM_SIZES.values()),
                         ids=list(ELEM_SIZES))
def test_query_terms_follow_the_fragment_order(elem_size):
    """``query_terms`` (the split kernel's output) holds each query's
    terms in the products' k order, zero past d: read back through the
    stage permutation they sum to q; for A in registers (f32, int8) the
    four k of lane t in every k-step of a stage are E/4 contiguous
    elements of the row, so a thread loads its A as two 16-byte pieces."""
    q = torch.from_numpy(np.random.default_rng(43).normal(
        size=(3, 80)).astype(np.float32))
    terms = fts.query_terms(q, elem_size)
    e = fts.stage_elems(elem_size)
    kb = fts.b_blocks(80, elem_size)
    assert terms.shape == (3, 3, 64 * kb) and terms.dtype == torch.bfloat16
    perm = fts.stage_perm(elem_size)
    assert sorted(perm.tolist()) == list(range(e))
    li = torch.arange(64 * kb)
    src = (li // e) * e + perm[li % e]
    back = torch.zeros(3, 64 * kb, dtype=torch.float64)
    back[:, src] = terms.double().sum(dim=1)
    assert (back[:, 80:] == 0).all()
    r = (q.double() - back[:, :80]).abs()
    assert (r <= 2.0 ** -24 * q.double().abs()).all()
    if elem_size == 2:
        assert torch.equal(perm, torch.arange(e))
        return
    for t in range(4):
        ks = [k for k in range(16) if (k % 8) // 2 == t]
        got = sorted(int(perm[16 * s + k]) for s in range(e // 16)
                     for k in ks)
        assert got == list(range(e // 4 * t, e // 4 * (t + 1)))


def _emulated_routed(q, q_loc, w, top_c, bufs, w_hat, *, k, scale):
    """The routed scan by the kernel's arithmetic (scan_dots_plain for
    the products, the plain spatial term and stable top-k)."""
    from repro_torch.core import spatial as port_spatial
    from repro_torch.core.index import topk_stable
    b = q.shape[0]
    tc = top_c.long()
    emb = bufs["emb"][tc].reshape(b, -1, bufs["emb"].shape[-1])
    loc = bufs["loc"][tc].reshape(b, -1, 2)
    ids = bufs["ids"][tc].reshape(b, -1)
    sc = None if scale is None else scale[tc].reshape(b, -1)
    dots = fts.scan_dots_plain(q[:, None], emb, scale=sc)[:, 0]
    srel = port_spatial.spatial_relevance_serve(
        w_hat, port_spatial.s_in_from_locs(q_loc[:, None], loc, DIST_MAX))
    st = w[:, 0:1] * dots + w[:, 1:2] * srel
    st = torch.where(ids >= 0, st, torch.full_like(st, fts.NEG_INF))
    scores, pos = topk_stable(st, k)
    return scores, torch.gather(ids, 1, pos).to(torch.int32)


@pytest.mark.parametrize("data", ["random", "integers"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_scan_products_match_plain_and_reference(precision, data):
    """The engine scans' product order emulated on the CPU at d 768 (three
    bf16 terms of q and of f32 rows, f32 sums, the int8 scale after the sum)
    against ``routed_topk_plain`` and the reference's dense engine: scores
    within 1e-4 + 1e-5·|s|, ids equal up to ties; on integer data (f32,
    bf16) equal outright."""
    exact = data == "integers" and precision != "int8"
    bufs, q, q_loc, w, top_c, w_hat, _, _ = edge_case_np(
        np.random.default_rng(44), precision, c=4, cap=96, d=768, b=8, cr=2,
        edge=data == "integers", boundary=(31, 32, 63, 64))
    scale = bufs["scale"] if precision == "int8" else None
    got_s, got_i = _emulated_routed(q, q_loc, w, top_c, bufs, w_hat, k=K,
                                    scale=scale)
    want_s, want_i = fts.routed_topk_plain(
        q, q_loc, w, top_c, bufs["emb"], bufs["loc"], bufs["ids"], w_hat,
        k=K, dist_max=DIST_MAX, buf_scale=scale)
    if exact:
        assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    assert_topk_match(got_i.numpy(), got_s.numpy(), want_i.numpy(),
                      want_s.numpy(), atol=1e-4, rtol=1e-5)
    emb = bufs["emb"]
    ref_emb = (jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16)
               if precision == "bf16" else jnp.asarray(emb.numpy()))
    ref_i, ref_s = ref_engine._routed_topk(
        jnp.asarray(q.numpy()), jnp.asarray(q_loc.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(top_c.numpy()), ref_emb,
        jnp.asarray(bufs["loc"].numpy()), jnp.asarray(bufs["ids"].numpy()),
        jnp.asarray(bufs["scale"].numpy()), jnp.asarray(w_hat.numpy()), k=K,
        backend="dense", interpret=True, dist_max=DIST_MAX, block_n=32,
        precision=precision)
    assert_topk_match(got_i.numpy(), got_s.numpy(), np.asarray(ref_i),
                      np.asarray(ref_s), atol=1e-4, rtol=1e-5)


def gather_case_np(rng, precision, *, b, n, d, ties=(), dead=None):
    """Candidates ``(b, n, d)`` from numpy as torch CPU tensors: small
    integers at one location (exact scores), the rows at ``ties`` all 2s
    against non-negative queries (the top score, tied), rows ``dead`` of
    the first half of the queries padding; 30% padding elsewhere. Returns
    ``(args, kw)`` of the gather wrappers (k left to the caller)."""
    emb = rng.integers(-2, 3, (b, n, d)).astype(np.float32)
    q = rng.integers(0, 3, (b, d)).astype(np.float32)
    ids = np.where(rng.uniform(size=(b, n)) < 0.3, -1,
                   rng.permutation(b * n).reshape(b, n)).astype(np.int32)
    rows = [r for r in ties if r < n]
    emb[:, rows] = 2.0
    ids[:, rows] = np.arange(len(rows), dtype=np.int32)
    if dead is not None:
        ids[: (b + 1) // 2, dead[0]:dead[1]] = -1
    emb[ids < 0] = 0.0
    stored, scale = port_index.quantize_rows(torch.from_numpy(emb), precision)
    loc = np.full((b, n, 2), 0.25, np.float32)
    q_loc = np.full((b, 2), 0.25, np.float32)
    w = rng.uniform(0.2, 1.0, (b, 2)).astype(np.float32)
    w_hat = np.cumsum(rng.uniform(size=20)).astype(np.float32)
    args = tuple(torch.from_numpy(x) for x in (q, q_loc, w))
    args = args[:3] + (stored, torch.from_numpy(loc), torch.from_numpy(ids),
                       torch.from_numpy(w_hat))
    return args, dict(dist_max=DIST_MAX,
                      cand_scale=scale if precision == "int8" else None)


@pytest.mark.parametrize("k", [5, 30])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_gather_partial_merge_matches_plain(precision, k):
    """The gather kernel's chunk partials, merged by key, give the plain
    gather scan exactly: N = 20 over three chunks of 8, the top score
    tied across both chunk boundaries (rows 7, 8, 15, 16), the middle
    chunk all padding for half the queries, and k 30 > N."""
    chunk = 8
    args, kw = gather_case_np(np.random.default_rng(31), precision, b=4,
                              n=20, d=16, ties=(7, 8, 15, 16), dead=(8, 16))
    want_s, want_p = fts.gather_topk_plain(*args, k=k, **kw)
    part = fts.gather_partials_plain(*args, k=k, chunk_rows=chunk, **kw)
    assert part[0].shape == (4, 3, k)
    got_s, got_p = fts.merge_partials_plain(*part, k=k)
    assert torch.equal(got_p, want_p) and torch.equal(got_s, want_s)
    # the tie ranks by position, across the dead chunk too
    assert got_p[0, :2].tolist() == [7, 16] and got_p[3, :4].tolist() == [
        7, 8, 15, 16]
    if k > 20:
        assert (got_p[:, 20:] == -1).all()
        assert (got_s[:, 20:] == fts.NEG_INF).all()


def _tie_case(precision, *, c=3, cap=40, d=16, b=6, cr=2, chunk=8):
    """Integer data (exact scores) with the top score tied across every
    chunk boundary (rows chunk·m - 1 and chunk·m are all 2s against
    non-negative queries), one all-padding chunk, one location."""
    bounds = tuple(r for m in range(1, cap // chunk + 1)
                   for r in (chunk * m - 1, chunk * m) if r < cap)
    rng = np.random.default_rng(21)
    bufs, q, q_loc, w, top_c, w_hat, fvals, _ = edge_case_np(
        rng, precision, c=c, cap=cap, d=d, b=b, cr=cr, edge=True,
        boundary=bounds, dead=(chunk, 2 * chunk), t=10)
    if precision == "int8":                   # identical rows still tie
        emb = torch.from_numpy(rng.integers(-2, 3, (c, cap, d))
                               .astype(np.float32))
        emb[2:, list(bounds)] = 2.0
        emb[bufs["ids"] < 0] = 0.0
        q = torch.from_numpy(rng.integers(0, 3, (b, d)).astype(np.float32))
        bufs["emb"], bufs["scale"] = port_index.quantize_rows(emb, "int8")
    return bufs, q, q_loc, w, top_c, w_hat, fvals


@pytest.mark.parametrize("k", [5, 12])
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_chunk_partial_merge_matches_plain_and_reference(precision, filtered,
                                                         k):
    """The kernels' chunk partials, merged by key, give the plain routed
    scan and the reference's dense backend exactly, ties across chunk
    boundaries included; per (query, route) pair they give the plain
    cluster-major partials."""
    chunk = 8
    bufs, q, q_loc, w, top_c, w_hat, fvals = _tie_case(precision,
                                                       chunk=chunk)
    kw = dict(k=k, dist_max=DIST_MAX,
              buf_scale=bufs["scale"] if precision == "int8" else None,
              buf_attrs=bufs["attrs"] if filtered else None,
              q_filt=torch.from_numpy(fvals) if filtered else None)
    args = (q, q_loc, w, top_c, bufs["emb"], bufs["loc"], bufs["ids"], w_hat)
    want_s, want_i = fts.routed_topk_plain(*args, **kw)
    part = fts.routed_partials_plain(*args, chunk_rows=chunk, **kw)
    b, cr = top_c.shape
    n_chunks = -(-bufs["emb"].shape[1] // chunk)
    assert part[0].shape == (b, cr * n_chunks, k)
    got_s, got_i = fts.merge_partials_plain(*part, k=k)
    _same(got_i, got_s, want_i, want_s, exact=precision != "int8")
    # the reference's own dense scan on the same buffers
    emb = bufs["emb"]
    ref_emb = (jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16)
               if precision == "bf16" else jnp.asarray(emb.numpy()))
    ref_i, ref_s = ref_engine._routed_topk(
        jnp.asarray(q.numpy()), jnp.asarray(q_loc.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(top_c.numpy()), ref_emb,
        jnp.asarray(bufs["loc"].numpy()), jnp.asarray(bufs["ids"].numpy()),
        jnp.asarray(bufs["scale"].numpy()), jnp.asarray(w_hat.numpy()), k=k,
        backend="dense", interpret=True, dist_max=DIST_MAX, block_n=32,
        precision=precision,
        buf_attrs=jnp.asarray(bufs["attrs"].numpy()) if filtered else None,
        q_filt=jnp.asarray(fvals) if filtered else None)
    if precision == "int8":       # dequantized values: sums in another order
        assert_topk_match(got_i.numpy(), got_s.numpy(), np.asarray(ref_i),
                          np.asarray(ref_s))
    else:
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    # per pair: the cluster-major partials (chunk partials of one route)
    pair_part = tuple(x.reshape(b * cr, n_chunks, k) for x in part)
    pair_s, pair_i = fts.merge_partials_plain(*pair_part, k=k)
    u, roster, _ = port_serving.cluster_major_plan(
        top_c, n_clusters=bufs["emb"].shape[0])
    cm_s, cm_i = fts.cluster_major_partials_plain(
        q, q_loc, w, u, roster, bufs["emb"], bufs["loc"], bufs["ids"], w_hat,
        cr=cr, **kw)
    _same(pair_i, pair_s, cm_i, cm_s, exact=precision != "int8")


def _same(ids, scores, want_ids, want_scores, *, exact):
    """Equal (exact data), or equal up to ties (int8: dequantized values
    sum in another order)."""
    if exact:
        assert torch.equal(ids, want_ids) and torch.equal(scores, want_scores)
    else:
        assert_topk_match(ids.numpy(), scores.numpy(), want_ids.numpy(),
                          want_scores.numpy())


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# the chunked designs' edge cases, as numpy buffers (see edge_case_np)
CUDA_SHAPES = {
    "small": dict(c=6, cap=96, d=64, b=12, k=40),
    "chunks": dict(c=4, cap=2600, d=64, b=40, k=40, edge=True,
                   boundary=(255, 256, 1023, 1024, 2047, 2048),
                   dead=(1024, 2048)),
    "d16": dict(c=5, cap=1500, d=16, b=24, k=20),
    "d1024": dict(c=4, cap=700, d=1024, b=20, k=24),
    # 48 pairs on one cluster: more than the widest slot group (32)
    "hot": dict(c=6, cap=2600, d=768, b=48, k=20, edge=True,
                boundary=(63, 64, 1023, 1024), routes="hot"),
    # every pair on two clusters (phase 6's trained routes, U = 2)
    "two": dict(c=6, cap=1500, d=768, b=64, k=20, routes="two"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CUDA_SHAPES))
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_kernels_match_plain(cuda_device, precision, filtered, shape):
    """Both kernels against their plain versions on the card: several row
    chunks with ties across their boundaries, 20 pairs on a cluster (two
    slot groups), all-padding chunks, k above a chunk's live rows, a
    filter that passes fewer than k rows, d 16 and d 1024, a cluster
    holding more pairs than the widest slot group and a batch whose pairs
    all land on two clusters. Exact (integer) cases must give equal ids,
    ties included."""
    cs = dict(CUDA_SHAPES[shape])
    k = cs.pop("k")
    case = edge_case_np(np.random.default_rng(7), precision, cr=2, **cs)
    bufs, q, q_loc, w, top_c, w_hat, fvals, exact = case
    kw = dict(k=k, dist_max=DIST_MAX,
              buf_scale=bufs["scale"] if precision == "int8" else None,
              buf_attrs=bufs["attrs"] if filtered else None,
              q_filt=torch.from_numpy(fvals) if filtered else None)
    dev = {key: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
           for key, v in kw.items()}
    args = (q, q_loc, w, top_c, bufs["emb"], bufs["loc"], bufs["ids"], w_hat)
    dargs = tuple(a.to(cuda_device) for a in args)
    want = fts.routed_topk_plain(*dargs, **dev)
    got = fts.fused_topk_score_routed(*dargs, **dev)
    torch.cuda.synchronize()
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)
    if exact:
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    c = bufs["emb"].shape[0]
    u, roster, _ = port_serving.cluster_major_plan(dargs[3], n_clusters=c)
    got = fts.fused_topk_score_cluster_major(
        dargs[0], dargs[1], dargs[2], u, roster, *dargs[4:], cr=2, **dev)
    want = fts.cluster_major_partials_plain(
        dargs[0], dargs[1], dargs[2], u, roster, *dargs[4:], cr=2, **dev)
    torch.cuda.synchronize()
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)
    if exact:
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_cuda_scan_smem_is_the_mirror(cuda_device):
    """The built library's engine-scan layout (``fts_scan_smem``) equals
    ``scan_smem``, the mirror the launch shapes above are checked on."""
    lib = fts._lib()
    for d in (16, 768, fts.D_MAX):
        for k in (1, 20, 300, fts.K_MAX):
            for elem in (1, 2, 4):
                sh = fts.launch_shape(cap=19072, d=d, k=k, elem_size=elem)
                assert lib.fts_scan_smem(d, k, elem, sh["slots"], sh["stages"],
                                         sh["wgs"]) == sh["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [17, "c"])
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_routed_any_cr(cuda_device, precision, filtered, cr):
    """The routed kernel past 16 routes (one query a group, one item per
    cluster of its routes) and at full fan-out, cr = c = 24."""
    c = 24
    cr = c if cr == "c" else cr
    bufs, q, q_loc, w, top_c, w_hat, fvals, _ = edge_case_np(
        np.random.default_rng(9), precision, c=c, cap=300, d=64, b=20, cr=cr)
    kw = dict(k=20, dist_max=DIST_MAX,
              buf_scale=bufs["scale"] if precision == "int8" else None,
              buf_attrs=bufs["attrs"] if filtered else None,
              q_filt=torch.from_numpy(fvals) if filtered else None)
    kw = {key: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
          for key, v in kw.items()}
    args = tuple(a.to(cuda_device) for a in (q, q_loc, w, top_c, bufs["emb"],
                                             bufs["loc"], bufs["ids"], w_hat))
    want = fts.routed_topk_plain(*args, **kw)
    got = fts.fused_topk_score_routed(*args, **kw)
    torch.cuda.synchronize()
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [300, 1024])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_large_k(cuda_device, precision, k):
    """Both scans at k above 256 (fewer slots per item): random data, and
    exact integer data with ties across tile and chunk boundaries, where
    the ids must equal the plain version's."""
    for edge in (False, True):
        bufs, q, q_loc, w, top_c, w_hat, _, exact = edge_case_np(
            np.random.default_rng(10), precision, c=4, cap=2600, d=64, b=12,
            cr=2, edge=edge, boundary=(255, 256, 1023, 1024, 2047, 2048),
            dead=(1024, 1400))
        kw = dict(k=k, dist_max=DIST_MAX,
                  buf_scale=(bufs["scale"].to(cuda_device)
                             if precision == "int8" else None))
        args = tuple(a.to(cuda_device) for a in (
            q, q_loc, w, top_c, bufs["emb"], bufs["loc"], bufs["ids"], w_hat))
        want = fts.routed_topk_plain(*args, **kw)
        got = fts.fused_topk_score_routed(*args, **kw)
        u, roster, _ = port_serving.cluster_major_plan(args[3], n_clusters=4)
        ps, pi = fts.fused_topk_score_cluster_major(
            *args[:3], u, roster, *args[4:], cr=2, **kw)
        got_c = port_engine.merge_cluster_major(ps, pi, b=12, cr=2, k=k)
        torch.cuda.synchronize()
        for g in (got, got_c):
            assert_topk_match(g[1].cpu(), g[0].cpu(), want[1].cpu(),
                              want[0].cpu(), atol=1e-4, rtol=1e-5)
            if exact:
                assert torch.equal(g[1], want[1]) and torch.equal(g[0],
                                                                  want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_gather_edge_shapes(cuda_device, precision):
    """The gather kernel against its plain version: exact ties across
    chunk boundaries with an all-padding chunk (positions equal), k > N,
    k 300 at d 768, k 1024 at d 16, and no candidates (no launch)."""
    rng = np.random.default_rng(12)
    for b, n, d, k, ties, dead in (
            (3, 3000, 64, 40, (1023, 1024, 2047, 2048, 2900), (1024, 2048)),
            (4, 16, 32, 20, (3, 4), None),
            (5, 2500, 768, 300, (255, 256, 1023), None),
            (2, 1100, 16, 1024, (), (0, 256)),
            (2, 0, 16, 5, (), None)):             # no candidates
        args, kw = gather_case_np(rng, precision, b=b, n=n, d=d, ties=ties,
                                  dead=dead)
        args = tuple(a.to(cuda_device) for a in args)
        kw = {key: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
              for key, v in kw.items()}
        before = fts.launches["gather"]
        got = fts.fused_topk_score(*args, k=k, **kw)
        want = fts.gather_topk_plain(*args, k=k, **kw)
        torch.cuda.synchronize()
        assert fts.launches["gather"] == before + (n > 0)
        assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                          want[0].cpu(), atol=1e-4, rtol=1e-5)
        if precision != "int8":               # integer data: exact
            assert torch.equal(got[1], want[1]) and torch.equal(got[0],
                                                                want[0])


def edge_case_np(rng, precision, *, c, cap, d, b, cr, edge=False,
                 boundary=(), dead=None, t=50, routes=None):
    """Buffers and queries from numpy, as torch CPU tensors. ``edge``
    makes f32/bf16 data small integers at one location (exact, often tied
    scores); the rows at ``boundary`` of clusters 2.. are all 2s against
    non-negative queries (the top score, tied across chunk boundaries);
    cluster 0 is padding over rows ``dead`` and cluster 1 keeps 5 live
    rows. Routes put b·cr/c pairs on each cluster; ``routes`` "hot" sends
    every query's first route to cluster 2, "two" every pair to clusters
    2 and 3 (cr 2). The filters include one that passes a handful of
    rows. Returns ``(buffers, q, q_loc, w,
    top_c, w_hat, q_filt, exact)``."""
    exact = edge and precision != "int8"
    if exact:
        emb = rng.integers(-2, 3, (c, cap, d)).astype(np.float32)
        q = rng.integers(0, 3, (b, d)).astype(np.float32)
    else:
        emb = rng.normal(size=(c, cap, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    perm = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids = np.where(rng.uniform(size=(c, cap)) < 0.3, -1, perm).astype(np.int32)
    loc = rng.uniform(size=(c, cap, 2)).astype(np.float32)
    q_loc = rng.uniform(size=(b, 2)).astype(np.float32)
    if edge:
        rows = [r for r in boundary if r < cap]
        emb[2:, rows] = 2.0
        ids[2:, rows] = perm[2:, rows]
        if dead is not None:
            ids[0, dead[0]:dead[1]] = -1
        ids[1, 5:] = -1
        loc[:] = 0.5
        q_loc[:] = 0.5
    emb[ids < 0] = 0.0
    stored, scale = port_index.quantize_rows(torch.from_numpy(emb), precision)
    bufs = {"emb": stored, "scale": scale, "ids": torch.from_numpy(ids),
            "loc": torch.from_numpy(loc),
            "attrs": torch.from_numpy(make_attrs_np(rng, c * cap)
                                      .reshape(c, cap, 3))}
    w = rng.uniform(0.2, 1.0, (b, 2)).astype(np.float32)
    top_c = np.stack([np.roll(np.arange(c), -(i % c))[:cr]
                      for i in range(b)]).astype(np.int32)
    if routes == "hot":
        top_c[:, 1] = np.where(top_c[:, 0] == 2, top_c[:, 1], top_c[:, 0])
        top_c[:, 0] = 2
        top_c[:, 1] = np.where(top_c[:, 1] == 2, 3, top_c[:, 1])
    elif routes == "two":
        top_c[:] = (2, 3)
    w_hat = np.cumsum(rng.uniform(size=t)).astype(np.float32)
    fvals, _ = ref_filters.compile_filters(_tight_specs(b), b)
    return (bufs, torch.from_numpy(q), torch.from_numpy(q_loc),
            torch.from_numpy(w), torch.from_numpy(top_c),
            torch.from_numpy(w_hat), fvals, exact)


def _tight_specs(b):
    """:func:`_specs` with every sixth query's filter passing a handful of
    rows (tenant 1, category bit 3, a 6-wide time window)."""
    specs = _specs(b)
    tight = ref_filters.FilterSpec(tenant=1, category_mask=0b1000, t_min=500,
                                   t_max=505)
    return [tight if i % 6 == 5 else sp for i, sp in enumerate(specs)]


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
