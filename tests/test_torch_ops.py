"""The port's kernel entry point ``repro_torch.kernels.ops`` against the
reference's ``repro.kernels.ops`` (Pallas in interpret mode) and the
model oracles.

Inputs come from numpy with a seed; the same arrays go to the reference
as jax arrays and to the port as CPU tensors, where every function runs
its kernel's plain PyTorch version. Tolerances are those the reference
holds its own kernels to (tests/test_kernels.py): gather scores 1e-5
(ids equal up to ties), flash attention 2e-5 in f32 and 2e-2 absolute in
bf16, dot interaction 1e-5, embedding bag 1e-4.

The CUDA kernels themselves are compared with the plain versions on the
card (``@pytest.mark.cuda``, skipped without one); flash attention in 16
bits is also held within one rounding of the plain version in f32. The
dot-interaction kernel's tiling and launch shape, and the flash forward's
launch shape, are plain Python, tested here.
"""
import inspect
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

from test_torch_common import assert_topk_match
from test_torch_common import f64_attention as _f64_attention
from test_torch_common import split3 as _split3

DIST_MAX = 1.414


def _gather_inputs(rng, b, n, d, t, *, precision="f32", pad_from=None):
    q = rng.normal(size=(b, d)).astype(np.float32)
    ql = rng.uniform(size=(b, 2)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(b, 2)).astype(np.float32)
    ce = rng.normal(size=(b, n, d)).astype(np.float32)
    cl = rng.uniform(size=(b, n, 2)).astype(np.float32)
    ci = rng.integers(-1, 10_000, size=(b, n)).astype(np.int32)
    if pad_from is not None:
        ci[:, pad_from:] = -1
    wh = np.cumsum(rng.uniform(0, 0.01, size=t)).astype(np.float32)
    scale = None
    if precision == "int8":
        scale = (np.abs(ce).max(-1) / 127).astype(np.float32)
        ce = np.clip(np.rint(ce / scale[..., None]), -127, 127).astype(np.int8)
    return dict(q=q, ql=ql, w=w, ce=ce, cl=cl, ci=ci, wh=wh, scale=scale)


def _gather_both(x, *, k, precision="f32"):
    """(reference (scores, pos), port (scores, pos)) as numpy."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    sc = x["scale"]
    ref = ref_ops.fused_topk_score(
        jnp.asarray(x["q"]), jnp.asarray(x["ql"]), jnp.asarray(x["w"]),
        jnp.asarray(x["ce"], jdt[precision]), jnp.asarray(x["cl"]),
        jnp.asarray(x["ci"]), jnp.asarray(x["wh"]), k=k, dist_max=DIST_MAX,
        cand_scale=None if sc is None else jnp.asarray(sc), interpret=True)
    t = {key: torch.from_numpy(v) for key, v in x.items() if v is not None}
    port = ops.fused_topk_score(
        t["q"], t["ql"], t["w"], t["ce"].to(tdt[precision]), t["cl"],
        t["ci"], t["wh"], k=k, dist_max=DIST_MAX, cand_scale=t.get("scale"))
    return ((np.asarray(ref[0]), np.asarray(ref[1])),
            (port[0].numpy(), port[1].numpy()))


# ---------------------------------------------------------------------------
# gather-path fused_topk_score
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,d,t,k", [
    (8, 1024, 32, 50, 5),
    (16, 2048, 64, 100, 10),
    (4, 512, 128, 1000, 20),
])
def test_gather_matches_reference(b, n, d, t, k):
    x = _gather_inputs(np.random.default_rng(0), b, n, d, t)
    (rs, ri), (ps, pi) = _gather_both(x, k=k)
    assert ps.dtype == np.float32 and pi.dtype == np.int32
    assert_topk_match(pi, ps, ri, rs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_gather_precision_tiers(precision):
    """bf16 candidates are widened exactly; int8 ones are dequantized as
    ``float(o) * scale[b, n]`` before the product."""
    x = _gather_inputs(np.random.default_rng(1), 6, 768, 64, 100,
                       precision=precision)
    (rs, ri), (ps, pi) = _gather_both(x, k=12, precision=precision)
    assert_topk_match(pi, ps, ri, rs, atol=1e-5, rtol=1e-5)


def test_gather_padding_only_tail():
    """Fewer valid candidates than k: the slots past the last valid one
    are (-1e30, -1), as the reference's running-list init leaves them."""
    x = _gather_inputs(np.random.default_rng(2), 4, 256, 32, 50, pad_from=7)
    x["ci"][:, :7] = np.arange(7)
    (rs, ri), (ps, pi) = _gather_both(x, k=12)
    np.testing.assert_array_equal(pi, ri)
    assert (pi[:, 7:] == -1).all() and (ps[:, 7:] == -1e30).all()
    assert (np.sort(pi[:, :7], axis=1) == np.arange(7)).all()
    np.testing.assert_allclose(ps, rs, atol=1e-5, rtol=1e-5)


def test_gather_fewer_candidates_than_k():
    """k > N: every candidate is ranked and the rest is (-1e30, -1)."""
    x = _gather_inputs(np.random.default_rng(6), 5, 16, 32, 50)
    (rs, ri), (ps, pi) = _gather_both(x, k=20)
    assert ps.shape == (5, 20)
    assert_topk_match(pi, ps, ri, rs, atol=1e-5, rtol=1e-5)
    assert ((pi == -1) == (ps == -1e30)).all()


def test_gather_exact_ties_rank_by_position():
    """Equal scores rank by local position, lowest first (the tie rule of
    ``jax.lax.top_k`` over [running list, tile]). Integer-valued inputs
    make every score exact, so positions must be equal bit for bit."""
    rng = np.random.default_rng(3)
    x = _gather_inputs(rng, 3, 512, 16, 20)
    x["q"] = rng.integers(-2, 3, size=x["q"].shape).astype(np.float32)
    x["ce"] = rng.integers(-2, 3, size=x["ce"].shape).astype(np.float32)
    x["cl"][:] = x["ql"][:, None, :]                  # one spatial bucket
    x["w"][:] = (1.0, 0.5)                            # exact products
    (rs, ri), (ps, pi) = _gather_both(x, k=40)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pi, ri)
    assert (np.diff(ps, axis=1) <= 0).all()
    tied = (np.diff(ps, axis=1) == 0) & (pi[:, 1:] >= 0)
    assert tied.any() and (np.diff(pi, axis=1)[tied] > 0).all()


def test_gather_positions_map_to_routed_ids():
    """Over a copy gathered from resident buffers (``buf[top_c]``), the
    gather path's positions mapped through ``cand_ids`` are the routed
    path's ids, with the same scores."""
    rng = np.random.default_rng(4)
    c, cap, d, b, cr, k = 5, 64, 32, 6, 2, 9
    emb = torch.from_numpy(rng.normal(size=(c, cap, d)).astype(np.float32))
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.uniform(size=(c, cap)) < 0.3] = -1
    ids = torch.from_numpy(ids)
    loc = torch.from_numpy(rng.uniform(size=(c, cap, 2)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    ql = torch.from_numpy(rng.uniform(size=(b, 2)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (b, 2)).astype(np.float32))
    top_c = torch.from_numpy(rng.integers(0, c, (b, cr)).astype(np.int32))
    wh = torch.cumsum(torch.from_numpy(rng.uniform(0, .01, 50)
                                       .astype(np.float32)), 0)
    tc = top_c.long()
    cand_ids = ids[tc].reshape(b, -1)
    gs, gp = ops.fused_topk_score(q, ql, w, emb[tc].reshape(b, -1, d),
                                  loc[tc].reshape(b, -1, 2), cand_ids, wh,
                                  k=k, dist_max=DIST_MAX)
    rs, ri = ops.fused_topk_score_routed(q, ql, w, top_c, emb, loc, ids, wh,
                                         k=k, dist_max=DIST_MAX)
    mapped = torch.where(gp >= 0, torch.gather(cand_ids, 1, gp.clamp(min=0)
                                               .long()), -1)
    np.testing.assert_array_equal(mapped.numpy(), ri.numpy())
    np.testing.assert_array_equal(gs.numpy(), rs.numpy())


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, s, h, kv, d, dtype=np.float32):
    return tuple(rng.normal(size=shape).astype(dtype) for shape in
                 ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 256, 4, 2, 32, True, 0),
    (1, 128, 4, 4, 64, True, 64),
    (2, 200, 2, 1, 16, True, 0),          # S not a multiple of 64
    (1, 256, 8, 2, 32, True, 100),        # window not a multiple of 64
    (1, 64, 2, 2, 32, False, 0),          # non-causal
])
def test_flash_matches_reference(b, s, h, kv, d, causal, window):
    q, k, v = _qkv(np.random.default_rng(0), b, s, h, kv, d)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=64, block_k=64,
                                   interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_bf16_matches_reference():
    q, k, v = _qkv(np.random.default_rng(1), 2, 128, 4, 2, 32)
    want = ref_ops.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), interpret=True)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert err.max() < 2e-2


def test_flash_matches_layers_oracle():
    """Also the model's chunked online-softmax attention, with a window."""
    from repro.models import layers
    q, k, v = _qkv(np.random.default_rng(2), 2, 192, 4, 2, 32)
    for window in (0, 72):
        want = layers.attention_full(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window, chunk=64)
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_forward_launch_shape(d, dtype):
    """The 16-bit forward's launch (``forward_launch_shape``, the mirror of
    flash_attention.cu): its shared memory fits the 227 KB a block may
    have; every (batch, head, query tile) has exactly one block; the heads
    go in chunks of whole KV groups whose K and V fit the chunk's share of
    the L2 (or one group), each chunk's blocks together and, under a causal
    mask, heaviest first (live key tiles never grow within a chunk); and
    each block's live key tiles hold every key its rows see, none that no
    row sees."""
    from repro_torch.kernels import flash_attention as fa
    sh = fa.forward_launch_shape(d, dtype)
    assert sh.smem_bytes <= fa.SMEM_LIMIT == 232_448
    assert sh.stages >= 2 and sh.threads == 384 and sh.rows == 128
    assert sh.smem_bytes == (1024 + sh.rows * d * 2
                             + sh.stages * 2 * sh.key_tile * d * 2 + 128)
    _check_launch_order(sh, d)


def _check_launch_order(sh, d):
    """``sh``'s launch order and key tiles over ragged, GQA, windowed and
    chunk-splitting shapes (see test_flash_forward_launch_shape)."""
    from repro_torch.kernels import flash_attention as fa
    for b, s, h, kv, causal, window in [
            (2, 333, 7, 7, True, 0), (1, 129, 8, 1, False, 0),
            (3, 257, 2, 1, True, 127), (1, 513, 4, 2, True, 1),
            (1, 640, 3, 3, False, 200),
            # K and V of a KV head past the chunk's bytes: a chunk a group
            (2, 65_536 * 128 // d + 1, 4, 2, True, 0)]:
        order = sh.blocks(b, s, h, kv)
        tiles = -(-s // sh.rows)
        assert sorted((bb, hh, q0 // sh.rows) for bb, hh, q0 in order) == [
            (bb, hh, t) for bb in range(b) for hh in range(h)
            for t in range(tiles)]
        chunk = sh.chunk(b, s, h, kv)
        assert chunk == b * h or chunk % (h // kv) == 0
        assert (chunk == h // kv or chunk // (h // kv) * s * d * 2
                * sh.kv_bytes <= fa.FWD_CHUNK_BYTES)
        for c0 in range(0, b * h, chunk):
            part = order[c0 * tiles:(c0 + min(chunk, b * h - c0)) * tiles]
            assert {bb * h + hh for bb, hh, _ in part} == set(
                range(c0, min(c0 + chunk, b * h)))
            if causal:
                q0s = [q0 for _, _, q0 in part]
                assert q0s == sorted(q0s, reverse=True)
        if s > 1000:
            continue
        mask = fa.attention_mask(s, s, causal=causal, window=window)
        t_of = torch.arange(s) // sh.key_tile
        for _, _, q0 in order:
            kt = sh.key_tiles(q0, s, causal=causal, window=window)
            seen = mask[q0:q0 + sh.rows].any(0)
            assert list(kt) == sorted(set(t_of[seen].tolist()))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_forward_launch_shape_f32(d):
    """The f32 body (three bf16 terms on ``wgmma``): 128-row blocks over
    64-key tiles, a ring of K's and V's three terms (two 96 KB stages at D
    128, four below) that fits the 227 KB a block may have, Q in
    registers; its launch order is the 16-bit body's, its chunks counting
    the 6 bytes an element of K and V it loads."""
    from repro_torch.kernels import flash_attention as fa
    sh = fa.forward_launch_shape(d, torch.float32)
    assert (sh.rows, sh.key_tile, sh.threads, sh.kv_bytes) == (128, 64, 384,
                                                               6)
    assert sh.stages == (2 if d == 128 else 4)
    assert sh.smem_bytes == 1024 + sh.stages * 6 * 64 * d * 2 + 128
    assert sh.smem_bytes <= fa.SMEM_LIMIT
    order = sh.blocks(2, 130, 3, 1)
    assert order[:2] == [(0, 0, 128), (0, 1, 128)] and len(set(order)) == 12
    _check_launch_order(sh, d)
    with pytest.raises(ValueError):
        fa.forward_launch_shape(48, torch.float32)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_backward_launch_shape(d, dtype):
    """The backward kernels' launches (``backward_launch_shape``, the
    mirror of flash_attention.cu): each fits the 227 KB a block may have
    with its resident rows and ring (in f32 three bf16 terms of each: 128
    resident rows split between the two consumer warpgroups from D 64
    down, 64 shared rows and alternate 32-row tiles at D 128); every
    block's resident rows are launched once, a head's blocks heaviest
    causal block first (dK/dV's first keys, dQ's last rows); and each
    block's streamed tiles hold every row its resident rows see or are
    seen by, none that none does."""
    from repro_torch.kernels import flash_attention as fa
    dkdv, dq = fa.backward_launch_shape(d, dtype)
    terms = 3 if dtype == torch.float32 else 1
    for sh in (dkdv, dq):
        assert sh.smem_bytes <= fa.SMEM_LIMIT and sh.threads == 384
        assert sh.rows % 64 == 0 and sh.tile % 16 == 0 and sh.stages >= 2
        assert sh.smem_bytes > 2 * terms * 2 * d * (sh.rows
                                                    + sh.stages * sh.tile)
        assert sh.split == (dtype != torch.float32 or d <= 64)
        assert sh.rows == (128 if sh.split else 64)
    for b, s, h, kv, causal, window in [
            (2, 333, 4, 2, True, 0), (1, 129, 8, 1, False, 0),
            (1, 257, 2, 1, True, 127), (1, 300, 4, 4, True, 1),
            (1, 200, 3, 3, False, 40)]:
        mask = fa.attention_mask(s, s, causal=causal, window=window)
        for sh, heads in ((dkdv, kv), (dq, h)):
            order = sh.blocks(b, s, h, kv)
            n = -(-s // sh.rows)
            assert sorted(order) == [(bb, hh, i * sh.rows) for bb in range(b)
                                     for hh in range(heads)
                                     for i in range(n)]
            for bb in range(b):
                for hh in range(heads):
                    r0s = [r0 for x, y, r0 in order if (x, y) == (bb, hh)]
                    assert r0s == sorted(r0s, reverse=sh.kind == "dq")
            # resident rows × streamed rows: keys × queries for dK/dV
            pairs = mask.T if sh.kind == "dkdv" else mask
            t_of = torch.arange(s) // sh.tile
            for r0 in range(0, s, sh.rows):
                seen = pairs[r0:r0 + sh.rows].any(0)
                assert list(sh.tiles(r0, s, causal=causal, window=window)
                            ) == sorted(set(t_of[seen].tolist()))
    with pytest.raises(ValueError):
        fa.backward_launch_shape(48, dtype)


# The f32 body's arithmetic (flash_attention.cu flash_fwd_f32_kernel),
# emulated in torch on the CPU: q·scale, k, v and P in three bf16 terms
# each, S = Q·Kᵀ and O = P·V the sums of the products kept, in f32.
# (A's term, B's term), 0 = hi, 1 = mid, 2 = lo: the kernel's six
# (prod_a / prod_b), every pair down to the 2^-16 terms.
F32_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _f32_body(q, k, v, *, causal, window, products=F32_PRODUCTS):
    """``(o, lse)`` as the f32 body computes them, the softmax taken over
    the whole row (the kernel's online softmax over 64-key tiles rescales
    the same terms); each product's terms are exact in f32. The sums are
    torch's, to nearest, so this bounds the split and the products only:
    on the card most of the body's error comes from ``wgmma``'s own f32
    accumulation, which falls short as the key tiles grow (the source
    note of ``flash_attention.cu``)."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    kv = k.shape[2]
    qt = _split3(q.reshape(b, s, kv, h // kv, d) * (1.0 / math.sqrt(d)))
    kt, vt = _split3(k), _split3(v)
    sc = sum(torch.einsum("bqkgd,bjkd->bkgqj", qt[i], kt[j])
             for i, j in products)
    mask = fa.attention_mask(s, s, causal=causal, window=window)
    sc = torch.where(mask, sc, torch.tensor(fa.NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    lsum = p.sum(-1, keepdim=True)
    pt = _split3(p)
    o = sum(torch.einsum("bkgqj,bjkd->bkgqd", pt[i], vt[j])
            for i, j in products) / lsum.clamp(min=1e-30)
    return (o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d),
            (m + torch.log(lsum)).reshape(b, h, s))


@pytest.mark.parametrize("scale", [1e-25, 1e-7, 1.0, 3e5, 1e30])
def test_f32_split_is_exact(scale):
    """hi + mid + lo == x for seeded f32 at tiny to large magnitudes; each
    term is a bf16 value, the next at most 2^-8 of the last. (Exact while
    lo stays a normal bf16, |x| above about 2^-110: below that what lo
    drops is under 2^-133.)"""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, mid, lo = _split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert (mid.abs() <= hi.abs() * 2 ** -8).all()
    assert (lo.abs() <= mid.abs() * 2 ** -8).all()


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 256, 4, 2, 32, True, 0),
    (1, 128, 4, 4, 64, True, 64),
    (2, 200, 2, 1, 16, True, 0),
    (1, 256, 8, 2, 32, True, 100),
    (1, 64, 2, 2, 32, False, 0),
])
def test_f32_body_matches_reference(b, s, h, kv, d, causal, window):
    """The emulated f32 body against the reference's Pallas kernel in
    interpret mode (o) and against the log-sum-exp of the reference's
    scaled, masked scores (lse), at the f32 tolerance 2e-5 of
    test_flash_matches_reference, with a margin of at least 5× for what
    the emulation models (the split and the six products; not the card's
    accumulation, see ``_f32_body``)."""
    import jax
    q, k, v = _qkv(np.random.default_rng(0), b, s, h, kv, d)
    want = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True))
    qg = jnp.asarray(q).reshape(b, s, kv, h // kv, d) * (1.0 / math.sqrt(d))
    sc = jnp.einsum("bqkgd,bjkd->bkgqj", qg, jnp.asarray(k),
                    precision=jax.lax.Precision.HIGHEST)
    pos = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    want_lse = np.asarray(jax.nn.logsumexp(
        jnp.where(mask, sc, -1e30), axis=-1)).reshape(b, h, s)
    o, lse = _f32_body(*(torch.from_numpy(x) for x in (q, k, v)),
                       causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)
    assert np.abs(o.numpy() - want).max() < 4e-6
    assert np.abs(lse.numpy() - want_lse).max() < 4e-6


@pytest.mark.parametrize("drop", [(2, 0), (0, 2), (1, 1)])
def test_f32_body_keeps_the_fewest_products(drop):
    """Against the attention in f64: the six products miss by < 2e-6, the
    nine by as much, and dropping any one of the 2^-16 products costs at
    least 5× that (in the 2e-5 contract's range), so six is the fewest
    that hold it with margin."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(0), 1, 192, 4, 2, 64))
    kw = dict(causal=True, window=0)
    exact, exact_lse = _f64_attention(q, k, v, **kw)
    o6, l6 = _f32_body(q, k, v, **kw)
    o9, _ = _f32_body(q, k, v, products=[(i, j) for i in range(3)
                                         for j in range(3)], **kw)
    o5, _ = _f32_body(q, k, v, products=[p for p in F32_PRODUCTS
                                         if p != drop], **kw)
    e6, e9, e5 = ((o.double() - exact).abs().max().item()
                  for o in (o6, o9, o5))
    assert e6 < 2e-6 and (l6.double() - exact_lse).abs().max() < 2e-6
    assert e9 < 2e-6
    assert e5 > 5 * e6


# ---------------------------------------------------------------------------
# dot_interaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,f,d", [(128, 27, 16), (256, 27, 128), (64, 8, 8)])
def test_dot_interaction_matches_reference(b, f, d):
    from repro.models.recsys import dlrm_dot_interaction
    x = np.random.default_rng(0).normal(size=(b, f, d)).astype(np.float32)
    got = ops.dot_interaction(torch.from_numpy(x))
    assert got.shape == (b, f * (f - 1) // 2)
    want = ref_ops.dot_interaction(jnp.asarray(x), block_m=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(dlrm_dot_interaction(x)),
                               rtol=1e-5, atol=1e-5)


def test_dot_interaction_bf16():
    """f32 sums rounded once to bf16, as the reference's kernel does."""
    x = np.random.default_rng(1).normal(size=(64, 27, 16)).astype(np.float32)
    want = ref_ops.dot_interaction(jnp.asarray(x, jnp.bfloat16), block_m=64,
                                   interpret=True)
    got = ops.dot_interaction(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    # at most one bf16 rounding step apart (f32 sums in another order)
    assert (np.abs(g - w) <= np.abs(w) * 2 ** -7 + 1e-5).all()
    assert (g == w).mean() > 0.95


@pytest.mark.parametrize("f", [2, 3, 4, 5, 8, 26, 27, 28, 33, 48, 64])
def test_dot_interaction_tiles_cover_each_pair_once(f):
    """The kernel's 4×4 tiles (ib ≤ jb) hold every pair i < j < F exactly
    once, in at most one block of threads."""
    from repro_torch.kernels import dot_interaction as di
    tiles = di.pair_tiles(f)
    assert len(tiles) <= di.THREADS
    seen = [(4 * ib + ii, 4 * jb + jj) for ib, jb in tiles
            for ii in range(4) for jj in range(4)]
    pairs = [(i, j) for i, j in seen if i < j < f]
    assert len(pairs) == len(set(pairs)) == f * (f - 1) // 2
    assert sorted(pairs) == list(zip(*np.triu_indices(f, k=1)))


@pytest.mark.parametrize("elem_size", [4, 2])
def test_dot_interaction_launch_shape(elem_size):
    """For F up to 64 (and any d: it streams through the stages 128 bytes
    at a time) the double buffer fits the 227 KB a block may have, the
    rows' 16-byte pad keeps copies aligned and quarter-warps on distinct
    banks, and every (row, tile) has a thread."""
    from repro_torch.kernels import dot_interaction as di
    for f in range(2, 65):
        sh = di.launch_shape(f, elem_size)
        row_bytes = sh["row_elems"] * elem_size
        assert sh["smem_bytes"] == 2 * sh["rows"] * row_bytes
        assert sh["smem_bytes"] <= di.SMEM_MAX == 227 * 1024
        assert row_bytes % 128 == 16
        assert sh["chunk"] * elem_size == 128
        assert sh["fp"] % 4 == 0 and f <= sh["fp"] < f + 4
        assert row_bytes >= sh["fp"] * 128
        assert sh["tiles"] == len(di.pair_tiles(f))
        assert sh["rows"] * sh["tiles"] <= sh["threads"] <= di.THREADS
        assert sh["threads"] % 32 == 0
        assert sh["rows"] < 8 or sh["rows"] % 8 == 0
    assert di.launch_shape(27, 4)["rows"] == 8          # dlrm-mlperf
    with pytest.raises(ValueError, match="tiles"):
        di.launch_shape(96, elem_size)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,d,b,p,block_v", [
    (1000, 32, 128, 8, 256),
    (500, 16, 64, 4, 512),     # block_v > v (single tile)
    (4096, 64, 256, 16, 512),
])
def test_embedding_bag_matches_reference(v, d, b, p, block_v):
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, p)).astype(np.int32)   # -1 anywhere
    want = ref_ops.embedding_bag(jnp.asarray(tab), jnp.asarray(idx),
                                 block_v=block_v, interpret=True)
    got = ops.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_embedding_bag_duplicates_and_padding():
    tab = np.random.default_rng(1).normal(size=(100, 8)).astype(np.float32)
    idx = np.array([[3, -1, 3, 3], [-1, -1, -1, -1], [7, 9, -1, 7]],
                   np.int32)
    got = ops.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx))
    want = ref_ops.embedding_bag(jnp.asarray(tab), jnp.asarray(idx),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), 3 * tab[3], rtol=1e-5)
    assert (got[1].numpy() == 0).all()


def test_embedding_bag_index_past_vocab_adds_nothing():
    """An index >= V lands on the TPU kernel's zero padding rows (or in no
    tile at all): it adds nothing. The port follows the kernel."""
    rng = np.random.default_rng(2)
    v, d = 300, 16
    tab = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(32, 6)).astype(np.int32)
    idx[:, 2] = v + rng.integers(0, 500, 32)
    want = ref_ops.embedding_bag(jnp.asarray(tab), jnp.asarray(idx),
                                 block_v=128, interpret=True)
    got = ops.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    keep = np.delete(idx, 2, axis=1)
    np.testing.assert_allclose(got.numpy(), tab[keep].sum(1), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the entry point itself
# ---------------------------------------------------------------------------

TPU_KNOBS = {"block_m", "block_n", "block_q", "block_k", "block_v",
             "interpret"}


@pytest.mark.parametrize("name", ["fused_topk_score", "flash_attention",
                                  "dot_interaction", "embedding_bag"])
def test_signature_is_the_reference_minus_tpu_knobs(name):
    def params(fn):
        return [(p.name, p.kind) for p in
                inspect.signature(fn).parameters.values()
                if p.name not in TPU_KNOBS]
    assert params(getattr(ops, name)) == params(getattr(ref_ops, name))


def test_cpu_tensors_never_launch_and_counters_cover_every_kernel():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "routed": 0, "cluster_major": 0, "gather": 0, "flash_attention": 0,
        "flash_attention_f32": 0, "flash_attention_backward": 0,
        "flash_attention_backward_f32": 0, "dot_interaction": 0,
        "dot_interaction_backward": 0, "embedding_bag": 0}
    ops.dot_interaction(torch.ones(2, 3, 4))
    ops.embedding_bag(torch.ones(5, 4), torch.zeros(2, 3, dtype=torch.int32))
    ops.flash_attention(*(torch.ones(1, 8, 2, 16) for _ in range(3)))
    assert set(ops.launch_counts().values()) == {0}


def test_other_devices_raise():
    """A device with neither a plain version nor a kernel raises: the lazy
    tensor device here. (A meta tensor takes the kernels' meta path,
    held in tests/test_torch_dryrun.py.)"""
    import torch._lazy.ts_backend
    torch._lazy.ts_backend.init()
    other = torch.device("lazy")
    with pytest.raises(ValueError, match="no kernel"):
        ops.dot_interaction(torch.ones(2, 3, 4, device=other))
    with pytest.raises(ValueError, match="no kernel"):
        ops.embedding_bag(torch.ones(5, 4, device=other),
                          torch.zeros(2, 3, dtype=torch.int32, device=other))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(*(torch.ones(1, 8, 2, 16, device=other)
                              for _ in range(3)))
    x = torch.ones(2, 4, 16, device=other)
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_topk_score(torch.ones(2, 16, device=other),
                             torch.ones(2, 2, device=other),
                             torch.ones(2, 2, device=other), x,
                             torch.ones(2, 4, 2, device=other),
                             torch.ones(2, 4, dtype=torch.int32, device=other),
                             torch.ones(5, device=other), k=2, dist_max=1.0)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cuda_gather_matches_plain(cuda_device, precision):
    from repro_torch.kernels import fused_topk_score as fts
    x = _gather_inputs(np.random.default_rng(5), 8, 1000, 64, 100,
                       precision=precision, pad_from=990)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    t = {key: torch.from_numpy(v).to(cuda_device)
         for key, v in x.items() if v is not None}
    args = (t["q"], t["ql"], t["w"], t["ce"].to(tdt[precision]), t["cl"],
            t["ci"], t["wh"])
    kw = dict(k=40, dist_max=DIST_MAX, cand_scale=t.get("scale"))
    before = fts.launches["gather"]
    got = ops.fused_topk_score(*args, **kw)
    want = fts.gather_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fts.launches["gather"] == before + 1
    assert_topk_match(got[1].cpu(), got[0].cpu(), want[1].cpu(),
                      want[0].cpu(), atol=1e-4, rtol=1e-5)


# half a unit in the last place: a 16-bit output rounded once from f32
ONE_ROUNDING = {torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_cuda_flash_matches_plain(cuda_device, dtype, tol):
    """The kernel against the plain version on the same inputs (f32 2e-5,
    16-bit 2e-2 absolute), and in 16 bits within one rounding of the plain
    version on the inputs widened to f32: |o - plain_f32| ≤ rel·|plain_f32|
    + 1e-4, rel half a unit in the last place. The shapes cut the f32
    body's 64-row, 64-key tiles and the 16-bit body's 128-row, 128-key
    tiles at S on either side of them (127, 129, 255, 257, 333), D 16 to
    128, H/KV 1, 7 and 8, windows of 1 and of one key under a tile, causal
    and not. The forward writing lse gives the same output, and its lse
    matches the plain version's (same tolerance)."""
    from repro_torch.kernels import flash_attention as fa
    for b, s, h, kv, d, causal, window in [
            (2, 200, 4, 2, 32, True, 0), (1, 256, 8, 2, 64, True, 100),
            (1, 130, 4, 4, 128, False, 0), (2, 77, 7, 1, 16, True, 0),
            (1, 191, 7, 7, 128, True, 1), (1, 321, 14, 2, 32, False, 40),
            (1, 64, 2, 2, 64, True, 1), (2, 129, 7, 1, 128, True, 65),
            (1, 127, 8, 1, 64, True, 0), (1, 129, 7, 1, 32, False, 0),
            (1, 255, 4, 2, 128, True, 127), (1, 257, 8, 1, 128, True, 1),
            (2, 333, 7, 1, 16, True, 0), (1, 333, 4, 4, 64, False, 127),
            (1, 257, 16, 2, 128, False, 0)]:
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in
                   _qkv(np.random.default_rng(6), b, s, h, kv, d))
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want, want_lse = fa.flash_attention_plain(
            q, k, v, causal=causal, window=window, return_lse=True)
        with_lse, lse = fa._launch(q, k, v, causal, window, True)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max().item() < tol
        assert torch.equal(with_lse, got)
        assert (lse - want_lse).abs().max().item() < tol
        if dtype != torch.float32:
            exact = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, window=window)
            bound = ONE_ROUNDING[dtype] * exact.abs() + 1e-4
            assert ((got.float() - exact).abs() <= bound).all()


@pytest.mark.cuda
def test_cuda_flash_forward_shape_is_the_mirror(cuda_device):
    """The built library's launch shape equals ``forward_launch_shape``."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in fa.HEAD_DIMS:
            sh = fa.forward_launch_shape(d, dtype)
            assert fa.kernel_forward_shape(d, dtype) == (
                sh.rows, sh.key_tile, sh.stages, sh.threads, sh.smem_bytes)


@pytest.mark.cuda
def test_cuda_flash_backward_shape_is_the_mirror(cuda_device):
    """The built library's backward launches equal
    ``backward_launch_shape``."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in fa.HEAD_DIMS:
            assert fa.kernel_backward_shape(d, dtype) == tuple(
                (x.rows, x.tile, x.stages, x.threads, x.smem_bytes,
                 int(x.split)) for x in fa.backward_launch_shape(d, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_dot_interaction_matches_plain(cuda_device, dtype):
    """F 2 to 33 cut the 4×4 pair tiles at every remainder; d 130 and 6 are
    not multiples of 8 (the path without 16-byte copies), d 130 also not
    a multiple of the 128-byte chunk."""
    from repro_torch.kernels import dot_interaction as di
    rng = np.random.default_rng(7)
    for b, f, d in [(300, 27, 128), (70, 2, 128), (70, 3, 64), (70, 26, 32),
                    (70, 28, 128), (70, 33, 130), (50, 27, 6)]:
        x = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)
                             ).to(cuda_device, dtype)
        got = ops.dot_interaction(x)
        want = di.dot_interaction_plain(x)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(
            got.float(), want.float(),
            rtol=1e-5 if dtype == torch.float32 else ONE_ROUNDING[dtype] * 2,
            atol=1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.cuda
def test_cuda_embedding_bag_matches_plain(cuda_device):
    from repro_torch.kernels import embedding_bag as eb
    rng = np.random.default_rng(8)
    tab = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 4100, (500, 16)).astype(np.int32))
    tab, idx = tab.to(cuda_device), idx.to(cuda_device)
    got = ops.embedding_bag(tab, idx)
    want = eb.embedding_bag_plain(tab, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
