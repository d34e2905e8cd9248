"""Gradients through the port's kernel twins, on the CPU.

The reference has no backward kernel: it differentiates its jnp path.
So each plain backward of the port (``flash_attention_backward_plain``,
``dot_interaction_backward_plain``, the oracles of the backward kernels)
is held to ``jax.vjp`` of the reference's oracle
(``repro.kernels.ref.flash_attention_ref`` / ``dot_interaction_ref``) on
the same numpy inputs: in f32 at ``F32`` (the frameworks sum in other
orders), in bf16 at ``BF16`` (each side rounds its f32 gradient once to
bf16, so they may differ by an ulp). In bf16 the flash backward is given
the forward's f32 output: the reference's softmax VJP reads no rounded
output, while the kernels' Dvec = rowsum(dO∘O) reads the output they
saved, whose rounding (2^-9 of O) moves a gradient near zero by up to a
few 1e-3 — the cuda cases hold the kernels to the plain version on that
same rounded output. The f32 backward kernels' arithmetic (operands in
three bf16 terms, six products for each of S, dP, dV, dK and dQ) is
emulated (``_f32_backward``) and held to ``jax.vjp`` at ``F32`` and to the
backward in f64, which also shows that each product kept is needed.
``FlashAttentionFn`` and ``DotInteractionFn`` —
the autograd Functions the layers use — must give the plain backward's
gradients, and torch autograd's of the plain forward at ``F32``. The plain
forward's ``lse`` is held to a float64 log-sum-exp. ``lm_forward`` with
``cfg.remat`` must give the same loss and gradients, bit for bit, as
without. ``cuda``-marked cases hold the backward kernels to their plain
versions on the card (one rounding of the f32 plain version in 16 bits,
as chip_smoke phase 12 does) and skip here.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import dot_interaction_ref, flash_attention_ref
from repro_torch import configs as port_configs
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf

from test_torch_common import f64_attention, ref_on_cpu, split3

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-4)
# the 16-bit gate on the card: half an ulp of the f32 plain version, plus
# 1e-4 of the tensor's largest magnitude for values near zero
ONE_ROUNDING = {torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11,
                torch.float32: 1e-5}
GATE_ATOL = 1e-4

# (B, S, H, KV, D, causal, window): MHA, GQA, a window, ragged S; the
# second row crosses several of the backward kernels' 128-row blocks and
# 64-row tiles: ragged S (300, 333), a window straddling tile boundaries,
# 8 query heads a KV head, D 16 and 32
FLASH_CASES = [(2, 16, 4, 4, 16, True, 0), (1, 37, 4, 2, 16, True, 0),
               (2, 24, 6, 2, 32, True, 5), (1, 19, 2, 1, 16, False, 0),
               (1, 21, 4, 2, 16, False, 6),
               (1, 300, 4, 4, 64, True, 0), (1, 333, 2, 2, 64, True, 0),
               (1, 333, 4, 2, 64, True, 130), (1, 333, 16, 2, 64, True, 0),
               (1, 300, 4, 2, 16, True, 0), (1, 333, 4, 2, 32, True, 0),
               (1, 300, 4, 4, 16, False, 0), (1, 257, 4, 2, 32, False, 40)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flash_inputs(case, seed=0):
    b, s, h, kv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_plain_matches_reference_vjp(case, dtype):
    causal, window = case[5], case[6]
    q, k, v, do = _flash_inputs(case)
    with ref_on_cpu():
        args = [jnp.asarray(x, dtype) for x in (q, k, v)]
        out, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
            a, b, c, causal=causal, window=window), *args)
        want = vjp(jnp.asarray(do, dtype))
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(out), **(F32 if dtype ==
                                                    "float32" else BF16))
    o32 = fa.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                   causal=causal, window=window)
    got = fa.flash_attention_backward_plain(tq, tk, tv, o32, lse, tdo,
                                            causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=name)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fn_gradients_match_plain_backward(case):
    """``flash_attention`` under autograd goes through FlashAttentionFn:
    its gradients are the plain backward's, exactly, and torch autograd's
    of the plain forward at ``F32``."""
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(case, 1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert torch.equal(out.detach(), o)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention_plain(
        *leaves, causal=causal, window=window), leaves, do)
    for g, w in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)


def test_flash_without_grad_is_the_plain_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in _flash_inputs(FLASH_CASES[1]))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q, k, v))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_lse(case):
    """``lse`` (B, H, S) is each row's log Σ exp of its scaled, unmasked
    scores, against float64 numpy."""
    b, s, h, kv, d, causal, window = case
    q, k, v, _ = _flash_inputs(case, 2)
    _, lse = fa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, s)
    g = h // kv
    kh = np.repeat(k.astype(np.float64), g, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kh) / math.sqrt(d)
    pq, pk = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= pq >= pk
    if window:
        mask &= pq - pk < window
    sc = np.where(mask, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, **F32)


# The f32 backward kernels' arithmetic (flash_attention.cu
# flash_bwd_dkdv_f32_kernel / flash_bwd_dq_f32_kernel), emulated in torch on
# the CPU: q·scale, k, v, dO, P and dS in three bf16 terms each, S, dP, dV,
# dK and dQ the sums of the products kept. (A's term, B's term), 0 = hi, 1 =
# mid, 2 = lo: the kernels' six for each (prod_a / prod_b), every pair down
# to the 2^-16 terms; THREE_PRODUCTS, those down to the 2^-8 terms.
F32_BWD_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
THREE_PRODUCTS = ((1, 0), (0, 1), (0, 0))
BWD_PRODUCTS_OF = ("s", "dp", "dv", "dk", "dq")


def _f32_backward(q, k, v, o, lse, do, *, causal, window, products=None,
                  sums=torch.float32, split=None):
    """``(dq, dk, dv)`` as the f32 backward kernels compute them from f32
    inputs and the forward's ``o`` and ``lse``: ``products`` maps S, dP,
    dV, dK or dQ to the products it keeps (the kernels' six by default);
    each product's terms are exact, P and dS are split from their f32
    values, the sums are torch's in ``sums``, to nearest (so this bounds
    the split and the products, not ``wgmma``'s accumulation). ``split``
    replaces the three-term split (``WHOLE``: none, the operands as
    given)."""
    keep = {x: F32_BWD_PRODUCTS for x in BWD_PRODUCTS_OF}
    keep.update(products or {})
    split = split or (lambda x: split3(x.float()))
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv

    def prod(eq, a, c, what):
        at, ct = split(a), split(c)
        return sum(torch.einsum(eq, at[i].to(sums), ct[j].to(sums))
                   for i, j in keep[what])
    qg = q.reshape(b, s, kv, g, d) * (1.0 / math.sqrt(d))
    dog = do.reshape(b, s, kv, g, d)
    sc = prod("bqkgd,bjkd->bkgqj", qg, k, "s")
    mask = fa.attention_mask(s, s, causal=causal, window=window)
    p = torch.where(mask, torch.exp(sc - lse.reshape(b, kv, g, s)[
        ..., None].to(sums)), torch.zeros((), dtype=sums))
    dvec = (dog * o.reshape(b, s, kv, g, d)).sum(-1)
    dp = prod("bqkgd,bjkd->bkgqj", dog, v, "dp")
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None].to(sums))
    dq = prod("bkgqj,bjkd->bqkgd", ds, k, "dq") * (1.0 / math.sqrt(d))
    return (dq.reshape(b, s, h, d), prod("bkgqj,bqkgd->bjkd", ds, qg, "dk"),
            prod("bkgqj,bqkgd->bjkd", p, dog, "dv"))


# the backward's formulas with the operands whole (in ``sums``)
WHOLE = dict(split=lambda x: (x,),
             products={x: ((0, 0),) for x in BWD_PRODUCTS_OF})


def _f64_backward(q, k, v, do, *, causal, window):
    """The exact backward: its formulas in f64 from the attention in
    f64."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    o, lse = f64_attention(q, k, v, causal=causal, window=window)
    return _f32_backward(q, k, v, o, lse, do, causal=causal, window=window,
                         sums=torch.float64, **WHOLE)


def _f32_contract_excess(got, want):
    """max |got − want| / (atol + rtol·|want|) at ``F32``: ≤ 1 holds it."""
    return max(float(((g.double() - w.double()).abs()
                      / (F32["atol"] + F32["rtol"] * w.double().abs())).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", [(1, 192, 4, 2, 64, True, 0),
                                  (1, 256, 2, 2, 128, True, 0),
                                  (2, 200, 2, 1, 32, True, 40),
                                  (1, 130, 4, 2, 16, False, 17)])
def test_f32_backward_body_matches_reference_vjp(case):
    """The emulated f32 backward kernels against ``jax.vjp`` of the
    reference's oracle at ``F32``, on the forward's own o and lse."""
    causal, window = case[5], case[6]
    q, k, v, do = _flash_inputs(case, 4)
    with ref_on_cpu():
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
            a, b, c, causal=causal, window=window),
            *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    got = _f32_backward(tq, tk, tv, o, lse, tdo, causal=causal,
                        window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


@pytest.mark.parametrize("what", BWD_PRODUCTS_OF)
@pytest.mark.parametrize("drop", [(2, 0), (0, 2), (1, 1)])
def test_f32_backward_keeps_the_fewest_products(what, drop):
    """Against the backward's formulas in f64 on the kernels' own f32
    operands (q·scale rounded to f32, the forward's o and lse), sums in f64
    (so only the split and the products count): the six products of each
    of S, dP, dV, dK and dQ miss by e < 1e-6, and dropping any one of the
    2^-16 products of any of them costs at least 5× e."""
    case = (1, 128, 4, 2, 32, True, 0)
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(case, 4))
    kw = dict(causal=True, window=0)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    exact = _f32_backward(q, k, v, o, lse, do, sums=torch.float64, **WHOLE,
                          **kw)

    def miss(products):
        got = _f32_backward(q, k, v, o, lse, do, products=products,
                            sums=torch.float64, **kw)
        return max(float((g - w).abs().max()) for g, w in zip(got, exact))
    e6 = miss(None)
    assert e6 < 1e-6
    assert miss({what: [p for p in F32_BWD_PRODUCTS if p != drop]}) > 5 * e6


@pytest.mark.parametrize("case", [(1, 192, 4, 2, 64, True, 0),
                                  (1, 128, 2, 1, 128, True, 30)])
def test_f32_backward_needs_the_six_products(case):
    """With f32 sums, as the card sums: against the exact backward (f64)
    the six products of each hold the CPU's f32 contract (``F32``) with
    the margin the plain f32 backward has; the three products down to the
    2^-8 terms for all five miss it."""
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(case, 4))
    kw = dict(causal=causal, window=window)
    exact = _f64_backward(q, k, v, do, **kw)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    six = _f32_contract_excess(_f32_backward(q, k, v, o, lse, do, **kw),
                               exact)
    plain = _f32_contract_excess(fa.flash_attention_backward_plain(
        q, k, v, o, lse, do, **kw), exact)
    three = _f32_contract_excess(_f32_backward(
        q, k, v, o, lse, do, products={x: THREE_PRODUCTS
                                       for x in BWD_PRODUCTS_OF}, **kw),
        exact)
    assert six <= max(0.25, 2 * plain)
    assert three > 1.0


# ---------------------------------------------------------------------------
# dot interaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,f,d", [(4, 27, 16), (3, 5, 8), (2, 2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_backward_plain_matches_reference_vjp(b, f, d, dtype):
    """In f32 at ``F32``. In bf16 the reference rounds twice: its oracle
    casts feats to f32 once per operand of the Gram product, so jax's
    VJP rounds each operand's part (``A = Gᵤ·X``, ``B = Gₗ·X``, the upper
    and lower triangles) to bf16 and adds them in bf16, while the port
    rounds ``Gsym·X`` once. So the port is held within one rounding of the
    float64 gradient, and the reference within the three roundings of
    ``A``, ``B`` and ``A + B``."""
    rng = np.random.default_rng(f)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    with ref_on_cpu():
        _, vjp = jax.vjp(dot_interaction_ref, jnp.asarray(x, dtype))
        (want,) = vjp(jnp.asarray(g, dtype))
    tdt = getattr(torch, dtype)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    got = di.dot_interaction_backward_plain(tx, tg)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        return
    iu, ju = np.triu_indices(f, 1)
    up = np.zeros((b, f, f))
    up[:, iu, ju] = tg.double().numpy()
    xd = tx.double().numpy()
    a, bb = up @ xd, up.transpose(0, 2, 1) @ xd
    exact = a + bb
    half = 2 ** -8
    assert (np.abs(_np(got) - exact) <= half * np.abs(exact) + 1e-30).all()
    assert (np.abs(_np(got) - _np(want))
            <= half * (np.abs(a) + np.abs(bb) + 2 * np.abs(exact))).all()


def test_dot_fn_gradients_match_plain_backward():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 27, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 351)).astype(np.float32))
    leaf = x.clone().requires_grad_()
    out = ops.dot_interaction(leaf)
    assert type(out.grad_fn).__name__ == "DotInteractionFnBackward"
    (got,) = torch.autograd.grad(out, leaf, g)
    assert torch.equal(got, di.dot_interaction_backward_plain(x, g))
    leaf = x.clone().requires_grad_()
    (auto,) = torch.autograd.grad(di.dot_interaction_plain(leaf), leaf, g)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), **F32)
    assert ops.dot_interaction(x).grad_fn is None


@pytest.mark.parametrize("f", [2, 5, 27, 40])
@pytest.mark.parametrize("elem_size", [2, 4])
def test_dot_backward_launch_shape(f, elem_size):
    """A stage holds one unit of X: Fp rows (the forward's padding) × all
    of d when that fits ``BWD_STAGE_BYTES``, else the most 16-byte pieces
    that do; the ring of stages, Gsym (Fp² floats), the staged gradient
    row, the pair table and one barrier a stage fit the block's shared
    memory; one thread per (4-feature block, piece), at most 256."""
    fp = di.launch_shape(f, elem_size)["fp"]
    vec = 16 // elem_size
    n_pairs = f * (f - 1) // 2
    for d in (3, 16, 128, 1024, 4096):
        shape = di.backward_launch_shape(f, d, elem_size)
        chunk = shape["chunk"]
        assert shape["fp"] == fp and shape["stages"] == di.BWD_STAGES >= 2
        if fp * d * elem_size <= di.BWD_STAGE_BYTES:
            assert chunk == d
        else:
            assert chunk % vec == 0 and vec <= chunk < d
            assert fp * chunk * elem_size <= di.BWD_STAGE_BYTES
            assert fp * (chunk + vec) * elem_size > di.BWD_STAGE_BYTES
        a16 = lambda n: -(-n // 16) * 16  # noqa: E731
        assert shape["smem_bytes"] == (
            a16(di.BWD_STAGES * fp * chunk * elem_size) + fp * fp * 4
            + a16(n_pairs * elem_size + 4) + a16(n_pairs * 4)
            + 8 * di.BWD_STAGES)
        assert shape["smem_bytes"] <= di.SMEM_MAX
        assert 32 <= shape["threads"] <= di.THREADS
        assert shape["threads"] % 32 == 0
        assert shape["threads"] == min(
            di.THREADS, -(-(fp // 4) * -(-chunk // vec) // 32) * 32)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-27b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_is_bit_equal(arch, compute_dtype):
    """``cfg.remat`` checkpoints every block: loss, metrics and every
    gradient bit for bit as without (the reference's
    ``jax.checkpoint`` changes no value either)."""
    cfg = dataclasses.replace(port_configs.reduced(
        port_configs.get_config(arch)), compute_dtype=compute_dtype)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    out = {}
    for remat in (False, True):
        model = tf.lm_init(dataclasses.replace(cfg, remat=remat), seed=3,
                           device="cpu")
        loss, metrics = tf.lm_loss(model, {"tokens": tokens})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (loss, metrics, grads)
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _de_batch(cfg, b=4, nneg=2, seed=0):
    r = np.random.default_rng(seed)
    L = cfg.max_len

    def toks(*shape):
        t = torch.from_numpy(r.integers(1, cfg.vocab_size, shape + (L,))
                             .astype(np.int32))
        m = torch.from_numpy(np.arange(L) < r.integers(2, L + 1, shape)
                             [..., None])
        return t, m

    def loc(*shape):
        return torch.from_numpy(r.random(shape + (2,)).astype(np.float32))
    q, qm = toks(b)
    p, pm = toks(b)
    n, nm = toks(b, nneg)
    return {"q_tokens": q, "q_mask": qm, "q_loc": loc(b),
            "pos_tokens": p, "pos_mask": pm, "pos_loc": loc(b),
            "neg_tokens": n, "neg_mask": nm, "neg_loc": loc(b, nneg)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encoder_remat_is_bit_equal(compute_dtype):
    """The reduced ``list-dual-encoder``'s contrastive loss, metrics and
    every gradient bit for bit with and without ``cfg.remat`` (the
    reference's ``encoder_forward`` under ``_maybe_remat``); the towers
    learn ``remat`` from the config, through ``relevance_init`` and
    ``convert``."""
    from repro_torch import convert
    from repro_torch.core import relevance as port_relevance
    cfg = dataclasses.replace(port_configs.reduced(
        port_configs.get_config("list-dual-encoder")),
        compute_dtype=compute_dtype)
    batch = _de_batch(cfg)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        rel = port_relevance.relevance_init(c, torch.Generator().manual_seed(3))
        assert rel.q_enc.remat is remat and rel.o_enc.remat is remat
        tree = convert.relevance_to_tree(rel, lambda p: p.detach())
        assert convert.relevance_from_numpy(tree, c).o_enc.remat is remat
        kept = []

        def pack(t):
            kept.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, metrics = port_relevance.contrastive_loss(rel, batch)
        grads = torch.autograd.grad(loss, list(rel.parameters()),
                                    allow_unused=True)
        out[remat] = (loss, metrics, grads, sum(kept))
    (l0, m0, g0, k0), (l1, m1, g1, k1) = out[False], out[True]
    # the blocks' activations are not kept under remat
    assert k1 < k0 / 2
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    assert sum(g is not None and bool(g.abs().sum() > 0) for g in g1) > 30


def test_remat_leaves_inference_alone():
    """Under ``no_grad`` (the serving paths) nothing is checkpointed."""
    cfg = dataclasses.replace(port_configs.reduced(
        port_configs.get_config("stablelm-1.6b")), remat=True)
    model = tf.lm_init(cfg, seed=0, device="cpu")
    tokens = np.arange(32, dtype=np.int32).reshape(2, 16)
    with torch.no_grad():
        x, _, _ = tf.lm_forward(model, tokens)
        y, _, _ = tf.lm_forward(tf.lm_init(dataclasses.replace(
            cfg, remat=False), seed=0, device="cpu"), tokens)
    assert x.grad_fn is None and torch.equal(x, y)


# ---------------------------------------------------------------------------
# On the card: each backward kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _one_rounding_excess(got, want, dtype):
    """max |got − want| / (rel·|want| + GATE_ATOL·max|want|): ≤ 1 passes."""
    a = GATE_ATOL * float(want.abs().max())
    return float(((got.float() - want).abs()
                  / (ONE_ROUNDING[dtype] * want.abs() + a)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + [(2, 130, 8, 2, 64, True, 24),
                                                (1, 200, 4, 4, 128, True, 0),
                                                (1, 333, 2, 2, 128, True, 0),
                                                (1, 520, 4, 2, 64, True, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_backward_matches_plain(cuda_device, case, dtype):
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x).to(cuda_device).to(dtype)
                   for x in _flash_inputs(case, 3))
    ops.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_backward"] == 1
    assert ops.launch_counts()["flash_attention_backward_f32"] == int(
        dtype == torch.float32)
    _, lse = fa._launch(q, k, v, causal, window, True)
    want = fa.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), out.detach().float(), lse,
        do.float(), causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        assert _one_rounding_excess(g, w, dtype) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 333, 2, 2, 64, True, 0),
                                  (2, 301, 4, 2, 128, True, 0),
                                  (1, 333, 4, 2, 32, False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_backward_ignores_what_the_scratch_held(cuda_device, case,
                                                           dtype):
    """At a ragged S the kernels read Dvec and lse in rows padded to a
    multiple of 4: a NaN left in the caching allocator's block of that
    size must not reach dK or dV (nor, in f32, one left where the inputs'
    three bf16 terms go: the split pass writes every term)."""
    b, s, h, _, d, causal, window = case
    q, k, v, do = (torch.from_numpy(x).to(cuda_device).to(dtype)
                   for x in _flash_inputs(case, 5))
    o, lse = fa._launch(q, k, v, causal, window, True)
    want = fa.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal=causal, window=window)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the wrapper's scratch is 2·B·H·S4 f32, S4 = S rounded up to 4: 4 MiB of
    # blocks of that size filled with NaN and freed, so the allocator's free
    # blocks of the small pool that the scratch can come from hold NaN
    n = 2 * b * h * (-(-s // 4) * 4)
    dirty = [torch.full((n,), float("nan"), device=cuda_device)
             for _ in range((4 << 20) // (4 * n))]
    del dirty
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _one_rounding_excess(g, w, dtype) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d", [(300, 27, 128), (17, 5, 12), (64, 27, 130),
                                   (40, 27, 1024), (33, 40, 64), (7, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dot_backward_matches_plain(cuda_device, b, f, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(b, f, d, generator=g, device=cuda_device).to(dtype)
    gr = torch.randn(b, f * (f - 1) // 2, generator=g,
                     device=cuda_device).to(dtype)
    ops.reset_launch_counts()
    leaf = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(ops.dot_interaction(leaf), leaf, gr)
    assert ops.launch_counts()["dot_interaction_backward"] == 1
    want = di.dot_interaction_backward_plain(x, gr)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_embedding_bag_refuses_a_table_that_needs_grad(cuda_device):
    from repro_torch.models import recsys
    table = torch.randn(50, 8, device=cuda_device, requires_grad=True)
    idx = torch.arange(12, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        recsys.embedding_bag(table, idx, torch.tensor([0, 4, 9]), n_bags=3)
    with torch.no_grad():
        out = recsys.embedding_bag(table, idx, torch.tensor([0, 4, 9]),
                                   n_bags=3)
    assert out.shape == (3, 8)
