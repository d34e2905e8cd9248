"""The port's dense LM serving path against the reference, on the CPU.

The same inputs, made with numpy, go through ``repro.models.{layers,
transformer}`` and ``repro_torch.models.{layers, transformer}``; weights
cross through ``repro_torch.convert`` (``lm_from_numpy``, caches both
ways). The dense archs run reduced (``configs.reduced``) at 1e-5 with
``compute_dtype="float32"``, where the two packages compute the same
function in the same order up to f32 rounding. In bf16 the port is held
to itself at the reference's own 2e-2 (``tests/test_decode_parity.py``'s
decode-against-forward cases, mirrored), and to the reference at
``BF16_CROSS`` with at most ``BF16_CROSS_FRAC`` of the logits beyond
2e-2. The MoE archs (moonshot, kimi: reduced to 4 experts, top-2) run
the same cases with their ``moe`` leaves carried across, the summed aux
included (in bf16 with each package's routing recorded: a token that
picks other experts at a near tie is named and left out, ``TIE_GAP``);
their decode is held to the full forward at capacity_factor = E, where
no assignment is dropped (prefill groups by sequence, decode by batch,
so capacity drops differ between them), as
``tests/test_decode_parity.py`` does. ``cuda``-marked cases hold the
flash twin's launches on the prefill path against the plain version on
the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.data import LMStream as RefLMStream
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.data.lm_data import LMStream
from repro_torch.models import layers
from repro_torch.models import transformer as tf

from test_torch_common import np_tree, ref_on_cpu

KEY = jax.random.PRNGKey(3)
DENSE = ["stablelm-1.6b", "gemma3-27b", "qwen2-7b"]
MOE = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)       # tests/test_decode_parity.py
# the port against the reference in bf16: the frameworks' f32 attention
# sums and exp differ in the last bits (P·V in ~77% of the elements, exp in
# ~10%), which flips bf16 roundings (2^-8) that then grow through the
# layers. At these sizes (logit std 1.0) the largest |Δ| − 2e-2·|logit|
# measured 0.046 and at most 3.5% of a step's logits missed the reference's
# own 2e-2 / 2e-2 (gemma3's remainder config; 0 for the reference's decode
# against its forward). Every logit is held at atol 0.06 (that 0.046 and a
# margin) and at most BF16_CROSS_FRAC of them may miss 2e-2 / 2e-2, so a
# fault that moves many logits a little fails as well as one that moves a
# few a lot. The f32 cases check the arithmetic at 1e-5.
BF16_CROSS = dict(rtol=2e-2, atol=6e-2)
BF16_CROSS_FRAC = 0.05


def _assert_bf16_cross(got, want, err_msg=""):
    """``got`` within ``BF16_CROSS`` of ``want`` everywhere and within
    the reference's ``BF16`` on all but ``BF16_CROSS_FRAC`` of it."""
    np.testing.assert_allclose(got, want, **BF16_CROSS, err_msg=err_msg)
    miss = np.abs(got - want) > BF16["atol"] + BF16["rtol"] * np.abs(want)
    assert miss.mean() <= BF16_CROSS_FRAC, (
        f"{err_msg}: {miss.mean():.4f} of the values miss 2e-2 / 2e-2")


def _np(x):
    """A jax array or tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, **kw):
    """``(reference cfg, port cfg)``: the reduced arch, ``kw`` applied."""
    return (dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), **kw),
        dataclasses.replace(port_configs.reduced(
            port_configs.get_config(arch)), **kw))


def _models(arch, **kw):
    """The reference's params and the port's LM converted from them."""
    rcfg, pcfg = _cfgs(arch, **kw)
    with ref_on_cpu():
        params = ref_tf.lm_init(KEY, rcfg)
    return rcfg, params, convert.lm_from_numpy(np_tree(params), pcfg)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 12))
    with ref_on_cpu():
        want = ref_layers.rope(jnp.asarray(x, dtype), jnp.asarray(pos),
                               theta=1e6)
    got = layers.rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(pos), theta=1e6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=2 ** -7 * 4)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    p = {"scale": scale} | ({"bias": bias} if kind == "layer" else {})
    with ref_on_cpu():
        want = ref_layers.apply_norm(p, jnp.asarray(x, dtype), eps=1e-6)
    norm = layers.norm_init(24, kind=kind)
    norm.scale.data = torch.from_numpy(scale)
    if kind == "layer":
        norm.bias.data = torch.from_numpy(bias)
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _qkv(rng, b, s, h, kv, d):
    return [rng.normal(size=shp).astype(np.float32)
            for shp in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("causal,window,chunk,s", [
    (True, 0, 16, 40), (True, 16, 16, 64), (True, 7, 32, 50),
    (False, 0, 64, 33)])
def test_attention_full(causal, window, chunk, s):
    q, k, v = _qkv(np.random.default_rng(2), 2, s, 4, 2, 16)
    with ref_on_cpu():
        want = ref_layers.attention_full(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, window=window,
                                         chunk=chunk)
    got = layers.attention_full(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_attention_full_positions():
    """The oracle knobs run on the CPU: explicit positions, as the
    reference's ``positions_q`` / ``positions_k``."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 24, 4, 4, 16)
    pq, pk = np.arange(100, 124), np.arange(90, 114)
    with ref_on_cpu():
        want = ref_layers.attention_full(
            *map(jnp.asarray, (q, k, v)), causal=True, window=12, chunk=8,
            positions_q=jnp.asarray(pq), positions_k=jnp.asarray(pk))
    got = layers.attention_full(
        *map(torch.from_numpy, (q, k, v)), causal=True, window=12, chunk=8,
        positions_q=torch.from_numpy(pq), positions_k=torch.from_numpy(pk))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("window,block", [(16, None), (8, 16)])
def test_attention_local_banded(window, block):
    q, k, v = _qkv(np.random.default_rng(4), 2, 64, 4, 2, 16)
    with ref_on_cpu():
        want = ref_layers.attention_local_banded(
            *map(jnp.asarray, (q, k, v)), window=window, block=block)
    got = layers.attention_local_banded(*map(torch.from_numpy, (q, k, v)),
                                        window=window, block=block)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_banded_equals_full_window_attention():
    """tests/test_decode_parity.py's check on the port: the banded blocks
    compute the window-limited full attention."""
    q, k, v = map(torch.from_numpy,
                  _qkv(np.random.default_rng(0), 2, 64, 4, 2, 16))
    o1 = layers.attention_local_banded(q, k, v, window=16)
    o2 = layers.attention_full(q, k, v, causal=True, window=16, chunk=32)
    np.testing.assert_allclose(_np(o1), _np(o2), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ring,window", [(False, 0), (False, 5), (True, 8)])
def test_decode_attention(ring, window):
    rng = np.random.default_rng(5)
    b, t, h, kv, d = 3, 8 if ring else 20, 4, 2, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    pos = np.array([3, 11, 19], np.int32)
    with ref_on_cpu():
        want = ref_layers.decode_attention(
            *map(jnp.asarray, (q, kc, vc, pos)), window=window, ring=ring)
    got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc, pos)),
                                  window=window, ring=ring)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent(masked):
    rng = np.random.default_rng(6)
    b, s, d, v = 2, 16, 8, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    u = rng.normal(size=(d, v)).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    m = rng.random((b, s)) < 0.7 if masked else None
    with ref_on_cpu():
        want = ref_layers.chunked_softmax_xent(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(t), chunk=4,
            mask=None if m is None else jnp.asarray(m))
    got = layers.chunked_softmax_xent(
        torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(t),
        chunk=4, mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the model: structure, weights, forward, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_scan_structure(arch):
    assert tf.scan_structure(port_configs.get_config(arch)) == \
        ref_tf.scan_structure(ref_configs.get_config(arch))


def test_gemma_pattern_structure():
    """tests/test_arch_smoke.py's check on the port's config."""
    cfg = port_configs.get_config("gemma3-27b")
    pat = cfg.pattern()
    assert len(pat) == 62
    assert pat.count("G") == 10 and pat.count("L") == 52
    n, period, rem = tf.scan_structure(cfg)
    assert n * len(period) + len(rem) == 62


def _hybrid(**kw):
    """gemma3 reduced to 5 layers "LGLGL": two periods and a remainder."""
    return dict(n_layers=5, layer_pattern=("L", "G", "L", "G", "L"),
                window_size=8, **kw)


def _no_drop(arch):
    """A MoE arch's reduced config at capacity_factor = E (no drops)."""
    moe = port_configs.reduced(port_configs.get_config(arch)).moe
    return dict(moe=dataclasses.replace(moe,
                                        capacity_factor=float(moe.n_experts)))


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-7b", {}), ("gemma3-27b", {}), ("gemma3-27b", _hybrid()),
    ("moonshot-v1-16b-a3b", {}), ("kimi-k2-1t-a32b", {})],
    ids=["qwen2", "gemma3", "gemma3-remainder", "moonshot", "kimi"])
def test_lm_weights_round_trip(arch, kw):
    rcfg, params, model = _models(arch, **kw)
    back = convert.lm_to_numpy(model)
    want = np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        # a bf16 leaf comes back as a CPU tensor (numpy has no bf16);
        # widening it to f32 is exact
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_forward_f32(arch):
    """The hidden states at 1e-5 and the aux summed over the layers: the
    MoE losses at 1e-5 (exactly 0 for a dense arch), ``drop_fraction``
    equal."""
    rcfg, params, model = _models(arch, compute_dtype="float32")
    toks = _tokens(rcfg, 2, 32)
    with ref_on_cpu():
        want, aux, _ = ref_tf.lm_forward(params, jnp.asarray(toks), rcfg)
    got, paux, _ = tf.lm_forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert set(paux) == set(aux)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(paux[k]), float(aux[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert float(paux["drop_fraction"]) == float(aux["drop_fraction"])
    if arch in MOE:
        assert float(aux["lb_loss"]) >= rcfg.n_layers * (1 - 1e-3)


@pytest.mark.parametrize("arch", DENSE + MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss(arch, dtype):
    rcfg, params, model = _models(arch, compute_dtype=dtype)
    batch = RefLMStream(rcfg.vocab_size, seed=1).batch(0, 2, 32)
    with ref_on_cpu():
        want, wm = ref_tf.lm_loss(params, {"tokens": jnp.asarray(
            batch["tokens"])}, rcfg)
    got, gm = tf.lm_loss(model, {"tokens": torch.from_numpy(
        batch["tokens"])})
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(float(got), float(want), **tol)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **tol,
                                   err_msg=k)


def _prefill_decode(rcfg, params, model, *, b, s, n_new, seed=0):
    """Prefill ``s`` tokens with a cache of ``s + n_new``, then decode
    ``n_new`` tokens, on both packages → per step ``(port logits,
    reference logits)``, and the two final caches."""
    toks = _tokens(rcfg, b, s + n_new, seed)
    with ref_on_cpu():
        r_logits, r_cache = ref_tf.lm_prefill(params, jnp.asarray(toks[:, :s]),
                                              rcfg, max_len=s + n_new)
    p_logits, p_cache = tf.lm_prefill(model, torch.from_numpy(toks[:, :s]),
                                      max_len=s + n_new)
    out = [(p_logits, r_logits)]
    for i in range(n_new):
        tok = toks[:, s + i:s + i + 1]
        pos = np.full((b,), s + i, np.int32)
        with ref_on_cpu():
            r_logits, r_cache = ref_tf.lm_decode_step(
                params, r_cache, jnp.asarray(tok), jnp.asarray(pos), rcfg)
        p_logits, p_cache = tf.lm_decode_step(model, p_cache,
                                              torch.from_numpy(tok),
                                              torch.from_numpy(pos))
        out.append((p_logits, r_logits))
    return out, p_cache, r_cache


@pytest.mark.parametrize("arch,kw", [
    ("stablelm-1.6b", {}), ("qwen2-7b", {}), ("gemma3-27b", {}),
    ("gemma3-27b", _hybrid())],
    ids=["stablelm", "qwen2", "gemma3", "gemma3-remainder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_decode_parity(arch, kw, dtype):
    """``lm_prefill`` (S 32: gemma3's local layers take the banded case)
    and 6 decode steps (past the 8-slot rings of the remainder config)
    against the reference; the final caches convert to the reference's
    layout and agree with it."""
    rcfg, params, model = _models(arch, compute_dtype=dtype, **kw)
    steps, p_cache, r_cache = _prefill_decode(rcfg, params, model, b=2, s=32,
                                              n_new=6)
    def close(got, want, err_msg):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32, err_msg=err_msg)
        else:
            _assert_bf16_cross(got, want, err_msg)
    for i, (got, want) in enumerate(steps):
        assert got.dtype == torch.float32
        close(_np(got), _np(want), f"step {i}")
    back = convert.cache_to_numpy(p_cache, model.cfg)
    want = np_tree(r_cache)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert tuple(a.shape) == tuple(b.shape)
        close(_np(a), _np(b), "cache")


# In bf16 the two packages' hidden states differ in the last bits
# (BF16_CROSS's note), which moves the router's probabilities by a little
# (the test holds that drift below TIE_GAP / 2 wherever both pick the same
# experts). A token whose k-th and (k+1)-th probabilities lie closer than
# twice the drift can pick another expert on one side, and its logits
# then move by O(1). A disagreement is accepted only at such a near tie
# (the port's gap below TIE_GAP), and the call's logits of that sequence,
# and the cache entries of that token in the layers after it, are left
# out of the comparison.
TIE_GAP = 0.02


class _Routes:
    """Records both packages' router calls (the reference's through
    ``jax.debug.callback``, inside its layer scan): per call ``(top-k
    ids, probabilities)``, one call per layer per model call."""

    def __init__(self, monkeypatch):
        from repro.models import moe as ref_moe
        from repro_torch.models import moe as port_moe
        self.ref, self.port = [], []
        real_r, real_p = ref_moe.route, port_moe.route

        def ref_route(params, x, spec):
            out = real_r(params, x, spec)
            probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"],
                                   axis=-1)
            jax.debug.callback(lambda i, p: self.ref.append(
                (np.asarray(i), np.asarray(p))), out[0], probs, ordered=True)
            return out

        def port_route(router, x, spec):
            out = real_p(router, x, spec)
            probs = torch.softmax(x.float() @ router.float(), dim=-1)
            self.port.append((out[0].numpy(), probs.detach().numpy()))
            return out
        monkeypatch.setattr(ref_moe, "route", ref_route)
        monkeypatch.setattr(port_moe, "route", port_route)

    def flips(self, b, n_layers, calls):
        """Per model call, ``(B, S_call, n_layers)`` bool: the tokens whose
        expert set differs between the packages in that layer. Raises
        unless each one is a near tie on the port's side, and unless the
        probabilities drift by less than ``TIE_GAP / 2`` wherever the
        expert sets agree."""
        assert len(self.ref) == len(self.port) == n_layers * calls
        out = []
        for c in range(calls):
            per_layer = []
            for l in range(n_layers):
                (ri, rp), (pi, pp) = self.ref[c * n_layers + l], \
                    self.port[c * n_layers + l]
                k = pi.shape[-1]
                diff = (np.sort(ri, -1) != np.sort(pi, -1)).any(-1)
                drift = np.abs(rp - pp).max(-1)[~diff]
                assert drift.size == 0 or drift.max() < TIE_GAP / 2, (
                    f"call {c} layer {l}: router probabilities drift by "
                    f"{drift.max():.4f}")
                srt = -np.sort(-pp, axis=-1)
                gap = srt[..., k - 1] - srt[..., k]
                assert (gap[diff] < TIE_GAP).all(), (
                    f"call {c} layer {l}: the packages route differently "
                    f"where the port's top-k gap is {gap[diff].min():.4f}")
                per_layer.append(diff.reshape(b, -1))
            out.append(np.stack(per_layer, axis=-1))
        return out


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_lm_prefill_decode_parity(arch, dtype, monkeypatch):
    """The MoE archs as served (capacity_factor 1.25, where both packages
    group and drop alike): ``lm_prefill`` (S 32) and 6 decode steps
    against the reference, each layer's routing recorded on both sides.
    In f32 every token picks the same experts, and the logits and caches
    agree at 1e-5. In bf16 a disagreement must be a near tie
    (``TIE_GAP``); every other (step, sequence) is held at
    ``BF16_CROSS``, and so are the caches but for the entries a flip fed
    (its token, in the layers after the flip)."""
    rcfg, params, model = _models(arch, compute_dtype=dtype)
    b, s, n_new = 2, 32, 6
    routes = _Routes(monkeypatch)
    steps, p_cache, r_cache = _prefill_decode(rcfg, params, model, b=b, s=s,
                                              n_new=n_new)
    flips = routes.flips(b, rcfg.n_layers, n_new + 1)
    if dtype == "float32":
        assert not any(f.any() for f in flips)
    close = ((lambda g, w, m: np.testing.assert_allclose(g, w, **F32,
                                                         err_msg=m))
             if dtype == "float32" else _assert_bf16_cross)
    held = np.array([[not f[i].any() for i in range(b)] for f in flips])
    assert held.mean() >= 0.75, f"too many flipped (step, sequence): {held}"
    for i, (got, want) in enumerate(steps):
        assert got.dtype == torch.float32
        rows = np.flatnonzero(held[i])
        close(_np(got)[rows], _np(want)[rows], f"step {i}")
    # a token's cache entries in layer l carry a flip of a layer before l
    fed = np.concatenate([f for f in flips], axis=1)        # (B, S + n, L)
    fed = np.cumsum(fed, axis=-1) - fed > 0
    want = convert.cache_from_numpy(np_tree(r_cache), model.cfg)
    for l, (got_l, want_l) in enumerate(zip(p_cache, want)):
        keep = ~fed[:, :, l]
        for kv in ("k", "v"):
            close(_np(got_l[kv])[keep], _np(want_l[kv])[keep], f"cache {l}")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-27b"] + MOE)
def test_decode_matches_full_forward(arch):
    """tests/test_decode_parity.py's KV-cache test on the port (bf16, its
    2e-2): prefill 24 tokens, decode 4, each step's logits against the
    full forward's at that position; a MoE arch at capacity_factor = E,
    where prefill and decode drop nothing."""
    cfg = port_configs.reduced(port_configs.get_config(arch))
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, **_no_drop(arch))
    model = tf.lm_init(cfg, seed=3, device="cpu")
    b, s_prompt, n_new = 2, 24, 4
    total = s_prompt + n_new
    toks = torch.from_numpy(_tokens(cfg, b, total, seed=3))
    x, _, _ = tf.lm_forward(model, toks)
    ref_logits = x @ tf.unembed_matrix(model).to(x.dtype)
    logits, cache = tf.lm_prefill(model, toks[:, :s_prompt], max_len=total)
    np.testing.assert_allclose(_np(logits), _np(ref_logits[:, s_prompt - 1]),
                               **BF16)
    for i in range(n_new):
        pos = torch.full((b,), s_prompt + i)
        logits, cache = tf.lm_decode_step(
            model, cache, toks[:, s_prompt + i:s_prompt + i + 1], pos)
        np.testing.assert_allclose(_np(logits),
                                   _np(ref_logits[:, s_prompt + i]), **BF16,
                                   err_msg=f"decode step {i}")


def test_ring_buffer_window_decode():
    """tests/test_decode_parity.py's ring test on the port: decode far past
    the 16-slot window; the last logits match a full forward."""
    cfg = port_configs.reduced(port_configs.get_config("gemma3-27b"))
    model = tf.lm_init(cfg, seed=3, device="cpu")
    total, s_prompt = 40, 8
    toks = torch.from_numpy(_tokens(cfg, 1, total, seed=4))
    x, _, _ = tf.lm_forward(model, toks)
    ref_logits = x @ tf.unembed_matrix(model).to(x.dtype)
    logits, cache = tf.lm_prefill(model, toks[:, :s_prompt], max_len=total)
    for i in range(total - s_prompt):
        logits, cache = tf.lm_decode_step(
            model, cache, toks[:, s_prompt + i:s_prompt + i + 1],
            torch.full((1,), s_prompt + i))
    np.testing.assert_allclose(_np(logits), _np(ref_logits[:, -1]), **BF16)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_prefill_decode_shapes(arch):
    """tests/test_arch_smoke.py's shape test on the port."""
    cfg = port_configs.reduced(port_configs.get_config(arch))
    model = tf.lm_init(cfg, device="cpu")
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(cfg, b, s))
    logits, cache = tf.lm_prefill(model, toks, max_len=s + 4)
    assert logits.shape == (b, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    lg, cache = tf.lm_decode_step(model, cache, toks[:, :1],
                                  torch.full((b,), s))
    assert lg.shape == (b, cfg.vocab_size)
    assert torch.isfinite(lg).all()


@pytest.mark.parametrize("arch,kw", [("qwen2-7b", {}),
                                     ("gemma3-27b", _hybrid())],
                         ids=["qwen2", "gemma3-remainder"])
def test_make_decode_cache(arch, kw):
    """The zero cache in the reference's layout, and a reference cache
    carried across and back unchanged."""
    rcfg, pcfg = _cfgs(arch, **kw)
    with ref_on_cpu():
        want = ref_tf.make_decode_cache(rcfg, 3, 24)
    got = tf.make_decode_cache(pcfg, 3, 24, device="cpu")
    assert all(c["k"].dtype == torch.bfloat16 for c in got)
    back = convert.cache_to_numpy(got, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree(want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree(want))):
        assert tuple(a.shape) == tuple(b.shape)
        assert not _np(a).any()
    filled = jax.tree.map(
        lambda a: np.random.default_rng(a.size).normal(
            size=a.shape).astype(np.float32), np_tree(want))
    rt = convert.cache_to_numpy(convert.cache_from_numpy(filled, pcfg), pcfg)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(filled)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_init(arch):
    """The port's own init of a MoE arch: every block holds a MoE with a
    float32 router and the reference's leaf shapes and dtypes (kimi's
    bf16 params), and a config whose blocks do not match is refused."""
    rcfg, pcfg = _cfgs(arch)
    model = tf.lm_init(pcfg, device="cpu")
    with ref_on_cpu():
        want = np_tree(ref_tf.lm_init(KEY, rcfg))
    got = convert.lm_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert all(b.moe.router.dtype == torch.float32 for b in model.blocks)
    with pytest.raises(ValueError, match="MoE"):
        tf.LM(dataclasses.replace(pcfg, moe=None), model.embed.data,
              list(model.blocks), model.final_norm, model.unembed.data)


def test_lm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = port_configs.reduced(port_configs.get_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        tf.lm_init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tf.make_decode_cache(cfg, 1, 8)


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3)])
def test_lm_stream(seed, step):
    want = RefLMStream(512, seed=seed).batch(step, 4, 33)
    got = LMStream(512, seed=seed).batch(step, 4, 33)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].dtype == want["tokens"].dtype


# ---------------------------------------------------------------------------
# On the card: the prefill path's flash launches against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,s", [("qwen2-7b", 128), ("gemma3-27b", 64),
                                    ("gemma3-27b", 40)])
def test_cuda_prefill_launches_flash(cuda_device, arch, s):
    """Every layer of a prefill launches the flash twin once (gemma3's
    local layers at S 64 take the banded case, at 40 the windowed full
    attention); each launch's output equals the plain version on its
    inputs within one bf16 rounding, and the logits match the CPU
    model's within 2e-2."""
    from repro_torch.kernels import flash_attention as fa
    cfg = port_configs.reduced(port_configs.get_config(arch))
    model = tf.lm_init(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, s))
    want, _ = tf.lm_prefill(model, toks)
    calls = []
    real = fa.flash_attention

    def record(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    fa.flash_attention = record
    try:
        before = fa.launches["flash_attention"]
        got, _ = tf.lm_prefill(model.to(cuda_device), toks.to(cuda_device))
        torch.cuda.synchronize()
    finally:
        fa.flash_attention = real
    assert fa.launches["flash_attention"] - before == cfg.n_layers
    assert len(calls) == cfg.n_layers
    for q, k, v, kw, out in calls:
        exact = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw)
        assert ((out.float() - exact).abs()
                <= 2 ** -8 * exact.abs() + 1e-4).all()
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
