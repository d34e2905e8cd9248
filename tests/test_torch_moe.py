"""The port's MoE (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU.

The reference draws the weights (``moe_init``) and the port takes them as
they are; the inputs are made with numpy. In f32 the two packages route
the same tokens to the same slots: outputs, ``lb_loss`` and ``z_loss`` at
1e-5, ``drop_fraction`` and the capacity equal. ``tests/test_moe.py``'s
four local cases run on both packages, the port's oracle
(``moe_dense_plain``) held to the reference's ``_dense_moe_ref`` there at
their 2e-4. The ``cuda``-marked case runs one layer on the card against
the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import MoESpec as RefMoESpec
from repro.models import moe as ref_moe
from repro_torch.configs.base import MoESpec
from repro_torch.models import moe

from test_moe import _dense_moe_ref
from test_torch_common import ref_on_cpu

KEY = jax.random.PRNGKey(0)
F32 = dict(rtol=1e-5, atol=1e-5)
ORACLE = dict(rtol=2e-4, atol=2e-4)     # tests/test_moe.py


def _specs(**kw):
    return RefMoESpec(**kw), MoESpec(**kw)


def _case(d, e, k, *, f=16, cf=1.25, key=KEY):
    """``(reference spec, port spec, reference params, port MoE)``: the
    reference's ``moe_init`` carried across unchanged."""
    rspec, pspec = _specs(n_experts=e, top_k=k, d_ff_expert=f,
                          capacity_factor=cf)
    with ref_on_cpu():
        params = ref_moe.moe_init(key, d, rspec)
    port = moe.MoE(*(torch.from_numpy(np.array(params[n]))
                     for n in ("router", "w1", "w3", "w2")))
    return rspec, pspec, params, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _apply_both(d, e, k, shape, *, f=16, cf=1.25, seed=1):
    """``moe_apply`` on both packages over the same x → ``((out, aux)
    reference, (out, aux) port, reference params, port MoE, specs)``."""
    rspec, pspec, params, port = _case(d, e, k, f=f, cf=cf)
    x = _x(shape, seed)
    with ref_on_cpu():
        want = ref_moe.moe_apply(params, jnp.asarray(x), rspec)
    got = moe.moe_apply(port, torch.from_numpy(x), pspec)
    return want, got, params, port, (rspec, pspec), x


def _assert_same(want, got):
    (w_out, w_aux), (g_out, g_aux) = want, got
    np.testing.assert_allclose(_np(g_out), np.asarray(w_out), **F32)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(g_aux[key]), float(w_aux[key]),
                                   **F32)
    assert float(g_aux["drop_fraction"]) == float(w_aux["drop_fraction"])


# ---------------------------------------------------------------------------
# tests/test_moe.py's local cases, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,d,e,k", [(2, 16, 8, 4, 2), (1, 32, 16, 8, 3)])
def test_moe_matches_dense_when_no_drops(b, s, d, e, k):
    """capacity_factor = E: no assignment dropped, so the dispatch equals
    the oracle on each package, and the port's oracle the reference's."""
    want, got, params, port, (rspec, pspec), x = _apply_both(
        d, e, k, (b, s, d), cf=float(e))
    with ref_on_cpu():
        ref_dense = _dense_moe_ref(params, jnp.asarray(x), rspec)
    plain = moe.moe_dense_plain(port, torch.from_numpy(x), pspec)
    for out, aux in (want, got):
        assert float(aux["drop_fraction"]) == 0.0
    np.testing.assert_allclose(np.asarray(want[0]), np.asarray(ref_dense),
                               **ORACLE)
    np.testing.assert_allclose(_np(got[0]), _np(plain), **ORACLE)
    np.testing.assert_allclose(_np(plain), np.asarray(ref_dense), **F32)
    _assert_same(want, got)


def test_moe_capacity_drops_counted():
    want, got, *_ = _apply_both(8, 4, 2, (1, 64, 8), f=8, cf=0.25, seed=2)
    for out, aux in (want, got):
        assert 0.0 < float(aux["drop_fraction"]) < 1.0
        assert np.isfinite(_np(out) if isinstance(out, torch.Tensor)
                           else np.asarray(out)).all()
    _assert_same(want, got)


def test_moe_aux_losses_finite_and_positive():
    want, got, *_ = _apply_both(8, 4, 2, (2, 16, 8), f=8, seed=3)
    for _, aux in (want, got):
        assert float(aux["lb_loss"]) >= 1.0 - 1e-3   # Cauchy-Schwarz
        assert np.isfinite(float(aux["z_loss"]))
    _assert_same(want, got)


def test_moe_grads_flow_to_experts_and_router():
    """The gradients of ``Σ out² + 0.01 · lb_loss`` reach the experts and
    the router, and equal the reference's ``jax.grad``."""
    rspec, pspec, params, port = _case(8, 4, 2, f=8)
    x = _x((1, 16, 8), 4)

    def loss(p):
        out, aux = ref_moe.moe_apply(p, jnp.asarray(x), rspec)
        return jnp.sum(out ** 2) + 0.01 * aux["lb_loss"]
    with ref_on_cpu():
        want = jax.grad(loss)(params)
    out, aux = moe.moe_apply(port, torch.from_numpy(x), pspec)
    (torch.sum(out ** 2) + 0.01 * aux["lb_loss"]).backward()
    assert float(port.w1.grad.abs().sum()) > 0
    assert float(port.router.grad.abs().sum()) > 0
    for name in ("router", "w1", "w3", "w2"):
        w = np.asarray(want[name])
        np.testing.assert_allclose(_np(getattr(port, name).grad), w,
                                   rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The port against the reference: shapes with and without drops, decode's
# one group, k >= 3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,d,e,k,cf", [
    (2, 16, 8, 4, 2, 1.25),          # prefill groups, no drops
    (1, 64, 8, 4, 2, 0.25),          # tight capacity: drops
    (2, 32, 16, 8, 3, 1.0),          # k = 3, drops
    (2, 24, 16, 16, 4, 1.25),        # k = 4 of 16 experts
    (4, 1, 16, 8, 3, 1.25),          # decode: one group of 4 tokens
    (64, 1, 8, 4, 2, 0.25),          # decode with drops
], ids=["seq", "seq-drops", "k3-drops", "k4", "decode", "decode-drops"])
def test_moe_apply_matches_reference(b, s, d, e, k, cf):
    want, got, *_ = _apply_both(d, e, k, (b, s, d), cf=cf, seed=5)
    _assert_same(want, got)


@pytest.mark.parametrize("t", [1, 3, 8, 100, 512, 1024, 4096])
@pytest.mark.parametrize("e,k,cf", [(64, 6, 1.25), (384, 8, 1.25),
                                    (64, 6, 64.0), (384, 8, 384.0),
                                    (4, 2, 0.25), (8, 3, 1.0)])
def test_capacity_matches_reference(t, e, k, cf):
    rspec, pspec = _specs(n_experts=e, top_k=k, d_ff_expert=8,
                          capacity_factor=cf)
    assert moe.capacity(t, pspec) == ref_moe.capacity(t, rspec)


def test_positions_in_expert_matches_reference():
    rng = np.random.default_rng(6)
    ids = np.sort(rng.integers(0, 5, (3, 40)), axis=-1).astype(np.int32)
    with ref_on_cpu():
        want = ref_moe._positions_in_expert(jnp.asarray(ids))
    got = moe._positions_in_expert(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_matches_reference():
    rspec, pspec, params, port = _case(16, 8, 3)
    x = _x((2, 12, 16), 7)
    with ref_on_cpu():
        w_i, w_p, w_aux = ref_moe.route(params, jnp.asarray(x), rspec)
    g_i, g_p, g_aux = moe.route(port.router, torch.from_numpy(x), pspec)
    np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
    np.testing.assert_allclose(_np(g_p), np.asarray(w_p), **F32)
    for key in w_aux:
        np.testing.assert_allclose(float(g_aux[key]), float(w_aux[key]),
                                   **F32)


def test_moe_init_keeps_router_f32():
    """The router stays float32 whatever the param dtype (the reference's
    ``moe_init``); the expert stacks take it, at the reference's shapes."""
    spec = MoESpec(n_experts=4, top_k=2, d_ff_expert=12)
    g = torch.Generator().manual_seed(0)
    m = moe.moe_init(g, 8, spec, dtype=torch.bfloat16)
    with ref_on_cpu():
        want = ref_moe.moe_init(KEY, 8, RefMoESpec(n_experts=4, top_k=2,
                                                   d_ff_expert=12),
                                dtype=jnp.bfloat16)
    for name in ("router", "w1", "w3", "w2"):
        got = getattr(m, name)
        assert tuple(got.shape) == want[name].shape
        assert str(got.dtype).split(".")[1] == want[name].dtype.name
    assert m.w1.float().std().item() == pytest.approx(8 ** -0.5, rel=0.2)
    assert m.w2.float().std().item() == pytest.approx(12 ** -0.5, rel=0.2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_apply_matches_cpu(cuda_device, dtype):
    """One layer's dispatch on the card against the CPU (sequence groups
    with drops, then decode's one group): drops equal; out within 1e-5 in
    f32, within two bf16 roundings in bf16 (the card's scatter-add sums in
    another order)."""
    _, pspec, _, port = _case(64, 16, 4, f=96, cf=1.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in ((4, 64, 64), (32, 1, 64)):
        x = torch.from_numpy(_x(shape, 8)).to(getattr(torch, dtype))
        want, w_aux = moe.moe_apply(port, x, pspec)
        got, g_aux = moe.moe_apply(port.to(cuda_device), x.to(cuda_device),
                                   pspec)
        port.cpu()
        assert float(g_aux["drop_fraction"]) == float(w_aux["drop_fraction"])
        tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
