"""The port's collectives on the CPU: the MoE's expert-parallel path and
the int8 compressed all-reduce, over gloo.

* One 2-rank spawn (``torch.multiprocessing``, a ``file://`` store under
  ``tmp_path``: no TCP port, so parallel test workers cannot collide; a
  few seconds) runs the expert-parallel MoE (``tests/test_moe.py``'s
  shard-map spec) on (1, 2) and (2, 1) ("data", "model") meshes, each rank
  on its blocks as the parameter specs place them, and
  ``compressed_psum`` of two seeded gradients. The parent holds them to
  the local path on the whole weights (output, aux and drop fraction,
  every gradient at 1e-5 in f32; the output also to the reference's
  ``_moe_apply_local``) and the psum bit for bit to the reference's
  arithmetic of the two ranks' gradients (which, like the reference's,
  is not within max|g| / 100 of their mean: ROADMAP Queue C 5).
* In-process checks in a world of one (a fixture creates and destroys its
  own gloo group): the host mesh's expert-parallel path bit-equal to the
  local path, ``compressed_psum`` against the reference's arithmetic and
  within max|g| / 100 of g, the production mesh refusing a world of one;
  and, with no group,
  ``quantize_int8`` / ``dequantize_int8`` bit-equal to the reference and
  error feedback as ``tests/test_substrate.py`` checks it.

jax is imported inside the tests only: the spawned ranks import this
module, and need torch alone.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import MoESpec
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import moe as moe_lib

SPEC = MoESpec(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=4.0)
B, S, D = 2, 16, 8
MESHES = ((1, 2), (2, 1))           # (data, model)
PSUM_N = 1000                       # not a multiple of the 256-value block


def _moe_inputs():
    r = np.random.default_rng(7)
    f = SPEC.d_ff_expert
    e = SPEC.n_experts
    arr = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))  # noqa: E731
    return {"router": arr(D, e) / np.sqrt(D), "w1": arr(e, D, f) / np.sqrt(D),
            "w3": arr(e, D, f) / np.sqrt(D), "w2": arr(e, f, D) / np.sqrt(f),
            "x": arr(B, S, D), "cot": arr(B, S, D)}


def _psum_grad(rank):
    return torch.from_numpy(np.random.default_rng(100 + rank).normal(
        size=(PSUM_N,)).astype(np.float32) * (1 + rank))


def _blocks(mesh):
    """The slices of this rank's blocks: experts, d and batch."""
    n_dp, n_ep = mesh.size(0), mesh.size(1)
    dp, ep = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    e_loc, d_loc, b_loc = SPEC.n_experts // n_ep, D // n_dp, B // n_dp
    return (slice(ep * e_loc, (ep + 1) * e_loc),
            slice(dp * d_loc, (dp + 1) * d_loc),
            slice(dp * b_loc, (dp + 1) * b_loc))


def _ep_rank(mesh):
    inp = _moe_inputs()
    es, ds, bs = _blocks(mesh)
    moe = moe_lib.MoE(inp["router"].clone(), inp["w1"][es][:, ds].clone(),
                      inp["w3"][es][:, ds].clone(),
                      inp["w2"][es][:, :, ds].clone())
    x = inp["x"][bs].clone().requires_grad_(True)
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        out, aux = moe_lib.moe_apply(moe, x, SPEC)
    loss = (out * inp["cot"][bs]).sum() + 0.01 * aux["lb_loss"]
    grads = torch.autograd.grad(loss, [moe.router, moe.w1, moe.w3, moe.w2,
                                       x])
    return {"out": out.detach(), "aux": {k: v.detach()
                                         for k, v in aux.items()},
            "grads": [g.detach() for g in grads], "blocks": (es, ds, bs)}


def _worker(rank, init_file, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    try:
        res = {}
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            res[shape] = _ep_rank(mesh)
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        res["psum"] = comp.compressed_psum(_psum_grad(rank),
                                           mesh.get_group("data"))
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _local_reference(n_dp):
    """The local path on the whole weights, each dp block of the batch on
    its own (the routing groups are sequences), summed as the
    expert-parallel loss is: ``(out, aux averaged over the blocks,
    gradients of router, w1, w3, w2 and x)``."""
    inp = _moe_inputs()
    moe = moe_lib.MoE(*(inp[k].clone() for k in ("router", "w1", "w3",
                                                   "w2")))
    x = inp["x"].clone().requires_grad_(True)
    outs, auxes = [], []
    for blk in torch.chunk(x, n_dp):
        o, a = moe_lib._moe_apply_local(moe, blk, SPEC)
        outs.append(o)
        auxes.append(a)
    aux = {k: sum(a[k] for a in auxes) / n_dp for k in auxes[0]}
    out = torch.cat(outs)
    loss = (out * inp["cot"]).sum() + 0.01 * aux["lb_loss"]
    grads = torch.autograd.grad(loss, [moe.router, moe.w1, moe.w3, moe.w2,
                                       x])
    return out.detach(), aux, grads


def _ref_quantized_mean(gs):
    """The reference's compressed_psum arithmetic over per-rank ``gs``."""
    import jax.numpy as jnp
    from repro.distributed import compression as ref_comp
    qs, ss = zip(*[ref_comp.quantize_int8(jnp.asarray(g.numpy()))[:2]
                   for g in gs])
    qsum = sum(q.astype(jnp.int32) for q in qs)
    ssum = sum(ss)
    world = jnp.float32(len(gs))
    return np.asarray(ref_comp.dequantize_int8(
        qsum.astype(jnp.float32) / world, ssum / world, gs[0].numel(),
        gs[0].shape))


def test_two_rank_expert_parallel_moe_and_compressed_psum(tmp_path):
    import jax.numpy as jnp
    from repro.configs.base import MoESpec as RefMoESpec
    from repro.models import moe as ref_moe
    mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    inp = _moe_inputs()
    ref_params = {k: jnp.asarray(inp[k].numpy())
                  for k in ("router", "w1", "w3", "w2")}
    ref_out, _ = ref_moe._moe_apply_local(
        ref_params, jnp.asarray(inp["x"].numpy()),
        RefMoESpec(**dataclasses.asdict(SPEC)))
    tol = dict(rtol=1e-5, atol=1e-5)
    for shape in MESHES:
        n_dp = shape[0]
        out, aux, grads = _local_reference(n_dp)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **tol)
        for r in ranks:
            got = r[shape]
            es, ds, bs = got["blocks"]
            torch.testing.assert_close(got["out"], out[bs], **tol)
            for k in aux:
                torch.testing.assert_close(got["aux"][k], aux[k], **tol)
            assert float(got["aux"]["drop_fraction"]) == \
                float(aux["drop_fraction"])
            g_router, g_w1, g_w3, g_w2, g_x = got["grads"]
            torch.testing.assert_close(g_router, grads[0], **tol)
            torch.testing.assert_close(g_w1, grads[1][es][:, ds], **tol)
            torch.testing.assert_close(g_w3, grads[2][es][:, ds], **tol)
            torch.testing.assert_close(g_w2, grads[3][es][:, :, ds], **tol)
            torch.testing.assert_close(g_x, grads[4][bs], **tol)
            assert float(g_w1.abs().sum()) > 0
    # bit for bit the reference's arithmetic, mean(q) · mean(s). That is
    # not within max|g| / 100 of the ranks' mean once their block scales
    # differ: the reference's own test_compressed_psum_matches_mean fails
    # so (ROADMAP Queue C 5); the world-of-one case below meets it
    gs = [_psum_grad(r) for r in range(2)]
    want = _ref_quantized_mean(gs)
    for r in ranks:
        np.testing.assert_array_equal(r["psum"].numpy(), want)


# ---------------------------------------------------------------------------
# a world of one, in process
# ---------------------------------------------------------------------------


@pytest.fixture()
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_host_mesh_expert_parallel_equals_local(world_of_one):
    """``tests/test_moe.py::test_shard_map_path_matches_local`` on the
    port: under the host mesh's rules the expert-parallel path runs, and
    equals the local path bit for bit."""
    mesh = port_mesh.make_host_mesh(device_type="cpu")
    assert port_mesh.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert port_mesh.mesh_chips(mesh) == 1
    inp = _moe_inputs()
    moe = moe_lib.MoE(*(inp[k] for k in ("router", "w1", "w3", "w2")))
    out1, aux1 = moe_lib._moe_apply_local(moe, inp["x"], SPEC)
    calls = []
    real = moe_lib._moe_apply_expert_parallel

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    moe_lib._moe_apply_expert_parallel = spy
    try:
        with sh.axis_rules(sh.rules_for_mesh(mesh)):
            out2, aux2 = moe_lib.moe_apply(moe, inp["x"], SPEC)
    finally:
        moe_lib._moe_apply_expert_parallel = real
    assert calls == [1]
    assert torch.equal(out1, out2)
    assert all(torch.equal(aux1[k], aux2[k]) for k in aux1)


def test_expert_parallel_needs_a_device_mesh():
    mesh = port_mesh.AbstractMesh((1, 2), ("data", "model"))
    inp = _moe_inputs()
    moe = moe_lib.MoE(*(inp[k] for k in ("router", "w1", "w3", "w2")))
    with sh.axis_rules(sh.rules_for_mesh(mesh)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            moe_lib.moe_apply(moe, inp["x"], SPEC)


def test_compressed_psum_world_of_one(world_of_one):
    with pytest.raises(ValueError, match="world of 256"):
        port_mesh.make_production_mesh(device_type="cpu")
    mesh = port_mesh.make_host_mesh(device_type="cpu")
    g = _psum_grad(0).reshape(10, 100)
    got = comp.compressed_psum(g, mesh.get_group("data"))
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_quantized_mean([g]).reshape(10, 100))
    assert float((got - g).abs().max()) < float(g.abs().max()) / 100


@pytest.mark.parametrize("n,block", [(320, 64), (1000, 256), (7, 256),
                                     (4096, 128)])
def test_quantize_dequantize_bit_equal_to_reference(n, block):
    import jax.numpy as jnp
    from repro.distributed import compression as ref_comp
    g = np.random.default_rng(n).normal(0, 3, size=(n,)).astype(np.float32)
    g[::17] = 0.0
    q, s, m = comp.quantize_int8(torch.from_numpy(g), block=block)
    rq, rs, rm = ref_comp.quantize_int8(jnp.asarray(g), block=block)
    assert m == rm == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s, n, (n,)).numpy(),
        np.asarray(ref_comp.dequantize_int8(rq, rs, n, (n,))))
    # the per-element error stays within half a scale
    err = np.abs(comp.dequantize_int8(q, s, n, (n,)).numpy() - g)
    pad = np.pad(np.abs(g), (0, (-n) % block)).reshape(-1, block).max(1)
    assert (err <= np.repeat(pad / 254 + 1e-6, block)[:n] + 1e-6).all()


def test_error_feedback_mirrors_reference():
    """``tests/test_substrate.py::test_error_feedback_reduces_bias`` on the
    port, its residuals bit-equal to the reference's along the way."""
    import jax.numpy as jnp
    from repro.distributed import compression as ref_comp
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, size=(256,)).astype(np.float32))
    res = comp.init_residuals({"g": g})
    assert torch.equal(res["g"], torch.zeros(256))
    ref_res = {"g": jnp.zeros((256,), jnp.float32)}
    acc_plain = torch.zeros(256)
    acc_ef = torch.zeros(256)
    for _ in range(50):
        q, s, n = comp.quantize_int8(g, block=64)
        acc_plain += comp.dequantize_int8(q, s, n, g.shape)
        qs, res = comp.compress_tree_for_allreduce({"g": g}, res, block=64)
        q2, s2 = qs["g"]
        acc_ef += comp.dequantize_int8(q2, s2, 256, g.shape)
        rqs, ref_res = ref_comp.compress_tree_for_allreduce(
            {"g": jnp.asarray(g.numpy())}, ref_res, block=64)
        np.testing.assert_array_equal(q2.numpy(), np.asarray(rqs["g"][0]))
        np.testing.assert_array_equal(res["g"].numpy(),
                                      np.asarray(ref_res["g"]))
    target = g * 50
    assert ((acc_ef - target).abs().mean()
            <= (acc_plain - target).abs().mean() + 1e-3)
