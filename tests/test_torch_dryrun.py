"""The dry-run and its analysis against the reference, on the CPU.

* ``analysis.roofline``: ``wire_bytes`` / ``collectives`` against the
  reference's ``collective_bytes`` on synthetic HLO lines of all five
  collectives at n = 2, 4, 16 and 300; ``roofline_terms`` with the
  reference's constants equal to its dict; ``model_flops`` for every
  config of both registries;
* ``kernels.ref``: the four oracles against ``repro.kernels.ref`` on
  seeded inputs (atol 1e-5; top-k positions equal up to ties at the k
  boundary);
* each kernel's meta path: output shapes and dtypes, and the ``work()``
  it records (the backward kernels' too when a gradient flows), nothing
  recorded on the CPU;
* ``serving.dispatch_slots``: static-shaped, so it runs on meta, and
  bit-equal on the CPU to the boolean-mask write it replaced;
* ``launch.dryrun.run_cell`` on a handful of cells and both meshes;
* ``analysis.op_cost``'s FLOPs against the reference's
  ``hlo_cost.analyze`` of the compiled reference plan on a one-device
  mesh, within 1%, for LIST's ``contrastive_train`` and ``encode_corpus``
  and xDeepFM's ``serve_p99`` (configs reduced in both registries).
"""
import dataclasses
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.analysis import hlo_cost
from repro.analysis import roofline as ref_rl
from repro.configs import arch_ids
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.configs import reduced as ref_reduced
from repro.distributed import sharding as ref_sh
from repro.kernels import ref as ref_oracles
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro_torch import configs as port_configs
from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline as rl
from repro_torch.core import serving
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_topk_score as fts
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops
from repro_torch.kernels import ref as oracles
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers

ATOL = 1e-5
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def hlo_line(kind, n, shape=(128, 96), dtype="f32"):
    """One post-optimization HLO instruction of ``kind`` over a group of
    ``n`` devices, result ``dtype[shape]``."""
    dims = ",".join(map(str, shape))
    groups = ",".join(map(str, range(n)))
    return (f"  %x.1 = {dtype}[{dims}]{{1,0}} {kind}({dtype}[{dims}]{{1,0}} "
            f"%p.0), replica_groups={{{{{groups}}}}}, channel_id=1")


@pytest.mark.parametrize("n", [2, 4, 16, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_match_reference(kind, n):
    want = ref_rl.collective_bytes(hlo_line(kind, n))
    nbytes = 128 * 96 * 4
    assert rl.wire_bytes(kind, nbytes, n) == want[kind]
    # the reference's pod split at 256 chips, and the port's node of 8
    assert rl.collectives([(kind, nbytes, n)], node_size=256) == want
    got = rl.collectives([(kind, nbytes, n)])
    assert got["dcn_bytes" if n > 8 else "ici_bytes"] == want[kind]
    assert got["total"] == want["total"]


@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.1e15, 2.0e12, {"ici_bytes": 4e9, "dcn_bytes": 1e8}),
    (1e9, 8e11, {"ici_bytes": 0.0, "dcn_bytes": 0.0}),
    (1e12, 1e9, {"ici_bytes": 9e11}),
    (0.0, 0.0, {})])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    want = ref_rl.roofline_terms(flops, nbytes, coll)
    got = rl.roofline_terms(flops, nbytes, coll,
                            peak_flops=ref_mesh.PEAK_FLOPS_BF16,
                            hbm=ref_mesh.HBM_BW, link=ref_mesh.ICI_BW,
                            network=ref_mesh.DCN_BW)
    assert got == want
    h100 = rl.roofline_terms(flops, nbytes, coll)
    assert h100["compute_s"] == flops / 989e12
    assert h100["memory_s"] == nbytes / 3.35e12


def test_roof_is_the_larger_term():
    r = rl.roof(3.35e12, 6.7e12, rl.F32_FLOPS_PER_S)
    assert r == dict(bound_ms=1000.0, bound_by="bytes",
                     bytes=3_350_000_000_000, flops=6_700_000_000_000)
    assert rl.roof(1, 989e9, rl.BF16_FLOPS_PER_S)["bound_by"] == "operations"


@pytest.mark.parametrize("arch", arch_ids())
def test_model_flops_match_reference(arch):
    for kw in (dict(tokens=4096 * 256), dict(tokens=1000, train=False),
               dict(tokens=7, extra=3.5), dict()):
        assert rl.model_flops(port_configs.get_config(arch), **kw) == \
            ref_rl.model_flops(ref_get_config(arch), **kw)


# ---------------------------------------------------------------------------
# kernels.ref: the oracles
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_fused_topk_score_ref_matches_reference():
    rng = np.random.default_rng(0)
    b, n, d, k, t = 6, 300, 32, 20, 100
    q = rng.standard_normal((b, d)).astype(np.float32)
    ql = rng.uniform(size=(b, 2)).astype(np.float32)
    w = rng.uniform(size=(b, 2)).astype(np.float32)
    ce = rng.standard_normal((b, n, d)).astype(np.float32)
    cl = rng.uniform(size=(b, n, 2)).astype(np.float32)
    ids = rng.integers(0, 10_000, (b, n)).astype(np.int32)
    ids[rng.uniform(size=(b, n)) < 0.3] = -1          # masked candidates
    w_hat = np.sort(rng.uniform(size=t)).astype(np.float32)
    args = (q, ql, w, ce, cl, ids, w_hat)
    want_s, want_p = ref_oracles.fused_topk_score_ref(
        *args, k=k, dist_max=1.4142)
    got_s, got_p = oracles.fused_topk_score_ref(*map(_t, args), k=k,
                                                dist_max=1.4142)
    want_s, want_p = np.asarray(want_s), np.asarray(want_p)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=ATOL, rtol=0)
    got_p = got_p.numpy()
    for r in range(b):
        # positions equal up to ties at the k boundary
        tied = np.abs(want_s[r] - want_s[r, -1]) <= ATOL
        assert set(got_p[r][~tied]) == set(want_p[r][~tied])
        assert (ids[r, got_p[r]] >= 0).all()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0),
                                           (False, 24)])
def test_flash_attention_ref_matches_reference(causal, window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 64, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = ref_oracles.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    got = oracles.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                      window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_dot_interaction_ref_matches_reference():
    feats = np.random.default_rng(2).standard_normal(
        (16, 27, 32)).astype(np.float32)
    np.testing.assert_allclose(
        oracles.dot_interaction_ref(_t(feats)).numpy(),
        np.asarray(ref_oracles.dot_interaction_ref(feats)), atol=ATOL,
        rtol=0)


def test_embedding_bag_ref_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((500, 24)).astype(np.float32)
    idx = rng.integers(0, 500, (64, 12)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.25] = -1
    np.testing.assert_allclose(
        oracles.embedding_bag_ref(_t(table), _t(idx)).numpy(),
        np.asarray(ref_oracles.embedding_bag_ref(table, idx)), atol=ATOL,
        rtol=0)


# ---------------------------------------------------------------------------
# The kernels' meta path
# ---------------------------------------------------------------------------


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("s,causal,window", [(64, True, 0), (100, True, 16),
                                             (48, False, 0), (80, False, 8),
                                             (40, True, 64)])
def test_visible_pairs_count_the_mask(s, causal, window):
    mask = fa.attention_mask(s, s, causal=causal, window=window)
    assert fa.visible_pairs(s, causal=causal, window=window) == \
        int(mask.sum())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_meta_path_records_forward_and_backward(dtype):
    b, s, h, kv, d, w = 2, 256, 8, 2, 64, 32
    q = meta(b, s, h, d, dtype=dtype, grad=True)
    k, v = (meta(b, s, kv, d, dtype=dtype, grad=True) for _ in range(2))
    with kmeta.WorkCounter() as wc:
        out = ops.flash_attention(q, k, v, causal=True, window=w)
        assert out.device.type == "meta" and out.shape == q.shape \
            and out.dtype == dtype
        assert set(wc.by_kernel) == {"flash_attention"}
        grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    fwd = fa.work(b, s, h, kv, d, causal=True, window=w, dtype=dtype,
                  with_lse=True)
    bwd = fa.backward_work(b, s, h, kv, d, causal=True, window=w,
                           dtype=dtype)
    assert wc.by_kernel == {
        "flash_attention": {"launches": 1, "flops": fwd[0],
                            "bytes": fwd[1]},
        "flash_attention_backward": {"launches": 1, "flops": bwd[0],
                                     "bytes": bwd[1]}}
    pairs = fa.visible_pairs(s, causal=True, window=w) * h * b
    assert fwd[0] == 4 * d * pairs and bwd[0] == 10 * d * pairs
    es = 2 if dtype == torch.bfloat16 else 4
    assert fwd[1] == (2 * b * s * h * d + 2 * b * s * kv * d) * es \
        + b * h * s * 4
    # without a gradient: the forward alone, without lse
    with kmeta.WorkCounter() as wc:
        layers.attention_full(q.detach(), k.detach(), v.detach(),
                              causal=True)
        layers.attention_local_banded(q.detach(), k.detach(), v.detach(),
                                      window=w)
    assert wc.by_kernel["flash_attention"] == {
        "launches": 2,
        "flops": (fa.work(b, s, h, kv, d, causal=True, dtype=dtype)[0]
                  + fa.work(b, s, h, kv, d, causal=True, window=w,
                            dtype=dtype)[0]),
        "bytes": 2 * fa.work(b, s, h, kv, d, dtype=dtype)[1]}


def test_dot_meta_path_records_forward_and_backward():
    b, f, d = 64, 27, 128
    x = meta(b, f, d, grad=True)
    with kmeta.WorkCounter() as wc:
        out = ops.dot_interaction(x)
        (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert out.shape == (b, f * (f - 1) // 2) and out.device.type == "meta"
    assert g.shape == x.shape
    fl, by = di.work(b, f, d)
    assert (fl, by) == (2 * d * b * 351, (b * f * d + b * 351) * 4)
    bfl, bby = di.backward_work(b, f, d)
    assert wc.by_kernel == {
        "dot_interaction": {"launches": 1, "flops": fl, "bytes": by},
        "dot_interaction_backward": {"launches": 1, "flops": bfl,
                                     "bytes": bby}}


def test_embedding_bag_meta_path():
    table = meta(1000, 64, dtype=torch.bfloat16)
    idx = meta(32, 16, dtype=torch.int32)
    with kmeta.WorkCounter() as wc:
        out = ops.embedding_bag(table, idx)
    assert out.shape == (32, 64) and out.dtype == torch.float32
    assert wc.by_kernel["embedding_bag"]["bytes"] == \
        512 * 64 * 2 + 32 * 16 * 4 + 32 * 64 * 4
    assert eb.work(1000, 64, 32, 16, rows_touched=10, valid=100) == (
        6400, 10 * 64 * 4 + 32 * 16 * 4 + 32 * 64 * 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.embedding_bag(meta(1000, 64, grad=True), idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_scan_meta_paths(dtype):
    b, cr, c, cap, d, k, t = 24, 2, 10, 300, 64, 20, 100
    q, ql, w = meta(b, d), meta(b, 2), meta(b, 2)
    buf = (meta(c, cap, d, dtype=dtype), meta(c, cap, 2),
           meta(c, cap, dtype=torch.int32))
    scale = meta(c, cap) if dtype == torch.int8 else None
    w_hat = meta(t)
    top_c = meta(b, cr, dtype=torch.int32)
    u, roster = meta(c, dtype=torch.int32), meta(c, 8, dtype=torch.int32)
    with kmeta.WorkCounter() as wc:
        s, i = ops.fused_topk_score_routed(q, ql, w, top_c, *buf, w_hat, k=k,
                                           dist_max=1.0, buf_scale=scale)
        assert (s.shape, s.dtype, i.shape, i.dtype) == (
            (b, k), torch.float32, (b, k), torch.int32)
        s, i = ops.fused_topk_score_cluster_major(
            q, ql, w, u, roster, *buf, w_hat, k=k, dist_max=1.0, cr=cr,
            buf_scale=scale)
        assert s.shape == i.shape == (b * cr, k)
        cand = (meta(b, 500, d, dtype=dtype), meta(b, 500, 2),
                meta(b, 500, dtype=torch.int32))
        s, i = ops.fused_topk_score(
            q, ql, w, *cand, w_hat, k=k, dist_max=1.0,
            cand_scale=meta(b, 500) if dtype == torch.int8 else None)
        assert s.shape == i.shape == (b, k) and i.dtype == torch.int32
    rows = min(b * cr, c)
    want = {"routed": fts.scan_work(b, d, k, cap=cap, distinct=rows,
                                    live_rows=rows * cap, pairs=b * cr * cap,
                                    dtype=dtype),
            "cluster_major": fts.scan_work(
                b, d, k, cap=cap, distinct=c, live_rows=c * cap,
                pairs=min(b * cr, c * 8) * cap, dtype=dtype),
            "gather": fts.gather_work(b, 500, d, k, t=t, dtype=dtype)}
    assert {n: (r["flops"], r["bytes"]) for n, r in wc.by_kernel.items()} \
        == want
    dq = 1 if dtype == torch.int8 else 0
    es = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    assert want["gather"] == (
        b * 500 * d * (2 + dq),
        b * 500 * (d * es + 12 + 4 * dq) + b * (d * 4 + 16) + t * 4
        + b * k * 8)


def test_cpu_runs_the_plain_version_and_records_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 8, generator=g)
    with kmeta.WorkCounter() as wc:
        out = ops.dot_interaction(x)
    assert wc.by_kernel == {}
    assert torch.equal(out, di.dot_interaction_plain(x))


# ---------------------------------------------------------------------------
# dispatch_slots: static-shaped
# ---------------------------------------------------------------------------


def dispatch_slots_masked(top_c, *, n_clusters, capacity):
    """The boolean-mask write ``dispatch_slots`` had before (the kept
    pairs' slots only), kept here as the oracle of its output."""
    b, cr = top_c.shape
    n = b * cr
    sort_idx, sorted_c, _, pos = serving._sorted_runs(top_c.reshape(n))
    keep = pos < capacity
    spare = n_clusters * capacity
    slot = torch.where(keep, sorted_c.long() * capacity + pos,
                       torch.full_like(pos, spare))
    origin = torch.full((spare + 1,), n, dtype=torch.int32)
    origin[slot[keep]] = sort_idx[keep].to(torch.int32)
    return (origin[:-1].reshape(n_clusters, capacity),
            (~keep).sum().to(torch.int32))


@pytest.mark.parametrize("b,cr,c,cap,skew", [(64, 2, 8, 8, False),
                                             (256, 3, 16, 8, True),
                                             (33, 1, 5, 40, False),
                                             (128, 2, 300, 8, True)])
def test_dispatch_slots_is_static_and_unchanged(b, cr, c, cap, skew):
    rng = np.random.default_rng(b + c)
    p = None
    if skew:
        p = 1.0 / np.arange(1, c + 1) ** 1.05
        p /= p.sum()
    top_c = torch.from_numpy(rng.choice(c, (b, cr), p=p).astype(np.int32))
    origin, dropped = serving.dispatch_slots(top_c, n_clusters=c,
                                             capacity=cap)
    want_o, want_d = dispatch_slots_masked(top_c, n_clusters=c, capacity=cap)
    assert torch.equal(origin, want_o) and torch.equal(dropped, want_d)
    if skew:
        assert int(dropped) > 0
    m_o, m_d = serving.dispatch_slots(top_c.to("meta"), n_clusters=c,
                                      capacity=cap)
    assert (m_o.shape, m_o.dtype, m_o.device.type) == (
        (c, cap), torch.int32, "meta")
    assert m_d.shape == () and m_d.dtype == torch.int32


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = [("dlrm-mlperf", "serve_p99"), ("xdeepfm", "train_batch"),
                ("gatedgcn", "molecule"), ("list-dual-encoder",
                                           "serve_queries"),
                ("stablelm-1.6b", "prefill_32k"), ("mind", "retrieval_cand")]


@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS)
def test_run_cell_ok(arch, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single, multi = dryrun.cell_records(arch, shape, [False, True],
                                            verbose=False)
    for rec, chips in ((single, 256), (multi, 512)):
        assert rec["status"] == "OK", rec.get("error")
        assert rec["chips"] == chips
        assert rec["flops_per_chip"] == rec["flops"] / chips > 0
        assert rec["bytes_per_chip"] == rec["bytes"] / chips > 0
        assert rec["roofline"]["step_time_lb_s"] > 0
        assert 0 < rec["argument_size_in_bytes"]
        for key in ("xla_flops_once", "temp_size_in_bytes",
                    "generated_code_size_in_bytes"):
            assert key not in rec
    assert single["mesh"] == "16x16" and multi["mesh"] == "2x16x16"
    if arch == "list-dual-encoder":
        assert single["kernels"]["cluster_major"]["launches"] == 1
    if arch == "dlrm-mlperf":
        assert set(single["kernels"]) == {"dot_interaction"}
    if shape == "train_batch":
        # a training cell reduces its gradients over the data axes
        assert single["collectives"]["all-reduce"] > 0


def test_run_cell_skip_and_fail():
    rec = dryrun.run_cell("qwen2-7b", "long_500k", verbose=False)
    assert rec["status"] == "SKIP" and rec["reason"]
    rec = dryrun.run_cell("qwen2-7b", "no_such_shape", verbose=False)
    assert rec["status"] == "FAIL" and "KeyError" in rec["error"]


def test_argument_bytes_follow_the_specs():
    """dlrm's tables are row-sharded over "model", the batch over "data":
    a card holds 1/16 of each table row-block and 1/16 of the batch."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = steps.plan_cell("dlrm-mlperf", "serve_p99", mesh)
    params, batch = plan.args
    pspecs, bspecs = plan.in_shardings
    want = 0.0
    for t, sp in op_cost.spec_leaves(params, pspecs):
        n = math.prod(16 for e in (sp or ()) if e is not None)
        want += t.numel() * t.element_size() / n
    want += sum(t.numel() * t.element_size() for t in batch.values()) / 16
    assert op_cost.argument_bytes(plan, mesh) == pytest.approx(want)
    assert any(sp and sp[0] == "model" for sp in pspecs["tables"])


# ---------------------------------------------------------------------------
# op_cost's FLOPs against the reference's hlo_cost on the compiled plan
# ---------------------------------------------------------------------------

PARITY_CELLS = {("list-dual-encoder", "contrastive_train"):
                dict(global_batch=8, max_len=16),
                ("list-dual-encoder", "encode_corpus"):
                dict(global_batch=8, max_len=16),
                ("xdeepfm", "serve_p99"): dict(batch=8)}


@pytest.mark.parametrize("arch,shape", list(PARITY_CELLS))
def test_flops_match_reference_hlo_cost(monkeypatch, arch, shape):
    dims = PARITY_CELLS[(arch, shape)]

    def shrunk(get_shape):
        return lambda a, n: dataclasses.replace(
            get_shape(a, n), dims={**get_shape(a, n).dims, **dims})

    monkeypatch.setattr(ref_steps, "get_config",
                        lambda a: ref_reduced(ref_get_config(a)))
    monkeypatch.setattr(ref_steps, "get_shape", shrunk(ref_get_shape))
    port_get_config = port_configs.get_config
    monkeypatch.setattr(port_configs, "get_config",
                        lambda a: port_configs.reduced(port_get_config(a)))
    monkeypatch.setattr(port_configs, "get_shape",
                        shrunk(port_configs.get_shape))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = ref_steps.plan_cell(arch, shape, mesh)
        with jax.default_device(jax.devices("cpu")[0]), mesh, \
                ref_sh.axis_rules(ref_sh.rules_for_mesh(mesh)):
            compiled = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                               out_shardings=plan.out_shardings).lower(
                *plan.args).compile()
        want = hlo_cost.analyze(compiled.as_text())["flops"]
        pplan = steps.plan_cell(arch, shape,
                                AbstractMesh((1, 1), ("data", "model")))
        got = op_cost.analyze(pplan, AbstractMesh((1, 1), ("data", "model")))
    assert want > 0
    assert abs(got["flops"] - want) <= 0.01 * want
    assert got["coll"]["total"] == 0.0           # one card: no wire
