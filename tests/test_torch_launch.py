"""The port's trainer (``repro_torch.launch``) against the reference's
(``repro.launch``), on the CPU.

* ``steps._train_step``: three steps of every family at its ``reduced``
  config (LMs with ``compute_dtype="float32"``), the reference's params
  carried across by ``convert.*_from_numpy`` and the same numpy batches
  given to both; losses and ``grad_norm`` at ``LOSS_RTOL``, every
  parameter after the steps at ``TOL`` (the frameworks sum in other
  orders). AdamW's first steps are nearly sign(g)·lr, so a gradient at
  the f32 noise floor, whose sign the two packages may not share, moves
  its parameter by up to 2·lr a step: at most ``FLIP_SHARE`` of the
  elements may do so, and a key bias without RoPE (bert4rec's ``wk.b``),
  whose gradient vanishes in exact arithmetic and is all noise, is held
  to that bound alone. kimi's reduced config runs Adafactor on bf16
  params, held at one bf16 rounding under the same rule (a near-tie
  rounds the other way), its losses after the first step at
  ``BF16_LOSS_RTOL``.
* Microbatch accumulation: the port's ``loss_and_grads(microbatch=2)``
  against the reference's accumulation written out in jax (an LM), and
  ``main --microbatch 2`` against the reference's ``main`` (DLRM): their
  final checkpoints, leaf by leaf (the states' leaves line up: a dict of
  params flattens alike in both).
* ``main(["--device", "cpu", ...])`` for every family: a run stopped at a
  checkpoint and resumed ends bit-equal to an uninterrupted one.
* ``watchdog_step``'s deadline, ``_chunked_item_topk`` against the
  reference's (ties included) and ``pad_up``.

A ``cuda``-marked case trains on the card and reads the launch counts.
"""
import dataclasses
import functools
import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.data import LMStream as RefLMStream
from repro.data import graph_data as ref_graph
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_rs
from repro.models import transformer as ref_tf
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.data.recsys_data import CTRStream, SeqRecStream
from repro_torch.distributed.resilience import watchdog_step
from repro_torch.launch import steps, train
from repro_torch.models import gnn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf

from test_torch_common import np_tree, ref_on_cpu

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_PARAM = dict(rtol=2 ** -7, atol=1e-6)
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 1e-4
N_STEPS = 3
LR = 3e-4                        # _train_step's default
FLIP_SHARE = 1e-4
NOISE_LEAVES = r"^/blocks/\d+/wk/b$"
LMS = ["stablelm-1.6b", "gemma3-27b", "moonshot-v1-16b-a3b",
       "kimi-k2-1t-a32b"]
RECSYS = ["dlrm-mlperf", "xdeepfm", "bert4rec", "mind"]
FAMILIES = LMS + RECSYS + ["gatedgcn", "gatedgcn-molecule"]


def _cfgs(arch):
    base = "gatedgcn" if arch.startswith("gatedgcn") else arch
    rcfg = ref_configs.reduced(ref_configs.get_config(base))
    pcfg = port_configs.reduced(port_configs.get_config(base))
    if arch in LMS:
        rcfg = dataclasses.replace(rcfg, compute_dtype="float32")
        pcfg = dataclasses.replace(pcfg, compute_dtype="float32")
    return rcfg, pcfg


@functools.lru_cache(maxsize=None)
def _ref_family(arch):
    """``(ref params, ref loss, batch(step), from_numpy, to_numpy)`` of
    ``arch``'s reduced config, built once per arch and shared by the tests
    (the reference's params are immutable; the batches depend on the step
    alone). The params are initialised under one ``jax.jit`` and the loss
    is jitted (not the molecule graph's, whose ``n_graphs`` is a Python
    int), so each family compiles once."""
    rcfg, pcfg = _cfgs(arch)
    if arch in LMS:
        with ref_on_cpu():
            params = jax.jit(lambda k: ref_tf.lm_init(k, rcfg))(KEY)
        stream = RefLMStream(rcfg.vocab_size, seed=1)
        return (params, jax.jit(lambda p, b: ref_tf.lm_loss(p, b, rcfg)),
                lambda s: stream.batch(s, 4, 32),
                lambda t: convert.lm_from_numpy(t, pcfg), convert.lm_to_numpy)
    if arch.startswith("gatedgcn"):
        if arch.endswith("molecule"):
            g0 = ref_graph.molecule_batch(6, 30, 64, 16, seed=0)
            dims = (16, 1, 4)
        else:
            g0 = ref_graph.community_graph(300, 1200, 64, 7, seed=0)
            dims = (64, 7, 0)
        with ref_on_cpu():
            params = jax.jit(lambda k: ref_gnn.gnn_init(k, rcfg, *dims))(KEY)
        loss = lambda p, b: ref_gnn.gnn_loss(p, b, rcfg)      # noqa: E731
        return (params, loss if arch.endswith("molecule") else jax.jit(loss),
                lambda s: g0, lambda t: convert.gnn_from_numpy(t, pcfg),
                convert.gnn_to_numpy)
    init, loss = {"dlrm-mlperf": ("dlrm_init", "dlrm_loss"),
                  "xdeepfm": ("xdeepfm_init", "xdeepfm_loss"),
                  "bert4rec": ("bert4rec_init", "bert4rec_loss"),
                  "mind": ("mind_init", "mind_loss")}[arch]
    with ref_on_cpu():
        params = jax.jit(lambda k: getattr(ref_rs, init)(k, rcfg))(KEY)
    if arch == "dlrm-mlperf":
        ctr = CTRStream(pcfg.n_dense, pcfg.table_sizes, seed=1)
        batch = lambda s: ctr.batch(s, 16)                  # noqa: E731
    elif arch == "xdeepfm":
        ctr = CTRStream(1, [pcfg.vocab_per_field] * pcfg.n_sparse, seed=1)
        batch = lambda s: {k: v for k, v in ctr.batch(s, 16).items()  # noqa
                           if k != "dense"}
    elif arch == "bert4rec":
        seq = SeqRecStream(pcfg.n_items, seed=1)
        batch = lambda s: seq.bert4rec_batch(                  # noqa: E731
            s, 8, pcfg.seq_len, pcfg.mask_prob)
    else:
        seq = SeqRecStream(pcfg.n_items, seed=1)
        batch = lambda s: seq.mind_batch(s, 8, pcfg.hist_len)  # noqa: E731
    return (params, jax.jit(lambda p, b: getattr(ref_rs, loss)(p, b, rcfg)),
            batch, convert.recsys_from_numpy, convert.recsys_to_numpy)


def _family(arch):
    """``(ref params, port params, ref loss, port loss, batch(step),
    to_numpy(port params))`` of ``arch``'s reduced config: the port's
    params are a fresh copy of the reference's."""
    _, pcfg = _cfgs(arch)
    params, ref_loss, batch, from_np, to_np = _ref_family(arch)
    if arch in LMS:
        port_loss = tf.lm_loss
    elif arch.startswith("gatedgcn"):
        port_loss = gnn.gnn_loss
    else:
        fn = getattr(rs, f"{pcfg.model}_loss")
        port_loss = lambda p, b: fn(p, b, pcfg)             # noqa: E731
    return (params, from_np(np_tree(params)), ref_loss, port_loss, batch,
            to_np)


def _ref_batch(b):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in b.items() if v is not None}


def _port_batch(b):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in b.items() if v is not None}


def _tree_pairs(got, want, path=""):
    """``(path, got leaf as f32 numpy, want leaf as f32 numpy)`` of two
    trees of one structure."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            yield from _tree_pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _tree_pairs(g, w, f"{path}/{i}")
    else:
        yield path, (got.float().numpy() if isinstance(got, torch.Tensor)
                     else np.asarray(got, np.float32)), np.asarray(
                         jnp.asarray(want, jnp.float32))


def _assert_trees_close(got, want, tol):
    for path, g, w in _tree_pairs(got, want):
        np.testing.assert_allclose(g, w, **tol, err_msg=path)


def _assert_params_close(got, want, tol, steps):
    """``tol`` everywhere but on the gradients AdamW's sign amplifies:
    those move by at most 2·lr a step, on at most ``FLIP_SHARE`` of the
    elements outside ``NOISE_LEAVES``."""
    import re
    flip = 2 * LR * steps * (1 + 1e-3)
    n = n_flip = 0
    for path, g, w in _tree_pairs(got, want):
        d = np.abs(g - w)
        assert (d <= flip).all(), (path, float(d.max()))
        if re.search(NOISE_LEAVES, path):
            continue
        n += d.size
        n_flip += int((d > tol["atol"] + tol["rtol"] * np.abs(w)).sum())
    assert n_flip <= FLIP_SHARE * n, (n_flip, n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    ref_params, port_params, ref_loss, port_loss, batch, to_np = _family(arch)
    # the loss jitted (_ref_family), the step eager: XLA's fused global
    # norm and update would differ from eager jnp (and the port) at ~5e-4
    ref_step, ref_init = ref_steps._train_step(ref_loss, rcfg)
    port_step, port_init = steps._train_step(port_loss, pcfg)
    with ref_on_cpu():
        ref_opt = ref_init(ref_params)
    port_opt = port_init(port_params)
    bf16 = getattr(pcfg, "param_dtype", "float32") == "bfloat16"
    for s in range(N_STEPS):
        b = batch(s)
        with ref_on_cpu():
            ref_params, ref_opt, rm = ref_step(ref_params, ref_opt,
                                               _ref_batch(b))
        port_params, port_opt, pm = port_step(port_params, port_opt,
                                              _port_batch(b))
        assert sorted(pm) == sorted(rm)
        rtol = BF16_LOSS_RTOL if bf16 and s else LOSS_RTOL
        for key in rm:
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=rtol, atol=1e-7,
                                       err_msg=f"step {s} {key}")
    assert port_opt["step"] == N_STEPS
    with torch.no_grad():
        got = to_np(port_params)
    _assert_params_close(got, np_tree(ref_params),
                         BF16_PARAM if bf16 else TOL, N_STEPS)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dlrm-mlperf"])
def test_microbatch_grads_match_reference_accumulation(arch):
    """The reference's accumulation (``launch/train.py``'s ``acc_body``:
    per microbatch ``value_and_grad``, f32 sums from zeros, ÷ microbatch,
    the loss the mean) against ``loss_and_grads(microbatch=2)``."""
    ref_params, port_params, ref_loss, port_loss, batch, _ = _family(arch)
    b = batch(0)
    with ref_on_cpu():
        g_acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             ref_params)
        l_acc = 0.0
        for i in range(2):
            mb = {k: jnp.asarray(v.reshape((2, -1) + v.shape[1:])[i])
                  for k, v in b.items()}
            (l, _), g = jax.value_and_grad(ref_loss, has_aux=True)(
                ref_params, mb)
            g_acc = jax.tree.map(jnp.add, g_acc, g)
            l_acc = l_acc + l
        want = jax.tree.map(lambda g: g / 2, g_acc)
        want_loss = l_acc / 2
    loss, _, grads = steps.loss_and_grads(port_loss, port_params,
                                          _port_batch(b), microbatch=2)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    leaves = steps.param_leaves(port_params)
    for p, g in zip(leaves, grads):
        assert g.dtype == torch.float32 and g.shape == p.shape
    if arch in LMS:
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.copy_(g)
        got = convert.lm_to_numpy(port_params)
    else:
        got = convert.recsys_to_numpy(ckpt._unflatten_like(
            port_params, iter(grads)))
    g_max = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(want))
    _assert_trees_close(got, np_tree(want),
                        dict(rtol=1e-4, atol=1e-6 * g_max))


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_dlrm_main_microbatch_matches_reference_main(tmp_path):
    """``--microbatch 2`` through both drivers from one state: the
    reference's ``main`` runs a step and saves it; the port resumes from
    that checkpoint (the states' leaves line up), the reference from its
    own, both to step 3; the final checkpoints (AdamW's moments and step,
    then the params) leaf by leaf."""
    import shutil
    argv = ["--arch", "dlrm-mlperf", "--batch", "16", "--microbatch", "2",
            "--log-every", "1"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    with ref_on_cpu():
        _run(ref_train.main, argv + ["--steps", "1", "--ckpt-dir",
                                     str(ref_dir)])
        shutil.copytree(ref_dir, port_dir)
        _run(ref_train.main, argv + ["--steps", "3", "--ckpt-dir",
                                     str(ref_dir)])
    text = _run(train.main, argv + ["--steps", "3", "--device", "cpu",
                                    "--ckpt-dir", str(port_dir)])
    assert "resumed from step 1" in text and "done: loss" in text
    want, step_w, _ = ckpt.restore(str(ref_dir))
    got, step_g, _ = ckpt.restore(str(port_dir))
    assert step_w == step_g == 3 and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **TOL, err_msg=f"leaf {i}")


MAIN_ARGS = {"stablelm-1.6b": ["--seq-len", "32"],
             "gemma3-27b": ["--seq-len", "32"],
             "moonshot-v1-16b-a3b": ["--seq-len", "32", "--microbatch", "2"],
             "kimi-k2-1t-a32b": ["--seq-len", "32"],
             "dlrm-mlperf": [], "xdeepfm": [], "bert4rec": [], "mind": [],
             "gatedgcn": [], "gatedgcn-molecule": ["--gnn-shape", "molecule"]}


@pytest.mark.parametrize("arch", sorted(MAIN_ARGS))
def test_main_resume_equals_uninterrupted(arch, tmp_path):
    """4 steps straight, against 2 steps, a stop, and a resume to 4 from
    the step-2 checkpoint: the final checkpoints equal bit for bit, and so
    do the logged losses of steps 2 and 3."""
    argv = ["--arch", arch.split("-molecule")[0], "--device", "cpu",
            "--batch", "4", "--log-every", "1", "--ckpt-every", "2",
            *MAIN_ARGS[arch]]
    whole = _run(train.main, argv + ["--steps", "4", "--ckpt-dir",
                                     str(tmp_path / "a")])
    _run(train.main, argv + ["--steps", "2", "--ckpt-dir",
                             str(tmp_path / "b")])
    resumed = _run(train.main, argv + ["--steps", "4", "--ckpt-dir",
                                       str(tmp_path / "b")])
    assert "resumed from step 2" in resumed
    for step in (2, 3):
        line = next(x for x in whole.splitlines()
                    if x.startswith(f"step {step}:"))
        assert line.split(" (")[0] in resumed
    want, _, _ = ckpt.restore(str(tmp_path / "a"))
    got, _, meta = ckpt.restore(str(tmp_path / "b"))
    assert meta["final"] and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    summary = json.loads(next(x for x in resumed.splitlines()
                              if x.startswith("summary "))[8:])
    assert summary["start_step"] == 2 and len(summary["losses"]) == 2
    assert set(summary["split_ms"]) == {"forward", "backward", "optimizer"}


def test_main_refuses_list_and_a_missing_card():
    with pytest.raises(ValueError, match="torch_train_dual_encoder"):
        train.main(["--arch", "list-dual-encoder", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "stablelm-1.6b"])


def test_watchdog_step():
    out, dt = watchdog_step(lambda x: {"b": x + 1, "a": [x]},
                            torch.ones(2), deadline_s=5.0)
    assert torch.equal(out["b"], torch.full((2,), 2.0)) and dt >= 0
    with pytest.raises(TimeoutError, match="deadline"):
        watchdog_step(lambda: time.sleep(0.05), deadline_s=0.01)


@pytest.mark.parametrize("n_items,chunk,k", [(60, 20, 5), (64, 16, 16),
                                             (50, 10, 3)])
def test_chunked_item_topk_matches_reference(n_items, chunk, k):
    """Scores on a coarse grid, so ties cross chunks: values and ids
    equal the reference's, tie order included."""
    rng = np.random.default_rng(n_items)
    scores = rng.integers(0, 6, (3, n_items)).astype(np.float32)
    with ref_on_cpu():
        wv, wi = ref_steps._chunked_item_topk(
            lambda ci: jax.lax.dynamic_slice_in_dim(jnp.asarray(scores),
                                                    ci * chunk, chunk, 1),
            n_items, chunk, k, 3)
    gv, gi = steps._chunked_item_topk(
        lambda ci: torch.from_numpy(scores[:, ci * chunk:(ci + 1) * chunk]),
        n_items, chunk, k, 3)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_pad_up_and_param_leaves():
    assert [steps.pad_up(x, 8) for x in (0, 1, 8, 9)] == [0, 8, 8, 16]
    assert steps.pad_up(7, 7) == ref_steps.pad_up(7, 7) == 7
    tree = {"b": [torch.zeros(1), torch.ones(2)], "a": torch.zeros(3)}
    assert [t.numel() for t in steps.param_leaves(tree)] == [3, 1, 2]
    model = torch.nn.Linear(2, 3)
    assert steps.param_leaves(model) == list(model.parameters())


def test_split_batch():
    b = {"x": torch.arange(12).reshape(4, 3), "n": 7}
    parts = steps.split_batch(b, 2)
    assert [p["n"] for p in parts] == [7, 7]
    assert torch.equal(parts[1]["x"], torch.arange(6, 12).reshape(2, 3))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_main_launches_the_backward_kernels(cuda_device, remat,
                                                 monkeypatch):
    """A reduced LM trains on the card through the flash twin: forward
    launches = layers × microbatches × steps (× 2 with remat), backward
    launches = layers × microbatches × steps; DLRM's dot forward and
    backward once per microbatch."""
    real = port_configs.reduced
    monkeypatch.setattr(train, "reduced", lambda cfg: dataclasses.replace(
        real(cfg), remat=remat) if cfg.family == "lm" else real(cfg))
    text = _run(train.main, ["--arch", "stablelm-1.6b", "--steps", "2",
                             "--batch", "4", "--seq-len", "64",
                             "--microbatch", "2"])
    s = json.loads(next(x for x in text.splitlines()
                        if x.startswith("summary "))[8:])
    n = 2 * 2 * 2
    assert s["launches"]["flash_attention"] == n * (2 if remat else 1)
    assert s["launches"]["flash_attention_backward"] == n
    text = _run(train.main, ["--arch", "dlrm-mlperf", "--steps", "3",
                             "--batch", "32", "--microbatch", "2"])
    s = json.loads(next(x for x in text.splitlines()
                        if x.startswith("summary "))[8:])
    assert s["launches"]["dot_interaction"] == 6
    assert s["launches"]["dot_interaction_backward"] == 6
