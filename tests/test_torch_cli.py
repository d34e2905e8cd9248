"""The port's command line (``repro_torch.launch.serve``), its examples and
``CheckpointManager`` against the reference's, on the CPU.

Each package's CLI builds a small snapshot (400 objects, a few training
steps) and both CLIs then serve it, whichever package wrote it: the
index line (cluster sizes, spill, tier) must be equal, and so must the
quality lines (recall@k and ndcg@5 of brute force and of LIST) of one
package's build run and its own load run. Across the packages the
quality numbers are held within ``QUALITY_TOL``, not equal: the CLI's
model computes in bf16, and bf16 towers do not round alike on the CPU
(the reference's own jitted and eager encoders differ by up to 0.025 in
the query embedding on this artifact), so a near-tie in the top 10 may
flip; the f32 parity of the same paths is held exactly in
``test_torch_dispatch.py`` and ``test_torch_slice.py``. A restart with
``--wal-dir`` after ``--churn`` replays the log;
``--mesh 2`` serves the unsharded ids from 2 logical CPU shards. A trainer's
state saved by either package's ``CheckpointManager`` resumes in the
other's. Each ``examples/torch_*.py`` runs its ``main`` on the CPU at its
smallest setting.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.launch import serve as ref_serve
from repro_torch.checkpoint import ckpt as port_ckpt
from repro_torch.launch import serve as port_serve

from test_torch_common import ref_on_cpu

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CLI = ["--objects", "400", "--queries", "400", "--train-steps", "6",
       "--index-steps", "6", "--requests", "40", "--clusters", "4"]
# recall@10 / ndcg@5 over the 40 held-out queries: a rank flip among bf16
# near-ties moves them by a few hundredths
QUALITY_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and beside the suite's other workers a team of threads waits on
    every barrier for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_cli_backend_alias():
    from repro_torch.core.engine import resolve_cli_backend
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert resolve_cli_backend(None, True) == "cuda"
    with pytest.warns(DeprecationWarning, match="ignored"):
        assert resolve_cli_backend("dense", True) == "dense"
    assert resolve_cli_backend(None, False) == "auto"
    assert resolve_cli_backend("cuda", False) == "cuda"


def run_cli(pkg, argv):
    """One package's ``main(argv)`` in process → ``(exit code, stdout)``;
    the port on the CPU, the reference's jax on the CPU with ``dense``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if pkg == "ref":
            with ref_on_cpu():
                rc = ref_serve.main(argv + ["--backend", "dense"])
        else:
            rc = port_serve.main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def quality(text):
    """The quality block's lines: brute force's and LIST's recall@k and
    ndcg@5 (their timings dropped)."""
    lines = [re.sub(r"\(.*", "", ln).strip() for ln in text.splitlines()
             if ln.startswith(("brute force :", "LIST cr="))]
    assert len(lines) == 2, text
    return lines


def numbers(lines):
    return np.array([float(v) for ln in lines
                     for v in re.findall(r"=(\d+\.\d+)", ln)])


def index_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("== index:")]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A snapshot directory written by each package's CLI, and the
    quality lines of that build run."""
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path_factory.mktemp(f"cli_{pkg}"))
        rc, text = run_cli(pkg, CLI + ["--snapshot-dir", d])
        assert rc == 0 and "== saved snapshot" in text, text
        out[pkg] = (d, quality(text))
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cli_serves_the_others_snapshot(built, writer):
    d, build_lines = built[writer]
    lines, index = {}, {}
    for pkg in ("ref", "port"):
        rc, text = run_cli(pkg, CLI + ["--snapshot-dir", d])
        assert rc == 0 and "== loaded snapshot" in text, text
        lines[pkg], index[pkg] = quality(text), index_line(text)
    assert index["port"] == index["ref"] and len(index["ref"]) == 1
    assert lines[writer] == build_lines
    got, want = numbers(lines["port"]), numbers(lines["ref"])
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, atol=QUALITY_TOL, rtol=0)


def test_cli_wal_restart_replays(tmp_path):
    """Churn with a WAL, then a restart on the same directories: the log's
    records are replayed before serving."""
    argv = CLI + ["--snapshot-dir", str(tmp_path / "snap"),
                  "--wal-dir", str(tmp_path / "wal")]
    rc, first = run_cli("port", argv + ["--churn", "2"])
    assert rc == 0 and "== churn: 2 write rounds" in first, first
    rc, second = run_cli("port", argv + ["--mode", "open", "--qps", "400"])
    assert rc == 0, second
    m = re.search(r"== recovery: replayed (\d+) WAL record", second)
    assert m and int(m.group(1)) >= 1, second
    # brute force scores the loaded artifact alone; LIST serves the
    # replayed delta too, so only the first line carries over
    assert quality(second)[0] == quality(first)[0]


def test_cli_mesh_exits_nonzero(tmp_path, monkeypatch):
    """``--mesh 2 --device cpu`` serves (exit 0, the mesh line) and its
    quality queries return the unsharded run's ids over the same
    artifact. (The name dates from the port's --mesh exiting non-zero.)"""
    from repro_torch import api as port_api
    seen = []
    real = port_api.Searcher.query_corpus

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append((self.snapshot.meta.n_shards, out))
        return out

    monkeypatch.setattr(port_api.Searcher, "query_corpus", spy)
    argv = CLI + ["--snapshot-dir", str(tmp_path / "snap")]
    rc, plain = run_cli("port", argv)
    assert rc == 0, plain
    rc, sharded = run_cli("port", argv + ["--mesh", "2"])
    assert rc == 0, sharded
    assert "== mesh: cluster buffers sharded across 2 devices" in sharded
    assert [n for n, _ in seen] == [1, 2]
    np.testing.assert_array_equal(seen[1][1][0], seen[0][1][0])
    np.testing.assert_allclose(seen[1][1][1], seen[0][1][1], rtol=1e-5,
                               atol=1e-5)
    assert quality(sharded) == quality(plain)


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(CLI)


def test_roundtrip_selftest_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.api --device cpu``: every leg (dense,
    dense-cm × f32, bf16, int8, unfiltered and filtered, the delta leg
    and the 2-shard mesh leg) bit-identical through save → load."""
    from repro_torch import api
    assert api._roundtrip_selftest(str(tmp_path), device="cpu") == 0
    assert api._main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("bit-identical") == 2 * 18
    assert "MISMATCH" not in out


# ---------------------------------------------------------------------------
# CheckpointManager across the packages
# ---------------------------------------------------------------------------


def _state(seed):
    """A trainer-like state: nested dicts and a list, a bf16 leaf, a 0-d
    int32 step; as torch tensors and as the reference's numpy leaves."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    e = rng.normal(size=(5, 2)).astype(np.float32)
    port = {"params": {"w": torch.from_numpy(w), "layers": [
        {"b": torch.from_numpy(b)},
        {"e": torch.from_numpy(e).to(torch.bfloat16)}]},
        "opt": {"step": torch.tensor(seed, dtype=torch.int32),
                "m": [torch.from_numpy(b * 2)]}}
    ref = {"params": {"w": jnp.asarray(w), "layers": [
        {"b": jnp.asarray(b)}, {"e": jnp.asarray(e, jnp.bfloat16)}]},
        "opt": {"step": jnp.asarray(seed, jnp.int32),
                "m": [jnp.asarray(b * 2)]}}
    return port, ref


def _leaves_np(tree):
    out = []
    for x in port_ckpt.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.float() if x.dtype == torch.bfloat16 else x
            out.append(x.numpy())
        else:
            out.append(np.asarray(x, np.float32)
                       if str(x.dtype) == "bfloat16" else np.asarray(x))
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_manager_resumes_across_packages(tmp_path, writer):
    saved_port, saved_ref = _state(7)
    init_port, init_ref = _state(0)
    d = str(tmp_path)
    if writer == "port":
        path = port_ckpt.CheckpointManager(d, every=5).maybe_save(
            5, saved_port, meta={"loss": 1.5})
        assert path is not None
        assert port_ckpt.CheckpointManager(d, every=5).maybe_save(
            6, saved_port) is None
        tree, step, meta = ref_ckpt.CheckpointManager(d).restore_or_init(
            lambda: init_ref)
    else:
        ref_ckpt.CheckpointManager(d, every=5).maybe_save(
            5, saved_ref, meta={"loss": 1.5})
        tree, step, meta = port_ckpt.CheckpointManager(d).restore_or_init(
            lambda: init_port)
        assert tree["params"]["layers"][1]["e"].dtype == torch.bfloat16
        assert tree["opt"]["step"].shape == ()
    assert step == 5 and meta == {"loss": 1.5}
    for got, want in zip(_leaves_np(tree), _leaves_np(saved_port)):
        np.testing.assert_array_equal(got, want)
    with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
        treedef = json.load(f)["treedef"]
    import jax
    assert treedef == str(jax.tree_util.tree_structure(saved_ref))


def test_checkpoint_manager_fresh_and_shard_fn(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path))
    tree, step, meta = mgr.restore_or_init(lambda: {"a": torch.zeros(2)})
    assert step == 0 and meta == {} and tree["a"].shape == (2,)
    # shard_fn places the restored host tree (elastic reload); a fresh
    # directory returns init_fn() as it is
    mgr.maybe_save(1, {"a": torch.arange(2.0)}, force=True)
    tree, step, _ = mgr.restore_or_init(
        lambda: {"a": torch.zeros(2)},
        shard_fn=lambda t: {k: (v.device.type, v + 1) for k, v in t.items()})
    assert step == 1 and tree["a"][0] == "cpu"
    assert torch.equal(tree["a"][1], torch.tensor([1.0, 2.0]))
    leaves, _, _ = port_ckpt.restore(str(tmp_path), shard_fn=len)
    assert leaves == 1


# ---------------------------------------------------------------------------
# The examples, at their smallest settings
# ---------------------------------------------------------------------------


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = ["--device", "cpu", "--objects", "300", "--queries", "60",
         "--rel-steps", "3", "--idx-steps", "3"]


@pytest.mark.parametrize("name,extra", [
    ("torch_quickstart", []),
    ("torch_serve_queries", ["--requests", "16"]),
    ("torch_incremental_index", []),
])
def test_example_runs_on_cpu(name, extra, capsys):
    assert _example(name).main(SMALL + extra) == 0
    out = capsys.readouterr().out
    if name == "torch_serve_queries":
        assert "streaming server and engine path agree" in out
        assert "paths agree on" in out


def test_train_example_resumes(tmp_path, capsys):
    mod = _example("torch_train_dual_encoder")
    ck = ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    assert mod.main(ck + ["--steps", "2"]) == 0
    assert mod.main(ck + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resume from step 0" in out and "resume from step 2" in out
    assert port_ckpt.all_steps(str(tmp_path)) == [2, 3]
