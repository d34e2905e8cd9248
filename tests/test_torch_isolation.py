"""The port stands alone: it imports neither jax nor the reference.

A subprocess with ``sys.modules["jax"] = None`` (any ``import jax`` then
raises) imports every module of ``repro_torch`` and runs the slice on
the CPU: random params in the reference's layout → ``params_from_numpy``
→ buffers → snapshot → ``Searcher.query`` on ``dense``, ``dense-cm``
and ``auto``, and on 2 logical shards (``with_mesh``). The default device is CUDA, so without one the entry
points raise instead of quietly running on the CPU. The import scan
covers the port, ``chip_smoke.py`` and the port's examples
(``examples/torch_*.py``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_SCRIPT = r'''
import sys
sys.modules["jax"] = None            # any "import jax" now fails
import importlib, pkgutil
import numpy as np
import torch
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch import api, convert
from repro_torch.configs import get_config
from repro_torch.core import index as index_lib
from repro_torch.core.snapshot import IndexSnapshot
import dataclasses

cfg = dataclasses.replace(get_config("list-dual-encoder"), n_layers=2,
                          d_model=32, n_heads=2, d_ff=64, vocab_size=512,
                          max_len=8, spatial_t=50, n_clusters=4,
                          index_mlp_hidden=(16,))
g = torch.Generator().manual_seed(0)
rel_p, idx_p = convert.random_params(cfg, n_clusters=4, generator=g)
rel, index = convert.params_from_numpy(rel_p, idx_p, cfg)
n = 96
emb = torch.nn.functional.normalize(torch.randn(n, 32, generator=g), dim=-1)
loc = torch.rand(n, 2, generator=g)
norm = index_lib.loc_normalizer(loc)
feats = index_lib.build_features(emb, loc, norm)
top = torch.topk(index(feats), 3).indices
buf = index_lib.build_cluster_buffers(top.numpy(), emb, loc, n_clusters=4,
                                      precision="int8")
snap = IndexSnapshot.from_parts(cfg, rel, index, norm, buf, dist_max=1.4142)
rng = np.random.default_rng(0)
tok = rng.integers(1, 512, (10, 8)).astype(np.int32)
msk = np.ones((10, 8), bool)
q_loc = rng.uniform(size=(10, 2)).astype(np.float32)
out = {}
for backend in ("dense", "dense-cm", "auto"):
    ids, sc = api.Searcher(snap, backend=backend, device="cpu").query(
        tok, msk, q_loc, k=5, cr=2, batch=4)
    assert ids.shape == (10, 5) and np.isfinite(sc).all(), backend
    out[backend] = ids
assert (out["dense"] == out["dense-cm"]).all()
for mod in ("repro_torch.distributed.sharding",
            "repro_torch.distributed.resilience"):
    assert mod in sys.modules, mod
ids, sc = api.Searcher(snap.with_mesh(2), backend="dense",
                       device="cpu").query(tok, msk, q_loc, k=5, cr=2,
                                           batch=4)
assert (ids == out["dense"]).all()
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
try:
    api.Searcher(snap)
except RuntimeError:
    print("default device refused")
print("OK")
'''


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    if not torch.cuda.is_available():
        assert "default device refused" in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]
    + list((REPO / "examples").glob("torch_*.py"))),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (
            f"{path} imports {name}")
