"""The port reads the reference's snapshot artifacts bit for bit.

The reference ``api.save``s f32, bf16 and int8 snapshots with a non-empty
delta segment; the port's reader must hand back every leaf bit-equal
(bf16 leaves reinterpreted from their uint16 storage view), rebuild the
tree in ``tree_flatten`` order, and refuse a damaged artifact with its
own ``SnapshotCorrupt`` before any array is used.
"""
import json
import os

import numpy as np
import jax
import pytest
import torch

from repro import api as ref_api
from repro.checkpoint import ckpt as ref_ckpt
from repro.core.snapshot import _spec_skeleton
from repro_torch import api
from repro_torch.checkpoint import ckpt
from repro_torch.core import snapshot as port_snapshot

from test_torch_common import make_ref_snapshot, tiny_cfg, with_delta

PRECISIONS = ("f32", "bf16", "int8")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """precision → (reference snapshot with delta, its directory)."""
    base = make_ref_snapshot(tiny_cfg())
    out = {}
    for p in PRECISIONS:
        snap = with_delta(base.with_precision(p))
        d = str(tmp_path_factory.mktemp(f"snap_{p}"))
        ref_api.save(snap, d)
        out[p] = (snap, d)
    return out


def _bits(x):
    """Raw bytes of a numpy array or torch tensor, for bit-equality."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_leaves_bit_equal(saved, precision):
    snap, d = saved[precision]
    ref_tree, _, _ = ref_ckpt.restore(d, _ref_skeleton(d))
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    leaves, step, meta = ckpt.restore(d)
    assert step == snap.meta.version
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype.name}"
        assert _bits(a) == _bits(b)


def _ref_skeleton(d):
    meta, _ = ref_ckpt.read_meta(d)
    return _spec_skeleton(meta["tree_spec"])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_snapshot_loads_bit_equal(saved, precision):
    snap, d = saved[precision]
    got = api.load(d, device="cpu")
    assert got.meta.__dict__ == {**snap.meta.__dict__}
    assert got.cfg.__dict__ == snap.cfg.__dict__
    want_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}[precision]
    assert got.buffers["emb"].dtype == want_dtype
    for k in ("emb", "loc", "ids", "counts", "scale", "attrs"):
        assert _bits(got.buffers[k]) == _bits(np.asarray(snap.buffers[k])), k
    for k in ("capacity", "n_spilled", "precision"):
        assert got.buffers[k] == snap.buffers[k]
    for k in ("lo", "span"):
        assert _bits(got.norm[k]) == _bits(np.asarray(snap.norm[k]))
    # params: the modules hold the reference's arrays
    rp = snap.rel_params
    assert _bits(got.rel.q_enc.embed.data) == _bits(
        np.asarray(rp["q_enc"]["embed"]))
    wq = np.asarray(rp["q_enc"]["blocks"]["attn"]["wq"]["w"])
    for i, blk in enumerate(got.rel.q_enc.blocks):
        assert _bits(blk.wq.w.data) == _bits(wq[i])
    assert _bits(got.rel.spatial["w_s"].data) == _bits(
        np.asarray(rp["spatial"]["w_s"]))
    for lay, p in zip(got.index.mlp.layers, snap.index_params["mlp"]):
        assert _bits(lay.w.data) == _bits(np.asarray(p["w"]))
        assert _bits(lay.b.data) == _bits(np.asarray(p["b"]))
    # delta segment: rows and tombstones
    ra, pa = snap.delta.arrays(), got.delta.arrays()
    for k in ("emb", "scale", "loc", "ids", "raw", "attrs"):
        assert _bits(pa[k]) == _bits(ra[k]), k
    assert got.delta.tombstones == snap.delta.tombstones
    assert got.delta.n_rows == snap.delta.n_rows == 5
    np.testing.assert_array_equal(got.delta.tombstone_array(),
                                  snap.delta.tombstone_array())
    # w_hat is derived (cumsum of softplus), not stored: float-close only
    np.testing.assert_allclose(got.w_hat.numpy(), np.asarray(snap.w_hat),
                               rtol=1e-6, atol=1e-6)


def _step_dir(d):
    return os.path.join(d, sorted(x for x in os.listdir(d)
                                  if x.startswith("step_"))[-1])


def test_flipped_byte_raises_snapshot_corrupt(saved, tmp_path):
    import shutil
    _, d = saved["f32"]
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    leaf = os.path.join(_step_dir(copy), "arr_00003.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0x01
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(ckpt.SnapshotCorrupt):
        api.load(copy, device="cpu")
    with pytest.raises(ckpt.SnapshotCorrupt):
        ckpt.restore(copy)
    # the reference agrees that this artifact is damaged
    with pytest.raises(ref_ckpt.SnapshotCorrupt):
        ref_api.load(copy)


def test_garbage_manifest_and_missing_leaf(saved, tmp_path):
    import shutil
    _, d = saved["bf16"]
    bad = str(tmp_path / "bad")
    shutil.copytree(d, bad)
    os.remove(os.path.join(_step_dir(bad), "arr_00000.npy"))
    with pytest.raises(ckpt.SnapshotCorrupt):
        api.load(bad, device="cpu")
    garbage = str(tmp_path / "garbage")
    shutil.copytree(d, garbage)
    with open(os.path.join(_step_dir(garbage), "manifest.json"), "w") as f:
        f.write('{"meta": ')
    with pytest.raises(ckpt.SnapshotCorrupt):
        api.load(garbage, device="cpu")


def test_gates_run_before_any_leaf_is_read(saved, tmp_path):
    import shutil
    _, d = saved["int8"]
    for field, value in (("schema_version", 4), ("precision", "fp4")):
        gated = str(tmp_path / field)
        shutil.copytree(d, gated)
        step = _step_dir(gated)
        mf = os.path.join(step, "manifest.json")
        manifest = json.load(open(mf))
        manifest["meta"][field] = value
        json.dump(manifest, open(mf, "w"))
        for name in os.listdir(step):           # no leaf may be touched
            if name.endswith(".npy"):
                os.remove(os.path.join(step, name))
        with pytest.raises(ValueError) as e:
            api.load(gated, device="cpu")
        assert not isinstance(e.value, ckpt.SnapshotCorrupt)
        assert field.split("_")[0] in str(e.value)


def test_load_latest_good_skips_a_corrupt_step(saved, tmp_path):
    import shutil
    snap, d = saved["f32"]
    lineage = str(tmp_path / "lineage")
    shutil.copytree(d, lineage)
    newer = snap.with_delta(snap.delta)             # version + 1
    ref_api.save(newer, lineage)
    steps = ckpt.all_steps(lineage)
    assert steps[-1] == newer.meta.version
    leaf = os.path.join(lineage, f"step_{steps[-1]:09d}", "arr_00001.npy")
    with open(leaf, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))
    got = port_snapshot.load_latest_good(lineage, device="cpu")
    assert got.meta.version == snap.meta.version


def test_default_device_raises_without_cuda(saved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, d = saved["f32"]
    with pytest.raises(RuntimeError, match="cuda"):
        api.load(d)
