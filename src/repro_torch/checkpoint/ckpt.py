"""The checkpoint layout (reference: ``repro.checkpoint.ckpt``).

Layout of one committed step::

    <dir>/step_000000007.tmp/  # written first, fsync'd file by file
    <dir>/step_000000007/      # the atomic rename is the commit
        manifest.json      # n_leaves, meta, per-leaf {file, shape, dtype, crc32}
        arr_00000.npy ...  # one file per leaf, in jax ``tree_flatten`` order

:func:`save` writes leaves given as ``torch`` tensors (on any device,
copied to the host one at a time) or numpy arrays; :func:`restore` gives
them back as CPU tensors; :class:`CheckpointManager` saves and resumes
nested dicts of tensors (a trainer's state) in that layout, so a state
written by either package resumes in the other. bfloat16 leaves are
stored as same-width unsigned views (numpy has no bf16 dtype); the
manifest records the true dtype and the port reinterprets the 16 bits as
``torch.bfloat16``, bit for bit. Every leaf's crc32 is checked before the file is parsed: a
damaged artifact raises :class:`SnapshotCorrupt`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults as faults_lib

_STEP_RE = re.compile(r"^step_(\d{9})$")

# dtypes .npy cannot express, stored as a same-width integer view
_VIEW_DTYPES = {"bfloat16": (np.int16, torch.bfloat16)}


class SnapshotCorrupt(ValueError):
    """A committed checkpoint that cannot be trusted: a truncated or
    garbage manifest, a leaf whose checksum does not match, or a leaf
    file missing outright. Distinct from ``FileNotFoundError`` (no
    checkpoint at all) so recovery can walk back to an older step."""


def _step_dir(directory: str, step: int, tmp: bool = False) -> str:
    return os.path.join(directory,
                        f"step_{step:09d}" + (".tmp" if tmp else ""))


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """``(stored array, true dtype name)`` of one leaf on the host: a
    contiguous copy, bf16 as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    # np.require keeps a 0-d leaf 0-d (ascontiguousarray would not)
    return np.require(arr, requirements="C"), str(arr.dtype)


def save(directory: str, step: int, leaves: Sequence, *, treedef: str,
         meta: Optional[dict] = None, keep: int = 3) -> str:
    """Commit ``leaves`` (in ``tree_flatten`` order) as step ``step``;
    returns the committed path. The reference's commit sequence: leaves
    and manifest into ``<step>.tmp`` with an fsync per file, then on the
    directory; a committed step of the same number renamed aside to
    ``<step>.old``; ``.tmp`` renamed into place; the parent directory
    fsync'd; ``.old`` removed; keep-``keep`` garbage collection, orphaned
    ``.tmp`` and ``.old`` directories included. ``treedef`` is recorded
    in the manifest and never read back. The fault points
    ``ckpt.mid_save`` (before the commit rename) and ``ckpt.post_commit``
    (after the garbage collection) sit where the reference's do."""
    os.makedirs(directory, exist_ok=True)
    tmp = _step_dir(directory, step, tmp=True)
    final = _step_dir(directory, step)
    old = final + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "treedef": treedef, "n_leaves": len(leaves),
                "meta": meta or {}, "leaves": []}
    for i, leaf in enumerate(leaves):
        stored, dtype = _host_array(leaf)
        fn = f"arr_{i:05d}.npy"
        leaf_path = os.path.join(tmp, fn)
        with open(leaf_path, "wb") as f:
            np.save(f, stored)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"file": fn, "shape": list(stored.shape), "dtype": dtype,
             "crc32": _crc_file(leaf_path)})
        del stored
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    faults_lib.fire("ckpt.mid_save", tmp=tmp, final=final)
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)          # atomic commit
    _fsync_dir(directory)
    shutil.rmtree(old, ignore_errors=True)
    _gc(directory, keep)
    faults_lib.fire("ckpt.post_commit", path=final)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    # orphaned tmp/old dirs of interrupted writers
    for name in os.listdir(directory):
        if name.endswith(".tmp") or name.endswith(".old"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _read_manifest(path: str) -> dict:
    """Parse ``<step dir>/manifest.json``; every way a damaged file can
    fail to parse becomes one :class:`SnapshotCorrupt`."""
    mf = os.path.join(path, "manifest.json")
    try:
        with open(mf, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
        raise SnapshotCorrupt(
            f"{mf}: manifest is truncated or garbage ({e}); fall back to "
            f"an older step or re-build the artifact") from e
    if not isinstance(manifest, dict) or "meta" not in manifest \
            or "leaves" not in manifest:
        raise SnapshotCorrupt(
            f"{mf}: manifest parses as JSON but is not a checkpoint "
            f"manifest (missing meta/leaves blocks)")
    return manifest


def _resolve_step(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return step


def read_meta(directory: str, *, step: Optional[int] = None
              ) -> Tuple[dict, int]:
    """The ``meta`` block of a committed step, without touching any leaf
    file. Returns ``(meta, step)``."""
    step = _resolve_step(directory, step)
    return _read_manifest(_step_dir(directory, step))["meta"], step


def _load_leaf(path: str, info: dict, i: int) -> torch.Tensor:
    want_crc = info.get("crc32")
    try:
        if want_crc is not None and _crc_file(path) != want_crc:
            raise SnapshotCorrupt(
                f"leaf {i} ({path}): checksum mismatch vs manifest — the "
                f"committed file was damaged")
        arr = np.load(path)
    except FileNotFoundError as e:
        raise SnapshotCorrupt(
            f"leaf {i} ({path}): missing from a committed checkpoint") from e
    except SnapshotCorrupt:
        raise
    except ValueError as e:
        raise SnapshotCorrupt(
            f"leaf {i} ({path}): not a readable .npy ({e})") from e
    want = info.get("dtype")
    if want in _VIEW_DTYPES:
        np_view, torch_dtype = _VIEW_DTYPES[want]
        return torch.from_numpy(arr.view(np_view)).view(torch_dtype)
    if want and str(arr.dtype) != want:
        arr = arr.view(np.dtype(want))
    if list(arr.shape) != list(info.get("shape", arr.shape)):
        raise SnapshotCorrupt(f"leaf {i} ({path}): shape {arr.shape} != "
                              f"manifest {info['shape']}")
    return torch.from_numpy(np.require(arr, requirements="C"))


def restore(directory: str, *, step: Optional[int] = None,
            shard_fn: Optional[Callable[[Any], Any]] = None
            ) -> Tuple[Any, int, dict]:
    """All leaves of a committed step, in manifest (= ``tree_flatten``)
    order, as CPU tensors. ``shard_fn`` (optional) maps that host list to
    what is returned in its place, e.g. the leaves placed for a new mesh
    (elastic reload). Returns ``(leaves, step, meta)``."""
    step = _resolve_step(directory, step)
    path = _step_dir(directory, step)
    manifest = _read_manifest(path)
    infos = manifest["leaves"]
    if len(infos) != manifest.get("n_leaves", len(infos)):
        raise SnapshotCorrupt(f"{path}: manifest lists {len(infos)} leaves "
                              f"but declares {manifest['n_leaves']}")
    leaves = [_load_leaf(os.path.join(path, info["file"]), info, i)
              for i, info in enumerate(infos)]
    if shard_fn is not None:
        leaves = shard_fn(leaves)
    return leaves, step, manifest["meta"]


# ---------------------------------------------------------------------------
# Nested states: jax's tree order and treedef string, and the manager
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple in jax ``tree_flatten``
    order: dict children by sorted key, sequences in order; ``None`` is
    an empty node, as in jax."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def treedef_str(tree) -> str:
    """jax's ``str(tree_structure(tree))`` of a nested dict / list /
    tuple: ``PyTreeDef({'a': *, 'b': [*, (*,)]})``."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _unflatten_like(template, leaves: Iterator[Any]):
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten_like(template[k], leaves)
               for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, leaves) for v in template)
    return next(leaves)


class CheckpointManager:
    """Save-every-N and resume over a nested dict of tensors (reference:
    ``repro.checkpoint.ckpt.CheckpointManager``): a training loop calls
    :meth:`maybe_save` each step and :meth:`restore_or_init` once at
    start. Leaves are written in jax ``tree_flatten`` order with jax's
    treedef string, so either package restores the other's state."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree, *, meta=None, force=False):
        """Commit ``tree`` as step ``step`` when ``force`` or when ``step``
        is a positive multiple of ``every``; returns the path, else
        None."""
        if force or (self.every > 0 and step % self.every == 0 and step > 0):
            return save(self.directory, step, tree_leaves(tree),
                        treedef=treedef_str(tree), meta=meta, keep=self.keep)
        return None

    def restore_or_init(self, init_fn: Callable[[], Any], *, shard_fn=None):
        """``(tree, start_step, meta)``: ``init_fn()`` and step 0 when the
        directory holds no checkpoint; else the latest step restored into
        ``init_fn()``'s structure, each leaf's shape checked and the leaf
        placed on the device of the template leaf it replaces. With
        ``shard_fn``, the restored tree stays on the host and
        ``shard_fn(tree)`` is returned in its place: the caller's
        placement for the new mesh (elastic reload)."""
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0, {}
        template = init_fn()
        ref = tree_leaves(template)
        leaves, step, meta = restore(self.directory, step=step)
        if len(leaves) != len(ref):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, expected {len(ref)} "
                f"— structure mismatch")
        placed = []
        for i, (leaf, want) in enumerate(zip(leaves, ref)):
            shape = tuple(getattr(want, "shape", leaf.shape))
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(leaf.shape)} != expected {shape}")
            if isinstance(want, torch.Tensor) and shard_fn is None:
                leaf = leaf.to(want.device)
            placed.append(leaf)
        tree = _unflatten_like(template, iter(placed))
        if shard_fn is not None:
            tree = shard_fn(tree)
        return tree, step, meta
