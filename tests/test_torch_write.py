"""The port's write path, artifact writer and recall oracle against the
reference, on the CPU at the widths of ``test_torch_common``.

* ``DeltaSegment`` insert / delete / to_leaves give the reference's
  arrays, with its refusals;
* ``insert_objects`` / ``delete_objects`` / ``compact`` give buffers
  array-equal to the reference's on the cases of
  ``tests/test_index_mutation.py`` and ``tests/test_delta.py``;
* artifacts go both ways: the port re-saves a reference artifact byte for
  byte, and the reference serves a port-written one bit-equal;
* ``brute_force`` gives the reference's ids; a query against a delta
  runs the query encoder once per chunk.

Tolerances are stated per test: arrays are compared exactly; scores of
two packages' scans at 1e-5 (f32 sums in another order).
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import delta as ref_delta
from repro.core import index as ref_index
from repro.core import relevance as ref_relevance
from repro.data import geotextual as ref_geo
from repro_torch import api, convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import delta as port_delta
from repro_torch.core import engine as port_engine
from repro_torch.core import index as port_index
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core import relevance as port_relevance
from repro_torch.data import geotextual as port_geo

from test_torch_common import (assert_topk_match, make_attrs,
                               make_ref_snapshot, make_requests, tiny_cfg,
                               to_torch, with_delta)

PRECISIONS = ("f32", "bf16", "int8")
D = 32


def _np(x):
    """A tensor or array as numpy, bf16 as its int16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_buffers_equal(got, want, keys=("emb", "loc", "ids", "counts",
                                          "scale", "attrs")):
    for k in keys:
        np.testing.assert_array_equal(_np(got[k].cpu()), _np(want[k]),
                                      err_msg=k)
        assert str(_np(got[k].cpu()).dtype) == str(_np(want[k]).dtype), k


def port_buffers(buf):
    """A reference buffer dict as the port's (CPU tensors)."""
    out = {k: to_torch(np.asarray(buf[k])) for k in
           ("emb", "loc", "ids", "counts", "scale", "attrs")}
    out.update({k: buf[k] for k in ("capacity", "n_spilled", "precision")})
    return out


def to_port(snap, tmp_path, name):
    """The reference snapshot as the port loads it from its artifact."""
    d = str(tmp_path / name)
    ref_api.save(snap, d)
    return api.load(d, device="cpu")


def rows_for(ids, d=D):
    """Seeded f32 rows and locations per id (as ``tests/test_delta.py``)."""
    ids = np.asarray(ids).reshape(-1)
    emb = np.stack([np.random.default_rng(10_000 + int(i))
                    .normal(size=d).astype(np.float32) for i in ids])
    loc = np.stack([np.random.default_rng(20_000 + int(i))
                    .uniform(size=2).astype(np.float32) for i in ids])
    return emb, loc


@pytest.fixture(scope="module")
def base():
    """A reference f32 snapshot (float32 compute) and its three tiers."""
    snap = make_ref_snapshot(tiny_cfg(compute_dtype="float32"))
    return {p: snap.with_precision(p) for p in PRECISIONS}


# ---------------------------------------------------------------------------
# DeltaSegment
# ---------------------------------------------------------------------------


def _segments(pkg, precision):
    """The same insert/delete log through a package's DeltaSegment."""
    emb, loc = rows_for([100, 101, 102, 103])
    seg = (pkg.DeltaSegment.empty(D, precision)
           .insert(emb[:2], loc[:2], [100, 101],
                   new_attrs=make_attrs(2, seed=1))
           .insert(emb[2:], loc[2:], [102, 103])
           .delete([101, 55]))
    return seg


@pytest.mark.parametrize("precision", PRECISIONS)
def test_delta_segment_matches_reference(precision):
    """Every array of ``arrays()`` and ``to_leaves()`` equal to the
    reference's, dtypes included; chunks shared on insert."""
    want = _segments(ref_delta, precision)
    got = _segments(port_delta, precision)
    assert got.n_rows == want.n_rows == 3
    assert got.ids_live == want.ids_live
    assert got.tombstones == want.tombstones
    wl, gl = want.to_leaves(), got.to_leaves()
    assert sorted(wl) == sorted(gl)
    for f in wl:
        np.testing.assert_array_equal(_np(gl[f]), _np(wl[f]), err_msg=f)
        assert str(_np(gl[f]).dtype) == str(_np(wl[f]).dtype), f
    back = port_delta.DeltaSegment.from_leaves(D, precision, gl)
    assert back.ids_live == got.ids_live and back.tombstones == got.tombstones
    emb, loc = rows_for([200])
    grown = got.insert(emb, loc, [200])
    assert grown.chunks[0] is got.chunks[0]            # shared, not copied
    assert got.n_rows == 3                             # predecessor untouched


def test_delta_segment_refusals():
    """The reference's refusals, message for message."""
    emb, loc = rows_for([100, 101])
    for pkg in (ref_delta, port_delta):
        seg = pkg.DeltaSegment.empty(D).insert(emb, loc, [100, 101])
        with pytest.raises(ValueError, match="duplicate"):
            seg.insert(*rows_for([101]), [101])
        with pytest.raises(ValueError, match="duplicate"):
            seg.insert(*rows_for([5, 5]), [5, 5])
        with pytest.raises(ValueError, match="non-negative"):
            seg.insert(*rows_for([7]), [-1])
        with pytest.raises(ValueError, match="disagree"):
            seg.insert(emb, loc[:1], [200, 201])
        with pytest.raises(ValueError, match="precision"):
            pkg.DeltaSegment.empty(D, "fp4")
        with pytest.raises(ValueError, match="attrs"):
            seg.insert(*rows_for([9]), [9], new_attrs=np.zeros((1, 2)))
        assert seg.empty(D).is_empty
        # delete frees the id for a re-insert; the tombstone stays
        again = seg.delete([100]).insert(*rows_for([100]), [100])
        assert 100 in again.ids_live and 100 in again.tombstones


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantize_and_dequantize_match_reference(base, precision):
    """quantize_buffers from f32 (only) and dequantize_rows: arrays equal
    to the reference's, at every tier."""
    ref = base["f32"]
    got = port_index.quantize_buffers(port_buffers(ref.buffers), precision)
    assert_buffers_equal(got, base[precision].buffers)
    assert got["precision"] == precision
    want = ref_index.dequantize_rows(base[precision].buffers["emb"],
                                     base[precision].buffers["scale"],
                                     precision)
    np.testing.assert_array_equal(
        port_index.dequantize_rows(got["emb"], got["scale"],
                                   precision).numpy(), want)
    if precision != "f32":
        with pytest.raises(ValueError, match="requantize"):
            port_index.quantize_buffers(got, "f32")


def test_live_counts_matches_reference(base):
    snap = base["f32"]
    victims = np.asarray(snap.buffers["ids"])[0, :3].tolist()
    want = ref_delta.live_counts(
        snap.buffers, ref_delta.DeltaSegment.empty(D).delete(victims + [999]))
    got = port_delta.live_counts(
        port_buffers(snap.buffers),
        port_delta.DeltaSegment.empty(D).delete(victims + [999]))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# insert_objects / delete_objects (the cases of test_index_mutation.py)
# ---------------------------------------------------------------------------


def _tiny_index(rng, *, n, c, cap, d=8, precision="f32"):
    emb = rng.normal(size=(n, d)).astype(np.float32)
    loc = rng.uniform(size=(n, 2)).astype(np.float32)
    norm = ref_index.loc_normalizer(jnp.asarray(loc))
    params = ref_index.index_init(jax.random.PRNGKey(0), d, c, hidden=(8,))
    feats = ref_index.build_features(jnp.asarray(emb), jnp.asarray(loc),
                                     norm)
    top = np.asarray(ref_index.assign_clusters(params, feats,
                                               top=min(2, c)))
    if top.ndim == 1:
        top = top[:, None]
    buf = ref_index.build_cluster_buffers(top, emb, loc, n_clusters=c,
                                          capacity=cap, precision=precision)
    return buf, params, norm, top, emb, loc


def _port_index(params, norm):
    params = jax.tree_util.tree_map(np.array, params)
    return (convert.index_from_numpy(params),
            {k: torch.from_numpy(np.array(v)) for k, v in norm.items()})


def _with_full_cluster(buf, ci, cap, fill_from=10_000):
    ids = np.asarray(buf["ids"]).copy()
    counts = np.asarray(buf["counts"]).copy()
    pad = cap - counts[ci]
    ids[ci, counts[ci]:cap] = fill_from + np.arange(pad)
    counts[ci] = cap
    return dict(buf, ids=jnp.asarray(ids), counts=jnp.asarray(counts))


def _insert_both(buf, params, norm, new_emb, new_loc, new_ids, **kw):
    want = ref_index.insert_objects(buf, params, norm, jnp.asarray(new_emb),
                                    jnp.asarray(new_loc),
                                    np.asarray(new_ids), **kw)
    index, pnorm = _port_index(params, norm)
    got = port_index.insert_objects(port_buffers(buf), index, pnorm,
                                    torch.from_numpy(new_emb),
                                    torch.from_numpy(new_loc),
                                    np.asarray(new_ids), **kw)
    return got, want


@pytest.mark.parametrize("precision", PRECISIONS)
def test_insert_overflow_raises(rng, precision):
    """Index packed to capacity: the next insert raises in both."""
    c, cap, d = 2, 4, 8
    buf, params, norm, *_ = _tiny_index(rng, n=c * cap, c=c, cap=cap, d=d,
                                        precision=precision)
    index, pnorm = _port_index(params, norm)
    with pytest.raises(ValueError, match="capacity"):
        port_index.insert_objects(
            port_buffers(buf), index, pnorm,
            torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(1, 2)).astype(np.float32)),
            np.array([999]))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_insert_spills_to_least_loaded(rng, precision):
    """One cluster full, six inserts: buffers array-equal to the
    reference's, every id stored once, no cluster over capacity."""
    c, cap, d = 4, 8, 8
    buf, params, norm, *_ = _tiny_index(rng, n=8, c=c, cap=cap, d=d,
                                        precision=precision)
    buf = _with_full_cluster(buf, int(np.asarray(buf["counts"]).argmax()),
                             cap)
    new_emb = rng.normal(size=(6, d)).astype(np.float32)
    new_loc = rng.uniform(size=(6, 2)).astype(np.float32)
    got, want = _insert_both(buf, params, norm, new_emb, new_loc,
                             np.arange(500, 506),
                             new_attrs=make_attrs(6, seed=2))
    assert_buffers_equal(got, want)
    assert (got["counts"] <= cap).all()
    assert got["precision"] == precision


def test_insert_fills_hole_after_delete(rng):
    """Delete then insert into a full index: the new row takes the hole
    at slot 0, as in the reference; no live object is overwritten."""
    c, cap, d = 2, 4, 8
    buf, params, norm, *_ = _tiny_index(rng, n=c * cap, c=c, cap=cap, d=d)
    victim = int(np.asarray(buf["ids"])[0, 0])
    want2 = ref_index.delete_objects(buf, [victim])
    got2 = port_index.delete_objects(port_buffers(buf), [victim])
    assert_buffers_equal(got2, want2)
    new_emb = rng.normal(size=(1, d)).astype(np.float32)
    new_loc = rng.uniform(size=(1, 2)).astype(np.float32)
    want3 = ref_index.insert_objects(want2, params, norm,
                                     jnp.asarray(new_emb),
                                     jnp.asarray(new_loc), np.array([999]))
    index, pnorm = _port_index(params, norm)
    got3 = port_index.insert_objects(got2, index, pnorm,
                                     torch.from_numpy(new_emb),
                                     torch.from_numpy(new_loc),
                                     np.array([999]))
    assert_buffers_equal(got3, want3)
    assert int(got3["ids"][0, 0]) == 999          # the hole, not a clobber
    assert int(got3["counts"].sum()) == c * cap
    # the input buffers are never written
    assert int(got2["ids"].eq(999).sum()) == 0


@pytest.mark.parametrize("precision", PRECISIONS)
def test_delete_restores_padding(rng, precision):
    """Deleted slots hold exactly the build's padding (emb 0, scale 1,
    loc PAD_LOC, attrs 0, id -1), counts recounted; array-equal to the
    reference's."""
    c, cap, d = 2, 8, 8
    buf, *_ = _tiny_index(rng, n=10, c=c, cap=cap, d=d, precision=precision)
    ids = np.asarray(buf["ids"])
    victims = ids[ids >= 0][:3]
    want = ref_index.delete_objects(buf, victims)
    src = port_buffers(buf)
    got = port_index.delete_objects(src, victims)
    assert_buffers_equal(got, want)
    pad = got["ids"] == -1
    assert (got["emb"][pad].float() == 0).all()
    assert (got["loc"][pad] == port_index.PAD_LOC).all()
    assert (got["scale"][pad] == 1.0).all()
    assert (got["attrs"][pad] == 0).all()
    assert int(got["counts"].sum()) == int(src["counts"].sum()) - 3
    assert_buffers_equal(src, buf)                 # the input is unchanged


def test_deleted_index_equals_rebuilt(rng):
    """Deleting the last-placed objects leaves buffers array-equal to
    building from the survivors, in the port as in the reference."""
    c, cap, d, n, n_del = 4, 8, 8, 12, 3
    buf, params, norm, top, emb, loc = _tiny_index(rng, n=n, c=c, cap=cap,
                                                   d=d)
    mutated = port_index.delete_objects(port_buffers(buf),
                                        np.arange(n - n_del, n))
    rebuilt = port_index.build_cluster_buffers(
        top[:n - n_del], torch.from_numpy(emb[:n - n_del]),
        torch.from_numpy(loc[:n - n_del]), n_clusters=c, capacity=cap)
    assert_buffers_equal(mutated, rebuilt)
    assert_buffers_equal(mutated, ref_index.delete_objects(
        buf, np.arange(n - n_del, n)))


def test_insert_prefers_spill_hop(rng):
    """With the preferred cluster full an insert takes its next spill
    hop, not the least-loaded cluster; at spill 1 it falls back to the
    least-loaded one. Array-equal to the reference in both."""
    c, cap, d = 4, 8, 8
    buf, params, norm, *_ = _tiny_index(rng, n=4, c=c, cap=cap, d=d)
    new_emb = rng.normal(size=(1, d)).astype(np.float32)
    new_loc = rng.uniform(size=(1, 2)).astype(np.float32)
    feats = ref_index.build_features(jnp.asarray(new_emb),
                                     jnp.asarray(new_loc), norm)
    pref = np.asarray(ref_index.assign_clusters(params, feats, top=c))[0]
    index, pnorm = _port_index(params, norm)
    got_pref = port_index.assign_clusters(
        index, port_index.build_features(torch.from_numpy(new_emb),
                                         torch.from_numpy(new_loc), pnorm),
        top=c)[0]
    np.testing.assert_array_equal(got_pref.numpy(), pref)
    ids = np.asarray(buf["ids"]).copy()
    counts = np.asarray(buf["counts"]).copy()
    ids[pref[0]] = 10_000 + np.arange(cap)
    counts[pref[0]] = cap
    fill = 3 - int((ids[pref[1]] >= 0).sum())
    if fill > 0:
        free = np.flatnonzero(ids[pref[1]] < 0)[:fill]
        ids[pref[1], free] = 20_000 + np.arange(fill)
    counts[pref[1]] = int((ids[pref[1]] >= 0).sum())
    least = min(range(c), key=lambda j: counts[j])
    assert least not in (int(pref[0]), int(pref[1]))
    buf = dict(buf, ids=jnp.asarray(ids), counts=jnp.asarray(counts))
    for spill, where in ((3, int(pref[1])), (1, least)):
        got, want = _insert_both(buf, params, norm, new_emb, new_loc,
                                 np.array([777]), spill=spill)
        assert_buffers_equal(got, want)
        assert int(np.argwhere(got["ids"].numpy() == 777)[0][0]) == where


# ---------------------------------------------------------------------------
# Snapshot derivations and compaction
# ---------------------------------------------------------------------------


def _mutations(pkg, precision, victims):
    new_ids = list(range(9100, 9130))
    emb, loc = rows_for(new_ids)
    return (pkg.DeltaSegment.empty(D, precision)
            .insert(emb, loc, new_ids, new_attrs=make_attrs(30, seed=5))
            .delete(list(victims) + new_ids[:5]))


@pytest.fixture(scope="module")
def compacted(base, tmp_path_factory):
    """precision → (reference delta snapshot, its compaction, the port's
    delta snapshot, its compaction, the reference's victims)."""
    out = {}
    tok, msk, loc = make_requests(np.random.default_rng(9), 10,
                                  base["f32"].cfg)
    c = base["f32"].cfg.n_clusters
    for p in PRECISIONS:
        ref = base[p]
        ids0, _ = ref_api.Searcher(ref, backend="dense").query(
            tok, msk, loc, k=10, cr=c, batch=4)
        victims = np.unique(ids0[ids0 >= 0])[:40].tolist()
        ref_d = ref.with_delta(_mutations(ref_delta, p, victims))
        tmp = tmp_path_factory.mktemp(f"compact_{p}")
        port = to_port(ref, tmp, "base")
        port_d = port.with_delta(_mutations(port_delta, p, victims))
        out[p] = (ref_d, ref_d.compact(), port_d, port_d.compact(), victims)
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_compact_matches_reference(compacted, precision):
    """The port's compaction of the same delta gives buffers array-equal
    to the reference's; version, counts and meta as the reference's;
    the predecessor is never written."""
    ref_d, ref_c, port_d, port_c, _ = compacted[precision]
    assert_buffers_equal(port_c.buffers, ref_c.buffers)
    assert port_c.delta is None
    assert port_c.meta.version == ref_c.meta.version == \
        port_d.meta.version + 1
    for f in ("n_objects", "delta_rows", "n_tombstones", "precision"):
        assert getattr(port_c.meta, f) == getattr(ref_c.meta, f), f
    assert (port_d.meta.delta_rows, port_d.meta.n_tombstones) == \
        (ref_d.meta.delta_rows, ref_d.meta.n_tombstones)
    assert_buffers_equal(port_d.buffers, ref_d.buffers)   # untouched
    assert port_c.compact() is port_c


@pytest.mark.parametrize("backend", ["dense", "dense-cm"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_compaction_parity(compacted, precision, backend):
    """At cr = c the delta snapshot and its compaction answer alike: ids
    equal, scores within 1e-5; no victim comes back; the delta's rows
    are found. Both equal the reference's delta answers."""
    ref_d, _, port_d, port_c, victims = compacted[precision]
    cfg = port_d.cfg
    tok, msk, loc = make_requests(np.random.default_rng(9), 10, cfg)
    c = cfg.n_clusters
    s = api.Searcher(port_d, backend=backend, device="cpu")
    ids_d, sc_d = s.query(tok, msk, loc, k=10, cr=c, batch=4)
    ids_c, sc_c = s.engine.query(tok, msk, loc, k=10, cr=c, batch=4,
                                 snapshot=port_c)
    np.testing.assert_array_equal(ids_d, ids_c)
    np.testing.assert_allclose(sc_d, sc_c, atol=1e-5, rtol=1e-5)
    assert not np.isin(ids_d, victims).any()
    assert (ids_d >= 9100).any()
    want = ref_api.Searcher(ref_d, backend=backend).query(
        tok, msk, loc, k=10, cr=c, batch=4)
    np.testing.assert_array_equal(ids_d, want[0])
    np.testing.assert_allclose(sc_d, want[1], atol=1e-5, rtol=1e-5)


# hand-picked interleavings (the reference's tests/test_delta.py)
_FIXED_LOGS = [
    [("insert", 3), ("delete", 5), ("insert", 2), ("delete", 0),
     ("insert", 1), ("delete", 97)],
    [("delete", 7), ("delete", 7), ("insert", 4), ("delete", 2)],
    [("insert", 4), ("insert", 4), ("delete", 123456), ("delete", 3),
     ("delete", 11), ("insert", 2)],
]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("log", range(len(_FIXED_LOGS)))
def test_fixed_mutation_logs(base, tmp_path, precision, log):
    """Each log op by op through both packages, queried after every op at
    cr = c: the port's ids equal the reference's, scores within 1e-5;
    only live ids come back; each compaction's buffers are array-equal
    to the reference's and hold exactly the live set."""
    ref = base[precision]
    port = to_port(ref, tmp_path, "base")
    cfg = ref.cfg
    tok, msk, loc = make_requests(np.random.default_rng(31), 4, cfg)
    ref_s = ref_api.Searcher(ref, backend="dense")
    port_s = api.Searcher(port, backend="dense", device="cpu")
    base_ids = np.asarray(ref.buffers["ids"])
    live = set(int(i) for i in base_ids[base_ids >= 0])
    segs = [ref_delta.DeltaSegment.empty(D, precision),
            port_delta.DeltaSegment.empty(D, precision)]
    next_id = 50_000
    for op, arg in _FIXED_LOGS[log]:
        if op == "insert":
            ids = list(range(next_id, next_id + arg))
            next_id += arg
            emb, loc_n = rows_for(ids)
            segs = [s.insert(emb, loc_n, ids) for s in segs]
            live |= set(ids)
        elif live:
            victim = sorted(live)[arg % len(live)]
            segs = [s.delete([victim]) for s in segs]
            live.discard(victim)
        ref_d, port_d = ref.with_delta(segs[0]), port.with_delta(segs[1])
        want = ref_s.engine.query(tok, msk, loc, k=8, cr=cfg.n_clusters,
                                  batch=4, snapshot=ref_d)
        got = port_s.engine.query(tok, msk, loc, k=8, cr=cfg.n_clusters,
                                  batch=4, snapshot=port_d)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
        assert set(int(i) for i in got[0][got[0] >= 0]) <= live
        port_c = port_d.compact()
        assert_buffers_equal(port_c.buffers, ref_d.compact().buffers)
        ids_c = port_c.buffers["ids"].numpy()
        assert set(int(i) for i in ids_c[ids_c >= 0]) == live


def test_derivation_refusals(base, tmp_path):
    """with_precision refuses a non-empty delta and a non-f32 source;
    with_buffers and with_delta refuse another tier; as the reference."""
    ref8 = base["int8"]
    port = to_port(base["f32"], tmp_path, "refusals")
    port8 = port.with_precision("int8")
    assert port8.meta.version == port.meta.version + 1
    assert port8.meta.precision == "int8"
    assert_buffers_equal(port8.buffers, ref8.buffers)
    assert port.with_precision("f32") is port
    with pytest.raises(ValueError, match="requantize"):
        port8.with_precision("bf16")
    seg = port_delta.DeltaSegment.empty(D, "f32").delete([1])
    with pytest.raises(ValueError, match="compact"):
        port.with_delta(seg).with_precision("int8")
    with pytest.raises(ValueError, match="with_precision"):
        port.with_buffers(port8.buffers)
    with pytest.raises(ValueError, match="tiers"):
        port8.with_delta(seg)
    grown = port.with_buffers(port_index.delete_objects(port.buffers, [0]))
    assert grown.meta.version == port.meta.version + 1
    assert grown.meta.n_objects == port.meta.n_objects - 1


# ---------------------------------------------------------------------------
# Artifacts, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("has_delta", [False, True], ids=["base", "delta"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_artifact_roundtrip_both_ways(base, tmp_path, precision, has_delta):
    """The reference saves; the port loads and saves again: every
    ``arr_*.npy`` byte-identical, manifests equal apart from ``treedef``.
    The reference loads the port's artifact and its dense queries give
    ids and scores bit-equal to querying the original."""
    snap = with_delta(base[precision]) if has_delta else base[precision]
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    path_a = ref_api.save(snap, a)
    port = api.load(a, device="cpu")
    path_b = api.save(port, b)
    assert os.path.basename(path_a) == os.path.basename(path_b)
    names = sorted(os.listdir(path_a))
    assert names == sorted(os.listdir(path_b))
    for name in names:
        if name.endswith(".npy"):
            assert filecmp.cmp(os.path.join(path_a, name),
                               os.path.join(path_b, name), shallow=False), name
    ma = json.load(open(os.path.join(path_a, "manifest.json")))
    mb = json.load(open(os.path.join(path_b, "manifest.json")))
    assert ma.pop("treedef") != mb.pop("treedef")
    assert ma == mb
    tok, msk, loc = make_requests(np.random.default_rng(12), 12, snap.cfg)
    for backend in ("dense", "dense-cm"):
        want = ref_api.Searcher(snap, backend=backend).query(
            tok, msk, loc, k=6, cr=2, batch=8)
        got = ref_api.Searcher(ref_api.load(b), backend=backend).query(
            tok, msk, loc, k=6, cr=2, batch=8)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_written_snapshot_served_by_reference(compacted, tmp_path,
                                                   precision):
    """Snapshots the port derived itself (a delta it built, and that
    delta compacted on its side) saved by the port: the reference loads
    them with every leaf bit-equal to the port's tensors, and serves them
    as it serves its own derivations of the same writes (ids and scores
    bit-equal)."""
    ref_d, ref_c, port_d, port_c, _ = compacted[precision]
    tok, msk, loc = make_requests(np.random.default_rng(13), 12, ref_d.cfg)
    for name, port_snap, ref_snap in (("delta", port_d, ref_d),
                                      ("compacted", port_c, ref_c)):
        d = str(tmp_path / name)
        api.save(port_snap, d)
        loaded = ref_api.load(d)
        assert loaded.meta.version == port_snap.meta.version
        assert_buffers_equal(port_snap.buffers, loaded.buffers)
        if port_snap.delta is not None:
            for f, v in port_snap.delta.to_leaves().items():
                np.testing.assert_array_equal(
                    _np(v), _np(loaded.delta.to_leaves()[f]), err_msg=f)
        want = ref_api.Searcher(ref_snap, backend="dense").query(
            tok, msk, loc, k=6, cr=2, batch=8)
        got = ref_api.Searcher(loaded, backend="dense").query(
            tok, msk, loc, k=6, cr=2, batch=8)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_params_to_numpy_inverts_params_from_numpy(base):
    """The reference's pytrees → modules → pytrees: the same structure,
    every leaf bit-equal at its dtype (blocks restacked)."""
    snap = base["f32"]
    rel, index = convert.params_from_numpy(
        jax.tree_util.tree_map(np.array, snap.rel_params),
        jax.tree_util.tree_map(np.array, snap.index_params), snap.cfg)
    rp, ip = convert.params_to_numpy(rel, index)
    for got, want in ((rp, snap.rel_params), (ip, snap.index_params)):
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    rel.o_enc = None
    assert "o_enc" not in convert.params_to_numpy(rel, index)[0]


def test_save_refusals_tmp_and_keep(base, tmp_path):
    """An older version into a newer directory is refused; a leftover
    ``.tmp`` is ignored by loads and collected by the next save; keep-k
    holds."""
    port = to_port(base["f32"], tmp_path, "src")
    d = str(tmp_path / "lineage")
    snaps = [port]
    for _ in range(4):
        snaps.append(snaps[-1].with_buffers(dict(snaps[-1].buffers)))
    api.save(snaps[2], d)
    with pytest.raises(ValueError, match="already holds version"):
        api.save(snaps[1], d)
    os.makedirs(os.path.join(d, "step_000000099.tmp"))
    os.makedirs(os.path.join(d, "step_000000001.old"))
    assert ckpt.latest_step(d) == snaps[2].meta.version
    assert api.load(d, device="cpu").meta.version == snaps[2].meta.version
    for s in snaps[3:]:
        api.save(s, d, keep=2)
    assert sorted(os.listdir(d)) == [f"step_{v:09d}" for v in
                                     (snaps[3].meta.version,
                                      snaps[4].meta.version)]
    api.save(snaps[4], d, keep=2)                  # the same step again
    assert ckpt.all_steps(d) == [snaps[3].meta.version,
                                 snaps[4].meta.version]


# ---------------------------------------------------------------------------
# The engine: publish, and one encoder pass with a delta
# ---------------------------------------------------------------------------


def test_publish(base, tmp_path):
    """A snapshot of another config is refused; a successor is served
    from then on, and the plan cache survives."""
    port = to_port(base["f32"], tmp_path, "a")
    s = api.Searcher(port, backend="dense", device="cpu")
    tok, msk, loc = make_requests(np.random.default_rng(14), 8, port.cfg)
    s.query(tok, msk, loc, k=5, cr=2, batch=8)
    plans = dict(s.engine._plans)
    other = to_port(make_ref_snapshot(tiny_cfg(compute_dtype="float32",
                                               spatial_t=40)),
                    tmp_path, "b")
    with pytest.raises(ValueError, match="cfg_digest"):
        s.publish(other)
    seg = port_delta.DeltaSegment.empty(D).delete(
        s.query(tok, msk, loc, k=5, cr=2, batch=8)[0][:, 0])
    succ = port.with_delta(seg)
    assert s.publish(succ) is succ and s.snapshot is succ
    ids, _ = s.query(tok, msk, loc, k=5, cr=2, batch=8)
    assert not np.isin(ids, seg.tombstone_array()).any()
    assert all(s.engine._plans[key] is fn for key, fn in plans.items())


def test_delta_query_encodes_once_per_chunk(base, tmp_path):
    """With delta rows and tombstones, each chunk runs the query encoder
    once (a forward hook counts the calls), and the ids equal the
    reference's, scores within 1e-5."""
    ref = with_delta(base["int8"])
    port = to_port(ref, tmp_path, "d")
    calls = []
    port.rel.q_enc.register_forward_hook(lambda *a: calls.append(1))
    tok, msk, loc = make_requests(np.random.default_rng(15), 20, ref.cfg)
    got = api.Searcher(port, backend="dense", device="cpu").query(
        tok, msk, loc, k=6, cr=2, batch=8)
    assert len(calls) == 3                          # 20 queries, batch 8
    want = ref_api.Searcher(ref, backend="dense").query(tok, msk, loc, k=6,
                                                        cr=2, batch=8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    rows = port.delta_rows
    assert rows is port.delta_rows                  # built once, kept
    assert rows["ids"].shape == (1, port_delta.PAD_BUCKET)
    assert (rows["ids"][0, port.delta.n_rows:] == -1).all()


@pytest.mark.parametrize("has_rows", [False, True], ids=["none", "rows"])
def test_query_fn_returns_one_shape(base, tmp_path, has_rows):
    """A plan's function returns (ids, scores, delta ids, delta scores)
    with or without delta rows, the delta pair None without them, and
    ``run_batched`` carries a None output through as None. With rows, the
    delta pair equals ``delta_scan_plain`` on the prefix's outputs
    (exactly: the same function on the same inputs)."""
    port = to_port(with_delta(base["f32"]), tmp_path, "q")
    rows = port.delta_rows if has_rows else None
    fn = port_engine.make_query_fn(cr=2, k=6, backend="dense",
                                   dist_max=port.dist_max)
    tok, msk, loc = make_requests(np.random.default_rng(16), 10, port.cfg)
    out = port_engine.run_batched(
        lambda *a: fn(port.scan_view, *a, delta_rows=rows), [tok, msk, loc],
        batch=5, device="cpu")
    assert len(out) == 4 and out[0].shape == out[1].shape == (10, 6)
    if not has_rows:
        assert out[2] is None and out[3] is None
        return
    prefix = port_engine.make_prefix_fn(cr=2)
    for s in (0, 5):                                # run_batched's chunks
        t = [torch.from_numpy(a[s:s + 5]) for a in (tok, msk, loc)]
        q_emb, w, _ = prefix(port.rel, port.index, port.norm, *t)
        ids, sc = port_engine.delta_scan_plain(
            q_emb, t[2], w, port.w_hat, rows, k=6, dist_max=port.dist_max)
        np.testing.assert_array_equal(out[2][s:s + 5], ids.numpy())
        np.testing.assert_array_equal(out[3][s:s + 5], sc.numpy())


# ---------------------------------------------------------------------------
# The generator and the recall oracle
# ---------------------------------------------------------------------------


def _corpus_cfg(pkg, cfg, n_objects=240):
    return pkg.scale_corpus(
        pkg.GeoCorpusConfig(n_queries=24, n_topics=10, max_len=cfg.max_len,
                            vocab_size=cfg.vocab_size, seed=3), n_objects)


def test_generator_matches_reference():
    cfg = tiny_cfg()
    want = ref_geo.GeoCorpus(_corpus_cfg(ref_geo, cfg))
    got = port_geo.GeoCorpus(_corpus_cfg(port_geo, cfg))
    for f in ("obj_vocab", "qry_vocab", "bg_vocab", "hotspots", "obj_topic",
              "obj_loc", "obj_doc", "query_seed", "q_topic", "q_loc",
              "q_mismatch", "q_doc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for a, b in zip(got.positives, want.positives):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(got.object_tokens() + got.query_tokens([3, 1]),
                    want.object_tokens() + want.query_tokens([3, 1])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(got.split(), want.split()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.positives_mask([0, 5]),
                                  want.positives_mask([0, 5]))
    assert got.dist_max == want.dist_max


def test_score_corpus_matches_reference(base, tmp_path):
    """score_corpus in each spatial mode against the reference's (eager),
    within 1e-5."""
    snap = base["f32"]
    port = to_port(snap, tmp_path, "s")
    rng = np.random.default_rng(16)
    qe = rng.normal(size=(5, D)).astype(np.float32)
    ql = rng.uniform(size=(5, 2)).astype(np.float32)
    oe = rng.normal(size=(40, D)).astype(np.float32)
    ol = rng.uniform(size=(40, 2)).astype(np.float32)
    for mode, spatial in (("step", None), ("linear", {}),
                          ("exp", {"alpha": np.float32(0.3),
                                   "beta": np.float32(-0.2)})):
        rp = snap.rel_params if spatial is None else dict(
            snap.rel_params, spatial=spatial)
        want = ref_relevance.score_corpus(rp, qe, ql, oe, ol, snap.cfg,
                                          dist_max=1.414, spatial_mode=mode)
        rel = port.rel if spatial is None else convert.params_from_numpy(
            jax.tree_util.tree_map(np.array, rp),
            jax.tree_util.tree_map(np.array, snap.index_params),
            snap.cfg)[0]
        got = port_relevance.score_corpus(
            rel, torch.from_numpy(qe), torch.from_numpy(ql),
            torch.from_numpy(oe), torch.from_numpy(ol), dist_max=1.414,
            spatial_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=mode)


def test_brute_force_matches_reference(base, tmp_path):
    """The oracle on one snapshot and corpus: ids equal to the
    reference's, scores within 1e-5; the embeddings within 1e-5."""
    snap = base["f32"]
    port = to_port(snap, tmp_path, "bf")
    cfg = snap.cfg
    ref_corpus = ref_geo.GeoCorpus(_corpus_cfg(ref_geo, cfg))
    port_corpus = port_geo.GeoCorpus(_corpus_cfg(port_geo, cfg))
    qids = np.arange(16)
    want = ref_api.brute_force(snap, ref_corpus, qids, k=10, batch=8)
    got = api.brute_force(port, port_corpus, qids, k=10, batch=8)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    from repro.core import pipeline as ref_pipeline
    np.testing.assert_allclose(
        port_pipeline.embed_objects(port.rel, port_corpus, batch=64),
        ref_pipeline.embed_objects(snap.rel_params, ref_corpus, cfg,
                                   batch=64), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_compaction_equals_cpu(cuda_device, compacted, precision):
    """Compaction on a CUDA snapshot: buffers array-equal to the CPU
    compaction's (the rows re-quantized on the card)."""
    _, _, port_d, port_c, _ = compacted[precision]
    got = port_d.to(cuda_device).compact()
    assert got.device.type == "cuda"
    assert_buffers_equal({k: v.cpu() for k, v in got.buffers.items()
                          if isinstance(v, torch.Tensor)}, port_c.buffers)


@pytest.mark.cuda
def test_cuda_brute_force_equals_cpu(cuda_device, base, tmp_path):
    """brute_force on the card against the CPU's: ids equal up to ties,
    scores within 1e-4 + 1e-5·|s|. TF32 is on when it is called: the
    oracle turns it off itself."""
    port = to_port(base["f32"], tmp_path, "bfc")
    corpus = port_geo.GeoCorpus(_corpus_cfg(port_geo, port.cfg))
    qids = np.arange(16)
    want = api.brute_force(port, corpus, qids, k=10, batch=8)
    torch.backends.cuda.matmul.allow_tf32 = True
    got = api.brute_force(port.to(cuda_device), corpus, qids, k=10, batch=8)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert_topk_match(got[0], got[1], want[0], want[1], atol=1e-4,
                      rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_delta_scan_equals_plain(cuda_device, compacted, precision):
    """The kernel's delta scan (one cluster, cr 1) against the plain one
    on the same prefix outputs, unfiltered and filtered: ids equal up to
    ties, scores within 1e-4 + 1e-5·|s|; the routed kernel launched."""
    from repro_torch.core import filters as port_filters
    from repro_torch.kernels import fused_topk_score as fts
    _, _, port_d, _, _ = compacted[precision]
    gpu = port_d.to(cuda_device)
    rng = np.random.default_rng(17)
    tok, msk, loc = make_requests(rng, 12, port_d.cfg)
    fvals = np.stack([port_filters.FilterSpec(tenant=i % 3 - 1).to_fvals()
                      for i in range(12)])
    scan = port_engine.make_delta_scan_fn(k=10, dist_max=port_d.dist_max,
                                          precision=precision)
    prefix = port_engine.make_prefix_fn(cr=1)
    for q_filt in (None, fvals):
        outs = []
        for snap in (port_d, gpu):
            dev = snap.device
            t = [torch.from_numpy(a).to(dev) for a in (tok, msk, loc)]
            q_emb, w, _ = prefix(snap.rel, snap.index, snap.norm, *t)
            qf = None if q_filt is None else torch.from_numpy(q_filt).to(dev)
            fts.reset_launch_counts()
            outs.append(scan(q_emb, t[2], w, snap.w_hat, snap.delta_rows,
                             qf))
        assert fts.launches["routed"] == 1
        (wi, ws), (gi, gs) = outs
        assert_topk_match(gi.cpu().numpy(), gs.cpu().numpy(), wi.numpy(),
                          ws.numpy(), atol=1e-4, rtol=1e-5)
