"""Shared inputs of the PyTorch-port parity tests (no tests of its own).

Everything is made with numpy (and the reference's own seeded init),
handed to the reference as numpy / jax arrays and to the port as torch
CPU tensors, so both packages see bit-identical inputs.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config
from repro.core import delta as ref_delta
from repro.core import engine as ref_engine
from repro.core import filters as ref_filters
from repro.core import index as ref_index
from repro.core import relevance as ref_relevance
from repro.core.snapshot import IndexSnapshot as RefSnapshot
from repro.data import geotextual as ref_geo
from repro_torch.data import geotextual as port_geo

DIST_MAX = 1.414
N_OBJ = 160
CAP = 64
# the training tests' corpus (``tests/conftest.py``'s ``small_corpus``)
TRAIN_CORPUS = dict(n_objects=600, n_queries=120, n_topics=8,
                    vocab_size=2048, seed=0)


def ref_on_cpu():
    """Run the reference's jax on the CPU (on a machine where jax also
    sees a GPU, its f32 products there default to TF32)."""
    return jax.default_device(jax.devices("cpu")[0])


def split3(x):
    """f32 ``x`` → its bf16 terms as f32: hi = RN(x), mid = RN(x − hi),
    lo = RN(x − hi − mid) (both differences exact): the split of the
    f32 flash kernels (flash_attention.cu ``split3``)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def f64_attention(q, k, v, *, causal, window):
    """``(o, lse)`` of flash attention in f64, from the (f32) inputs."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.double().reshape(b, s, kv, h // kv, d) / math.sqrt(d)
    sc = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.double())
    mask = fa.attention_mask(s, s, causal=causal, window=window)
    sc = torch.where(mask, sc, torch.tensor(-1e30, dtype=torch.float64))
    o = torch.einsum("bkgqj,bjkd->bkgqd", torch.softmax(sc, -1), v.double())
    return (o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d),
            torch.logsumexp(sc, -1).reshape(b, h, s))


def corpora(**kw):
    """The same corpus from both packages' generators: ``(reference's,
    port's)``, ``TRAIN_CORPUS`` updated by ``kw``."""
    c = dict(TRAIN_CORPUS, **kw)
    return (ref_geo.GeoCorpus(ref_geo.GeoCorpusConfig(**c)),
            port_geo.GeoCorpus(port_geo.GeoCorpusConfig(**c)))


def np_tree(tree):
    """A pytree of jax arrays as numpy."""
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_cfg(**kw):
    """The ``tiny_de_cfg`` geometry: 2 layers, d 32, c 4."""
    base = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab_size=2048,
                max_len=16, spatial_t=50, n_clusters=4, neg_start=200,
                neg_end=300, index_mlp_hidden=(32,))
    base.update(kw)
    return dataclasses.replace(get_config("list-dual-encoder"), **base)


def make_attrs(n, seed=3):
    rng = np.random.default_rng(seed)
    return ref_filters.make_attrs(
        tenant=rng.integers(0, 3, n),
        category_mask=rng.integers(0, 16, n),
        timestamp=rng.integers(0, 1000, n))


def make_ref_snapshot(cfg, *, seed=17, n_obj=N_OBJ, capacity=CAP):
    """A reference f32 snapshot with random (seeded) params, ``n_obj``
    objects and filter attributes, placed by the reference's own router
    into buffers of ``capacity`` rows."""
    rng = np.random.default_rng(seed)
    rel = ref_relevance.relevance_init(jax.random.PRNGKey(0), cfg)
    obj_emb = rng.normal(size=(n_obj, cfg.d_model)).astype(np.float32)
    obj_loc = rng.uniform(size=(n_obj, 2)).astype(np.float32)
    norm = ref_index.loc_normalizer(jnp.asarray(obj_loc))
    iparams = ref_index.index_init(jax.random.PRNGKey(5), cfg.d_model,
                                   cfg.n_clusters,
                                   hidden=cfg.index_mlp_hidden)
    feats = ref_index.build_features(jnp.asarray(obj_emb),
                                     jnp.asarray(obj_loc), norm)
    top = np.asarray(ref_index.assign_clusters(iparams, feats, top=2))
    buf = ref_index.build_cluster_buffers(top, obj_emb, obj_loc,
                                          n_clusters=cfg.n_clusters,
                                          capacity=capacity,
                                          attrs=make_attrs(n_obj))
    return RefSnapshot.from_parts(cfg, rel, iparams, norm, buf,
                                  dist_max=DIST_MAX)


def with_delta(snap, seed=23):
    """``snap`` plus a delta segment: 5 inserted rows, 3 tombstones."""
    rng = np.random.default_rng(seed)
    d = snap.cfg.d_model
    seg = ref_delta.DeltaSegment.empty(d, snap.meta.precision)
    seg = seg.insert(rng.normal(size=(5, d)).astype(np.float32),
                     rng.uniform(size=(5, 2)).astype(np.float32),
                     np.arange(9000, 9005), new_attrs=make_attrs(5, seed=4))
    seg = seg.delete([0, 1, 2])
    return snap.with_delta(seg)


def with_tombstones(snap, n, *, seed=29):
    """``snap`` plus a delta segment of ``n`` tombstones and no rows: ids
    drawn (seeded) from those its buffers hold."""
    held = np.asarray(snap.buffers["ids"]).reshape(-1)
    held = held[held >= 0]
    dead = np.random.default_rng(seed).choice(held, n, replace=False)
    seg = ref_delta.DeltaSegment.empty(snap.cfg.d_model, snap.meta.precision)
    return snap.with_delta(seg.delete(dead))


def make_requests(rng, n, cfg):
    tok = rng.integers(2, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    tok[:, 0] = 1
    msk = np.ones((n, cfg.max_len), bool)
    msk[:, cfg.max_len // 2:] = rng.uniform(size=(n, cfg.max_len // 2)) < 0.5
    tok[~msk] = 0
    loc = rng.uniform(size=(n, 2)).astype(np.float32)
    return tok, msk, loc


def ref_prefix(snap, tok, msk, loc, *, cr):
    """The reference's (q_emb, w, top_c) as numpy."""
    fn = ref_engine.make_prefix_fn(snap.cfg, cr=cr,
                                   weight_mode=snap.meta.weight_mode)
    return tuple(np.asarray(x) for x in fn(
        snap.rel_params, snap.index_params, snap.norm, jnp.asarray(tok),
        jnp.asarray(msk), jnp.asarray(loc)))


def ref_buffers_np(snap):
    return {k: np.asarray(snap.buffers[k]) for k in
            ("emb", "loc", "ids", "scale", "attrs")}


def to_torch(x):
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def numpy_oracle(q_emb, w, top_c, q_loc, buf, w_hat, fvals, *, k, precision,
                 dist_max=DIST_MAX):
    """Pure-numpy routed scan (dequant, Eq. 5, predicate, stable top-k):
    the oracle of ``tests/test_filters.py``, fed explicit routes."""
    be = buf["emb"].astype(np.float32)
    if precision == "int8":
        be = be * buf["scale"][..., None]
    t = w_hat.shape[0]
    d = be.shape[-1]
    out_i, out_s = [], []
    for q in range(q_emb.shape[0]):
        ce = be[top_c[q]].reshape(-1, d)
        cl = buf["loc"][top_c[q]].reshape(-1, 2)
        ci = buf["ids"][top_c[q]].reshape(-1).copy()
        ca = buf["attrs"][top_c[q]].reshape(-1, 3)
        if fvals is not None:
            ok = ref_filters.predicate_mask_np(ca, fvals[q][None])
            ci[~ok] = -1
        trel = ce @ q_emb[q]
        dist = np.linalg.norm(q_loc[q] - cl, axis=-1)
        s_in = 1.0 - np.clip(dist / dist_max, 0.0, 1.0)
        srel = w_hat[np.clip(np.floor(s_in * t).astype(np.int32), 0, t - 1)]
        st = w[q, 0] * trel + w[q, 1] * srel
        st = np.where(ci >= 0, st, ref_engine.NEG_INF).astype(np.float32)
        order = np.argsort(-st, kind="stable")[:k]
        out_i.append(np.where(st[order] > ref_engine.NEG_INF / 2,
                              ci[order], -1))
        out_s.append(st[order])
    return np.stack(out_i).astype(np.int32), np.stack(out_s)


def assert_topk_match(ids, scores, want_ids, want_scores, *, atol=1e-5,
                      rtol=1e-5):
    """Scores allclose; ids equal except where scores tie (within the
    tolerance): a swap of near-equal scores, or a different pick among
    entries tied with the k-th score."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    scores, want_scores = np.asarray(scores), np.asarray(want_scores)
    np.testing.assert_allclose(scores, want_scores, atol=atol, rtol=rtol)
    tol = atol + rtol * np.abs(want_scores)
    for q in range(ids.shape[0]):
        for p in np.flatnonzero(ids[q] != want_ids[q]):
            same = np.flatnonzero(want_ids[q] == ids[q, p])
            tied = np.abs(want_scores[q] - want_scores[q, p]) <= 2 * tol[q, p]
            at_edge = abs(scores[q, p] - want_scores[q, -1]) <= 2 * tol[q, -1]
            assert (same.size and tied[same].any()) or at_edge, (
                f"row {q} position {p}: id {ids[q, p]} vs {want_ids[q, p]} "
                f"(scores {scores[q, p]} / {want_scores[q, p]}) is no tie")


# ---------------------------------------------------------------------------
# The serving stack: both packages over one artifact
# ---------------------------------------------------------------------------

# the serving tests' geometry (tests/test_server.py's engine_parts), f32
# compute so the two packages encode and route alike
def serve_cfg():
    return tiny_cfg(vocab_size=512, max_len=8, index_mlp_hidden=(16,),
                    compute_dtype="float32")


# server counters that must agree between the packages on one scenario
# (the per-flush wall-time monitor's slow_flushes is timing, not logic)
COUNTERS = ("n_requests", "exact_hits", "near_hits", "coalesced",
            "engine_batches", "engine_queries", "flushes", "invalidations",
            "writes", "compactions", "compaction_triggers", "shed",
            "flush_retries", "poisoned_requests", "breaker_trips",
            "breaker_fallback_flushes", "wal_appends", "recovered_writes",
            "wal_checkpoints")


class Side:
    """One package's serving stack (``which`` is ``"ref"`` or ``"port"``)
    over the snapshot saved in ``directory``; the port runs on the CPU,
    the reference's jax under :func:`ref_on_cpu`. The modules a scenario
    needs are attributes: ``api``, ``server_lib``, ``faults``, ``wal_lib``,
    ``engine_lib``, ``continuous``, ``filters``, ``snapshot_lib``,
    ``ckpt``, ``resilience``, ``index_lib``."""

    def __init__(self, which, directory):
        import importlib
        self.which = which
        pkg = "repro" if which == "ref" else "repro_torch"
        for attr, mod in (("api", "api"), ("server_lib", "core.server"),
                          ("faults", "core.faults"), ("wal_lib", "core.wal"),
                          ("engine_lib", "core.engine"),
                          ("continuous", "core.continuous"),
                          ("filters", "core.filters"),
                          ("snapshot_lib", "core.snapshot"),
                          ("ckpt", "checkpoint.ckpt"),
                          ("resilience", "distributed.resilience"),
                          ("index_lib", "core.index")):
            setattr(self, attr, importlib.import_module(f"{pkg}.{mod}"))
        self.dir = directory
        with self.ctx():
            self.snap = self.load(directory)
        self.cfg = self.snap.cfg

    def __repr__(self):
        return self.which

    def ctx(self):
        import contextlib
        return ref_on_cpu() if self.which == "ref" else \
            contextlib.nullcontext()

    def _dev(self):
        return {} if self.which == "ref" else {"device": "cpu"}

    def load(self, directory):
        return self.api.load(directory, **self._dev())

    def load_latest_good(self, directory):
        return self.snapshot_lib.load_latest_good(directory, **self._dev())

    def engine(self, backend="dense", snap=None):
        snap = self.snap if snap is None else snap
        if self.which == "ref":
            return self.engine_lib.QueryEngine.from_snapshot(
                snap, backend=backend)
        return self.engine_lib.QueryEngine(snap, backend=backend,
                                           device="cpu")

    def searcher(self, snap=None, backend="dense"):
        snap = self.snap if snap is None else snap
        return self.api.Searcher(snap, backend=backend, **self._dev())

    def server(self, *, snap=None, engine_backend="dense", **over):
        """A server over a fresh engine: tests/test_server.py's
        ``make_server`` knobs (batch 4, 30 ms, k 5, cr 2, dense)."""
        kw = dict(batch_size=4, max_delay_ms=30.0, k=5, cr=2,
                  backend="dense")
        kw.update(over)
        return self.server_lib.StreamingServer(
            self.engine(engine_backend, snap),
            self.server_lib.ServerConfig(**kw))

    def recover(self, snap_dir, wal_dir, **kw):
        return self.api.recover(snap_dir, wal_dir, **kw, **self._dev())

    def run(self, scenario, *args):
        self.faults.clear()
        try:
            with self.ctx():
                return scenario(self, *args)
        finally:
            self.faults.clear()


def serve_requests(rng, n, cfg):
    """The serving tests' requests (tests/test_server.py's
    ``make_requests``): CLS first, full masks, uniform locations."""
    tok = rng.integers(2, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    tok[:, 0] = 1
    msk = np.ones((n, cfg.max_len), bool)
    loc = rng.uniform(size=(n, 2)).astype(np.float32)
    return tok, msk, loc


def make_sides(directory):
    return Side("ref", directory), Side("port", directory)


def saved_ref_snapshot(tmp_path_factory, name, **kw):
    """``make_ref_snapshot(serve_cfg(), **kw)`` saved by the reference;
    returns the directory (both packages load it)."""
    d = str(tmp_path_factory.mktemp(name))
    make_ref_snapshot(serve_cfg(), **kw).save(d)
    return d


def counters(server) -> dict:
    s = server.stats
    return {f: (dict(getattr(s, f)) if isinstance(getattr(s, f), dict)
                else getattr(s, f)) for f in COUNTERS}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x


def assert_same(got, want, path="result", *, atol=1e-5):
    """The port's scenario result ``got`` against the reference's ``want``:
    int arrays equal, float arrays within ``atol`` (+ 1e-5 relative),
    servers by :data:`COUNTERS`, exceptions by class name, containers
    element by element, anything else equal."""
    got, want = _as_np(got), _as_np(want)
    if hasattr(want, "stats") and hasattr(want, "engine"):
        assert counters(got) == counters(want), path
    elif isinstance(want, BaseException):
        assert type(got).__name__ == type(want).__name__, (path, got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}[{key!r}]", atol=atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", atol=atol)
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        assert abs(got - want) <= atol + 1e-5 * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(sides, scenario, *args):
    """Run ``scenario(side, *args)`` on the reference, then on the port,
    and hold the port's result to the reference's (:func:`assert_same`).
    Returns both results."""
    ref, port = sides
    want = ref.run(scenario, *args)
    got = port.run(scenario, *args)
    assert_same(got, want)
    return want, got
