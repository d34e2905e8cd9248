"""The LIST query engine (reference: ``repro.core.engine``).

The query phase (paper Algorithm 1): encode the query → router features
(Eq. 9–10) → top-``cr`` clusters (Eq. 11) → score the routed clusters'
resident objects with ST and keep the top ``k`` → merge the delta
segment.

Backends (``backend=``):

* ``"cuda"`` — the routed CUDA kernel (twin of the reference's
  ``pallas``): one block per query over its routed clusters.
* ``"cuda-cm"`` — the cluster-major CUDA kernel (twin of ``pallas-cm``):
  the batch's routed clusters are deduped (``serving.cluster_major_plan``)
  and each distinct cluster is streamed once against its query roster.
* ``"dense"`` / ``"dense-cm"`` — the plain PyTorch versions of the two
  kernels, for snapshots on the CPU.
* ``"auto"`` — by the snapshot's device: ``"cuda"`` on a CUDA device,
  ``"dense"`` on the CPU; :meth:`QueryEngine.query` then upgrades to the
  ``-cm`` twin per batch when the route dedup factor ``B·cr/U`` reaches
  :data:`CLUSTER_MAJOR_DEDUP_THRESHOLD`.

The CUDA backends run only on CUDA snapshots and the dense ones only on
CPU snapshots: asking for the other raises instead of falling back.

A mesh-sharded snapshot (``IndexSnapshot.with_mesh``) is served by
:meth:`QueryEngine._query_sharded`: the prefix once on the engine's
device, one scan per shard over its part with localized routes
(:func:`make_shard_topk_fn`, the same kernels), a host tree merge
(:func:`merge_shard_topk`), then the delta merge. Shard health, retries
against a host replica, hedging of stragglers, degraded coverage and
:meth:`QueryEngine.recover_shard` follow the reference.

Inputs: ``q_tokens (B, L)`` int token ids (0 = padding), ``q_mask (B, L)``
bool, ``q_loc (B, 2)`` float32. Outputs: ``ids (B, k)`` global object ids
(-1 past the end) and ``scores (B, k)`` f32 descending, as numpy arrays.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import weakref
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import delta as delta_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import filters as filters_lib
from repro_torch.core import index as index_lib
from repro_torch.core import relevance
from repro_torch.core import serving as serving_lib
from repro_torch.core.index import topk_stable
from repro_torch.device import full_f32_products, require_device
from repro_torch.kernels import fused_topk_score as fts

NEG_INF = fts.NEG_INF

BACKENDS = ("cuda", "cuda-cm", "dense", "dense-cm", "auto")

# query-major backends and their cluster-major twins
_CM_TWIN = {"cuda": "cuda-cm", "dense": "dense-cm"}
# the device type each explicit backend runs on
_BACKEND_DEVICE = {"cuda": "cuda", "cuda-cm": "cuda", "dense": "cpu",
                   "dense-cm": "cpu"}

# auto upgrades to cluster-major when the batch would stream each
# distinct cluster at least this many times under query-major execution
CLUSTER_MAJOR_DEDUP_THRESHOLD = 2.0

DEFAULT_PLAN_CACHE_SIZE = 32

# shard fault tolerance: the reference's knobs
SHARD_SCAN_RETRIES = 2             # extra attempts per shard per chunk
SHARD_RETRY_BACKOFF_MS = 1.0       # first retry delay; doubles, capped
SHARD_RETRY_BACKOFF_MAX_MS = 20.0
SHARD_DOWN_AFTER = 3               # consecutive scan failures → DOWN
SHARD_HEDGE_PROBE_EVERY = 8        # hedged scans between device probes
# the port's hedge floor: the pinned-to-card copy whose rate it measures
HOST_COPY_PROBE_BYTES = 64 << 20


def resolve_backend(backend: str, device) -> str:
    """``"auto"`` → ``"cuda"`` on a CUDA device, ``"dense"`` on the CPU;
    an explicit backend must match the device it runs on."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if backend == "auto":
        return "cuda" if dev.type == "cuda" else "dense"
    if _BACKEND_DEVICE[backend] != dev.type:
        raise ValueError(
            f"backend {backend!r} runs on {_BACKEND_DEVICE[backend]} "
            f"snapshots, this one is on {dev}")
    return backend


def resolve_cli_backend(backend: Optional[str], use_pallas: bool,
                        *, default: str = "auto") -> str:
    """The command lines' alias rule (the reference's
    ``resolve_cli_backend``): ``--use-pallas`` is deprecated, warns and
    forwards to ``cuda`` (the twin of ``pallas``); an explicit
    ``--backend`` wins, with a warning that the alias was ignored.
    Neither flag → ``default``."""
    if use_pallas:
        import warnings
        if backend is None:
            warnings.warn("--use-pallas is deprecated; forwarding to "
                          "--backend cuda", DeprecationWarning,
                          stacklevel=2)
            return "cuda"
        if backend != "cuda":
            warnings.warn(f"--use-pallas ignored: explicit --backend "
                          f"{backend} wins", DeprecationWarning,
                          stacklevel=2)
    return backend or default


def cluster_major_variant(backend: str, dedup_factor: float, *,
                          threshold: float = CLUSTER_MAJOR_DEDUP_THRESHOLD
                          ) -> str:
    """Upgrade a query-major backend to its cluster-major twin when the
    batch dedup factor ``B·cr/U`` reaches ``threshold``."""
    if dedup_factor >= threshold:
        return _CM_TWIN.get(backend, backend)
    return backend


def cluster_major_feasible(batch: int, cr: int, n_clusters: int,
                           capacity: int) -> bool:
    """Shape guard of the auto upgrade: ``min(B·cr, c) ≤ cap``."""
    return min(batch * cr, n_clusters) <= capacity


# ---------------------------------------------------------------------------
# Scoring: the plain versions live beside the kernels
# ---------------------------------------------------------------------------

score_candidates = fts.score_candidates
dense_routed_topk = fts.routed_topk_plain


def merge_cluster_major(pair_scores, pair_ids, *, b: int, cr: int, k: int):
    """Fold the per-(query, route) partial lists ``(B·cr, k)`` into one
    top-k per query. Pair ``q·cr + r`` holds route ``r`` of query ``q``,
    so a stable top-k over ``(B, cr·k)`` ranks equal scores by route,
    then by row: the routed path's order. (The reference's scatter of
    roster slots to pairs happens inside the cluster-major kernel and
    its plain version.)"""
    per_v = pair_scores.reshape(b, cr * k)
    per_i = pair_ids.reshape(b, cr * k)
    scores, pos = topk_stable(per_v, k)
    return scores, torch.gather(per_i, 1, pos).to(torch.int32)


def dense_cluster_major(q_emb, q_loc, w_st, top_c, buf_emb, buf_loc, buf_ids,
                        w_hat, *, k: int, dist_max: float, buf_scale=None,
                        buf_attrs=None, q_filt=None):
    """Plain cluster-major path: plan → score each distinct cluster once
    against its roster → fold. Same contract as :func:`dense_routed_topk`."""
    b, cr = top_c.shape
    u, roster, _ = serving_lib.cluster_major_plan(
        top_c, n_clusters=buf_emb.shape[0])
    ps, pi = fts.cluster_major_partials_plain(
        q_emb, q_loc, w_st, u, roster, buf_emb, buf_loc, buf_ids, w_hat,
        k=k, dist_max=dist_max, cr=cr, buf_scale=buf_scale,
        buf_attrs=buf_attrs, q_filt=q_filt)
    return merge_cluster_major(ps, pi, b=b, cr=cr, k=k)


def _routed_topk(q_emb, q_loc, w, top_c, buffers: dict, w_hat, *, k: int,
                 backend: str, dist_max: float, precision: str,
                 q_filt=None):
    """Backend dispatch of the routed scan. ``backend`` is resolved.
    ``q_filt`` engages the filtered variants. Returns ``(ids, scores)``."""
    scale = buffers["scale"] if precision == "int8" else None
    attrs = buffers["attrs"] if q_filt is not None else None
    args = (q_emb, q_loc, w, top_c, buffers["emb"], buffers["loc"],
            buffers["ids"], w_hat)
    kw = dict(k=k, dist_max=dist_max, buf_scale=scale, buf_attrs=attrs,
              q_filt=q_filt)
    if backend == "cuda":
        score, ids = fts.fused_topk_score_routed(*args, **kw)
    elif backend == "cuda-cm":
        b, cr = top_c.shape
        u, roster, _ = serving_lib.cluster_major_plan(
            top_c, n_clusters=buffers["emb"].shape[0])
        ps, pi = fts.fused_topk_score_cluster_major(
            q_emb, q_loc, w, u, roster, buffers["emb"], buffers["loc"],
            buffers["ids"], w_hat, cr=cr, **kw)
        score, ids = merge_cluster_major(ps, pi, b=b, cr=cr, k=k)
    elif backend == "dense-cm":
        score, ids = dense_cluster_major(*args, **kw)
    else:
        score, ids = dense_routed_topk(*args, **kw)
    return ids, score


# ---------------------------------------------------------------------------
# Query-phase functions
# ---------------------------------------------------------------------------


def make_prefix_fn(*, cr: int = 1, weight_mode: str = "mlp") -> Callable:
    """encode → mixing weights → route: ``fn(rel, index, norm, q_tokens,
    q_mask, q_loc) -> (q_emb (B, d), w (B, 2), top_c (B, cr) int32)``."""
    @torch.no_grad()
    def prefix_fn(rel, index, norm, q_tokens, q_mask, q_loc):
        q_emb = relevance.encode_queries(rel, q_tokens, q_mask)
        feats = index_lib.build_features(q_emb, q_loc, norm)
        top_c, _ = index_lib.route_queries(index, feats, cr=cr)
        w = relevance.st_weights(rel, q_emb, weight_mode=weight_mode)
        return q_emb, w, top_c

    return prefix_fn


def delta_scan_plain(q_emb, q_loc, w, w_hat, rows, q_filt=None, *, k: int,
                     dist_max: float = 1.4142, precision: str = "f32"):
    """The plain version of the delta scan: ``score_candidates`` over
    every delta row for every query, then a stable top-k (lowest scan
    position first on a tie). Arguments as the function of
    :func:`make_delta_scan_fn`; ``k`` at most the padded row count.
    → ``(ids (B, k) int32, scores (B, k))``."""
    b = q_emb.shape[0]
    ids_eff = rows["ids"][0][None].expand(b, -1)
    if q_filt is not None:
        ok = filters_lib.predicate_mask(rows["attrs"], q_filt[:, None, :])
        ids_eff = torch.where(ok, ids_eff, torch.full_like(ids_eff, -1))
    st = score_candidates(q_emb, q_loc, w, rows["emb"][0], rows["loc"][0],
                          ids_eff, w_hat, dist_max=dist_max,
                          cand_scale=rows["scale"][0] if precision == "int8"
                          else None)                          # (B, m)
    vals, pos = topk_stable(st, k)
    return torch.gather(ids_eff, 1, pos).to(torch.int32), vals


def make_delta_scan_fn(*, k: int = 20, dist_max: float = 1.4142,
                       precision: str = "f32") -> Callable:
    """Scan of a delta segment's rows with no routing: every query sees
    every delta row. It takes the prefix's ``q_emb`` and ``w`` (the
    reference encodes the same tokens a second time with the same
    function, so reusing them keeps its ids). ``fn(q_emb (B, d), q_loc,
    w, w_hat, rows, q_filt | None) -> (ids (B, k), scores (B, k))`` with
    ``rows`` the snapshot's :attr:`~IndexSnapshot.delta_rows`.

    On a CUDA device the rows are one cluster of the routed kernel (every
    query routed to it, ``cr`` 1), whose scan order is the reference's
    tie order; on the CPU, :func:`delta_scan_plain`."""
    if precision not in index_lib.PRECISIONS:
        raise ValueError(f"precision must be one of {index_lib.PRECISIONS}, "
                         f"got {precision!r}")

    @torch.no_grad()
    def scan_fn(q_emb, q_loc, w, w_hat, rows, q_filt=None):
        kk = min(k, rows["ids"].shape[1])
        if q_emb.device.type == "cuda":
            top_c = torch.zeros((q_emb.shape[0], 1), dtype=torch.int32,
                                device=q_emb.device)
            vals, ids = fts.fused_topk_score_routed(
                q_emb, q_loc, w, top_c, rows["emb"], rows["loc"],
                rows["ids"], w_hat, k=kk, dist_max=dist_max,
                buf_scale=rows["scale"] if precision == "int8" else None,
                buf_attrs=None if q_filt is None else rows["attrs"],
                q_filt=q_filt)
        else:
            ids, vals = delta_scan_plain(q_emb, q_loc, w, w_hat, rows, q_filt,
                                         k=kk, dist_max=dist_max,
                                         precision=precision)
        if kk < k:
            vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
        return ids, vals

    return scan_fn


def make_query_fn(*, cr: int = 1, k: int = 20, backend: str,
                  dist_max: float = 1.4142, weight_mode: str = "mlp",
                  precision: str = "f32") -> Callable:
    """The query phase for one plan: ``fn(snapshot, q_tokens, q_mask,
    q_loc, q_filt=None, *, delta_rows=None) -> (ids (B, k), scores (B,
    k), delta ids, delta scores)`` as device tensors. The prefix runs
    once and feeds both scans; the delta pair is None when
    ``delta_rows`` is. ``backend`` must be resolved (not ``"auto"``)."""
    if precision not in index_lib.PRECISIONS:
        raise ValueError(f"precision must be one of {index_lib.PRECISIONS}, "
                         f"got {precision!r}")
    prefix = make_prefix_fn(cr=cr, weight_mode=weight_mode)
    delta_scan = make_delta_scan_fn(k=k, dist_max=dist_max,
                                    precision=precision)

    @torch.no_grad()
    def query_fn(snap, q_tokens, q_mask, q_loc, q_filt=None, *,
                 delta_rows=None):
        q_emb, w, top_c = prefix(snap.rel, snap.index, snap.norm, q_tokens,
                                 q_mask, q_loc)
        w_hat = snap.w_hat
        ids, scores = _routed_topk(q_emb, q_loc, w, top_c, snap.buffers,
                                   w_hat, k=k, backend=backend,
                                   dist_max=dist_max, precision=precision,
                                   q_filt=q_filt)
        if delta_rows is None:
            return ids, scores, None, None
        return (ids, scores) + delta_scan(q_emb, q_loc, w, w_hat, delta_rows,
                                          q_filt)

    return query_fn


def make_shard_topk_fn(*, k: int = 20, backend: str,
                       dist_max: float = 1.4142,
                       precision: str = "f32") -> Callable:
    """The per-shard scan of the sharded query phase: one shard's local
    buffers against the prefix's queries and LOCAL routes
    (``serving.localize_routes``; off-shard routes point at the
    sentinel, which scores ``(−1, NEG_INF)`` like padding).

    ``fn(w_hat, part, q_emb, q_loc, w, top_c, q_filt=None) -> (ids (B,
    k), scores (B, k))`` device tensors on the part's device, with
    ``part`` a dict of ``sharding.ClusterShards.parts``; ``q_filt (B, 4)``
    engages the filtered scan over ``part["attrs"]``. ``backend`` must be
    resolved: ``cuda`` and ``cuda-cm`` launch the routed and
    cluster-major kernels, the dense backends their plain versions. Each
    candidate scores as in the unsharded scan, so the per-shard lists
    merged by :func:`merge_shard_topk` give the unsharded top-k up to
    ties."""
    if precision not in index_lib.PRECISIONS:
        raise ValueError(f"precision must be one of {index_lib.PRECISIONS}, "
                         f"got {precision!r}")
    if backend not in _BACKEND_DEVICE:
        raise ValueError(f"make_shard_topk_fn: backend must be one of "
                         f"{tuple(_BACKEND_DEVICE)}, got {backend!r}")

    @torch.no_grad()
    def shard_fn(w_hat, part, q_emb, q_loc, w, top_c, q_filt=None):
        return _routed_topk(q_emb, q_loc, w, top_c, part, w_hat, k=k,
                            backend=backend, dist_max=dist_max,
                            precision=precision, q_filt=q_filt)

    return shard_fn


def merge_shard_topk(parts, *, k: Optional[int] = None):
    """Pairwise tree-reduce per-shard partial top-k lists (host, numpy).

    ``parts`` is a sequence of per-shard ``(ids (B, m), scores (B, m))``
    in shard order, merged pairwise (each level keeps the best ``k``)
    until one list remains; ``k`` defaults to the partial width. Each
    level's sort is STABLE with the lower-index operand first, so an
    exact cross-shard tie resolves in shard order: the one divergence
    from single-device tie order. Returns ``(ids (B, k) int32, scores
    (B, k) f32)`` descending."""
    items = [(np.asarray(i), np.asarray(v, np.float32)) for i, v in parts]
    if not items:
        raise ValueError("merge_shard_topk: no partial lists")
    if k is None:
        k = items[0][0].shape[-1]

    def merge2(a, b):
        ci = np.concatenate([a[0], b[0]], axis=-1)
        cv = np.concatenate([a[1], b[1]], axis=-1)
        order = np.argsort(-cv, axis=-1, kind="stable")[..., :k]
        return (np.take_along_axis(ci, order, axis=-1),
                np.take_along_axis(cv, order, axis=-1))

    while len(items) > 1:
        nxt = [merge2(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    ids, scores = items[0]
    return (ids[..., :k].astype(np.int32),
            scores[..., :k].astype(np.float32))


def merge_delta(base_ids, base_scores, delta_ids=None, delta_scores=None, *,
                tombstones=None, k=None):
    """Merge a delta scan's top-k into the base one (host, numpy).

    Tombstoned base entries become ``(-1, NEG_INF)``; the stable sort puts
    base entries first on an exact tie. Returns ``(ids (B, k) int32,
    scores (B, k) f32)``; ``k`` defaults to the base width."""
    base_ids = np.asarray(base_ids)
    base_scores = np.asarray(base_scores, np.float32)
    if k is None:
        k = base_ids.shape[-1]
    if tombstones is not None and len(tombstones):
        dead = np.isin(base_ids, np.asarray(tombstones))
        base_ids = np.where(dead, -1, base_ids)
        base_scores = np.where(dead, NEG_INF, base_scores)
    if delta_ids is None:
        cat_i, cat_v = base_ids, base_scores
    else:
        cat_i = np.concatenate([base_ids, np.asarray(delta_ids)], axis=-1)
        cat_v = np.concatenate(
            [base_scores, np.asarray(delta_scores, np.float32)], axis=-1)
    order = np.argsort(-cat_v, axis=-1, kind="stable")[..., :k]
    ids = np.take_along_axis(cat_i, order, axis=-1).astype(np.int32)
    scores = np.take_along_axis(cat_v, order, axis=-1).astype(np.float32)
    return ids, scores


# ---------------------------------------------------------------------------
# Static-shape batching
# ---------------------------------------------------------------------------


def pad_leading(arr: np.ndarray, batch: int) -> np.ndarray:
    """Zero-pad axis 0 of ``arr`` up to ``batch`` rows."""
    n = arr.shape[0]
    if n == batch:
        return arr
    if n > batch:
        raise ValueError(f"{n} rows exceed the batch of {batch}")
    return np.pad(arr, ((0, batch - n),) + ((0, 0),) * (arr.ndim - 1))


def run_batched(fn: Callable, arrays: Sequence[np.ndarray], *, batch: int,
                device):
    """Map ``fn`` over ``arrays`` in chunks of exactly ``batch`` rows.

    Each chunk is zero-padded to ``batch`` rows and moved to ``device``;
    the padded output rows are trimmed. Chunk ``i``'s results are copied
    to the host only after chunk ``i+1`` is dispatched, so the copy
    overlaps the next chunk's device work. Returns numpy arrays (a tuple
    when ``fn`` returns one; an output that is None stays None)."""
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays):
        raise ValueError(f"leading dims differ: {[a.shape for a in arrays]}")
    def host(r, rows):
        return None if r is None else r.cpu().numpy()[:rows]

    outs, pending = None, None
    for s in range(0, n, batch):
        e = min(s + batch, n)
        chunk = [torch.from_numpy(pad_leading(np.asarray(a[s:e]), batch))
                 .to(device) for a in arrays]
        res = fn(*chunk)
        res = res if isinstance(res, (tuple, list)) else (res,)
        if outs is None:
            outs = [[] for _ in res]
        if pending is not None:
            for o, r in zip(outs, pending[0]):
                o.append(host(r, pending[1]))
        pending = (res, e - s)
    if pending is not None:
        for o, r in zip(outs, pending[0]):
            o.append(host(r, pending[1]))
    cat = tuple(None if o[0] is None else np.concatenate(o, axis=0)
                for o in outs)
    return cat if len(cat) > 1 else cat[0]


def _cached_for(cache: dict):
    """The placement a per-placement cache was built for, or None. The
    cache holds it weakly: a published-over placement's parts are freed
    with it, not kept alive by the cache."""
    ref = cache.get("key")
    return None if ref is None else ref()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class QueryEngine:
    """Query executor over an immutable :class:`IndexSnapshot` on one
    device, with an LRU cache of plans keyed ``(batch, k, cr, backend,
    precision, filtered)``.

    ``device`` (default ``"cuda"``) is where the snapshot is served; a
    snapshot elsewhere is moved there (a sharded one moves its modules
    only: its parts stay where the mesh put them, its global buffers on
    the host). Raises when CUDA is asked for and absent."""

    def __init__(self, snapshot, *, backend: str = "auto", device="cuda"):
        dev = require_device(device)
        full_f32_products(dev)
        self.device = dev
        self._snapshot = snapshot.to(dev)
        self.backend = resolve_backend(backend, dev)
        self._auto_cm = backend == "auto"
        self.last_dedup_factor: Optional[float] = None
        # the sharded engine's coverage annotations (the reference's
        # DESIGN.md §15), read by the server: an unsharded snapshot is
        # always fully covered
        self.last_coverage = 1.0
        self.last_down_shards: tuple = ()
        self._plans: "collections.OrderedDict" = collections.OrderedDict()
        self._prefix_plans: dict = {}
        # shard fault tolerance: health and hedging of the sharded scan
        self.shard_stats = {"hedged_scans": 0, "scan_retries": 0,
                            "down_skips": 0, "host_scans": 0,
                            "recoveries": 0}
        self.shard_retries = SHARD_SCAN_RETRIES
        self.shard_backoff_ms = SHARD_RETRY_BACKOFF_MS
        self.shard_backoff_max_ms = SHARD_RETRY_BACKOFF_MAX_MS
        self.shard_down_after = SHARD_DOWN_AFTER
        self.hedge_probe_every = SHARD_HEDGE_PROBE_EVERY
        self._shard_health = None       # sized at the first sharded query
        self._shard_monitor = None      # StragglerMonitor of device scans
        self._hedged: dict = {}         # shard → hedged-scan count
        # shard → seconds one scan of its host replica costs (the copy to
        # the card and the scan): the floor of the straggler rule, for the
        # placement that ``_floors_for`` holds weakly
        self.replica_scan_s: dict = {}
        self._floors_for = None
        self._host_copy_rate: Optional[float] = None   # bytes/s, measured
        self._host_parts: dict = {}     # host replicas of one placement
        self._shard_maps: dict = {}     # its placement maps on the device

    @property
    def snapshot(self):
        return self._snapshot

    def query_fn(self, *, k: int, cr: int, backend: Optional[str] = None,
                 batch: Optional[int] = None,
                 precision: Optional[str] = None, filtered: bool = False):
        backend = self.backend if backend is None else backend
        if precision is None:
            precision = self._snapshot.meta.precision
        return self._cached_plan(
            (batch, k, cr, backend, precision, filtered),
            lambda: make_query_fn(
                cr=cr, k=k, backend=backend, dist_max=self._snapshot.dist_max,
                weight_mode=self._snapshot.meta.weight_mode,
                precision=precision))

    def prefix_fn(self, *, cr: int):
        """The prefix (:func:`make_prefix_fn`) for ``cr``, one per engine:
        the standing-query registry encodes and routes with it."""
        if cr not in self._prefix_plans:
            self._prefix_plans[cr] = make_prefix_fn(
                cr=cr, weight_mode=self._snapshot.meta.weight_mode)
        return self._prefix_plans[cr]

    def _cached_plan(self, key, make):
        """The plan LRU: ``make()`` under ``key`` unless cached."""
        if key not in self._plans:
            while len(self._plans) >= DEFAULT_PLAN_CACHE_SIZE:
                self._plans.popitem(last=False)
            self._plans[key] = make()
        self._plans.move_to_end(key)
        return self._plans[key]

    def shard_topk_fn(self, *, k: int, backend: Optional[str] = None,
                      batch: Optional[int] = None,
                      precision: Optional[str] = None):
        """The per-shard scan (:func:`make_shard_topk_fn`), cached in the
        plan LRU under ``("shard", batch, k, backend, precision)``: one
        function serves every shard."""
        backend = self.backend if backend is None else backend
        if precision is None:
            precision = self._snapshot.meta.precision
        return self._cached_plan(
            ("shard", batch, k, backend, precision),
            lambda: make_shard_topk_fn(k=k, backend=backend,
                                       dist_max=self._snapshot.dist_max,
                                       precision=precision))

    def delta_scan_fn(self, *, k: int, precision: str):
        """The delta scan (:func:`make_delta_scan_fn`) of the sharded
        path, cached in the plan LRU under ``("delta", k, precision)``."""
        return self._cached_plan(
            ("delta", k, precision),
            lambda: make_delta_scan_fn(k=k, dist_max=self._snapshot.dist_max,
                                       precision=precision))

    def _shard_state(self, n_shards: int):
        """Lazy per-mesh health state: a ``ShardHealth`` and a
        ``StragglerMonitor`` sized to the shard count (made anew when a
        publish changes the mesh width)."""
        from repro_torch.distributed import resilience as resilience_lib

        if (self._shard_health is None
                or self._shard_health.n_shards != n_shards):
            self._shard_health = resilience_lib.ShardHealth(
                n_shards, down_after=self.shard_down_after)
            self._shard_monitor = resilience_lib.StragglerMonitor()
            self._hedged = {}
        return self._shard_health

    def _host_shard_part(self, snap, shards, s: int) -> dict:
        """The host replica of shard ``s``: its local buffers rebuilt from
        the snapshot's global host buffers with the layout and fills of
        ``sharding.shard_cluster_buffers``, in pinned pages on a CUDA
        host. A scan of it copies it to the engine's device and runs the
        same scan as the device part, so a hedged or retried scan gives
        the device scan's answer. Cached per placement object (a publish
        or a recovery changes it)."""
        from repro_torch.distributed import sharding as sharding_lib

        cache = self._host_parts
        if _cached_for(cache) is not shards:
            self._host_parts = cache = {"key": weakref.ref(shards)}
        part = cache.get(s)
        if part is None:
            part = sharding_lib.shard_part(
                snap.buffers, shards.group(s), shards.c_local + 1,
                torch.device("cpu"), pin=True)
            cache[s] = part
        return part

    def host_copy_rate(self) -> float:
        """Bytes per second from pinned host memory to the engine's device:
        the best of three copies of ``HOST_COPY_PROBE_BYTES``, measured
        once per engine (what a hedged scan's replica copy runs at)."""
        if self._host_copy_rate is None:
            src = torch.empty(HOST_COPY_PROBE_BYTES, dtype=torch.uint8,
                              pin_memory=True)
            dst = torch.empty_like(src, device=self.device)
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                dst.copy_(src, non_blocking=True)
                torch.cuda.synchronize(self.device)
                best = min(best, time.perf_counter() - t0)
            self._host_copy_rate = src.numel() / best
        return self._host_copy_rate

    def _placement_maps(self, shards):
        """``shard_of`` / ``local_of`` as tensors on the engine's device,
        cached per placement object."""
        if _cached_for(self._shard_maps) is not shards:
            self._shard_maps = {
                "key": weakref.ref(shards),
                "maps": (torch.from_numpy(shards.shard_of).to(self.device),
                         torch.from_numpy(shards.local_of).to(self.device))}
        return self._shard_maps["maps"]

    def down_signature(self) -> Tuple[int, ...]:
        """The DOWN shard set: the server's cache-key component that keeps
        a degraded answer from serving as a fully covered one."""
        health = self._shard_health
        return () if health is None else health.down_shards()

    def recover_shard(self, s: int):
        """Online shard recovery: re-materialize shard ``s``'s part on its
        device from the snapshot's global host buffers (the layout of
        ``shard_cluster_buffers``), publish the patched placement in one
        assignment, and mark the shard UP. Placement only: no version
        bump, no content change, no notification. Returns the snapshot
        now served."""
        snap = self._snapshot
        shards = snap.shards
        if shards is None:
            raise ValueError("recover_shard: snapshot is not mesh-sharded")
        if not 0 <= s < shards.n_shards:
            raise ValueError(f"recover_shard: shard {s} out of range "
                             f"0..{shards.n_shards - 1}")
        host = self._host_shard_part(snap, shards, s)
        new_part = {key: arr.to(shards.devices[s], copy=True)
                    for key, arr in host.items()}
        parts = list(shards.parts)
        parts[s] = new_part
        new_shards = dataclasses.replace(shards, parts=tuple(parts))
        # one reference assignment, like publish(): a concurrent query
        # sees the old placement or the new one, never a mix
        self._snapshot = dataclasses.replace(snap, shards=new_shards)
        self._host_parts = {}
        if self._shard_health is not None:
            self._shard_health.mark_up(s)
        self._hedged.pop(s, None)
        self.shard_stats["recoveries"] += 1
        return self._snapshot

    def _query_sharded(self, snap, arrays, *, k: int, cr: int, batch: int,
                       backend: str, filtered: bool, rows):
        """The mesh-sharded query: the prefix once per chunk on the
        engine's device, one scan per shard over its part with localized
        routes (on the part's device), the host tree merge, and the delta
        scan from the same prefix. → ``(ids, scores, delta ids, delta
        scores)`` numpy, as the unsharded plan.

        Fault tolerance: every shard scan is timed (synced) into
        ``ShardHealth``; a failure retries on the host replica with
        doubling, capped backoff; a shard the ``StragglerMonitor`` flags
        slow is hedged: its scans run on the replica, with a device probe
        every ``hedge_probe_every``-th scan; a DOWN shard is skipped and
        the others merge into a degraded answer whose coverage (routes
        scanned / routes, padded rows included) is ``last_coverage``.
        Raises ``ShardUnavailable`` only when no shard can serve.

        A hedge must pay: a flagged shard is hedged only if its device
        scan took longer than one scan of its replica
        (``replica_scan_s``). Where the part lives on the card, a replica
        scan copies the whole part from pinned host memory and then scans
        it, so its cost is the part's bytes at the measured host-to-card
        copy rate (:meth:`host_copy_rate`) plus the shard's median device
        scan, taken once per placement, the first time the shard is
        flagged; no replica is built for it. A CPU part's replica is on its own device: the
        reference's rule holds as it is, unless the caller sets the
        shard's entry."""
        from repro_torch.distributed import resilience as resilience_lib

        shards = snap.shards
        want = _BACKEND_DEVICE[backend]
        if any(d.type != want for d in shards.devices):
            raise ValueError(
                f"backend {backend!r} scans parts on {want}; this "
                f"snapshot's parts are on "
                f"{sorted({str(d) for d in shards.devices})}")
        dev = self.device
        prefix = self.prefix_fn(cr=cr)
        precision = snap.meta.precision
        sfn = self.shard_topk_fn(k=k, backend=backend, batch=batch,
                                 precision=precision)
        delta_scan = (None if rows is None else
                      self.delta_scan_fn(k=k, precision=precision))
        w_hat = snap.w_hat
        w_hat_on = {dev: w_hat}
        health = self._shard_state(shards.n_shards)
        if self._floors_for is None or self._floors_for() is not shards:
            # a publish, re-shard or recovery places other parts, even at
            # the same shard count: their floors are measured anew
            self._floors_for = weakref.ref(shards)
            self.replica_scan_s = {}
        monitor = self._shard_monitor
        shard_of_d, local_of_d = self._placement_maps(shards)
        parts = snap.scan_parts
        tomb = (snap.delta.tombstone_array()
                if snap.delta is not None and snap.delta.n_tombstones
                else None)
        coverage = [0, 0]               # routes scanned / routes
        down_seen = set()

        def run_scan(s, part, inputs, *, on_device):
            # scan_error fires on device AND replica attempts (the
            # shard's data is unscannable); scan_slow models a slow
            # device only
            if on_device:
                faults_lib.fire("shard.scan_slow", shard=s)
            faults_lib.fire("shard.scan_error", shard=s)
            pdev = part["emb"].device
            if pdev not in w_hat_on:
                w_hat_on[pdev] = w_hat.to(pdev)
            q_emb, q_loc, w, local_c, qf = (
                None if x is None else x.to(pdev) for x in inputs)
            with (torch.cuda.device(pdev) if pdev.type == "cuda"
                  else contextlib.nullcontext()):
                ids, scores = sfn(w_hat_on[pdev], part, q_emb, q_loc, w,
                                  local_c, qf)
            # the copy to the host syncs: the time fed to ShardHealth is
            # this shard's scan, not what was queued behind it
            return ids.cpu().numpy(), scores.cpu().numpy()

        def replica(s):
            host = self._host_shard_part(snap, shards, s)
            part = {key: v.to(dev, non_blocking=True)
                    for key, v in host.items()}
            if tomb is not None:
                part["ids"] = delta_lib.mask_tombstones(part["ids"], tomb)
            return part

        def hedge_floor(s, part):
            """What one scan of shard ``s``'s replica costs (seconds): its
            copy at the measured rate and a median device scan, for a part
            on the card; 0 for a CPU part unless set."""
            if s not in self.replica_scan_s:
                if part["emb"].device.type == "cpu":
                    return 0.0
                nbytes = sum(v.numel() * v.element_size()
                             for v in part.values())
                lat = sorted(monitor.latencies[f"shard{s}"])
                self.replica_scan_s[s] = (nbytes / self.host_copy_rate()
                                          + lat[len(lat) // 2])
            return self.replica_scan_s[s]

        def scan_shard(s, part, inputs):
            """One shard's partial ``(ids, scores)``, or None when it
            could not be scanned this chunk."""
            try:
                faults_lib.fire("shard.device_lost", shard=s)
            except Exception:
                health.mark_down(s)
                return None
            hedge = s in self._hedged
            probe = False
            if hedge:
                # hedged: serve from the replica, but probe the device
                # every Nth scan so a recovered device is noticed
                self._hedged[s] += 1
                probe = self._hedged[s] % self.hedge_probe_every == 0
            delay_ms = self.shard_backoff_ms
            for attempt in range(1 + self.shard_retries):
                if attempt > 0:
                    self.shard_stats["scan_retries"] += 1
                    if delay_ms > 0:
                        time.sleep(min(delay_ms,
                                       self.shard_backoff_max_ms) / 1e3)
                    delay_ms = min(delay_ms * 2, self.shard_backoff_max_ms)
                # retries go to the host replica: the device already
                # failed once this chunk
                on_host = (hedge and not probe) or attempt > 0
                try:
                    t0 = time.perf_counter()
                    if on_host:
                        out = run_scan(s, replica(s), inputs,
                                       on_device=False)
                        self.shard_stats["host_scans"] += 1
                        if hedge and not probe:
                            self.shard_stats["hedged_scans"] += 1
                    else:
                        out = run_scan(s, part, inputs, on_device=True)
                    dt = time.perf_counter() - t0
                    health.record_success(s, dt)
                    if not on_host:
                        # only device times feed the straggler stream: a
                        # replica scan must not mask the slow device
                        monitor.record(f"shard{s}", dt)
                        if (monitor.slow(f"shard{s}")
                                and dt > hedge_floor(s, part)):
                            self._hedged.setdefault(s, 0)
                        elif hedge:
                            self._hedged.pop(s, None)   # probe was fast
                    return out
                except Exception:
                    health.record_failure(s)
                    if health.is_down(s):
                        return None
            return None                  # retries spent, not DOWN yet

        def chunk_fn(t, m, l, *rest):
            q_emb, w, top_c = prefix(snap.rel, snap.index, snap.norm, t, m, l)
            qf = rest[0] if filtered else None
            routes_per = torch.bincount(
                shard_of_d[top_c.long()].reshape(-1),
                minlength=shards.n_shards).cpu().numpy()
            coverage[1] += int(top_c.numel())
            partials = []
            for s, part in enumerate(parts):
                if health.is_down(s):
                    self.shard_stats["down_skips"] += 1
                    down_seen.add(s)
                    continue
                local_c = serving_lib.localize_routes(
                    top_c, shard_of_d, local_of_d, s,
                    sentinel=shards.sentinel)
                out = scan_shard(s, part, (q_emb, l, w, local_c, qf))
                if out is None:
                    if health.is_down(s):
                        down_seen.add(s)
                    continue
                coverage[0] += int(routes_per[s])
                partials.append(out)
            if not partials:
                raise resilience_lib.ShardUnavailable(
                    f"all {shards.n_shards} shards down/unscannable — "
                    f"no partial top-k lists to merge")
            ids, scores = merge_shard_topk(partials, k=k)
            base = (torch.from_numpy(ids), torch.from_numpy(scores))
            if delta_scan is None:
                return base + (None, None)
            return base + delta_scan(q_emb, l, w, w_hat, rows, qf)

        out = run_batched(chunk_fn, arrays, batch=batch, device=dev)
        self.last_coverage = (coverage[0] / coverage[1]
                              if coverage[1] else 1.0)
        self.last_down_shards = tuple(sorted(down_seen))
        return out

    def route(self, q_tokens, q_mask, q_loc, *, cr: int = 1, snapshot=None):
        """Route-only prefix → ``top_c (n, cr)`` int32 device tensor."""
        snap = self._snapshot if snapshot is None else snapshot
        dev = snap.device
        with torch.no_grad():
            q_emb = relevance.encode_queries(
                snap.rel, torch.as_tensor(q_tokens).to(dev),
                torch.as_tensor(q_mask).to(dev))
            feats = index_lib.build_features(
                q_emb, torch.as_tensor(q_loc).to(dev), snap.norm)
            return index_lib.route_queries(snap.index, feats, cr=cr)[0]

    def pick_backend(self, q_tokens, q_mask, q_loc, *, cr: int, batch: int,
                     snapshot=None, base: Optional[str] = None) -> str:
        """Per-batch backend of an auto request: upgrade ``base`` to its
        cluster-major twin when the dedup factor ``B·cr/U`` reaches the
        threshold — structurally when the batch saturates the clusters,
        else measured by routing the first chunk."""
        snap = self._snapshot if snapshot is None else snapshot
        base = self.backend if base is None else base
        c, cap = snap.buffers["emb"].shape[:2]
        if not cluster_major_feasible(batch, cr, c, cap):
            self.last_dedup_factor = None
            return base
        eff = min(batch, q_tokens.shape[0])
        dedup = (eff * cr) / min(eff * cr, c)
        if dedup < CLUSTER_MAJOR_DEDUP_THRESHOLD:
            tok = pad_leading(np.asarray(q_tokens[:eff]), batch)
            msk = pad_leading(np.asarray(q_mask[:eff]), batch)
            loc = pad_leading(np.asarray(q_loc[:eff]), batch)
            top_c = self.route(tok, msk, loc, cr=cr, snapshot=snap)[:eff]
            dedup = (eff * cr) / max(int(torch.unique(top_c).numel()), 1)
        self.last_dedup_factor = float(dedup)
        return cluster_major_variant(base, dedup)

    def publish(self, snapshot):
        """Swap the served snapshot in one assignment; returns the old
        one. A snapshot of another model config (``cfg_digest``) is
        refused; one on another device is moved to the engine's. The
        plan cache survives."""
        old = self._snapshot
        if snapshot.meta.cfg_digest != old.meta.cfg_digest:
            raise ValueError(
                f"publish: snapshot cfg_digest {snapshot.meta.cfg_digest} "
                f"!= engine's {old.meta.cfg_digest}; build a new engine "
                f"for a different model config")
        self._snapshot = snapshot.to(self.device)
        return old

    def query(self, q_tokens, q_mask, q_loc, *, k: int = 20, cr: int = 1,
              batch: int = 256, backend: Optional[str] = None,
              snapshot=None, filters=None):
        """Batched routed query → ``(ids (n, k), scores (n, k))`` numpy.

        Reads the snapshot reference once. ``backend`` overrides the
        engine's for this call; an auto request picks query- or
        cluster-major per call (:meth:`pick_backend`). ``filters``: None,
        one :class:`~repro_torch.core.filters.FilterSpec`, or one per row.
        A delta segment's rows (held on the device,
        ``IndexSnapshot.delta_rows``) are scanned from the same prefix as
        the base and merged on the host; its tombstoned ids are masked out
        of the base scan (``IndexSnapshot.scan_view``)."""
        snap = self._snapshot if snapshot is None else snapshot
        # coverage of this call: 1.0 unless the sharded path loses a shard
        self.last_coverage = 1.0
        self.last_down_shards = ()
        q_tokens, q_mask, q_loc = (np.asarray(a) for a in
                                   (q_tokens, q_mask, q_loc))
        fvals, filtered = filters_lib.compile_filters(filters,
                                                      q_tokens.shape[0])
        if backend == "auto" or (backend is None and self._auto_cm):
            base = resolve_backend("auto", snap.device)
            backend = self.pick_backend(q_tokens, q_mask, q_loc, cr=cr,
                                        batch=batch, snapshot=snap, base=base)
        elif backend is not None:
            backend = resolve_backend(backend, snap.device)
        delta = snap.delta
        use_delta = delta is not None and not delta.is_empty
        rows = snap.delta_rows if use_delta else None
        if backend is None:
            backend = self.backend
        arrays = [q_tokens, q_mask, q_loc] + ([fvals] if filtered else [])
        if snap.shards is not None:
            # per-shard scans and the host tree merge, before the same
            # delta merge below
            ids, scores, d_ids, d_scores = self._query_sharded(
                snap, arrays, k=k, cr=cr, batch=batch, backend=backend,
                filtered=filtered, rows=rows)
        else:
            scan_snap = snap.scan_view
            fn = self.query_fn(k=k, cr=cr, backend=backend, batch=batch,
                               precision=snap.meta.precision,
                               filtered=filtered)
            ids, scores, d_ids, d_scores = run_batched(
                lambda *a: fn(scan_snap, *a, delta_rows=rows), arrays,
                batch=batch, device=snap.device)
        if not use_delta:
            return ids, scores
        return merge_delta(ids, scores, d_ids, d_scores,
                           tombstones=delta.tombstone_array(), k=k)
