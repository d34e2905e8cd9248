"""Streaming serving stack over the query engine (reference:
``repro.core.server``, DESIGN.md §7).

The port keeps the reference's surface, counters and semantics: requests
arrive as numpy rows, the engine moves each flush to its device (the
``cuda`` / ``cuda-cm`` kernels on a CUDA snapshot, ``dense`` /
``dense-cm`` on a CPU one), and every write is logged (numpy arrays on
the host) before it is published. One difference, in the circuit
breaker: the reference degrades a failing ``pallas`` flush onto the
bit-identical ``dense`` backend. In the port ``dense`` runs only on CPU
snapshots and nothing on the card gives way to a plain version, so
:meth:`StreamingServer._fallback_backend` names a fallback only when it
runs on the engine's own device: on the card the breaker never opens and
a failed flush reaches its own futures (a retry, or a poisoned request);
on the CPU an ``auto`` server degrades to ``dense`` as the reference's
does.

The engine (core/engine.py) answers *batches*; real traffic arrives as
*individual* requests. This module is the production-shaped layer in
between — everything a long-lived serving process needs so that no user
request pays warm-up latency, repeated work, or a ragged batch shape:

* :class:`StreamingServer` — an **async micro-batcher**. ``await
  server.submit(tokens, mask, loc)`` enqueues one request; the queue is
  flushed into a single engine call when it reaches the configured
  static batch size (*size* flush) or when the oldest request has waited
  ``max_delay_ms`` (*deadline* flush). Flushes go through
  ``QueryEngine.query`` → ``engine.run_batched``, so a partial flush is
  zero-padded to the plan's batch shape by exactly the same rule as any
  direct engine call — micro-batched results are bit-identical to
  offline ones at a fixed backend (tests/test_torch_server.py; an AUTO
  engine picks query- vs cluster-major per batch, DESIGN.md §10, so
  differently-composed batches are bit-compatible modulo tie order
  within equal scores).

* a **two-tier result cache** that exploits workload skew (WISK's
  observation: real query logs are heavily repeated):

  - *exact tier* — LRU keyed on the full request bytes
    ``(k, cr, tokens, mask, loc)``; a repeat of a previously answered
    request returns without touching the engine.
  - *near-duplicate tier* (opt-in via ``near_cells > 0``) — keyed on the
    **keyword signature** (sorted unique token ids) plus the **spatial
    cell** (location quantized to a ``near_cells × near_cells`` grid).
    Two queries with the same keywords issued a few meters apart share
    one answer. This tier is an *approximation* — word order and
    in-cell displacement are dropped — so it is off by default and
    meant for skew-heavy traffic where the recall cost is measured.

  Identical requests that are *in flight* (submitted before the first
  copy's flush completed) are coalesced onto one future instead of
  occupying two batch slots.

* an **LSM-style write path** (DESIGN.md §11) — :meth:`insert_objects`
  / :meth:`delete_objects` append to the snapshot's small mutable
  **delta segment** (core/delta.py) in O(batch) and publish the
  successor (``snapshot.with_delta`` — ``meta.version`` + 1); queries
  brute-force scan the delta and merge it into the base top-k
  (``engine.merge_delta``), with deletes as tombstones. When the delta
  crosses ``delta_threshold`` rows+tombstones — or, with
  ``max_imbalance`` set, when the live cluster sizes degrade past that
  imbalance-factor bound — a background **compaction**
  (``snapshot.compact``: the §4.3 delete/insert fold, one version
  bump) runs on the next event-loop tick, between flushes, and
  publishes the folded base. ``delta_threshold=0`` disables the delta
  entirely: every write folds eagerly through ``with_buffers``
  (O(index) per batch — the legacy path, kept as the bench baseline).

* **atomic snapshot publication** — the server never mutates the
  engine's resident state. Writes derive the successor snapshot and
  :meth:`publish` it: one engine reference swap plus a cache clear in
  the same event-loop step. Every cache key additionally embeds
  ``snapshot.meta.version``, so even a stale entry could never be
  served against the wrong index generation. A flush pins the snapshot
  it started with (passed explicitly into ``engine.query``), so
  requests already being scored finish on the OLD snapshot — no torn
  reads — while everything still queued flushes on the new one.

* a **warm-up manager** — :meth:`warmup` runs the configured (batch,
  backend) shapes through the *same* plan the flush path uses, so the
  first live request finds the plan built and the kernels loaded.
  Per-shape seconds are recorded in the stats block.

The event loop is single-threaded and the engine call blocks it for the
duration of one batch — the right model for a single-host accelerator
where query batches are executed serially anyway. A multi-host front
tier would run one server per accelerator behind a router.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core import cluster_metrics as cm
from repro_torch.core import delta as delta_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import filters as filters_lib
from repro_torch.core import index as index_lib
from repro_torch.core import wal as wal_lib
from repro_torch.distributed import resilience as resilience_lib


class Overloaded(RuntimeError):
    """Admission refused: the pending queue is at ``max_queue``. The
    caller sees this at submit time — load shedding, not a hang."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline (``request_timeout_ms``) passed before its
    batch launched; it was shed instead of scored (DESIGN.md §14)."""


# ---------------------------------------------------------------------------
# Config + stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Knobs of the streaming server (DESIGN.md §7).

    batch_size      static batch shape of every engine call; a full
                    queue flushes immediately ("size" flush)
    max_delay_ms    deadline flush: the oldest queued request never waits
                    longer than this before its batch is launched
    k, cr           top-k size and routed-clusters fanout of every answer
    backend         engine backend for flushes (any of engine.BACKENDS,
                    e.g. "cuda-cm" to force cluster-major batched
                    execution; None → the engine's own pick — an auto
                    engine then chooses query- vs cluster-major per
                    micro-batch from its dedup factor, DESIGN.md §10)
    cache_size      exact-tier LRU entries
    near_cells      near-duplicate tier grid resolution per axis
                    (0 disables the tier — the default: it approximates)
    near_cache_size near-tier LRU entries
    delta_threshold compaction trigger: fold the delta into the base
                    once ``delta_rows + tombstones`` reaches this.
                    0 disables the delta path entirely — every write
                    eagerly rebuilds buffers (O(index), the legacy
                    behavior and the churn-bench baseline)
    max_imbalance   optional second trigger: compact when the LIVE
                    per-cluster sizes' imbalance factor
                    (cluster_metrics.imbalance_factor; uniform = 1.0)
                    exceeds this bound. 0 disables (the default —
                    the check is O(index) per write batch)
    spill           §4.3 spill hops for insert routing (both the delta
                    compaction fold and the eager path)

    Resilience knobs (DESIGN.md §14):

    wal_dir         directory for the write-ahead log (core/wal.py).
                    None (default) disables durability: acknowledged
                    writes in the delta segment die with the process.
                    Set → every insert/delete batch is logged BEFORE
                    its publish; ``checkpoint()`` truncates the log
    wal_fsync       fsync each WAL append (durable ack; default) vs
                    OS-buffered (lower write latency, bounded loss)
    max_queue       admission bound: a submit arriving with this many
                    requests already pending raises :class:`Overloaded`
                    instead of growing the queue. 0 = unbounded
    request_timeout_ms  per-request deadline: a request still queued
                    when its deadline passes is shed with
                    :class:`DeadlineExceeded` at the next flush instead
                    of riding an already-late batch. 0 = no deadlines
    breaker_threshold   consecutive engine-call failures that trip the
                    circuit breaker onto the dense fallback backend
                    (cuda→dense, cuda-cm→dense-cm, auto→dense) when that
                    fallback runs on the engine's device — on a CPU
                    engine only (:meth:`StreamingServer.
                    _fallback_backend`); a no-op otherwise. 0 disables
                    the breaker
    breaker_probe_every successful fallback flushes before the breaker
                    half-opens and the primary backend is probed again
    retry_backoff_ms    base backoff before retrying the halves of a
                    failed multi-request flush (doubles per bisection
                    level, capped at retry_backoff_max_ms)
    retry_backoff_max_ms  backoff cap for the bisection retry path
    retry_jitter    full-jitter fraction on the bisection backoff: each
                    sleep is scaled by a factor drawn uniformly from
                    ``[1 - retry_jitter, 1]`` so co-failing flushes
                    don't retry in lockstep. 0 disables (pure doubling)
    retry_seed      seed of the jitter stream — the backoff sequence is
                    deterministic per server instance (pinnable in tests)
    wal_max_bytes   WAL growth bound (DESIGN.md §15): once the log file
                    exceeds this many bytes after a write, the server
                    schedules :meth:`checkpoint` (compact + save +
                    truncate) into ``snapshot_dir`` off the write path.
                    0 (default) disables; > 0 requires both ``wal_dir``
                    and ``snapshot_dir``
    snapshot_dir    where the auto-checkpoint commits snapshots
    """
    batch_size: int = 64
    max_delay_ms: float = 2.0
    k: int = 10
    cr: int = 1
    backend: Optional[str] = None
    cache_size: int = 8192
    near_cells: int = 0
    near_cache_size: int = 8192
    delta_threshold: int = 1024
    max_imbalance: float = 0.0
    spill: int = 3
    wal_dir: Optional[str] = None
    wal_fsync: bool = True
    max_queue: int = 0
    request_timeout_ms: float = 0.0
    breaker_threshold: int = 3
    breaker_probe_every: int = 8
    retry_backoff_ms: float = 1.0
    retry_backoff_max_ms: float = 50.0
    retry_jitter: float = 0.25
    retry_seed: int = 0
    wal_max_bytes: int = 0
    snapshot_dir: Optional[str] = None


LATENCY_WINDOW = 65536       # sliding window of most-recent request latencies


@dataclasses.dataclass
class ServerStats:
    """Counters + per-request latencies; read via StreamingServer.metrics().

    ``latencies_s`` is a bounded deque (most recent :data:`LATENCY_WINDOW`
    requests) so a long-lived server neither grows without bound nor pays
    an ever-increasing percentile cost in ``metrics()``.
    """
    n_requests: int = 0
    exact_hits: int = 0
    near_hits: int = 0
    coalesced: int = 0
    engine_batches: int = 0
    engine_queries: int = 0            # real (unpadded) rows sent on-device
    flushes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"size": 0, "deadline": 0, "drain": 0})
    invalidations: int = 0
    writes: int = 0                    # insert/delete batches accepted
    compactions: int = 0
    compaction_triggers: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"size": 0, "imbalance": 0, "manual": 0})
    compile_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    latencies_s: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    # resilience counters (DESIGN.md §14)
    shed: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"expired": 0, "queue_full": 0,
                                 "cancelled": 0})
    flush_retries: int = 0             # bisection levels entered after failure
    poisoned_requests: int = 0         # singletons that failed alone
    breaker_trips: int = 0
    breaker_fallback_flushes: int = 0  # engine calls served by the fallback
    slow_flushes: int = 0              # StragglerMonitor anomalies
    last_slow_flush_at: Optional[float] = None   # unix seconds
    wal_appends: int = 0
    recovered_writes: int = 0          # WAL records applied by replay_wal
    wal_checkpoints: int = 0           # auto-checkpoints (wal_max_bytes)
    # shard fault tolerance (DESIGN.md §15)
    degraded_flushes: int = 0          # flushes served at coverage < 1.0
    last_coverage: float = 1.0         # of the most recent flush
    min_coverage: Optional[float] = None
    shard_recoveries: int = 0


def _host_array(x) -> np.ndarray:
    """``x`` (numpy, a sequence, or a tensor on any device) as a host
    numpy array: request rows and write batches cross the server's API
    boundary as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def latency_percentiles(latencies_s: Sequence[float]) -> Dict[str, float]:
    """→ {"p50", "p95", "p99", "mean"} in milliseconds (0.0 when empty)."""
    if not len(latencies_s):
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    ms = np.asarray(latencies_s, np.float64) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95)),
            "p99": float(np.percentile(ms, 99)),
            "mean": float(ms.mean())}


def zipf_sample(rng, n_unique: int, size: int, *, a: float = 1.05):
    """Rank-frequency Zipf draw over ``[0, n_unique)`` — the standard model
    of query-log skew (WISK): p(rank r) ∝ 1/r^a. ``a <= 0`` → uniform."""
    if a <= 0:
        return rng.integers(0, n_unique, size=size)
    p = 1.0 / np.arange(1, n_unique + 1, dtype=np.float64) ** a
    return rng.choice(n_unique, size=size, p=p / p.sum())


# ---------------------------------------------------------------------------
# LRU cache (both tiers)
# ---------------------------------------------------------------------------


class LRUCache:
    """Plain ordered-dict LRU; get() refreshes recency, put() evicts oldest."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key, value):
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)


def exact_key(tokens: np.ndarray, mask: np.ndarray, loc: np.ndarray,
              k: int, cr: int, fsig=None) -> tuple:
    """Full-request cache key: every byte of the request participates.
    ``fsig`` (``filters.filter_signature``) is the tenant-isolation
    component (DESIGN.md §13): two requests differing only in their
    filter can never share a cached answer."""
    return (k, cr, fsig, tokens.tobytes(), mask.tobytes(), loc.tobytes())


def near_key(tokens: np.ndarray, mask: np.ndarray, loc: np.ndarray,
             k: int, cr: int, cells: int, fsig=None) -> tuple:
    """Near-duplicate key: keyword signature (sorted unique token ids) +
    spatial cell (loc quantized to a cells×cells grid over the unit box)
    + the filter signature (near-duplicates must agree on the predicate
    exactly — proximity never crosses a tenant boundary)."""
    sig = tuple(sorted(set(tokens[mask].tolist())))
    cell = tuple(np.clip((loc * cells).astype(np.int64), 0, cells - 1).tolist())
    return (k, cr, fsig, sig, cell)


# ---------------------------------------------------------------------------
# The streaming server
# ---------------------------------------------------------------------------


class _Pending:
    __slots__ = ("tokens", "mask", "loc", "filt", "ekey", "ikey", "nkey",
                 "future", "t_deadline")

    def __init__(self, tokens, mask, loc, filt, ekey, ikey, nkey, future,
                 t_deadline=None):
        self.tokens, self.mask, self.loc = tokens, mask, loc
        self.filt = filt
        self.ekey, self.ikey = ekey, ikey
        self.nkey, self.future = nkey, future
        self.t_deadline = t_deadline     # perf_counter stamp; None = none


class StreamingServer:
    """Micro-batching, caching, pre-warmed front end for one QueryEngine.

    Single-event-loop usage::

        server = StreamingServer(retriever.engine(),
                                 ServerConfig(batch_size=64, max_delay_ms=2))
        server.warmup()
        ids, scores = await server.submit(tokens_row, mask_row, loc_row)

    ``submit`` answers one request: ``ids (k,)`` global object ids
    (``-1`` past-the-end) and ``scores (k,)`` — the same contract as one
    row of ``QueryEngine.query``. Batch replay without writing the async
    plumbing: :meth:`serve_all`.
    """

    def __init__(self, engine: engine_lib.QueryEngine,
                 config: Optional[ServerConfig] = None):
        self.engine = engine
        self.cfg = config or ServerConfig()
        self.stats = ServerStats()
        self._exact = LRUCache(self.cfg.cache_size)
        self._near = LRUCache(self.cfg.near_cache_size)
        self._inflight: Dict[tuple, asyncio.Future] = {}
        self._pending: List[_Pending] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._compaction_handle: Optional[asyncio.Handle] = None
        self._checkpoint_handle: Optional[asyncio.Handle] = None
        self._subs = None            # SubscriptionRegistry, created lazily
        if self.cfg.wal_max_bytes > 0 and not (self.cfg.wal_dir
                                               and self.cfg.snapshot_dir):
            raise ValueError(
                "ServerConfig.wal_max_bytes requires wal_dir AND "
                "snapshot_dir (the auto-checkpoint must know where to "
                "commit the snapshot before truncating the log)")
        # seeded jitter stream for the bisection-retry backoff: a fixed
        # retry_seed makes the sleep sequence reproducible under test
        self._backoff_rng = np.random.default_rng(self.cfg.retry_seed)
        # durability (DESIGN.md §14): WAL opened eagerly so a torn tail
        # from a previous crash is truncated before the first append
        self.wal: Optional[wal_lib.WriteAheadLog] = None
        if self.cfg.wal_dir:
            self.wal = wal_lib.WriteAheadLog(
                wal_lib.wal_path(self.cfg.wal_dir),
                fsync=self.cfg.wal_fsync)
        self._replaying = False      # replay_wal must not re-append
        # circuit breaker over the engine backend
        self._breaker_open = False
        self._breaker_failstreak = 0
        self._breaker_successes = 0
        # per-flush wall-time anomaly detection (single-stream reuse of
        # the fleet StragglerMonitor, distributed/resilience.py)
        self._flush_monitor = resilience_lib.StragglerMonitor()

    # --- warm-up manager --------------------------------------------------

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               backends: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """Run every configured (batch, backend) shape once.

        Runs an all-padding batch through the *same* plan the flush path
        uses (same ``(batch, k, cr, backend)`` plan key), so the plan is
        built and the kernel library loaded before the first live
        request (the first call on the card includes the library's
        build). An "auto" configuration picks query- vs cluster-major per
        LIVE batch (DESIGN.md §10) — warmup's identical all-padding rows
        would mistrain that pick (they all route to one cluster, so the
        measured dedup is always maximal) — so auto warm-up runs BOTH
        twins explicitly and leaves the choice to real traffic. Returns
        {"backend@batch": seconds} and records it in ``stats``.
        """
        eng = self.engine
        L = eng.snapshot.cfg.max_len
        for backend in backends or (self.cfg.backend,):
            for b in batch_sizes or (self.cfg.batch_size,):
                targets = [backend]
                if backend == "auto" or (backend is None and eng._auto_cm):
                    base = (engine_lib.resolve_backend("auto", eng.device)
                            if backend == "auto" else eng.backend)
                    targets = [base]
                    c, cap = eng.snapshot.buffers["emb"].shape[:2]
                    if engine_lib.cluster_major_feasible(b, self.cfg.cr,
                                                         c, cap):
                        targets.append(engine_lib.cluster_major_variant(
                            base, float("inf")))
                tok = np.zeros((b, L), np.int32)
                tok[:, 0] = 1                        # CLS: keep masks non-empty
                msk = tok != 0
                loc = np.zeros((b, 2), np.float32)
                for target in targets:
                    t0 = time.perf_counter()
                    eng.query(tok, msk, loc, k=self.cfg.k, cr=self.cfg.cr,
                              batch=b, backend=target)
                    name = f"{target or eng.backend}@{b}"
                    self.stats.compile_seconds[name] = \
                        time.perf_counter() - t0
        # warmup's degenerate routing is not traffic: don't let its
        # artificial dedup factor leak into metrics()
        eng.last_dedup_factor = None
        return dict(self.stats.compile_seconds)

    # --- the write path (DESIGN.md §8 + §11) ------------------------------

    def _delta_of(self, snap) -> delta_lib.DeltaSegment:
        if snap.delta is not None:
            return snap.delta
        return delta_lib.DeltaSegment.empty(
            int(snap.buffers["emb"].shape[-1]), snap.meta.precision)

    def insert_objects(self, new_emb, new_loc, new_ids, new_attrs=None):
        """Accept a batch of new objects and publish the successor
        snapshot. Returns the snapshot being served after the call.

        O(batch): the rows append to the snapshot's delta segment
        (quantized at its precision tier); queries see them immediately
        via the engine's delta scan. Compaction folds them into their
        §4.3 clusters later (:meth:`_maybe_compact`). With
        ``delta_threshold=0`` the fold happens eagerly instead
        (``index.insert_objects`` — O(index), the legacy path).
        ``new_attrs (n, 3)`` are the rows' filter attributes
        (core/filters.py; None → all-zero).

        After the publish the batch is dispatched ONCE against the
        standing-query roster (:meth:`subscribe`, core/continuous.py):
        matched subscriptions are notified synchronously, tagged with
        the published version — exactly-once across any later hot-swap.

        After a publish the SERVER'S SNAPSHOT is the source of truth for
        the corpus: a ``ListRetriever`` that originally supplied the
        engine still holds the pre-mutation state, so its offline
        oracles (``brute_force``, cluster metrics) describe the old
        corpus until it is rebuilt.

        With ``wal_dir`` set, the batch is durably logged BEFORE the
        publish (WAL-then-publish, DESIGN.md §14): a crash at any point
        after the append is recoverable by :func:`repro_torch.api.recover`,
        so a returned (acknowledged) write is never lost. The arrays may
        be numpy or tensors on any device; they are copied to the host
        (the WAL's records are numpy)."""
        snap = self.engine.snapshot
        new_emb = _host_array(new_emb)
        new_loc = _host_array(new_loc)
        new_ids = _host_array(new_ids)
        if new_attrs is not None:
            new_attrs = _host_array(new_attrs)
        self.stats.writes += 1
        self._wal_append("insert", snap, emb=new_emb, loc=new_loc,
                         ids=new_ids,
                         **({"attrs": new_attrs}
                            if new_attrs is not None else {}))
        faults_lib.fire("write.pre_publish", kind="insert")
        if self.cfg.delta_threshold <= 0:
            buf = index_lib.insert_objects(
                snap.buffers, snap.index, snap.norm,
                new_emb, new_loc, new_ids, spill=self.cfg.spill,
                new_attrs=new_attrs)
            out = self.publish(snap.with_buffers(buf))
        else:
            delta = self._delta_of(snap).insert(new_emb, new_loc, new_ids,
                                                new_attrs)
            out = self.publish(snap.with_delta(delta))
        faults_lib.fire("write.post_publish", kind="insert")
        if self._subs is not None and len(self._subs):
            self._subs.dispatch(new_emb, new_loc, new_ids, new_attrs,
                                snapshot=out)
        if self.cfg.delta_threshold > 0:
            self._maybe_compact()
        self._maybe_checkpoint()
        return self.engine.snapshot

    def delete_objects(self, del_ids):
        """Delete objects and publish the successor snapshot. Returns
        the snapshot being served after the call.

        O(batch): the ids join the delta's tombstone set (filtering base
        results at query time; delta-resident rows are dropped
        physically). With ``delta_threshold=0``: the legacy eager mask
        (``index.delete_objects`` — O(index)). WAL-then-publish like
        :meth:`insert_objects`."""
        snap = self.engine.snapshot
        del_ids = _host_array(del_ids)
        self.stats.writes += 1
        self._wal_append("delete", snap, ids=del_ids)
        faults_lib.fire("write.pre_publish", kind="delete")
        if self.cfg.delta_threshold <= 0:
            buf = index_lib.delete_objects(snap.buffers, del_ids)
            out = self.publish(snap.with_buffers(buf))
            faults_lib.fire("write.post_publish", kind="delete")
            self._maybe_checkpoint()
            return out
        delta = self._delta_of(snap).delete(del_ids)
        self.publish(snap.with_delta(delta))
        faults_lib.fire("write.post_publish", kind="delete")
        self._maybe_compact()
        self._maybe_checkpoint()
        return self.engine.snapshot

    def _wal_append(self, kind: str, snap, **arrays):
        """Log one write batch before its publish. The record carries
        the version the publish WILL produce, so recovery can skip
        records whose effects are already inside the snapshot it loaded
        (a crash between snapshot save and WAL truncate double-applies
        nothing). Replay sets ``_replaying`` — replayed writes must not
        re-log themselves."""
        if self.wal is None or self._replaying:
            return
        self.wal.append(kind, version=snap.meta.version + 1, **arrays)
        self.stats.wal_appends += 1

    # --- durability: checkpoint + recovery (DESIGN.md §14) ----------------

    def checkpoint(self, directory: str, *, keep: int = 3) -> str:
        """Make every acknowledged write durable in a committed snapshot,
        then truncate the WAL (its records are now redundant). Sequence:
        compact (fold the delta), ``snapshot.save`` (atomic commit),
        ``wal.truncate``. A crash between save and truncate is safe —
        replay skips records at-or-below the saved version. Returns the
        committed snapshot path."""
        snap = self.compact_now()
        path = snap.save(directory, keep=keep)
        if self.wal is not None:
            self.wal.truncate()
        return path

    def _maybe_checkpoint(self):
        """WAL growth bound (``ServerConfig.wal_max_bytes``): once the
        log exceeds the threshold after a write, run :meth:`checkpoint`
        into ``snapshot_dir`` — scheduled on the next loop tick (like
        compaction) so the save never sits inside a write call's
        latency; inline when no loop is running. Never during
        :meth:`replay_wal`: truncating mid-replay with re-append
        suppressed would drop the records not yet applied."""
        if (self.wal is None or self.cfg.wal_max_bytes <= 0
                or self._replaying
                or self.wal.nbytes() <= self.cfg.wal_max_bytes):
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is None:
            self._auto_checkpoint()
        elif self._checkpoint_handle is None:
            self._checkpoint_handle = loop.call_soon(self._checkpoint_cb)

    def _checkpoint_cb(self):
        self._checkpoint_handle = None
        self._auto_checkpoint()

    def _auto_checkpoint(self):
        if (self.wal is None
                or self.wal.nbytes() <= self.cfg.wal_max_bytes):
            return               # a queued trigger may already be stale
        self.checkpoint(self.cfg.snapshot_dir)
        self.stats.wal_checkpoints += 1

    def replay_wal(self) -> int:
        """Re-apply logged writes missing from the current snapshot:
        every WAL record with ``version > snapshot.meta.version`` runs
        back through the normal write path (same delta append, same
        compaction triggers — so the recovered index is bit-identical
        to one that never crashed), without re-logging. Returns the
        number of records applied."""
        if self.wal is None:
            return 0
        base = self.engine.snapshot.meta.version
        applied = 0
        self._replaying = True
        try:
            for rec in self.wal.records():
                if rec["version"] <= base:
                    continue
                if rec["kind"] == "insert":
                    self.insert_objects(rec["emb"], rec["loc"], rec["ids"],
                                        rec.get("attrs"))
                else:
                    self.delete_objects(rec["ids"])
                applied += 1
        finally:
            self._replaying = False
        self.stats.recovered_writes += applied
        return applied

    def close(self):
        """Release the WAL file handle (tests / clean shutdown)."""
        if self.wal is not None:
            self.wal.close()

    def _maybe_compact(self):
        """Check the compaction triggers; fold now (no running event
        loop) or on the next loop tick (between flushes, so a compaction
        never sits inside a write call's latency or splits a batch)."""
        snap = self.engine.snapshot
        delta = snap.delta
        if delta is None or delta.is_empty:
            return
        trigger = None
        if delta.n_rows + delta.n_tombstones >= self.cfg.delta_threshold:
            trigger = "size"
        elif self.cfg.max_imbalance > 0:
            counts = delta_lib.live_counts(snap.buffers, delta)
            if cm.imbalance_factor_from_counts(counts) > self.cfg.max_imbalance:
                trigger = "imbalance"
        if trigger is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is None:
            self._compact(trigger)
        elif self._compaction_handle is None:
            self._compaction_handle = loop.call_soon(self._compact_cb,
                                                     trigger)

    def _compact_cb(self, trigger: str):
        self._compaction_handle = None
        self._compact(trigger)

    def _compact(self, trigger: str):
        """Fold the current delta into the base and publish — atomic
        like any publish; the pre-compaction snapshot keeps serving any
        flush that already pinned it."""
        snap = self.engine.snapshot
        if snap.delta is None or snap.delta.is_empty:
            return
        self.publish(snap.compact(spill=self.cfg.spill))
        self.stats.compactions += 1
        self.stats.compaction_triggers[trigger] = \
            self.stats.compaction_triggers.get(trigger, 0) + 1

    def compact_now(self):
        """Force a synchronous compaction (drain loops, shutdown,
        pre-save). Returns the snapshot being served after the call."""
        self._compact("manual")
        return self.engine.snapshot

    def publish(self, snapshot):
        """Atomically publish ``snapshot``: swap the engine's reference
        (digest-checked) and drop every cached result, in ONE event-loop
        step — a pre-publish answer is never served post-publish. The
        queue is untouched: pending requests flush *after* the publish
        and score the new snapshot; a flush that already started pinned
        the old snapshot and finishes on it (no torn reads). Returns the
        published snapshot as the engine serves it (moved to the engine's
        device)."""
        self.engine.publish(snapshot)
        snapshot = self.engine.snapshot
        self.invalidate_cache()
        if self._subs is not None:
            self._subs.on_publish(snapshot)
        return snapshot

    # --- continuous queries (DESIGN.md §13, core/continuous.py) -----------

    @property
    def subscriptions(self):
        """The lazily created standing-query registry."""
        if self._subs is None:
            from repro_torch.core import continuous as continuous_lib
            self._subs = continuous_lib.SubscriptionRegistry(
                self.engine, cr=self.cfg.cr)
        return self._subs

    def subscribe(self, tokens, mask, loc, *, filters=None,
                  threshold: float = 0.0):
        """Register a standing query → :class:`~repro_torch.core.
        continuous.Subscription` (an async iterator of notifications). Every
        subsequent :meth:`insert_objects` batch is matched against it:
        assigned cluster ∈ its routes, filter predicate, ST ≥
        ``threshold``. Survives snapshot hot-swaps; :meth:`unsubscribe`
        (or ``sub.close()``) ends the stream."""
        return self.subscriptions.register(tokens, mask, loc,
                                           filters=filters,
                                           threshold=threshold)

    def unsubscribe(self, sub_id: int):
        if self._subs is not None:
            self._subs.unregister(sub_id)

    def invalidate_cache(self):
        self._exact.clear()
        self._near.clear()
        self.stats.invalidations += 1

    # --- the micro-batcher ------------------------------------------------

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def _adopt_loop(self, loop):
        """Bind the batcher state to ``loop``. Timer handles, pending
        entries, and in-flight futures are per-event-loop objects: if a
        previous ``asyncio.run`` was aborted mid-batch (engine error,
        cancellation), its leftovers would poison a fresh loop — a timer
        that never re-arms, flushes resolving futures of a closed loop,
        duplicates coalescing onto dead futures. On loop change, drop
        them (their awaiters are gone with the old loop)."""
        if self._loop is not loop:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            if self._compaction_handle is not None:
                self._compaction_handle.cancel()
                self._compaction_handle = None
            if self._checkpoint_handle is not None:
                self._checkpoint_handle.cancel()
                self._checkpoint_handle = None
            self._pending.clear()
            self._inflight.clear()
            self._loop = loop

    async def submit(self, tokens, mask, loc, *, filters=None,
                     t_arrival=None):
        """Answer one spatial-keyword request: → (ids (k,), scores (k,)).

        Cache hits return immediately; misses wait for the size- or
        deadline-triggered flush of the current micro-batch. The
        returned arrays are read-only (shared with the result cache);
        ``.copy()`` before mutating.

        ``filters`` is an optional per-request
        :class:`~repro_torch.core.filters.FilterSpec` (DESIGN.md §13). Its
        signature joins every cache and coalescing key, so requests
        with different predicates — different tenants above all — never
        share an answer; a no-op spec keys identically to no filter.

        ``t_arrival`` (a ``time.perf_counter()`` stamp) backdates the
        latency measurement to the request's intended arrival time —
        open-loop load generators pass it so queueing backlog under
        overload is counted instead of omitted.
        """
        tokens = np.ascontiguousarray(_host_array(tokens), np.int32)
        mask = np.ascontiguousarray(_host_array(mask), bool)
        loc = np.ascontiguousarray(_host_array(loc), np.float32)
        if filters is not None and not isinstance(filters,
                                                  filters_lib.FilterSpec):
            raise TypeError(f"filters must be a FilterSpec or None, "
                            f"got {type(filters)}")
        fsig = filters_lib.filter_signature(filters)
        t0 = time.perf_counter() if t_arrival is None else t_arrival
        self._adopt_loop(asyncio.get_running_loop())
        self.stats.n_requests += 1
        k, cr = self.cfg.k, self.cfg.cr

        # cache lookups are keyed on the CURRENT snapshot version: a hit
        # can only come from an answer computed against this exact index
        # generation (publish also clears, so this is belt and braces).
        # The down-shard signature (DESIGN.md §15) joins every key: a
        # degraded answer is cached under the shard set it was computed
        # WITHOUT, so it can never serve a full-coverage request (or a
        # differently-degraded one) — and recovery needs no invalidation
        ver = self.engine.snapshot.meta.version
        dsig = self.engine.down_signature()
        ekey = exact_key(tokens, mask, loc, k, cr, fsig)
        hit = self._exact.get((ver, dsig, ekey))
        if hit is not None:
            self.stats.exact_hits += 1
            self.stats.latencies_s.append(time.perf_counter() - t0)
            return hit
        nkey = None
        if self.cfg.near_cells > 0:
            nkey = near_key(tokens, mask, loc, k, cr, self.cfg.near_cells,
                            fsig)
            hit = self._near.get((ver, dsig, nkey))
            if hit is not None:
                self.stats.near_hits += 1
                self.stats.latencies_s.append(time.perf_counter() - t0)
                return hit

        # the in-flight key embeds the snapshot version + down-shard
        # signature, like the result caches: a request arriving just
        # after a publish (or a shard state change) must NOT coalesce
        # onto a stale flush's future
        ikey = (ver, dsig, ekey)
        inflight = self._inflight.get(ikey)
        if inflight is not None:                 # identical request queued:
            self.stats.coalesced += 1            # share its future, don't
            res = await inflight                 # spend a second batch slot
            self.stats.latencies_s.append(time.perf_counter() - t0)
            return res

        # graceful degradation (DESIGN.md §14): shed at the door rather
        # than queue without bound. Cache/coalesce hits above stay free
        # — shedding only applies to work that would claim a batch slot.
        if 0 < self.cfg.max_queue <= len(self._pending):
            self.stats.shed["queue_full"] += 1
            raise Overloaded(
                f"admission queue full ({len(self._pending)} pending >= "
                f"max_queue={self.cfg.max_queue}); retry with backoff")
        t_deadline = None
        if self.cfg.request_timeout_ms > 0:
            t_deadline = t0 + self.cfg.request_timeout_ms / 1e3
            if time.perf_counter() > t_deadline:
                # open-loop backlog: the intended arrival is already
                # past its deadline — shed now, don't occupy a slot
                self.stats.shed["expired"] += 1
                raise DeadlineExceeded(
                    f"request expired before enqueue (deadline "
                    f"{self.cfg.request_timeout_ms}ms)")

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inflight[ikey] = fut
        self._pending.append(_Pending(tokens, mask, loc, filters, ekey,
                                      ikey, nkey, fut, t_deadline))
        if len(self._pending) >= self.cfg.batch_size:
            self._flush("size")
        elif self._timer is None:
            self._timer = loop.call_later(self.cfg.max_delay_ms / 1e3,
                                          self._flush, "deadline")
        res = await fut
        self.stats.latencies_s.append(time.perf_counter() - t0)
        return res

    def flush_now(self):
        """Force-flush the queue (used by drain loops and shutdown)."""
        self._flush("drain")

    def _flush(self, reason: str):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # shed BEFORE the engine call (DESIGN.md §14): a request whose
        # deadline passed while queued gets a fast DeadlineExceeded, not
        # a seat on an already-late batch; cancelled waiters (their
        # submit was cancelled/abandoned) free their slots the same way
        now = time.perf_counter()
        live = []
        for p in pending:
            if p.future.done():
                self._inflight.pop(p.ikey, None)
                self.stats.shed["cancelled"] += 1
            elif p.t_deadline is not None and now > p.t_deadline:
                self._inflight.pop(p.ikey, None)
                self.stats.shed["expired"] += 1
                p.future.set_exception(DeadlineExceeded(
                    f"request shed at flush: waited past its "
                    f"{self.cfg.request_timeout_ms}ms deadline"))
            else:
                live.append(p)
        if not live:
            return
        self._flush_group(live, reason, 0)

    def _flush_group(self, pending: List[_Pending], reason: str,
                     depth: int):
        """Score one group of requests; on failure, isolate the poison.

        A healthy group resolves every future. A failed singleton fails
        ALONE — its exception reaches only its own future (the §14 fix
        for the batch-poisoning bug where one request's error was set on
        every co-batched future). A failed multi-request group backs off
        (bounded, doubling per bisection level) and retries as two
        halves, so co-batched healthy requests still resolve and a
        transient engine error costs retries, not a dropped batch."""
        tok = np.stack([p.tokens for p in pending])
        msk = np.stack([p.mask for p in pending])
        loc = np.stack([p.loc for p in pending])
        # per-row filters: a mixed-tenant micro-batch runs ONE
        # filtered plan (sentinel no-op rows, core/filters.py); an
        # all-unfiltered batch collapses to the unfiltered program
        filts = ([p.filt for p in pending]
                 if any(p.filt is not None for p in pending) else None)
        # pin the snapshot for the WHOLE flush: every row of this batch
        # scores one consistent index generation even if a publish lands
        # while the engine call is executing, and the results are cached
        # under the version actually served
        snap = self.engine.snapshot
        try:
            ids, scores = self._engine_call(tok, msk, loc, filts, snap)
        except Exception as e:                   # noqa: BLE001
            if len(pending) == 1:
                p = pending[0]
                self._inflight.pop(p.ikey, None)
                self.stats.poisoned_requests += 1
                if not p.future.done():
                    p.future.set_exception(e)
                return
            # bounded backoff, then bisect: a transient failure clears
            # on the retry; a poisoned request is cornered in O(log b)
            # levels while every healthy sibling still gets its answer.
            # time.sleep is deliberate — the engine call itself blocks
            # the loop far longer, and backoff must also apply to the
            # sync serve_all path.
            self.stats.flush_retries += 1
            backoff = self._backoff_ms(depth)
            if backoff > 0:
                time.sleep(backoff / 1e3)
            mid = len(pending) // 2
            self._flush_group(pending[:mid], reason, depth + 1)
            self._flush_group(pending[mid:], reason, depth + 1)
            return
        if depth == 0:
            self.stats.flushes[reason] += 1
        self.stats.engine_batches += 1
        self.stats.engine_queries += len(pending)
        ver = snap.meta.version
        # coverage annotation (DESIGN.md §15): results computed while a
        # shard was DOWN are cached under the shard set actually MISSING
        # from the answer — not the one seen at submit time — so a
        # degraded result can only ever be re-served to requests
        # degraded the same way
        coverage = self.engine.last_coverage
        dsig_served = self.engine.last_down_shards
        self.stats.last_coverage = coverage
        if (self.stats.min_coverage is None
                or coverage < self.stats.min_coverage):
            self.stats.min_coverage = coverage
        if coverage < 1.0:
            self.stats.degraded_flushes += 1
        for i, p in enumerate(pending):
            res = (ids[i].copy(), scores[i].copy())
            for arr in res:              # shared with the cache + every
                arr.setflags(write=False)  # waiter: freeze, don't trust
            self._exact.put((ver, dsig_served, p.ekey), res)
            if p.nkey is not None:
                self._near.put((ver, dsig_served, p.nkey), res)
            self._inflight.pop(p.ikey, None)
            if not p.future.done():
                p.future.set_result(res)

    def _backoff_ms(self, depth: int) -> float:
        """One bisection-retry sleep: doubling in ``depth``, capped at
        ``retry_backoff_max_ms``, scaled by a seeded full-jitter factor
        in ``[1 - retry_jitter, 1]`` so co-failing flush groups spread
        out instead of retrying in lockstep (deterministic for a fixed
        ``retry_seed`` — tests pin the exact sequence)."""
        base = min(self.cfg.retry_backoff_ms * (2 ** depth),
                   self.cfg.retry_backoff_max_ms)
        jitter = self.cfg.retry_jitter
        if base <= 0 or jitter <= 0:
            return base
        return base * (1.0 - jitter * float(self._backoff_rng.random()))

    # --- shard fault tolerance (DESIGN.md §15) ----------------------------

    def recover_shard(self, s: int):
        """Online shard recovery: re-materialize a DOWN shard's device
        part and flip it back UP (:meth:`QueryEngine.recover_shard`) —
        under live traffic, no version bump, no drained queue, no cache
        invalidation (degraded answers are keyed by their down-shard
        signature). An unsharded engine raises ``ValueError``. Returns
        the snapshot being served after the call."""
        snap = self.engine.recover_shard(s)
        self.stats.shard_recoveries += 1
        return snap

    # --- degraded execution: breaker + anomaly detection ------------------

    def _fallback_backend(self) -> Optional[str]:
        """The plain backend the breaker degrades onto: cuda → dense
        (query-major or cluster-major preserved), auto → dense, as the
        reference maps pallas. None when the configured backend IS its
        own fallback (nothing to degrade to), and None when the fallback
        does not run on the engine's device: ``dense`` serves only CPU
        snapshots, and a flush on the card never gives way to a plain
        version — there the breaker never opens and a failed flush
        reaches its own futures (retried by bisection, or poisoned)."""
        primary = self.cfg.backend or self.engine.backend
        fallback = {"cuda": "dense", "cuda-cm": "dense-cm",
                    "auto": "dense"}.get(primary)
        if (fallback is None or engine_lib._BACKEND_DEVICE[fallback]
                != self.engine.device.type):
            return None
        return fallback

    def _engine_call(self, tok, msk, loc, filts, snap):
        """One engine call wearing the resilience instrumentation:
        fault points (chaos tier), the circuit breaker (on a CPU engine,
        repeated primary-backend failures route to the dense fallback
        until a probe succeeds), and per-flush wall-time anomaly
        detection."""
        backend = self.cfg.backend
        fallback = self._fallback_backend()
        if self._breaker_open and fallback is not None:
            backend = fallback
        t0 = time.perf_counter()
        try:
            faults_lib.fire("flush.slow")        # callback sleeps
            faults_lib.fire("flush.engine")      # armed → raises in-place
            out = self.engine.query(
                tok, msk, loc, k=self.cfg.k, cr=self.cfg.cr,
                batch=self.cfg.batch_size, backend=backend,
                snapshot=snap, filters=filts)
        except Exception:
            self._breaker_failstreak += 1
            if (not self._breaker_open and fallback is not None
                    and self.cfg.breaker_threshold > 0
                    and self._breaker_failstreak
                    >= self.cfg.breaker_threshold):
                self._breaker_open = True
                self._breaker_successes = 0
                self.stats.breaker_trips += 1
            raise
        dt = time.perf_counter() - t0
        self._flush_monitor.record("flush", dt)
        if self._flush_monitor.slow("flush"):
            self.stats.slow_flushes += 1
            self.stats.last_slow_flush_at = time.time()
        self._breaker_failstreak = 0
        if self._breaker_open:
            self.stats.breaker_fallback_flushes += 1
            self._breaker_successes += 1
            if self._breaker_successes >= self.cfg.breaker_probe_every:
                # half-open probe: route the next flush back through the
                # primary; if it still fails, the streak re-trips
                self._breaker_open = False
        return out

    # --- batch replay convenience ----------------------------------------

    async def _drain(self, tasks):
        """Resolve every submitted task: one loop tick lets each queued
        submit run to its enqueue point (ready callbacks are FIFO, so
        all of them go before we resume), one forced flush drains the
        trailing partial batch, and the deadline timer backstops any
        straggler — no busy-spinning over the task list."""
        await asyncio.sleep(0)
        self.flush_now()
        return await asyncio.gather(*tasks)

    async def submit_all(self, tokens, mask, locs):
        """Submit every row of (n, L)/(n, L)/(n, 2), drain, and return
        stacked (ids (n, k), scores (n, k)). Requests enqueue in row
        order, so flush boundaries land exactly where a direct
        ``engine.run_batched`` call would put its chunk boundaries."""
        tasks = [asyncio.ensure_future(self.submit(tokens[i], mask[i],
                                                   locs[i]))
                 for i in range(len(tokens))]
        out = await self._drain(tasks)
        return (np.stack([o[0] for o in out]),
                np.stack([o[1] for o in out]))

    def serve_all(self, tokens, mask, locs):
        """Synchronous wrapper around :meth:`submit_all` (owns the loop)."""
        return asyncio.run(self.submit_all(tokens, mask, locs))

    # --- reporting --------------------------------------------------------

    def metrics(self, wall_seconds: Optional[float] = None) -> dict:
        """One flat dict for callers and benchmarks: hit rates, batch fill,
        latency percentiles (ms), flush/invalidation counters, compile
        seconds, the engine's last measured route-dedup factor (the
        cluster-major auto signal, DESIGN.md §10), and QPS when
        ``wall_seconds`` is given."""
        s = self.stats
        n = max(s.n_requests, 1)
        filled = s.engine_batches * self.cfg.batch_size
        out = {
            "requests": s.n_requests,
            # split cache economics (DESIGN.md §7): raw counts beside the
            # rates, so callers can report exact-LRU vs near-duplicate
            # traffic without multiplying rates back up
            "exact_hits": s.exact_hits,
            "near_hits": s.near_hits,
            "exact_hit_rate": s.exact_hits / n,
            "near_hit_rate": s.near_hits / n,
            "hit_rate": (s.exact_hits + s.near_hits) / n,
            "coalesced": s.coalesced,
            "engine_batches": s.engine_batches,
            "engine_queries": s.engine_queries,
            "batch_fill": s.engine_queries / filled if filled else 0.0,
            "latency_ms": latency_percentiles(s.latencies_s),
            "flushes": dict(s.flushes),
            "invalidations": s.invalidations,
            "compile_seconds": dict(s.compile_seconds),
            "dedup_factor": self.engine.last_dedup_factor,
            "writes": s.writes,
            "delta_rows": self.engine.snapshot.meta.delta_rows,
            "tombstones": self.engine.snapshot.meta.n_tombstones,
            "compactions": s.compactions,
            "compaction_triggers": dict(s.compaction_triggers),
            # resilience block (DESIGN.md §14)
            "shed": dict(s.shed),
            "flush_retries": s.flush_retries,
            "poisoned_requests": s.poisoned_requests,
            "breaker": {"open": self._breaker_open,
                        "trips": s.breaker_trips,
                        "fallback_flushes": s.breaker_fallback_flushes},
            "slow_flushes": s.slow_flushes,
            "last_slow_flush_at": s.last_slow_flush_at,
            "wal": {"enabled": self.wal is not None,
                    "appends": s.wal_appends,
                    "records": self.wal.n_records if self.wal else 0,
                    "bytes": self.wal.nbytes() if self.wal else 0,
                    "max_bytes": self.cfg.wal_max_bytes,
                    "auto_checkpoints": s.wal_checkpoints},
            "recovered_writes": s.recovered_writes,
            # degraded partial-result serving (DESIGN.md §15)
            "coverage": {"last": s.last_coverage,
                         "min": s.min_coverage,
                         "degraded_flushes": s.degraded_flushes},
        }
        if self._subs is not None:
            # standing-query dispatch economics (core/continuous.py):
            # distinct_clusters_per_dispatch is the O(·) the reversed
            # cluster-major plan promises per insert batch
            out["subscriptions"] = self._subs.metrics()
        snap = self.engine.snapshot
        out["n_shards"] = snap.meta.n_shards
        if snap.shards is not None:
            # mesh-sharded serving: resident bytes per part, and the
            # shard health state machine with the hedge / retry /
            # recovery counters
            out["shard_bytes_per_device"] = snap.shards.nbytes_per_device()
            health = self.engine._shard_health
            out["shard_health"] = (health.snapshot()
                                   if health is not None else None)
            out["shard_stats"] = dict(self.engine.shard_stats)
            out["shard_recoveries"] = s.shard_recoveries
        if wall_seconds is not None and wall_seconds > 0:
            out["qps"] = s.n_requests / wall_seconds
        return out


# ---------------------------------------------------------------------------
# Load generation (load tests + benchmarks)
# ---------------------------------------------------------------------------


async def open_loop(server: StreamingServer, requests, *, qps: float,
                    shed_ok: bool = False):
    """Fixed-rate arrivals: one submit every 1/qps seconds regardless of
    completions. Each submit is stamped with its INTENDED arrival time,
    so when the engine can't keep up the backlog shows up as queueing
    latency instead of being coordinated-omitted from the percentiles.
    ``requests`` is a sequence of (tokens, mask, loc) rows.

    ``shed_ok=True`` is the overload-bench mode: a request the server
    sheds (:class:`Overloaded` / :class:`DeadlineExceeded`) yields
    ``None`` in the result list instead of aborting the run — shedding
    under 2× load is the designed behavior being measured, and the
    server's ``shed`` counters account for every one."""

    async def one(tok, msk, loc, arrival):
        try:
            return await server.submit(tok, msk, loc, t_arrival=arrival)
        except (Overloaded, DeadlineExceeded):
            if not shed_ok:
                raise
            return None

    interval = 1.0 / qps
    t_start = time.perf_counter()
    tasks = []
    for i, (tok, msk, loc) in enumerate(requests):
        arrival = t_start + i * interval
        delay = arrival - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(tok, msk, loc, arrival)))
    return await server._drain(tasks)


async def closed_loop(server: StreamingServer, requests, *,
                      concurrency: int):
    """Fixed-concurrency workers: each keeps exactly one request
    outstanding, pulling the next from a shared iterator on completion."""
    results = [None] * len(requests)
    it = iter(range(len(requests)))

    async def worker():
        for i in it:
            tok, msk, loc = requests[i]
            results[i] = await server.submit(tok, msk, loc)

    await asyncio.gather(*[worker()
                           for _ in range(min(concurrency, len(requests)))])
    return results
