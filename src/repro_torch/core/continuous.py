"""Continuous spatial-keyword queries: a standing-query subscription
engine over the streaming write path (reference:
``repro.core.continuous``, DESIGN.md §13).

A one-shot query asks "what matches now"; a *continuous* query asks
"tell me whenever a NEW object matches". This module keeps standing
queries resident — encoded once, routed once — and evaluates every
insert batch against the whole roster with the cluster-major plan run
in REVERSE: instead of streaming resident clusters against a query
batch, the freshly inserted objects are grouped by their assigned
cluster and each distinct cluster's group is scored against that
cluster's subscribed queries in one ``score_candidates`` product on the
engine's device (the reference scores them in plain XLA as well: no
kernel runs here). Per insert batch the dispatch cost is O(distinct
assigned clusters), not O(subscriptions) — the same dedup economics as
``cuda-cm``, applied to the write path.

Match semantics (deterministic, replicable by an oracle that re-runs
the one-shot pipeline per insert):

    match(q, o)  ⟺  assign(o) ∈ route(q, cr)
                 ∧  predicate(attrs(o), q.filters)        (core/filters.py)
                 ∧  ST(q, o) ≥ q.threshold                (Eq. 5 serve form)

``assign(o)`` is the ARGMAX cluster of the trained router
(``index.assign_clusters``, top=1) — deliberately NOT the §4.3 spill
placement, which depends on buffer fill state and would make matches
irreproducible. ``ST`` is scored on the QUANTIZED row exactly as the
delta scan stores it, so a notification's score equals what a one-shot
re-query of the standing query would report for that row
(tests/test_torch_continuous.py).

Snapshot hot-swaps: registry membership is independent of the engine's
snapshot reference, so subscriptions survive every publish. Routes and
encodings are recomputed only when a publish actually changes the
routing inputs (object identity of the snapshot's ``rel`` and ``index``
modules and its ``norm``) — delta appends and compactions reuse the same
objects and trigger nothing. Delivery is exactly-once by construction:
the server dispatches each insert batch synchronously, once, after the
successor snapshot is published; later swaps never re-dispatch.

A subscription's resident state (``q_emb``, ``w_st``, ``routes``) is
numpy on the host; the registry keeps its stacked copy on the engine's
device, and one dispatch copies its matches to the host once.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import filters as filters_lib
from repro_torch.core import index as index_lib

_CLOSED = object()          # queue sentinel injected by Subscription.close


@dataclasses.dataclass(frozen=True)
class Notification:
    """One matched (standing query, inserted object) pair.

    ``version`` is the snapshot version the insert batch published —
    the generation whose delta physically holds the object."""
    sub_id: int
    object_id: int
    score: float
    version: int


class Subscription:
    """One standing query: an async iterator of :class:`Notification`.

    Consumed with ``async for note in sub``; ends when :meth:`close` is
    called and the queue drains. :meth:`drain` is the synchronous
    convenience for replay-style tests and benchmarks — it pops every
    notification delivered so far without awaiting.
    """

    def __init__(self, sub_id: int, tokens, mask, loc, *,
                 filters: Optional[filters_lib.FilterSpec],
                 threshold: float, cr: int):
        self.sub_id = int(sub_id)
        self.tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        self.mask = np.ascontiguousarray(np.asarray(mask, bool))
        self.loc = np.ascontiguousarray(np.asarray(loc, np.float32))
        self.filters = filters
        self.threshold = float(threshold)
        self.cr = int(cr)
        self.closed = False
        self.n_notified = 0
        # resident serve-side state, owned by the registry (host numpy)
        self.q_emb: Optional[np.ndarray] = None      # (d,)
        self.w_st: Optional[np.ndarray] = None       # (2,)
        self.routes: Optional[np.ndarray] = None     # (cr,)
        # put_nowait needs no running loop, so the server's synchronous
        # write path can deliver; awaiting consumers wake on their loop
        self._queue: "asyncio.Queue" = asyncio.Queue()

    def _push(self, note: Notification):
        self.n_notified += 1
        self._queue.put_nowait(note)

    def close(self):
        if not self.closed:
            self.closed = True
            self._queue.put_nowait(_CLOSED)

    def drain(self) -> List[Notification]:
        out = []
        while True:
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                return out
            if item is _CLOSED:
                self._queue.put_nowait(_CLOSED)   # keep the iterator ending
                return out
            out.append(item)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Notification:
        if self.closed and self._queue.empty():
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _CLOSED:
            raise StopAsyncIteration
        return item


class SubscriptionRegistry:
    """The resident standing-query roster + its insert-batch dispatcher.

    Owned by a :class:`~repro_torch.core.server.StreamingServer` (or used
    standalone around a :class:`~repro_torch.core.engine.QueryEngine`).
    All mutation and dispatch runs on the server's single event-loop
    thread — no locking. ``cr`` is the routing fanout every subscription
    is matched under (one roster per registry keeps dispatch one pass).
    """

    def __init__(self, engine: engine_lib.QueryEngine, *, cr: int = 1):
        self.engine = engine
        self.cr = int(cr)
        self._subs: Dict[int, Subscription] = {}
        self._ids = itertools.count()
        self._dirty = True                   # resident stacks need rebuild
        self._routing_key = self._routing_identity(engine.snapshot)
        # cumulative dispatch economics (server.metrics() reads these)
        self.n_dispatches = 0
        self.n_objects_seen = 0
        self.n_distinct_clusters = 0         # Σ distinct assigned clusters
        self.n_notifications = 0
        self.n_reroutes = 0
        # rebuilt-on-demand resident stacks (S = len(self._subs))
        self._stack = None

    # --- membership -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._subs)

    def register(self, tokens, mask, loc, *, filters=None,
                 threshold: float = 0.0) -> Subscription:
        """Add a standing query; encodes + routes it against the CURRENT
        snapshot immediately so the first dispatch after registration
        already sees it."""
        if filters is not None and not isinstance(filters,
                                                  filters_lib.FilterSpec):
            raise TypeError(f"filters must be a FilterSpec or None, "
                            f"got {type(filters)}")
        sub = Subscription(next(self._ids), tokens, mask, loc,
                           filters=filters, threshold=threshold, cr=self.cr)
        self._encode(sub, self.engine.snapshot)
        self._subs[sub.sub_id] = sub
        self._dirty = True
        return sub

    def unregister(self, sub_id: int):
        sub = self._subs.pop(int(sub_id), None)
        if sub is not None:
            sub.close()
            self._dirty = True

    # --- routing residency ------------------------------------------------

    def _encode(self, sub: Subscription, snap):
        """Encode + route one subscription on ``snap``'s modules (the
        engine's prefix for this ``cr``, batch 1, on the snapshot's
        device)."""
        prefix = self.engine.prefix_fn(cr=self.cr)
        dev = snap.device
        q_emb, w, top_c = prefix(
            snap.rel, snap.index, snap.norm,
            torch.from_numpy(sub.tokens[None]).to(dev),
            torch.from_numpy(sub.mask[None]).to(dev),
            torch.from_numpy(sub.loc[None]).to(dev))
        sub.q_emb = q_emb[0].float().cpu().numpy()
        sub.w_st = w[0].float().cpu().numpy()
        sub.routes = top_c[0].cpu().numpy()

    @staticmethod
    def _routing_identity(snap):
        return (id(snap.rel), id(snap.index), id(snap.norm))

    def on_publish(self, snap):
        """Called after every snapshot publish. Delta appends and
        compactions reuse the same modules — free. A publish that swaps
        routing inputs (retrained modules) re-encodes and re-routes
        every subscription once."""
        key = self._routing_identity(snap)
        if key == self._routing_key:
            return
        if self._subs:
            for sub in self._subs.values():
                self._encode(sub, snap)
            self.n_reroutes += 1
            self._dirty = True
        self._routing_key = key

    def _stacks(self):
        """Resident stacked tensors on the engine's device + the
        cluster→subscription roster."""
        if not self._dirty and self._stack is not None:
            return self._stack
        dev = self.engine.device
        subs = list(self._subs.values())

        def stacked(name, dtype):
            return torch.from_numpy(np.stack(
                [getattr(s, name) for s in subs]).astype(dtype)).to(dev)

        fvals = np.stack([(s.filters or filters_lib.NOOP_FILTER).to_fvals()
                          for s in subs]) if subs else \
            np.zeros((0, filters_lib.N_FVALS), np.int32)
        stack = {
            "subs": subs,
            "q_emb": stacked("q_emb", np.float32) if subs else None,
            "w_st": stacked("w_st", np.float32) if subs else None,
            "loc": stacked("loc", np.float32) if subs else None,
            "thr": torch.tensor([s.threshold for s in subs],
                                dtype=torch.float32, device=dev),
            "fvals": torch.from_numpy(fvals).to(dev),
            "roster": {},                 # cluster id -> sub row indices
        }
        for row, s in enumerate(subs):
            for c in np.unique(s.routes):
                stack["roster"].setdefault(int(c), []).append(row)
        stack["roster"] = {c: np.asarray(rows, np.int64)
                           for c, rows in stack["roster"].items()}
        stack["roster_dev"] = {c: torch.from_numpy(rows).to(dev)
                               for c, rows in stack["roster"].items()}
        self._stack = stack
        self._dirty = False
        return stack

    # --- the reversed cluster-major dispatch ------------------------------

    def dispatch(self, new_emb, new_loc, new_ids, new_attrs=None,
                 snapshot=None) -> List[Notification]:
        """Evaluate one insert batch against the whole roster.

        Groups the batch by argmax-assigned cluster and scores each
        distinct cluster's object group against that cluster's
        subscribed queries in one product — the cluster-major plan with
        the roles of resident/streamed swapped, on the engine's device.
        Rows are quantized to the snapshot's precision tier first, so
        scores equal what the delta scan will report for the same rows.
        Returns (and pushes) the notifications, in (cluster, subscription
        row, object) order.
        """
        snap = self.engine.snapshot if snapshot is None else snapshot
        self.n_dispatches += 1
        ids = np.asarray(new_ids).reshape(-1).astype(np.int32)
        n = ids.shape[0]
        self.n_objects_seen += n
        if not self._subs or n == 0:
            return []
        st = self._stacks()
        dev = self.engine.device
        emb = torch.as_tensor(np.asarray(new_emb, np.float32)).reshape(
            n, -1).to(dev)
        loc = torch.as_tensor(np.asarray(new_loc, np.float32)).reshape(
            n, 2).to(dev)
        ids_d = torch.from_numpy(ids).to(dev)
        attrs = filters_lib.validate_attrs(new_attrs, n).to(dev)
        with torch.no_grad():
            # the oracle-replicable assignment: argmax router cluster
            feats = index_lib.build_features(emb, loc, snap.norm)
            assign = index_lib.assign_clusters(snap.index, feats,
                                               top=1).reshape(n).cpu().numpy()
            # score the QUANTIZED rows — parity with the delta scan
            stored, scale = index_lib.quantize_rows(emb, snap.meta.precision)
        int8 = snap.meta.precision == "int8"
        w_hat = snap.w_hat
        version = int(snap.meta.version)
        distinct = [int(c) for c in np.unique(assign)
                    if int(c) in st["roster"]]
        self.n_distinct_clusters += len(distinct)
        groups, flat_s, flat_h = [], [], []
        for c in distinct:
            rows = st["roster_dev"][c]                # (S_c,) sub rows
            sel = np.flatnonzero(assign == c)         # (m_c,) object rows
            sel_d = torch.from_numpy(sel).to(dev)
            # the predicate masks a row like padding (id -1), as the
            # reference's cand_attrs / fvals do
            ok = filters_lib.predicate_mask(attrs[sel_d][None],
                                            st["fvals"][rows][:, None])
            cand_ids = torch.where(ok, ids_d[sel_d][None],
                                   torch.full_like(ok, -1, dtype=torch.int32))
            with torch.no_grad():
                scores = engine_lib.score_candidates(
                    st["q_emb"][rows], st["loc"][rows], st["w_st"][rows],
                    stored[sel_d], loc[sel_d], cand_ids, w_hat,
                    dist_max=snap.meta.dist_max,
                    cand_scale=scale[sel_d] if int8 else None)  # (S_c, m_c)
            hit = ((scores >= st["thr"][rows][:, None])
                   & (scores > engine_lib.NEG_INF / 2))
            groups.append((st["roster"][c], sel, scores.shape))
            flat_s.append(scores.reshape(-1))
            flat_h.append(hit.reshape(-1))
        notes: List[Notification] = []
        if groups:
            # one copy to the host for the whole batch
            all_s = torch.cat(flat_s).cpu().numpy()
            all_h = torch.cat(flat_h).cpu().numpy()
            off = 0
            for rows, sel, shape in groups:
                size = shape[0] * shape[1]
                sc = all_s[off:off + size].reshape(shape)
                hit = all_h[off:off + size].reshape(shape)
                off += size
                for i, j in zip(*np.nonzero(hit)):
                    sub = st["subs"][rows[i]]
                    note = Notification(sub.sub_id, int(ids[sel[j]]),
                                        float(sc[i, j]), version)
                    sub._push(note)
                    notes.append(note)
        self.n_notifications += len(notes)
        return notes

    # --- reporting --------------------------------------------------------

    def metrics(self) -> dict:
        d = max(self.n_dispatches, 1)
        return {
            "subscriptions": len(self._subs),
            "dispatches": self.n_dispatches,
            "objects_seen": self.n_objects_seen,
            "notifications": self.n_notifications,
            "distinct_clusters": self.n_distinct_clusters,
            "distinct_clusters_per_dispatch": self.n_distinct_clusters / d,
            "reroutes": self.n_reroutes,
        }


__all__ = ["Notification", "Subscription", "SubscriptionRegistry"]
