"""Fault tolerance shared by the serving stack (reference:
``repro.distributed.resilience``).

- :class:`StragglerMonitor` ingests per-stream latencies and flags the
  slow ones against a robust threshold (median + k·MAD). The streaming
  server feeds it one stream, its per-flush wall times
  (:meth:`StragglerMonitor.slow`).
- :class:`ShardUnavailable` is the sharded engine's total-loss error,
  re-exported by ``repro_torch.api``.

The reference's ``ShardHealth``, ``ElasticPlanner`` and ``watchdog_step``
serve the sharded engine and the trainer fleet; they come with the
port's sharding (ROADMAP Queue A 11). Host-side Python, no device.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Optional


class StragglerMonitor:
    def __init__(self, *, window: int = 20, mad_k: float = 5.0,
                 patience: int = 3):
        self.window = window
        self.mad_k = mad_k
        self.patience = patience
        self.latencies: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self.strikes: Dict[str, int] = defaultdict(int)

    def record(self, host: str, step_seconds: float):
        self.latencies[host].append(step_seconds)

    def slow(self, host: str) -> bool:
        """Single-stream anomaly test: is ``host``'s LAST sample slow
        against its OWN recent window (median + k·MAD of the window)?

        :meth:`flagged` compares hosts against each other, which needs a
        fleet (≥ 2 streams). This variant serves the one-stream case —
        e.g. per-flush wall times in the streaming server, where "slow"
        means "slow relative to this process's own recent flushes". The
        MAD floor (5% of median) keeps a perfectly steady stream from
        flagging noise-level jitter. Needs half a window of history."""
        lat = self.latencies.get(host)
        if not lat or len(lat) < max(4, self.window // 2):
            return False
        hist = sorted(list(lat)[:-1])
        med = hist[len(hist) // 2]
        mad = sorted(abs(x - med) for x in hist)[len(hist) // 2]
        return lat[-1] > med + self.mad_k * max(mad, 0.05 * med, 1e-4)

    def _threshold(self) -> Optional[float]:
        last = [d[-1] for d in self.latencies.values() if d]
        if len(last) < 2:
            return None
        last_sorted = sorted(last)
        med = last_sorted[len(last_sorted) // 2]
        mad = sorted(abs(x - med) for x in last)[len(last) // 2]
        return med + self.mad_k * max(mad, 0.05 * med, 1e-4)

    def flagged(self) -> List[str]:
        """Hosts exceeding the robust threshold `patience` times in a row."""
        thr = self._threshold()
        if thr is None:
            return []
        out = []
        for host, lat in self.latencies.items():
            if lat and lat[-1] > thr:
                self.strikes[host] += 1
            else:
                self.strikes[host] = 0
            if self.strikes[host] >= self.patience:
                out.append(host)
        return sorted(out)


class ShardUnavailable(RuntimeError):
    """No shard could serve the scan — every shard is DOWN/unscannable.

    A SINGLE lost shard never raises this: the engine serves the
    surviving partial top-k lists with a reduced coverage fraction
    (DESIGN.md §15). Only the total-loss case — zero partials to merge —
    surfaces as an error, because an empty result would be
    indistinguishable from "nothing matched"."""


__all__ = ["StragglerMonitor", "ShardUnavailable"]
