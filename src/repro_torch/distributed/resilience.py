"""Fault tolerance shared by the serving stack (reference:
``repro.distributed.resilience``).

- :class:`StragglerMonitor` ingests per-stream latencies and flags the
  slow ones against a robust threshold (median + k·MAD). The streaming
  server feeds it one stream, its per-flush wall times
  (:meth:`StragglerMonitor.slow`).
- :class:`ShardHealth` is the sharded engine's per-shard health: the
  EWMA of scan times, the consecutive failures, UP → SUSPECT → DOWN.
- :class:`ShardUnavailable` is the sharded engine's total-loss error,
  re-exported by ``repro_torch.api``.
- :class:`ElasticPlanner` picks the largest valid mesh
  (:class:`MeshPlan`) for a trainer fleet's surviving pods.
- :func:`watchdog_step` runs one training step against a wall-clock
  deadline (``launch.train``).

Host-side Python; ``watchdog_step`` waits for the card its step ran on.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


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


class ShardHealth:
    """Per-shard serving health of the mesh-sharded engine.

    For each shard: an EWMA of scan wall time (every shard scan is
    timed), a consecutive-failure count, and a state:

    * UP → SUSPECT on the first scan failure;
    * SUSPECT → UP when a scan (device or host replica) succeeds;
    * SUSPECT → DOWN after ``down_after`` consecutive failures, or at
      once through :meth:`mark_down` (device lost);
    * DOWN is sticky: queries skip the shard until :meth:`mark_up`,
      which only ``recover_shard`` calls after re-materializing the
      part. A lucky success does not mask a dead device.
    """

    UP, SUSPECT, DOWN = "up", "suspect", "down"

    def __init__(self, n_shards: int, *, alpha: float = 0.2,
                 down_after: int = 3):
        if n_shards < 1:
            raise ValueError(f"ShardHealth: n_shards={n_shards} < 1")
        if down_after < 1:
            raise ValueError(f"ShardHealth: down_after={down_after} < 1")
        self.n_shards = int(n_shards)
        self.alpha = float(alpha)
        self.down_after = int(down_after)
        self._ewma: List[Optional[float]] = [None] * self.n_shards
        self._failures: List[int] = [0] * self.n_shards
        self._states: List[str] = [self.UP] * self.n_shards

    def record_success(self, shard: int, seconds: float) -> None:
        prev = self._ewma[shard]
        self._ewma[shard] = (seconds if prev is None else
                             self.alpha * seconds
                             + (1.0 - self.alpha) * prev)
        self._failures[shard] = 0
        if self._states[shard] == self.SUSPECT:
            self._states[shard] = self.UP

    def record_failure(self, shard: int) -> str:
        """Count one failed scan; returns the new state."""
        self._failures[shard] += 1
        if self._states[shard] != self.DOWN:
            self._states[shard] = (
                self.DOWN if self._failures[shard] >= self.down_after
                else self.SUSPECT)
        return self._states[shard]

    def mark_down(self, shard: int) -> None:
        self._states[shard] = self.DOWN

    def mark_up(self, shard: int) -> None:
        """Recovery: reset the shard to a clean UP slate."""
        self._states[shard] = self.UP
        self._failures[shard] = 0
        self._ewma[shard] = None

    def state(self, shard: int) -> str:
        return self._states[shard]

    def is_down(self, shard: int) -> bool:
        return self._states[shard] == self.DOWN

    def ewma(self, shard: int) -> Optional[float]:
        return self._ewma[shard]

    def down_shards(self) -> Tuple[int, ...]:
        """Sorted DOWN set: the cache-key signature of degraded results."""
        return tuple(s for s in range(self.n_shards) if self.is_down(s))

    def snapshot(self) -> dict:
        """Metrics view (``server.metrics()`` embeds it as it is)."""
        return {
            "states": list(self._states),
            "ewma_s": list(self._ewma),
            "failures": list(self._failures),
            "down": list(self.down_shards()),
        }


__all__ = ["StragglerMonitor", "ShardHealth", "ShardUnavailable"]


@dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    n_chips: int
    reason: str = ""


class ElasticPlanner:
    """Choose the largest valid (data, model) mesh for the surviving
    chips.

    The model axis is ``min(tp_divisor, 16)`` (``tp_divisor``: the heads /
    d_ff / vocab GCD); the pod count must keep ``global_batch`` divisible.
    Pods are atomic: losing any chip in a pod drops the pod."""

    def __init__(self, *, chips_per_pod: int = 256, tp_divisor: int = 16,
                 global_batch: int = 256):
        self.chips_per_pod = chips_per_pod
        self.tp_divisor = tp_divisor
        self.global_batch = global_batch

    def plan(self, healthy_pods: int) -> Optional[MeshPlan]:
        if healthy_pods <= 0:
            return None
        tp = min(self.tp_divisor, 16)
        per_pod_data = self.chips_per_pod // tp
        if healthy_pods == 1:
            return MeshPlan((per_pod_data, tp), ("data", "model"),
                            self.chips_per_pod, "single pod")
        if self.global_batch % healthy_pods != 0:
            # drop to the largest pod count that divides the batch
            while healthy_pods > 1 and self.global_batch % healthy_pods:
                healthy_pods -= 1
            return self.plan(healthy_pods)
        return MeshPlan((healthy_pods, per_pod_data, tp),
                        ("pod", "data", "model"),
                        healthy_pods * self.chips_per_pod,
                        f"{healthy_pods} pods")


def _first_tensor(tree):
    """The first tensor of a nested dict / list / tuple, in jax's leaf
    order (dict children by sorted key), or None."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def watchdog_step(fn, *args, deadline_s: float = 600.0):
    """``(fn(*args), seconds)``: one step with a wall-clock deadline;
    raises ``TimeoutError`` past it (a hung card or collective). CUDA
    runs asynchronously, so the clock stops after the device of the
    output's first tensor has finished its work (the reference blocks on
    the first output leaf)."""
    import torch
    t0 = time.time()
    out = fn(*args)
    leaf = _first_tensor(out)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    dt = time.time() - t0
    if dt > deadline_s:
        raise TimeoutError(
            f"step exceeded deadline ({dt:.1f}s > {deadline_s}s) — "
            "likely a hung card or collective")
    return out, dt
