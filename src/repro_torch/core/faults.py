"""Fault-injection registry for the serving stack (reference:
``repro.core.faults``, DESIGN.md §14). The port keeps its own registry:
the two packages' points are armed and cleared independently.

Chaos testing without monkeypatching: production code is instrumented
with named **injection points** — one :func:`fire` call at each place a
real deployment fails (engine errors mid-flush, crashes around the WAL
append / snapshot publish, torn WAL tails, corrupted snapshot files,
slow flushes). In production every ``fire`` is a dict lookup that misses
and returns ``None``; a chaos test arms a point with :func:`inject` and
the *real* code path — not a test double — takes the failure branch.

    faults.inject("flush.engine", error=RuntimeError("XLA OOM"), times=2)
    ... the next two engine flushes raise, then behavior is clean again

    with faults.injected("write.pre_publish", error=faults.Crash("died")):
        server.insert_objects(...)        # acked never happens: WAL has
                                          # the record, publish does not

Two injection flavors per point:

* ``error=`` — ``fire`` raises that exception (fresh copy semantics are
  the caller's concern; the same instance is raised each time);
* ``callback=`` — ``fire(point, **ctx)`` returns ``callback(**ctx)``;
  the callback may sleep (slow-flush), return a value the instrumented
  site interprets (e.g. ``wal.torn_tail`` returns how many bytes of the
  record actually reach the disk), or raise.

:class:`Crash` simulates a process dying at the injection point. It
derives from ``BaseException`` so the serving stack's own error
handling (which catches ``Exception`` to keep serving) can never
swallow a simulated crash — exactly like a real SIGKILL, nothing
downstream of the crash point runs.

The registry is process-global (module state) and explicitly NOT
thread-safe — the serving stack is single-event-loop by design. Tests
must :func:`clear` in teardown (or use the :func:`injected` context
manager, which does).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

# Every instrumented site, so a typo'd inject() fails loudly instead of
# arming a point nothing ever fires.
POINTS = frozenset({
    # core/server.py
    "flush.engine",          # raised in place of the engine call
    "flush.slow",            # fired before the engine call (callback sleeps)
    "write.pre_publish",     # after the WAL append, before the publish
    "write.post_publish",    # after the publish, before the write returns
    # core/wal.py
    "wal.torn_tail",         # callback → n bytes of the record written,
                             # then Crash (simulates dying mid-append)
    # checkpoint/ckpt.py
    "ckpt.mid_save",         # between leaf writes and the atomic commit
    "ckpt.post_commit",      # after commit (callback gets path=, e.g. to
                             # corrupt a committed file on purpose)
    # core/engine.py _query_sharded (callback gets shard=)
    "shard.scan_error",      # raised in place of a shard scan, device AND
                             # host-replica attempts (the shard's data is
                             # unscannable, not just its device)
    "shard.scan_slow",       # fired before a DEVICE scan (callback sleeps
                             # — a slow device; the host replica is fine)
    "shard.device_lost",     # fired once per shard per chunk before any
                             # attempt; raising = device gone → instant DOWN
})


class Crash(BaseException):
    """A simulated process death at an injection point.

    BaseException on purpose: the serving stack's keep-serving handlers
    catch ``Exception``; a crash must tear through them like a SIGKILL.
    """


class FaultError(RuntimeError):
    """Default injected failure when ``inject`` gets no error/callback."""


class _Injection:
    __slots__ = ("error", "callback", "remaining")

    def __init__(self, error, callback, times):
        self.error = error
        self.callback = callback
        self.remaining = times          # None → fire forever


_armed: Dict[str, List[_Injection]] = {}
_fired: Dict[str, int] = {}


def inject(point: str, *, error: Optional[BaseException] = None,
           callback: Optional[Callable] = None,
           times: Optional[int] = 1) -> None:
    """Arm ``point``: the next ``times`` fires (None = every fire) raise
    ``error`` or run ``callback`` (exactly one of the two; with neither,
    a generic :class:`FaultError` is raised). Multiple injections on one
    point queue FIFO."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: "
                         f"{sorted(POINTS)}")
    if error is not None and callback is not None:
        raise ValueError("inject: pass error= or callback=, not both")
    if error is None and callback is None:
        error = FaultError(f"injected fault at {point}")
    _armed.setdefault(point, []).append(_Injection(error, callback, times))


def clear(point: Optional[str] = None) -> None:
    """Disarm one point (or everything), and reset the fired counters."""
    if point is None:
        _armed.clear()
        _fired.clear()
    else:
        _armed.pop(point, None)
        _fired.pop(point, None)


def active(point: str) -> bool:
    return bool(_armed.get(point))


def fired(point: str) -> int:
    """How many times ``point`` actually took an injected branch."""
    return _fired.get(point, 0)


def fire(point: str, **ctx):
    """The instrumented-site hook. No-op (returns ``None``) unless the
    point is armed; otherwise consumes one firing of the front injection
    and raises its error or returns its callback's result."""
    queue = _armed.get(point)
    if not queue:
        return None
    inj = queue[0]
    if inj.remaining is not None:
        inj.remaining -= 1
        if inj.remaining <= 0:
            queue.pop(0)
            if not queue:
                _armed.pop(point, None)
    _fired[point] = _fired.get(point, 0) + 1
    if inj.callback is not None:
        return inj.callback(**ctx)
    raise inj.error


@contextlib.contextmanager
def injected(point: str, *, error: Optional[BaseException] = None,
             callback: Optional[Callable] = None,
             times: Optional[int] = 1):
    """Context-manager form of :func:`inject`; disarms the point on exit
    even when the armed fault (e.g. a :class:`Crash`) propagates out."""
    inject(point, error=error, callback=callback, times=times)
    try:
        yield
    finally:
        clear(point)


__all__ = ["POINTS", "Crash", "FaultError", "inject", "clear", "active",
           "fired", "fire", "injected"]
