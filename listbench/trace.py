"""The traced run's reduction: ``torch.profiler`` with CUDA activity only
(kernels, copies and the CUDA runtime calls, which cost the host little;
recording every host operator as well slowed the served and offline
paths by half on the card) around the measured window, reduced to the
device's busy time, each device operation's time and count, and the idle
gaps named by what the host was doing.

The window is the harness's, stamped with ``time.time_ns()``, the clock of
the profiler's timestamps; device events are clipped to it. Busy time is
the union of the device events' intervals (kernels, copies, sets), so
nothing counts twice. A gap is named by the CUDA runtime call the host
was in at its midpoint (``cudaStreamSynchronize`` when it waits on the
card), or as time outside any CUDA call (Python, the server, numpy).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time

import torch

OUTSIDE = "(host outside CUDA calls)"
TOP = 10
GAP_SCAN_BACK = 256          # host events looked back over per gap


def kernel_names(source: str) -> set:
    """The ``__global__`` function names of a CUDA source's text."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*[(<]")
    return set(pat.findall(source))


def function_name(event_name: str) -> str:
    """A device event's function name without ``void``, namespaces,
    template or argument list."""
    name = event_name.replace("(anonymous namespace)::", "")
    m = re.match(r"\s*(?:void\s+)?([A-Za-z_][\w:]*)", name)
    return m.group(1).split("::")[-1] if m else event_name


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


# the profiler's device activities that occupy the device (user
# annotations mirrored onto the device's timeline do not)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


class Traced:
    """``with Traced(on) as t: ... with t.window(): ...``, then
    ``t.summary`` — a no-op when off, and without a CUDA device (there is
    no device to trace: the summary stays None)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary = None
        self._prof = None
        self._span = None

    @contextlib.contextmanager
    def window(self):
        """Open around the measured window (inside the profiler)."""
        if not self.on:
            yield
            return
        w0 = time.time_ns()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span = (w0, time.time_ns())

    def __enter__(self):
        if self.on and torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = reduce(self._prof, self._span)
        return False


def _occupies_device(e) -> bool:
    """A device event that is work, not an annotation mirrored onto the
    device's timeline (older profilers name no activity type)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    annotation = getattr(e, "is_user_annotation", None)
    return annotation is None or not annotation()


def _events(prof):
    """``(device work, host runtime calls)`` as ``(start_ns, end_ns,
    name)``."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if _occupies_device(e):
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return dev, host


def reduce(prof, span) -> dict:
    """→ ``{window_s, busy_s, device_s_by_name, kernels_by_name,
    n_kernels, device_ops, idle_gaps}``; ``busy_s`` is None when the trace
    holds no device event."""
    dev, host = _events(prof)
    w0, w1 = span
    inside = [(max(s, w0), min(t, w1), n) for s, t, n in dev
              if t > w0 and s < w1]
    if dev and not inside:
        raise RuntimeError("no device event inside the window: the "
                           "profiler's clock is not time.time_ns()")
    dev = inside
    by_name = collections.Counter()
    kernels = collections.Counter()
    for s, t, n in dev:
        by_name[n] += (t - s) / 1e9
        if not is_copy(n):
            kernels[n] += 1
    busy, gaps, end = 0, [], w0
    for s, t, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if end < w1:
        gaps.append((end, w1))
    host = sorted(host)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        at = bisect.bisect_right(starts, mid) - 1
        name = OUTSIDE
        for j in range(at, max(at - GAP_SCAN_BACK, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9 if dev else None,
        "device_s_by_name": dict(by_name),
        "kernels_by_name": dict(kernels),
        "n_kernels": sum(kernels.values()),
        "device_ops": [[n[:120], s] for n, s in by_name.most_common(TOP)],
        "idle_gaps": [[n[:120], s] for n, s in idle.most_common(TOP)],
    }
