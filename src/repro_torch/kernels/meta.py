"""The kernels' meta path, and their names in a profile.

Each kernel wrapper given ``meta`` tensors runs the checks it runs for a
CUDA tensor, allocates its outputs on ``meta`` and launches nothing: in
place of the launch it calls :func:`record` with its module's declared
``work()`` (FLOPs and bytes) under the kernel's launch-count name, and
every active :class:`WorkCounter` adds it. This is how the dry-run
(``launch/dryrun.py``, ``analysis/op_cost.py``) counts a cell's kernels
without a card. Counters are process-wide, not per thread, so a backward
kernel that autograd's engine reaches counts too.

:func:`launch_range` names a real launch in a ``torch.profiler`` trace
(``twin::<name>``, only while a profiler runs), so
``analysis/op_top.py`` finds each twin and its launches by name.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

RANGE_PREFIX = "twin::"

_ACTIVE: List["WorkCounter"] = []


class WorkCounter:
    """``with WorkCounter() as wc:`` → ``wc.by_kernel``, ``{name:
    {"launches", "flops", "bytes"}}`` of every meta-path call inside;
    :attr:`flops` and :attr:`bytes` are their sums."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, int]] = {}

    def __enter__(self) -> "WorkCounter":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def add(self, name: str, flops: int, nbytes: int) -> None:
        r = self.by_kernel.setdefault(name, {"launches": 0, "flops": 0,
                                             "bytes": 0})
        r["launches"] += 1
        r["flops"] += int(flops)
        r["bytes"] += int(nbytes)

    @property
    def flops(self) -> int:
        return sum(r["flops"] for r in self.by_kernel.values())

    @property
    def bytes(self) -> int:
        return sum(r["bytes"] for r in self.by_kernel.values())


def record(name: str, work: Tuple[int, int]) -> None:
    """A meta-path call of kernel ``name`` doing ``work = (flops,
    bytes)``: added to every active counter."""
    flops, nbytes = work
    for counter in _ACTIVE:
        counter.add(name, flops, nbytes)


def launch_range(name):
    """A ``record_function`` range ``twin::<name>`` around a launch while
    ``torch.profiler`` records, else (or for ``name`` None) a context that
    does nothing."""
    if name is not None and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(RANGE_PREFIX + name)
    return contextlib.nullcontext()


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()
