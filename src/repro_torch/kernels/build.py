"""Build the port's CUDA sources into a shared library at first use.

Sources under ``kernels/csrc/`` are compiled by ``nvcc`` for ``sm_90a``
into a plain-C-interface shared library (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. The library lands in
``<repo>/build/kernels/<name>-<hash>/``, keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
Each kernel module holds one :class:`KernelLibrary` (one source, one
library), so a compile error names its kernel and the libraries can be
built side by side. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (/usr/local/cuda)")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str],
                 csrc: Path = CSRC) -> Tuple[ctypes.CDLL, dict]:
    """Compile (if needed) and load ``lib<name>.so`` from files of ``csrc``
    (the port's ``kernels/csrc`` unless given).

    Returns ``(library, info)`` where ``info`` holds the build seconds
    (0 when the cached library was reused) and the compiler's output."""
    paths = [Path(csrc) / s for s in sources]
    out_dir = BUILD_ROOT / f"{name}-{_digest(paths)}"
    lib_path = out_dir / f"lib{name}.so"
    info = {"seconds": 0.0, "log": "", "path": str(lib_path)}
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{info['log']}")
        os.replace(tmp, lib_path)           # atomic: readers see all or none
    return ctypes.CDLL(str(lib_path)), info


class KernelLibrary:
    """A library built from ``sources`` at its first call, then bound by
    ``bind(lib)`` (which sets each C function's ``argtypes``/``restype``).
    Calling it returns the loaded ``ctypes.CDLL``."""

    def __init__(self, name: str, sources: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None], *, csrc: Path = CSRC):
        self.name, self.sources, self._bind = name, tuple(sources), bind
        self.csrc = csrc
        self._lib = None
        self._info: dict = {}

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, info = load_library(self.name, self.sources, self.csrc)
            self._bind(lib)
            self._lib, self._info = lib, info
        return self._lib

    def info(self) -> dict:
        """Build seconds, nvcc/ptxas output and path (builds if needed)."""
        self()
        return dict(self._info)
