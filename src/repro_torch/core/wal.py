"""Write-ahead log for the serving stack's mutation path (reference:
``repro.core.wal``, DESIGN.md §14). The on-disk format is the
reference's, so each package replays the log the other writes. Records
hold numpy arrays: the server copies device tensors to the host first.

The LSM write path (DESIGN.md §11) makes writes O(batch) by keeping them
in an in-memory delta segment until compaction — which means every
acknowledged insert/delete since the last ``snapshot.save`` lives only
in process memory. A :class:`WriteAheadLog` closes that durability hole:
``StreamingServer.insert_objects`` / ``delete_objects`` append one
checksummed record *before* publishing the successor snapshot, so after
a crash ``api.recover`` = load the last good snapshot + replay the intact
WAL suffix, and no acknowledged write is ever lost.

On-disk format — one append-only file::

    [8-byte magic "LISTWAL1"]
    record*:  [u32 payload length][u32 crc32(payload)][payload]

The payload is a self-contained ``.npz`` blob (numpy's own container —
any tool can inspect it) holding the op kind (``insert`` | ``delete``),
the post-write snapshot ``version`` the record produced, and the op's
arrays. Properties:

* **torn tails are detected, never propagated**: a crash mid-append
  leaves a record whose length/crc don't match; :meth:`records` stops at
  the first bad record and reports the good prefix. Re-opening for
  append truncates the torn tail so new records extend the good prefix.
* **append is atomic-enough**: length+crc are written with the payload
  in one buffered write and (optionally, default on) fsync'd, so an
  acknowledged write is on disk before the publish makes it visible.
* **replay is idempotent w.r.t. snapshots**: each record carries the
  snapshot version its publish produced; recovery replays only records
  with ``version > loaded_snapshot.meta.version``, so a crash between
  ``snapshot.save`` and :meth:`truncate` double-applies nothing.
* :meth:`truncate` (called by ``StreamingServer.checkpoint`` after a
  successful compact+save) atomically replaces the log with an empty
  one via temp-file + ``os.replace``.

The ``wal.torn_tail`` fault point (core/faults.py) lets the chaos tier
inject a mid-append crash: the injection returns how many bytes of the
record reach the disk, the append writes exactly that prefix, and a
:class:`~repro_torch.core.faults.Crash` tears out — precisely the state a real
power cut leaves behind.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import faults as faults_lib

MAGIC = b"LISTWAL1"
_HEADER = struct.Struct("<II")           # payload length, crc32(payload)

KINDS = ("insert", "delete")


class WalCorrupt(ValueError):
    """The log's magic header is wrong — this is not (or no longer) a
    LIST WAL. Torn/garbage *records* are NOT an error: they are the
    expected crash artifact and are silently dropped at the tail."""


def encode_record(kind: str, version: int, arrays: Dict[str, np.ndarray]
                  ) -> bytes:
    """One op → a self-contained npz payload."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    bio = io.BytesIO()
    np.savez(bio, kind=np.array(kind), version=np.array(int(version)),
             **{k: np.asarray(v) for k, v in arrays.items()})
    return bio.getvalue()


def decode_record(payload: bytes) -> dict:
    with np.load(io.BytesIO(payload)) as z:
        out = {k: z[k] for k in z.files}
    out["kind"] = str(out["kind"])
    out["version"] = int(out["version"])
    return out


def _scan(path: str) -> Tuple[List[dict], int, bool]:
    """Parse the log → (good records, byte offset of the good prefix's
    end, torn-tail flag). Stops at the first short/corrupt record."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise WalCorrupt(f"{path}: bad magic {magic!r} — not a LIST "
                             f"write-ahead log")
        records: List[dict] = []
        good_end = f.tell()
        torn = False
        while True:
            header = f.read(_HEADER.size)
            if len(header) == 0:
                break
            if len(header) < _HEADER.size:
                torn = True
                break
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                torn = True
                break
            try:
                records.append(decode_record(payload))
            except Exception:                      # noqa: BLE001
                torn = True                        # crc collision / garbage
                break
            good_end = f.tell()
        return records, good_end, torn


class WriteAheadLog:
    """Append-only, checksummed durability log for serving writes.

    ``fsync=True`` (default) makes every acknowledged write durable at
    the cost of one fsync per write batch — the LIST write path batches,
    so this amortizes exactly like the engine call does. ``fsync=False``
    trades the tail of writes since the last OS flush for latency
    (still crash-consistent: the checksums bound what replay trusts).
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self.dropped_tail = False      # a previous crash left a torn record
        self._n_records = 0
        self._last_version = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        if os.path.exists(path):
            records, good_end, torn = _scan(path)
            self.dropped_tail = torn
            self._n_records = len(records)
            if records:
                self._last_version = max(r["version"] for r in records)
            self._f = open(path, "r+b")
            # new appends must extend the GOOD prefix, not a torn record
            self._f.truncate(good_end)
            self._f.seek(good_end)
        else:
            self._f = open(path, "w+b")
            self._f.write(MAGIC)
            self._flush()

    # -- inspection ---------------------------------------------------------

    @property
    def n_records(self) -> int:
        return self._n_records

    @property
    def last_version(self) -> int:
        """Highest snapshot version any record in the log produced."""
        return self._last_version

    def nbytes(self) -> int:
        return self._f.tell()

    def records(self) -> List[dict]:
        """Re-read the good prefix from disk (what replay would see)."""
        self._f.flush()
        records, _, _ = _scan(self.path)
        return records

    # -- the write path -----------------------------------------------------

    def append(self, kind: str, *, version: int,
               **arrays) -> int:
        """Durably append one op record; returns the record count after.

        MUST be called before the corresponding snapshot publish: the
        contract is WAL-then-publish, so an acknowledged write is always
        either on disk or not yet visible."""
        payload = encode_record(kind, version, arrays)
        blob = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        torn_at = faults_lib.fire("wal.torn_tail", nbytes=len(blob),
                                  path=self.path)
        if torn_at is not None:
            # simulated crash mid-append: exactly torn_at bytes reach
            # the disk, then the process "dies"
            self._f.write(blob[:int(torn_at)])
            self._flush()
            raise faults_lib.Crash(
                f"simulated crash mid-WAL-append ({int(torn_at)}/"
                f"{len(blob)} bytes reached {self.path})")
        self._f.write(blob)
        self._flush()
        self._n_records += 1
        self._last_version = max(self._last_version, int(version))
        return self._n_records

    def _flush(self):
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    # -- lifecycle ----------------------------------------------------------

    def truncate(self) -> None:
        """Drop every record — the log's writes are now durable in a
        committed snapshot (compact + save happened). Atomic: a fresh
        empty log is built beside and ``os.replace``d over the old one,
        so a crash mid-truncate leaves either the full old log (replay
        skips it by version) or the empty new one — never a torn file."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "r+b")
        self._f.seek(0, os.SEEK_END)
        self._n_records = 0
        self._last_version = 0
        self.dropped_tail = False

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay(path: str) -> Iterator[dict]:
    """Read-only replay of a log file's good prefix (no lock, no append
    handle): yields decoded records in append order. Missing file →
    empty iterator, matching 'nothing to recover'."""
    if not os.path.exists(path):
        return iter(())
    records, _, _ = _scan(path)
    return iter(records)


def wal_path(wal_dir: str) -> str:
    """The canonical log location under a WAL directory."""
    return os.path.join(wal_dir, "serving.wal")


__all__ = ["WriteAheadLog", "WalCorrupt", "replay", "wal_path",
           "encode_record", "decode_record", "MAGIC", "KINDS"]
