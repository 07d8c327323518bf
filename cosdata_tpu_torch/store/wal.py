"""Write-ahead log for transactions.

Mirrors the reference's per-transaction WAL semantics
(upstream src/models/wal.rs:23-250, durable_wal.rs:12-100):

- ``VectorOp`` = Upsert(list of raw vectors) | Delete(vector_id)
- header counters: records_upserted, records_deleted, total_operations
- explicit transactions buffer in memory and flush to ``{version}.wal`` at
  pre-commit; implicit (streaming) transactions append durably per op.

Framing is msgpack-per-record after a fixed msgpack header (the reference
uses a hand-rolled varint format; the on-disk format is ours, the lifecycle
semantics are the parity surface).

Port of ``cosdata_tpu/store/wal.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import msgpack

OP_UPSERT = 0
OP_DELETE = 1


class WALFile:
    """In-memory WAL, flushed once at pre-commit (wal.rs:35-100)."""

    def __init__(self):
        self.ops: list[tuple[int, object]] = []
        self.records_upserted = 0
        self.records_deleted = 0
        # stored, not len(ops): flush() drops the in-memory payloads but
        # the counters must stay queryable (txn status after commit)
        self.total_operations = 0

    def append_upsert(self, vectors: list[dict]) -> None:
        self.ops.append((OP_UPSERT, vectors))
        self.records_upserted += len(vectors)
        self.total_operations += 1

    def append_delete(self, vector_id) -> None:
        self.ops.append((OP_DELETE, vector_id))
        self.records_deleted += 1
        self.total_operations += 1

    def flush(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(
                msgpack.packb(
                    {
                        "upserted": self.records_upserted,
                        "deleted": self.records_deleted,
                        "total_ops": self.total_operations,
                    }
                )
            )
            for op, payload in self.ops:
                f.write(msgpack.packb([op, payload]))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the DIRECTORY: the rename's dirent must be durable before
        # the commit is acknowledged, or a crash makes the committed WAL
        # vanish and restart recovery silently skips the version
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        # ops now live on disk; index_version reads them back from the
        # file, so drop the in-memory payloads (a long-running server
        # otherwise pins every committed transaction's vectors in RAM —
        # status queries only need the counters, which stay)
        self.ops = []


def read_wal(path: str | Path):
    """Returns (header dict, list of (op, payload)) — wal.rs:137."""
    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, strict_map_key=False)
        header = unpacker.unpack()
        ops = [tuple(rec) for rec in unpacker]
    return header, ops


class DurableWALFile:
    """Streaming WAL for implicit transactions (durable_wal.rs:12-100):
    every append hits disk before returning."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self.records_upserted = 0
        self.records_deleted = 0
        self.total_operations = 0
        if self.path.stat().st_size == 0:
            self._f.write(msgpack.packb({"durable": True}))
            self._f.flush()

    def append_upsert(self, vectors: list[dict]) -> None:
        self._append([OP_UPSERT, vectors])
        self.records_upserted += len(vectors)

    def append_delete(self, vector_id) -> None:
        self._append([OP_DELETE, vector_id])
        self.records_deleted += 1

    def _append(self, rec) -> None:
        with self._lock:
            self._f.write(msgpack.packb(rec))
            self._f.flush()
            os.fsync(self._f.fileno())
            self.total_operations += 1

    def close(self) -> None:
        with self._lock:
            self._f.close()


def read_durable_wal(path: str | Path):
    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, strict_map_key=False)
        _header = unpacker.unpack()
        return [tuple(rec) for rec in unpacker]
