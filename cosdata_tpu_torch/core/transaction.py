"""Explicit and implicit transactions with live status statistics.

Mirrors upstream src/models/collection_transaction.rs:

- "transaction as a resource": one open explicit transaction per collection
  (api/vectordb/transactions/repo.rs:17-99); ops buffer in an in-memory WAL
  and only hit the indexes after commit, in the background.
- implicit (streaming) transactions write a durable WAL per op and index
  inline; they are swapped out by an epoch timer (collection.rs:264-278).
- ProcessingStats (collection_transaction.rs:285-330): records_upserted,
  rate, ETA, percentage — surfaced over GET .../transactions/{id}/status.

Port of ``cosdata_tpu/core/transaction.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import threading
import time
import uuid

from cosdata_tpu_torch.store.wal import DurableWALFile, WALFile


class ProcessingStats:
    def __init__(self):
        self.records_upserted = 0
        self.records_deleted = 0
        self.total_operations = 0
        self.percentage_complete = 0.0
        self.processing_time_seconds: float | None = None
        self.average_throughput: float | None = None
        self.current_processing_rate: float | None = None
        self.estimated_completion: str | None = None
        self.version_created: int | None = None

    def to_dict(self) -> dict:
        return {
            "records_upserted": self.records_upserted,
            "records_deleted": self.records_deleted,
            "total_operations": self.total_operations,
            "percentage_complete": round(self.percentage_complete, 2),
            "processing_time_seconds": self.processing_time_seconds,
            "average_throughput": self.average_throughput,
            "current_processing_rate": self.current_processing_rate,
            "estimated_completion": self.estimated_completion,
            "version_created": self.version_created,
        }


class TransactionStatus:
    NOT_STARTED = "not_started"
    IN_PROGRESS = "in_progress"
    COMPLETE = "complete"

    def __init__(self):
        self.state = self.NOT_STARTED
        self.stats = ProcessingStats()
        self.started_at: float | None = None
        self._lock = threading.Lock()

    def start(self, total_ops: int):
        with self._lock:
            self.state = self.IN_PROGRESS
            self.started_at = time.time()
            self.stats.total_operations = total_ops

    def progress(self, upserted: int, deleted: int, done_ops: int):
        with self._lock:
            s = self.stats
            s.records_upserted = upserted
            s.records_deleted = deleted
            elapsed = max(time.time() - (self.started_at or time.time()), 1e-9)
            s.percentage_complete = (
                100.0 * done_ops / s.total_operations if s.total_operations else 100.0
            )
            s.current_processing_rate = upserted / elapsed
            if s.total_operations and done_ops:
                remaining = (s.total_operations - done_ops) * elapsed / done_ops
                s.estimated_completion = time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + remaining)
                )

    def complete(self, version: int):
        with self._lock:
            self.state = self.COMPLETE
            s = self.stats
            s.percentage_complete = 100.0
            if self.started_at is not None:
                s.processing_time_seconds = round(time.time() - self.started_at, 3)
                if s.processing_time_seconds > 0:
                    s.average_throughput = round(
                        s.records_upserted / s.processing_time_seconds, 2
                    )
            s.estimated_completion = None
            s.version_created = version

    def to_dict(self) -> dict:
        with self._lock:
            return {"status": self.state, **self.stats.to_dict()}


class ExplicitTransaction:
    def __init__(self):
        self.txn_id = uuid.uuid4().hex[:16]
        self.wal = WALFile()
        self.status = TransactionStatus()
        self.created_at = time.time()
        self.committed = False
        self.aborted = False

    def to_dict(self) -> dict:
        return {
            "transaction_id": self.txn_id,
            "created_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.created_at)
            ),
        }


class ImplicitTransaction:
    """Lazily-initialized streaming transaction (collection_transaction.rs:195-236)."""

    def __init__(self, wal_path: str, version: int):
        self.version = version
        self.wal = DurableWALFile(wal_path)
        self.created_at = time.time()
