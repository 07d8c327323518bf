"""Background indexing manager.

Mirrors upstream src/models/indexing_manager.rs: committed explicit
transactions are queued to a worker thread which replays the WAL into the
indexes, updating live ProcessingStats; on restart every version in
(background_version, current_version] is re-indexed from its WAL
(types.rs:747-760, indexing_manager.rs:250-267).

Port of ``cosdata_tpu/core/indexing_manager.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import logging
import queue
import threading

log = logging.getLogger(__name__)


class IndexingManager:
    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def trigger(self, collection, version: int, txn=None) -> None:
        if self._stopped:
            raise RuntimeError("indexing manager is stopped")
        self._q.put((collection, version, txn))

    def index_version_on_restart(self, collection, version: int) -> None:
        """WAL replay path; synchronous (startup)."""
        wal_path = collection.data_dir / f"{version}.wal"
        if wal_path.exists():
            collection.index_version(version, None)
        else:
            collection.vcs.update_background_version(version)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                # mark the sentinel done, or a later wait_idle()/join()
                # blocks forever on the unfinished count
                self._q.task_done()
                return
            collection, version, txn = item
            try:
                collection.index_version(version, txn)
            except Exception:  # pragma: no cover - logged, not fatal
                log.exception(
                    "indexing failed for %s version %s", collection.name, version
                )
            finally:
                self._q.task_done()

    def wait_idle(self):
        self._q.join()

    def stop(self):
        """Drain queued work, then stop the worker. Items committed before
        stop() must still be indexed (they were acknowledged); new
        trigger() calls are rejected."""
        self._stopped = True
        self._q.join()
        self._q.put(None)
