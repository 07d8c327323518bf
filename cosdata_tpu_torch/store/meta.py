"""Embedded metadata KV store (the reference's LMDB role).

The reference opens one LMDB env with 10 named DBs per data dir
(upstream src/models/types.rs:1543-1547, models/meta_persist.rs).
Host metadata has no device angle, so it uses stdlib sqlite3 in WAL mode: a
single-file, crash-safe, multi-reader KV with named sub-databases.

Port of ``cosdata_tpu/store/meta.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path

import msgpack


class MetaStore:
    """Named-DB byte KV over sqlite. Values are msgpack-encoded."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(str(self.path), check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " db TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (db, key))"
        )
        self._conn.commit()


    def _write(self, sql: str, params: tuple) -> None:
        """Execute + commit; ROLL BACK on failure so the shared connection
        never carries a failed statement into a later unrelated commit
        (which would durably persist a write the caller saw fail)."""
        with self._lock:
            try:
                self._conn.execute(sql, params)
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def put(self, db: str, key, value) -> None:
        kb = msgpack.packb(key)
        vb = msgpack.packb(value)
        self._write(
            "INSERT OR REPLACE INTO kv (db, key, value) VALUES (?, ?, ?)",
            (db, kb, vb),
        )

    def get(self, db: str, key, default=None):
        kb = msgpack.packb(key)
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE db = ? AND key = ?", (db, kb)
            ).fetchone()
        if row is None:
            return default
        return msgpack.unpackb(row[0], strict_map_key=False)

    def delete(self, db: str, key) -> None:
        kb = msgpack.packb(key)
        self._write("DELETE FROM kv WHERE db = ? AND key = ?", (db, kb))

    def items(self, db: str):
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE db = ?", (db,)
            ).fetchall()
        return [
            (
                msgpack.unpackb(k, strict_map_key=False),
                msgpack.unpackb(v, strict_map_key=False),
            )
            for k, v in rows
        ]

    def clear(self, db: str) -> None:
        self._write("DELETE FROM kv WHERE db = ?", (db,))

    def close(self) -> None:
        with self._lock:
            self._conn.close()
