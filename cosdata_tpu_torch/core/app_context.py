"""Application context: config, collections map, users, auth secrets.

Mirrors AppContext/AppEnv (upstream src/app_context.rs:12-50,
src/models/types.rs:1413-1588): a single process-wide context owning the
metadata store, the collections map, the admin-key verification (double
SHA-256) and the indexing manager.

Port of ``cosdata_tpu/core/app_context.py``. Changed from the reference:
the context takes the ``device`` every collection's indexes live on (a
sharded dense index cycles its shards over the CUDA devices); a dense
snapshot reloads with its HNSW graph (a scan-only one without);
``close()`` stops the epoch timer and drains background indexing.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

import torch

from cosdata_tpu_torch.config import Config
from cosdata_tpu_torch.core.collection import Collection
from cosdata_tpu_torch.core.indexing_manager import IndexingManager
from cosdata_tpu_torch.store.meta import MetaStore


def double_sha256(data: bytes) -> bytes:
    """get_admin_key scheme (types.rs:1423-1478)."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


class AppContext:
    def __init__(self, config: Config, admin_key: str, device):
        self.config = config
        self.device = torch.device(device)
        self.data_dir = Path(config.data_path)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.meta = MetaStore(self.data_dir / "meta.sqlite")
        self.indexing = IndexingManager()
        self.collections: dict[str, Collection] = {}
        self.lock = threading.RLock()
        self._closed = False
        self._timer: threading.Timer | None = None

        stored = self.meta.get("meta", "admin_key_hash")
        digest = double_sha256(admin_key.encode())
        if stored is None:
            self.meta.put("meta", "admin_key_hash", digest)
        elif bytes(stored) != digest:
            raise PermissionError("admin key does not match stored hash")
        self.admin_key = admin_key
        self.max_loaded_collections = getattr(
            getattr(config, "cache", None), "max_collections", 10
        )

        # users map (types.rs:1323-1404 / :1557-1579): admin user registered
        if self.meta.get("users", "admin") is None:
            self.meta.put(
                "users", "admin", {"username": "admin", "key_hash": digest}
            )

        self._load_collections()
        self._start_epoch_timer()

    def _start_epoch_timer(self):
        """Per-epoch implicit-transaction close (collection.rs:264-278; the
        reference spawns a per-collection epoch thread, epoch_length=3600s)."""
        import time

        interval = min(self.config.epoch_length / 4, 60.0)

        def tick():
            try:
                with self.lock:  # snapshot: writers mutate the dict
                    colls = list(self.collections.values())
                for coll in colls:
                    try:
                        if (
                            coll.implicit is not None
                            and time.time() - coll.implicit.created_at
                            >= self.config.epoch_length
                        ):
                            coll.close_epoch()
                    except Exception:  # pragma: no cover
                        pass
            finally:
                # re-arm UNCONDITIONALLY (until close): an escaping exception
                # would kill epoch closing for the process lifetime
                arm()

        def arm():
            with self.lock:
                if self._closed:
                    return
                self._timer = threading.Timer(interval, tick)
                self._timer.daemon = True
                self._timer.start()

        arm()

    def close(self) -> None:
        """Stop the epoch timer, finish queued background indexing and
        close the metadata store. Open implicit epochs stay on disk as
        durable WALs (closed here), which the next context replays."""
        with self.lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
        self.indexing.stop()
        for coll in self.snapshot_collections():
            if coll.implicit is not None:
                coll.implicit.wal.close()
        self.meta.close()

    # ------------------------------------------------------------- lifecycle

    def _load_collections(self):
        """Reload collection configs + replay unindexed WALs (types.rs:575-760).

        Index data snapshots are reloaded where present; versions after the
        background pointer are re-indexed from their WAL files.
        """
        for _, cfg in self.meta.items("collections"):
            coll = Collection(self.meta, self.data_dir, cfg, self.device)
            coll.app_config = self.config
            self._restore_indexes(coll, cfg)
            self._replay_wals(coll)
            self.collections[coll.name] = coll

    def _replay_wals(self, coll: Collection) -> None:
        """Crash recovery: replay every WAL that still exists on disk.

        The version-range form ((background, current]) alone is WRONG for
        implicit epochs: an explicit commit mid-epoch advances the
        background pointer PAST the still-open implicit version, whose
        durable WAL would then never be replayed — acknowledged streaming
        writes lost. WAL files are deleted only after successful indexing
        or epoch close, so "any .wal still present" is exactly the
        unreplayed set; replay is idempotent (upserts re-resolve ids,
        deletes are tombstones). Each replay is fault-isolated: one
        poisoned WAL (e.g. a malformed committed payload) must not
        crash-loop server startup."""
        versions = set(coll.vcs.unindexed_versions())
        for p in coll.data_dir.glob("*.wal"):
            stem = p.stem
            if stem.isdigit():
                versions.add(int(stem))
        for version in sorted(versions):
            try:
                self.indexing.index_version_on_restart(coll, version)
            except Exception:  # pragma: no cover - logged, not fatal
                import logging

                logging.getLogger(__name__).exception(
                    "WAL replay failed for %s version %s — continuing "
                    "startup; the WAL is kept for manual inspection",
                    coll.name, version,
                )

    def _restore_indexes(self, coll: Collection, cfg: dict):
        coll.restore_indexes_from_meta()
        snap_dir = coll.data_dir / "snapshot"
        if snap_dir.exists():
            from cosdata_tpu_torch.store.snapshots import load_collection_state

            load_collection_state(coll, snap_dir)

    def _persist_index_descriptors(self, coll: Collection):
        self.meta.put("indexes", coll.name, coll.list_indexes())

    # ------------------------------------------------------------ collections

    # max resident collections set from config.cache in __init__
    # (reference collection_cache: 10 by default, config_loader.rs:201-225)

    def create_collection(self, cfg: dict) -> Collection:
        with self.lock:
            name = cfg.get("name")
            if not name:
                raise ValueError("collection name is required")
            if name in self.collections or self.meta.get("collections", name):
                raise ValueError(f"collection {name} already exists")
            coll = Collection(self.meta, self.data_dir, cfg, self.device)
            coll.app_config = self.config
            self.collections[name] = coll
            self.meta.put("collections", name, cfg)
            self._maybe_evict(keep=name)
            return coll

    def get_collection(self, name: str) -> Collection | None:
        coll = self.collections.get(name)
        if coll is None and self.meta.get("collections", name) is not None:
            # lazily reload an unloaded collection (collection_cache.rs:56-270)
            coll = self.load_collection(name)
        elif coll is not None:
            # move-to-back so eviction is least-recently-used, matching the
            # reference's usage-based eviction (collection_cache.rs:56-270)
            with self.lock:
                if name in self.collections:
                    self.collections[name] = self.collections.pop(name)
        return coll

    def unload_collection(self, name: str) -> None:
        """Snapshot and drop a collection from memory (POST .../unload)."""
        with self.lock:
            coll = self.collections.get(name)
            if coll is None:
                if self.meta.get("collections", name) is None:
                    raise KeyError(f"collection '{name}' not found")
                return
            # drain queued background indexing first: a version indexed on
            # an instance popped from the map would write snapshots/WAL
            # deletions racing the next lazy reload of the same files
            self.indexing.wait_idle()
            self.collections.pop(name, None)
            coll.flush_indexes()
            coll.save_snapshot()

    def load_collection(self, name: str) -> Collection:
        with self.lock:
            if name in self.collections:
                return self.collections[name]
            cfg = self.meta.get("collections", name)
            if cfg is None:
                raise KeyError(f"collection '{name}' not found")
            coll = Collection(self.meta, self.data_dir, cfg, self.device)
            coll.app_config = self.config
            self._restore_indexes(coll, cfg)
            self._replay_wals(coll)
            self.collections[name] = coll
            self._maybe_evict(keep=name)
            return coll

    def _maybe_evict(self, keep: str) -> None:
        """Evict the least-recently-used collection past the residency cap.
        Collections with unindexed versions are skipped — evicting one
        would orphan its queued background indexing (which would then race
        a lazy reload on the same WAL/snapshot files)."""
        candidates = [
            n for n, c in self.collections.items()
            if n != keep
            and c.vcs.background_version >= c.vcs.current_version
        ]
        while len(self.collections) > self.max_loaded_collections and candidates:
            victim = candidates.pop(0)
            try:
                self.unload_collection(victim)
            except Exception:  # pragma: no cover
                self.collections.pop(victim, None)

    def delete_collection(self, name: str) -> dict:
        """Drop a collection AND its on-disk state (snapshots, WALs, version
        records) so a recreated same-named collection starts clean — the
        reference deletes collection data from disk on DELETE. Returns the
        collection's config record. An UNLOADED collection is deleted
        without loading it (loading would synchronously replay WALs and
        rebuild indexes on the device — minutes of work — just to derive a
        path that is a pure function of the name)."""
        import shutil

        with self.lock:
            cfg = self.meta.get("collections", name)
            coll = self.collections.pop(name, None)
            if cfg is None and coll is None:
                raise KeyError(f"collection '{name}' not found")
            # drain queued background indexing: a worker indexing this
            # collection after rmtree would recreate the data dir (ghost
            # snapshot resurrected by a future same-named collection)
            self.indexing.wait_idle()
            self.meta.delete("collections", name)
            self.meta.delete("indexes", name)
            self.meta.clear(f"versions:{name}")
            data_dir = (
                coll.data_dir
                if coll is not None
                else Path(self.data_dir) / "collections" / name
            )
            shutil.rmtree(data_dir, ignore_errors=True)
            return coll.to_dict() if coll is not None else (cfg or {"name": name})

    def list_collections(self) -> list[dict]:
        with self.lock:  # LRU move-to-back mutates the dict concurrently
            colls = list(self.collections.values())
        return [c.to_dict() for c in colls]

    def snapshot_collections(self) -> list:
        """Point-in-time list of loaded Collection objects (safe iteration
        for callers on other threads — gRPC pool, epoch timer)."""
        with self.lock:
            return list(self.collections.values())
