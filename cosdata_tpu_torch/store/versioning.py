"""Git-like version control over the metadata store.

Mirrors upstream src/models/versioning.rs:13-347: monotonically
increasing u32 version numbers; per-version info records the source
(explicit transaction vs implicit epoch), creation time, and op statistics;
a current-version pointer plus a background ("last indexed") pointer used
for WAL replay on restart (types.rs:747-760).

Port of ``cosdata_tpu/store/versioning.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import time

from cosdata_tpu_torch.store.meta import MetaStore


class VersionControl:
    def __init__(self, meta: MetaStore, collection: str):
        self.meta = meta
        self.db = f"versions:{collection}"
        if self.meta.get(self.db, "current") is None:
            self.meta.put(self.db, "current", 0)
            self.meta.put(self.db, "background", 0)
            self.meta.put(
                self.db,
                ("info", 0),
                {
                    "source": {"kind": "root"},
                    "created_at": time.time(),
                    "records_upserted": 0,
                    "records_deleted": 0,
                    "total_operations": 0,
                },
            )

    # -- allocation -----------------------------------------------------

    def allot_version(self) -> int:
        """Next version number (not yet current)."""
        cur = self.meta.get(self.db, "current")
        return int(cur) + 1

    def set_current_version(
        self,
        version: int,
        source: dict,
        upserted: int = 0,
        deleted: int = 0,
        total_ops: int = 0,
    ) -> None:
        self.meta.put(
            self.db,
            ("info", version),
            {
                "source": source,
                "created_at": time.time(),
                "records_upserted": upserted,
                "records_deleted": deleted,
                "total_operations": total_ops,
            },
        )
        self.meta.put(self.db, "current", int(version))

    # -- pointers ---------------------------------------------------------

    @property
    def current_version(self) -> int:
        return int(self.meta.get(self.db, "current") or 0)

    @property
    def background_version(self) -> int:
        return int(self.meta.get(self.db, "background") or 0)

    def update_background_version(self, version: int) -> None:
        """Advance the fully-indexed pointer — MONOTONIC: an implicit
        epoch closing after a later explicit version finished indexing
        must not regress the pointer (it would pin the 'still indexing'
        warning on every search until restart)."""
        cur = self.background_version
        self.meta.put(self.db, "background", max(int(version), int(cur)))

    # -- listing ----------------------------------------------------------

    def version_info(self, version: int) -> dict | None:
        return self.meta.get(self.db, ("info", version))

    def list_versions(self) -> list[dict]:
        out = []
        for key, value in self.meta.items(self.db):
            if isinstance(key, (list, tuple)) and key and key[0] == "info":
                value = dict(value)
                value["version"] = key[1]
                out.append(value)
        out.sort(key=lambda v: v["version"])
        return out

    def unindexed_versions(self) -> list[int]:
        """Versions in (background, current] needing WAL replay on restart."""
        return list(range(self.background_version + 1, self.current_version + 1))
