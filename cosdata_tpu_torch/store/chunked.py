"""Chunked array persistence with dirty-row tracking — O(delta) snapshots.

The reference persists index state append-only: node records patched in
place in rotated ``{file_id}.index`` files plus an append-only ``prop.data``
(upstream src/models/file_persist.rs:16-157, offset_counter.rs:70-77).
A dense-array engine can't append — adjacency rows mutate — but it can do
the moral equivalent: split every large row-major array into fixed row
chunks, remember which chunks a mutation touched, and rewrite only those at
flush time. A commit of +10k vectors into a 1M-row collection then writes
O(touched chunks), not O(collection).

Layout per array (inside a snapshot directory)::

    <name>.meta.json                    {shape, dtype, chunk_rows, axis, gen,
                                         chunks: {"0": [epoch, row_extent]}}
    <name>.c<chunk>.e<epoch>.r<rows>.npy  one immutable file per chunk;
                                          epoch AND row extent in the name,
                                          so extent changes (capacity grow/
                                          shrink) write new files

Chunk files are immutable once written; the meta file (atomically replaced)
references exactly one epoch per chunk, so a crash mid-save never produces
a torn snapshot — stale chunk files are garbage-collected on the next
successful save. Epochs come from a :class:`DirtyTracker` owned by the
in-memory structure; each snapshot directory records the epochs it has, so
several directories (current snapshot + version-context history) can catch
up independently from one tracker.

Port of ``cosdata_tpu/store/chunked.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

#: rows per chunk — 64k rows x 768 f32 = 192 MB worst case (raw vectors),
#: 16 MB for u8 codes, 16 MB for (64,) int32 adjacency
CHUNK_ROWS = 65536


class DirtyTracker:
    """Per-(array, row-chunk) mutation epochs.

    ``mark_*`` record that rows of a named array changed; ``epochs`` reports
    the latest mutation epoch per chunk so savers can skip clean chunks.
    """

    def __init__(self):
        import uuid

        self._epoch = 1
        self._chunks: dict[str, dict[int, int]] = {}
        #: identity token: a *new* tracker (rebuilt structure) restarts its
        #: epochs, so savers must not trust chunk epochs recorded under a
        #: different generation
        self.gen = uuid.uuid4().hex

    def bump(self) -> None:
        self._epoch += 1

    def mark_range(self, name: str, lo: int, hi: int) -> None:
        """Mark rows [lo, hi) dirty."""
        if hi <= lo:
            return
        d = self._chunks.setdefault(name, {})
        for c in range(lo // CHUNK_ROWS, (hi - 1) // CHUNK_ROWS + 1):
            d[c] = self._epoch

    def mark_rows(self, name: str, rows) -> None:
        rows = np.asarray(rows)
        if rows.size == 0:
            return
        d = self._chunks.setdefault(name, {})
        for c in np.unique(rows[rows >= 0] // CHUNK_ROWS):
            d[int(c)] = self._epoch

    def mark_all(self, name: str, n_rows: int) -> None:
        self.mark_range(name, 0, max(n_rows, 1))

    def epoch_of(self, name: str, chunk: int) -> int:
        return self._chunks.get(name, {}).get(chunk, 0)

    def view(self, name: str) -> "_TrackerView":
        """Bind a track-name: several persisted arrays (e.g. adj0 + adj0_d)
        can share one dirty-row space."""
        return _TrackerView(self, name)


class _TrackerView:
    def __init__(self, tracker: DirtyTracker, name: str):
        self._t = tracker
        self._name = name
        self.gen = tracker.gen

    def epoch_of(self, _name: str, chunk: int) -> int:
        return self._t.epoch_of(self._name, chunk)


def _atomic_json(path: Path, obj) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_chunked(
    snap_dir: Path,
    name: str,
    arr,  # torch tensor or numpy array; chunked along `axis`
    tracker: DirtyTracker | None,
    axis: int = 0,
) -> None:
    """Write the dirty chunks of ``arr`` into ``snap_dir``.

    ``tracker=None`` forces a full write. Device arrays are transferred
    chunk-by-chunk — clean chunks never leave the device.
    """
    snap_dir = Path(snap_dir)
    snap_dir.mkdir(parents=True, exist_ok=True)
    meta_p = snap_dir / f"{name}.meta.json"
    shape = tuple(int(s) for s in arr.shape)
    dtype = str(np.dtype(arr.dtype))
    rows = shape[axis]
    n_chunks = max(-(-rows // CHUNK_ROWS), 1)
    old = None
    if meta_p.exists():
        with open(meta_p) as f:
            old = json.load(f)
        if (
            tuple(old["shape"][:axis]) != tuple(shape[:axis])
            or tuple(old["shape"][axis + 1 :]) != tuple(shape[axis + 1 :])
            or old["dtype"] != dtype
            or old.get("axis", 0) != axis
            or old.get("chunk_rows", CHUNK_ROWS) != CHUNK_ROWS
            or old.get("gen") != (tracker.gen if tracker is not None else None)
        ):
            old = None  # layout or structure generation changed: full rewrite
    # chunks meta value = [epoch, row_extent]: a saved chunk is reusable
    # only if BOTH its epoch is current and its row extent still matches —
    # a capacity grow/shrink changes the boundary chunk's extent without
    # marking any row dirty, and the stale partial file would otherwise be
    # skipped and crash the next load. Extent lives in the filename too, so
    # extent changes write a NEW immutable file (crash mid-save keeps the
    # old meta + old files fully consistent).
    saved: dict[int, tuple[int, int]] = {}
    for k, v in (old or {}).get("chunks", {}).items():
        if isinstance(v, list) and len(v) == 2:
            saved[int(k)] = (int(v[0]), int(v[1]))
    new_chunks: dict[int, tuple[int, int]] = {}
    for c in range(n_chunks):
        cur = tracker.epoch_of(name, c) if tracker is not None else 1
        lo = c * CHUNK_ROWS
        hi = min(lo + CHUNK_ROWS, rows)
        extent = hi - lo
        have = saved.get(c)
        # a chunk recorded at epoch e is current if e >= cur; chunks the
        # tracker never saw (epoch 0) still need one initial write
        if (
            have is not None
            and have[0] >= cur
            and have[1] == extent
            and tracker is not None
        ):
            new_chunks[c] = have
            continue
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(lo, hi)
        part = np.asarray(arr[tuple(sl)])
        epoch = max(cur, 1)
        fp = snap_dir / f"{name}.c{c}.e{epoch}.r{extent}.npy"
        tmp = snap_dir / f"{name}.c{c}.e{epoch}.r{extent}.npy.tmp"
        with open(tmp, "wb") as f:
            np.save(f, part)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fp)
        new_chunks[c] = (epoch, extent)
    _atomic_json(
        meta_p,
        {
            "shape": list(shape),
            "dtype": dtype,
            "chunk_rows": CHUNK_ROWS,
            "axis": axis,
            "gen": tracker.gen if tracker is not None else None,
            "chunks": {str(k): list(v) for k, v in new_chunks.items()},
        },
    )
    # one dir fsync covers every chunk rename + the meta replace above
    dfd = os.open(snap_dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    # GC chunk files the meta no longer references, and .tmp leftovers a
    # crash mid-write may have stranded (they never matched *.npy before)
    live = {f"{name}.c{c}.e{e}.r{r}.npy" for c, (e, r) in new_chunks.items()}
    for f in snap_dir.glob(f"{name}.c*.npy"):
        if f.name not in live:
            f.unlink(missing_ok=True)
    for f in snap_dir.glob(f"{name}.c*.npy.tmp"):
        f.unlink(missing_ok=True)


def load_chunked(snap_dir: Path, name: str, out_factory=None) -> np.ndarray | None:
    """Assemble the array from its chunk files (None if absent).

    ``out_factory(shape, dtype)``: optional destination allocator — lets a
    caller stream chunks directly into e.g. a disk-backed memmap instead of
    materializing the whole array in RAM (the beyond-RAM raw tier).
    """
    snap_dir = Path(snap_dir)
    meta_p = snap_dir / f"{name}.meta.json"
    if not meta_p.exists():
        return None
    with open(meta_p) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    axis = meta.get("axis", 0)
    if out_factory is not None:
        out = out_factory(shape, np.dtype(meta["dtype"]))
    else:
        out = np.zeros(shape, np.dtype(meta["dtype"]))
    rows = shape[axis]
    chunk_rows = meta.get("chunk_rows", CHUNK_ROWS)
    for c_str, rec in meta["chunks"].items():
        c = int(c_str)
        lo = c * chunk_rows
        hi = min(lo + chunk_rows, rows)
        if isinstance(rec, list):
            epoch, extent = int(rec[0]), int(rec[1])
            part = np.load(snap_dir / f"{name}.c{c}.e{epoch}.r{extent}.npy")
        else:  # pre-extent meta format
            part = np.load(snap_dir / f"{name}.c{c}.{int(rec)}.npy")
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(lo, hi)
        out[tuple(sl)] = part
    return out


def chunked_exists(snap_dir: Path, name: str) -> bool:
    return (Path(snap_dir) / f"{name}.meta.json").exists()


def adopt_tracker(snap_dir: Path, tracker: DirtyTracker, names: list[str]) -> None:
    """After loading a snapshot, resume its chunk generation: the in-memory
    arrays now equal the on-disk chunks, so the (fresh) tracker takes over
    the dir's gen and starts its epochs above everything recorded — clean
    chunks stay skipped across restarts, dirty ones still rewrite."""
    snap_dir = Path(snap_dir)
    gen = None
    max_epoch = 0
    for nm in names:
        meta_p = snap_dir / f"{nm}.meta.json"
        if not meta_p.exists():
            return
        with open(meta_p) as f:
            meta = json.load(f)
        g = meta.get("gen")
        if g is None or (gen is not None and g != gen):
            return
        gen = g
        for rec in meta.get("chunks", {}).values():
            e = int(rec[0]) if isinstance(rec, list) else int(rec)
            max_epoch = max(max_epoch, e)
    if gen is not None:
        tracker.gen = gen
        tracker._epoch = max_epoch + 1
