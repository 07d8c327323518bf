"""Versioned snapshot persistence for collections and their indexes.

Port of ``cosdata_tpu/store/snapshots.py``: the id maps (``maps.msgpack`` +
``maps.log``, copied), the dense part in torch, and the sparse and tf-idf
parts. A checkpoint is an atomic .npz + msgpack snapshot plus chunked row
arrays, written at flush points (txn indexing / epoch close); crash
recovery between snapshots is WAL replay.

The on-disk layout is the reference's, so the two packages read each
other's snapshots:

- ``dense.msgpack`` (store meta and the graph's ``n_up``, ``entry``,
  ``entry_level``, ``level_counts``), ``dense.npz`` (``levels``,
  ``alive``, ``mags``, ``sums``, ``up_slot``) and the chunked ``data``
  (u8 int8 / f16 / f32 rows), ``planes`` (sub-byte, uint32 words) and
  ``raw`` (device raw rows) or ``raw_host`` (host or disk raw rows) arrays;
- a store whose codes spilled writes ``codes_on_host: true`` and loads
  back into host tensors, never onto the device; ``raw_host`` loads into
  host memory, or streams into a fresh memmap for a "disk" index;
- the graph: the chunked ``adj0``, ``adj0_d`` (level 0, rows rewritten by
  the index tracker's ``adj0`` view) and ``up_adj``, ``up_d`` (the upper
  table, by its ``up`` view);
- an index with no graph (spilled, or loaded from a ``scan_only``
  snapshot) writes ``scan_only: true`` and no graph files, and is served
  by the exact scan at any size; so does a kept-graph spill, whose graph
  is only half on the device (the reference writes that state with a (1,)
  placeholder for its tombstones, which its loader serves as all alive);
- the sparse index: ``sparse.npz`` (``alive``, ``has_doc``, ``raw_nnz``),
  the chunked host CSR (``sp_keys``, ``sp_ids``, ``sp_buckets``) and raw
  rows (``sp_raw_dims``, ``sp_raw_vals``), and ``sparse.msgpack`` written
  last; the device CSR, doc rows and head matrix are rebuilt from them at
  the first search;
- a sharded dense engine: one ``dense_shard{s}/`` sub-snapshot per shard
  in the layout above, then ``dense_sharded.msgpack`` (``n_shards``,
  ``n``, ``global_of``: each shard's local row -> global row, and
  ``configured_range``); the load rebuilds the global tombstones from
  the shards';
- the tf-idf index: ``tfidf.msgpack`` (k1, b, avgdl, the document
  accounting, ``alive``/``has_doc`` and each term's postings); its device
  arrays are rebuilt from it at the first search.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import msgpack
import numpy as np
import torch

from cosdata_tpu_torch.ops.storage import VectorStore
from cosdata_tpu_torch.store.chunked import adopt_tracker, chunked_exists, load_chunked, save_chunked

#: the graph's chunked arrays
_GRAPH_ARRAYS = ("adj0", "adj0_d", "up_adj", "up_d")
#: the REST data type of each sub-byte resolution
_SUBBYTE_NAME = {1: "binary", 2: "quaternary", 3: "octal"}
#: numpy dtype of each row array's tensor dtype
_NP_DTYPE = {torch.int8: np.int8, torch.float16: np.float16, torch.float32: np.float32}


def _fsync_dir(path: Path) -> None:
    """Make a rename durable: the dirent must hit disk too."""
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _atomic_write(path: Path, data: bytes):
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def _save_npz(path: Path, arrays: dict):
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    # fsync BEFORE the rename: a power loss must not leave a durable
    # msgpack pointing at a torn npz (np.savez does not sync)
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


class _HostChunks:
    """A device tensor seen by ``save_chunked`` as a numpy array of
    ``dtype``: each slice it takes is copied to the host on its own, so
    clean chunks never leave the device."""

    def __init__(self, t: torch.Tensor, dtype):
        self.t = t
        self.shape = tuple(t.shape)
        self.dtype = np.dtype(dtype)

    def __getitem__(self, sl):
        return self.t[sl].cpu().numpy().view(self.dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _dense_rows_state(coll):
    d = coll.dense
    if d is None:
        return None
    return {
        "gen": getattr(d, "_gen", 0),
        "internal_of": list(d.internal_of),
        "field_rows": {f: list(v) for f, v in d.field_rows.items()},
    }


def _save_maps(coll, snap_dir: Path, archive: bool = False) -> None:
    """Incremental id-map persistence: a compacted ``maps.msgpack`` base +
    an append-only ``maps.log`` of per-commit deltas. A commit of a small
    batch appends O(batch) bytes; the base is rewritten only when the log
    outgrows it. ``archive=True`` (version-context history dirs) always
    writes a standalone full base."""
    base_p = snap_dir / "maps.msgpack"
    log_p = snap_dir / "maps.log"
    deltas = getattr(coll, "_map_log", None)
    d = coll.dense
    saved = getattr(coll, "_maps_saved", None)
    can_increment = (
        not archive
        and base_p.exists()
        and deltas is not None
        and saved is not None
        and (d is None or saved.get("dense_gen") == getattr(d, "_gen", 0))
    )
    if can_increment:
        frame = {"ops": deltas}
        new_mark = saved.get("dense_mark", 0)
        if d is not None:
            mark = saved.get("dense_mark", 0)
            new_mark = len(d.internal_of)
            if new_mark > mark:
                frame["drows"] = {
                    "internal_of": list(d.internal_of[mark:]),
                    "field_rows": {f: list(v[mark:]) for f, v in d.field_rows.items()},
                }
        if frame["ops"] or "drows" in frame:
            with open(log_p, "ab") as f:
                f.write(msgpack.packb(frame))
                f.flush()
                os.fsync(f.fileno())
        # advance the mark only AFTER the frame is durably appended
        if d is not None:
            saved["dense_mark"] = new_mark
        coll._map_log = []
        log_sz = log_p.stat().st_size if log_p.exists() else 0
        if log_sz <= max(base_p.stat().st_size, 1 << 20):
            return
    maps = {
        "etoi": list(coll.etoi.items()),
        "dtoi": list(coll.dtoi.items()),
        "raw": list(coll.raw.items()),
        "next_internal": coll.next_internal,
        "dense_rows": _dense_rows_state(coll),
    }
    _atomic_write(base_p, msgpack.packb(maps))
    log_p.unlink(missing_ok=True)
    if not archive:
        if deltas is not None:
            coll._map_log = []
        coll._maps_saved = {
            "dense_gen": getattr(d, "_gen", 0) if d is not None else None,
            "dense_mark": len(d.internal_of) if d is not None else 0,
        }


def _save_dense(idx, snap_dir: Path, configured_range: list) -> None:
    """Persist the HNSWIndex (+ its VectorStore) into ``snap_dir`` in the
    reference's layout."""
    vs = idx.store
    a = vs.arrays
    st = vs.tracker.view("rows")
    # a kept-graph spill keeps only the level-0 ids on the device: written
    # as what it serves after a restart, a scan-only index
    scan_only = idx.scan_only or idx.graph_on_spill
    # write order: chunked arrays and the npz first, the msgpack manifest
    # last (loaders key on the manifest)
    if not scan_only:
        save_chunked(snap_dir, "adj0", _HostChunks(idx.adj0, np.int32), idx.tracker.view("adj0"))
        save_chunked(snap_dir, "adj0_d", _HostChunks(idx.adj0_d, np.float32), idx.tracker.view("adj0"))
        save_chunked(snap_dir, "up_adj", _HostChunks(idx.up_adj, np.int32), idx.tracker.view("up"))
        save_chunked(snap_dir, "up_d", _HostChunks(idx.up_d, np.float32), idx.tracker.view("up"))
    if vs.kind == "subbyte":
        save_chunked(snap_dir, "planes", _HostChunks(a.planes, np.uint32), st, axis=1)
    else:
        save_chunked(snap_dir, "data", _HostChunks(a.data, _NP_DTYPE[a.data.dtype]), st)
    if vs.raw is not None:
        save_chunked(snap_dir, "raw", _HostChunks(vs.raw, _NP_DTYPE[vs.raw.dtype]), st)
    elif vs.raw_host is not None:
        save_chunked(snap_dir, "raw_host", _HostChunks(vs.raw_host, np.float32), st)
    alive = idx._alive_host if idx._alive_host is not None else _host(idx.alive)
    arrays = {"levels": idx.levels, "alive": alive, "mags": _host(a.mags)}
    if not scan_only:
        arrays["up_slot"] = _host(idx.up_slot)
    if vs.kind in ("u8", "subbyte"):
        arrays["sums"] = _host(a.sums)
    _save_npz(snap_dir / "dense.npz", arrays)
    meta = {
        "kind": vs.kind,
        "metric": vs.metric,
        "resolution": vs.resolution,
        "range": list(vs.range),
        "n": vs.n,
        "n_up": idx.n_up,
        "entry": idx.entry,
        "entry_level": idx.entry_level,
        "n_deleted": idx.n_deleted,
        "level_counts": [int(x) for x in idx.level_counts],
        "configured_range": configured_range,
        # rows arrive as exact f32 (the reference's wire format on a fast link)
        "ship_dtype": "f32",
        "capacity": int(vs.capacity),
        "codes_on_host": bool(vs.codes_on_host),
        "scan_only": bool(scan_only),
        "raw_dtype": vs.raw_dtype,
    }
    _atomic_write(snap_dir / "dense.msgpack", msgpack.packb(meta))
    if scan_only:
        # graph files of a snapshot this one replaced no longer describe
        # the store (removed only once the scan-only manifest is down)
        for name in _GRAPH_ARRAYS:
            for f in snap_dir.glob(f"{name}.*"):
                f.unlink(missing_ok=True)
    # every mutation after this save must mark its chunks at an epoch
    # strictly above anything just recorded
    idx.tracker.bump()
    vs.tracker.bump()


def _save_sharded_dense(d, snap_dir: Path) -> None:
    """A sharded engine: each shard as a dense sub-snapshot, then the
    manifest with the global <-> local row maps (written last)."""
    idx = d.index
    for s, shard in enumerate(idx.shards):
        sub = snap_dir / f"dense_shard{s}"
        sub.mkdir(parents=True, exist_ok=True)
        _save_dense(shard, sub, list(d.range))
    manifest = {
        "n_shards": len(idx.shards),
        "n": idx.n,
        "global_of": [list(map(int, g)) for g in idx._global_of],
        "configured_range": list(d.range),
    }
    _atomic_write(snap_dir / "dense_sharded.msgpack", msgpack.packb(manifest))


def save_collection_state(coll, snap_dir: str | Path, archive: bool = False) -> None:
    """Persist collection state into ``snap_dir``. ``archive=True`` marks a
    one-shot version-context history dir (always full, self-contained)."""
    snap_dir = Path(snap_dir)
    snap_dir.mkdir(parents=True, exist_ok=True)
    _save_maps(coll, snap_dir, archive=archive)
    d = coll.dense
    if d is not None and d.index is not None:
        if getattr(d.index, "is_sharded", False):
            _save_sharded_dense(d, snap_dir)
        else:
            _save_dense(d.index, snap_dir, list(d.range))
    if coll.sparse is not None:
        _save_sparse(coll.sparse, snap_dir)
    if coll.tfidf is not None:
        _save_tfidf(coll.tfidf, snap_dir)


def _save_tfidf(t, snap_dir: Path) -> None:
    """Persist the tf-idf index's host state in the reference's layout."""
    data = {
        "k1": t.k1,
        "b": t.b,
        "avgdl": t.average_document_length,
        "configured": t.is_configured,
        "total_documents": t.total_documents,
        "live_documents": t.live_documents,
        "n": t.n,
        "n_cap": t.n_cap,
        "alive": t._alive.tolist(),
        "has_doc": t._has_doc.tolist(),
        "postings": [(term, ids, t._tfs[term]) for term, ids in t._postings.items()],
    }
    _atomic_write(snap_dir / "tfidf.msgpack", msgpack.packb(data))


def _load_tfidf(t, snap_dir: Path) -> None:
    """Load a tf-idf index saved by either package into ``t`` (k1 and b
    come from the index descriptor, as in the reference)."""
    with open(snap_dir / "tfidf.msgpack", "rb") as f:
        data = msgpack.unpackb(f.read(), strict_map_key=False)
    t.average_document_length = data["avgdl"]
    t.is_configured = data["configured"]
    t.total_documents = data["total_documents"]
    t.live_documents = data.get("live_documents", t.total_documents)
    t.n = data["n"]
    t.n_cap = data["n_cap"]
    t._alive = np.asarray(data["alive"], bool)
    t._has_doc = np.asarray(data["has_doc"], bool) if "has_doc" in data else np.ones(t.n_cap, bool)
    t._postings = {int(term): list(ids) for term, ids, _ in data["postings"]}
    t._tfs = {int(term): list(tfs) for term, _, tfs in data["postings"]}
    t._alive_dev = None
    t._csr_dirty = True


def _save_sparse(s, snap_dir: Path) -> None:
    """Persist the inverted index's host state in the reference's layout."""
    s._fold_pending()
    data = {
        "bits": s.bits,
        "upper_bound": s.values_upper_bound,
        "configured": s.is_configured,
        "n": s.n,
        "n_cap": s.n_cap,
        "n_docs": s.n_docs,
        "live_docs": s.live_docs,
        "raw_max": s._raw_max,
        "keep_raw": s.keep_raw,
        "sample": [(int(i), d.tolist(), v.tolist()) for i, d, v in s._sample],
    }
    # chunked arrays and the npz first, the msgpack manifest last: loaders
    # key on the manifest
    _save_npz(snap_dir / "sparse.npz", {"alive": s._alive, "has_doc": s._has_doc, "raw_nnz": s._raw_nnz})
    csr_t = s.tracker.view("csr")
    save_chunked(snap_dir, "sp_keys", s._h_keys, csr_t)
    save_chunked(snap_dir, "sp_ids", s._h_ids, csr_t)
    save_chunked(snap_dir, "sp_buckets", s._h_buckets, csr_t)
    raw_t = s.tracker.view("raw")
    save_chunked(snap_dir, "sp_raw_dims", s._raw_dims, raw_t)
    save_chunked(snap_dir, "sp_raw_vals", s._raw_vals, raw_t)
    s.tracker.bump()  # later mutations mark chunks above this save's epoch
    _atomic_write(snap_dir / "sparse.msgpack", msgpack.packb(data))


def _load_sparse(s, snap_dir: Path) -> None:
    """Load an inverted index saved by either package into ``s``."""
    with open(snap_dir / "sparse.msgpack", "rb") as f:
        data = msgpack.unpackb(f.read(), strict_map_key=False)
    s.values_upper_bound = data["upper_bound"]
    s.is_configured = data["configured"]
    s.n = data["n"]
    s.n_cap = data["n_cap"]
    s.n_docs = data["n_docs"]
    s.live_docs = data["live_docs"]
    s._raw_max = data["raw_max"]
    s.keep_raw = data["keep_raw"]
    s._sample = [(i, np.asarray(d, np.int64), np.asarray(v, np.float32)) for i, d, v in data["sample"]]
    z = np.load(snap_dir / "sparse.npz")
    s._h_keys = np.asarray(load_chunked(snap_dir, "sp_keys"), np.int64)
    s._h_ids = np.asarray(load_chunked(snap_dir, "sp_ids"), np.int32)
    s._h_buckets = np.asarray(load_chunked(snap_dir, "sp_buckets"), np.int32)
    s._alive = np.asarray(z["alive"], bool)
    s._has_doc = np.asarray(z["has_doc"], bool)
    s._raw_nnz = np.asarray(z["raw_nnz"], np.int32)
    s._raw_dims = np.asarray(load_chunked(snap_dir, "sp_raw_dims"), np.int64)
    s._raw_vals = np.asarray(load_chunked(snap_dir, "sp_raw_vals"), np.float32)
    adopt_tracker(snap_dir, s.tracker, ["sp_keys", "sp_ids", "sp_buckets", "sp_raw_dims", "sp_raw_vals"])
    s._alive_dev = None
    s._csr_ids = None
    s._csr_dirty = False
    s._pend_docs, s._pend_dims, s._pend_buckets = [], [], []
    s._rebuild_ranges()


def _replay_map_log(coll, dense_rows, log_p: Path):
    """Apply maps.log frames on top of the loaded base."""
    with open(log_p, "rb") as f:
        unpacker = msgpack.Unpacker(f, strict_map_key=False)
        for frame in unpacker:
            for op in frame.get("ops", []):
                if op[0] == "u":
                    _, iid, rec = op
                    iid = int(iid)
                    ext = rec["id"]
                    old = coll.etoi.get(ext)
                    if old is not None and old != iid:
                        coll.itoe.pop(old, None)
                        old_rec = coll.raw.pop(old, None)
                        if old_rec and old_rec.get("document_id") is not None:
                            lst = coll.dtoi.get(old_rec["document_id"], [])
                            if old in lst:
                                lst.remove(old)
                    coll.etoi[ext] = iid
                    coll.itoe[iid] = ext
                    coll.raw[iid] = rec
                    if rec.get("document_id") is not None:
                        coll.dtoi.setdefault(rec["document_id"], []).append(iid)
                    coll.next_internal = max(coll.next_internal, iid + 1)
                else:  # ("d", iid, ext)
                    _, iid, ext = op
                    iid = int(iid)
                    coll.etoi.pop(ext, None)
                    coll.itoe.pop(iid, None)
                    rec = coll.raw.pop(iid, None)
                    if rec and rec.get("document_id") is not None:
                        lst = coll.dtoi.get(rec["document_id"], [])
                        if iid in lst:
                            lst.remove(iid)
            drows = frame.get("drows")
            if drows is not None and dense_rows is not None:
                dense_rows["internal_of"].extend(drows["internal_of"])
                for fld, vals in drows["field_rows"].items():
                    base_len = len(dense_rows["internal_of"]) - len(vals)
                    cur = dense_rows["field_rows"].setdefault(fld, [-1] * base_len)
                    cur.extend(vals)
    return dense_rows


def _load_store(snap_dir: Path, meta: dict, z, dim: int, device, keep_raw_mode) -> VectorStore:
    """The VectorStore a dense snapshot describes, on ``device``; spilled
    codes stay in host tensors, and host raw rows go to the host, or to a
    fresh memmap when the index's ``keep_raw_mode`` is "disk".

    ``ship_dtype`` (the wire format the reference ingested the rows with)
    is not needed: the loaded codes serve as they are, and the port
    quantizes new rows from exact f32 on the device, as the reference's
    f32 wire does."""
    if meta.get("capacity"):
        cap = int(meta["capacity"])
    else:  # pre-capacity layout: the graph's adjacency had one row per slot
        with open(snap_dir / "adj0.meta.json") as f:
            cap = int(json.load(f)["shape"][0])
    raw = load_chunked(snap_dir, "raw")
    raw_host = None
    if raw is None and chunked_exists(snap_dir, "raw_host"):
        raw_host = "disk" if keep_raw_mode == "disk" else "host"
    vs = VectorStore(
        dim=dim, device=device, kind=meta["kind"], metric=meta["metric"],
        resolution=int(meta["resolution"]), range=tuple(meta["range"]), keep_raw=raw_host or False,
        raw_dtype=meta.get("raw_dtype") or "f32", initial_capacity=cap,
    )
    if vs.capacity != cap:
        raise ValueError(f"snapshot capacity {cap} is not a multiple of 128")
    host = bool(meta.get("codes_on_host"))

    def dev(x, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
        if host and t.ndim:  # the spilled rows stay on the host (pinned)
            return t.pin_memory() if vs._pin else t
        return t.to(vs.device)

    empty = vs.arrays  # carries the dequant scalars rebuilt from range/dim
    mags = dev(z["mags"], torch.float32)
    if vs.kind == "subbyte":
        # int32 tensors holding the reference's uint32 words
        planes = np.asarray(load_chunked(snap_dir, "planes"), np.uint32).view(np.int32)
        vs.arrays = empty._replace(planes=dev(planes), sums=dev(z["sums"], torch.int32), mags=mags)
    elif vs.kind == "u8":
        data = dev(load_chunked(snap_dir, "data"), torch.int8)
        vs.arrays = empty._replace(data=data, sums=dev(z["sums"], torch.int32), mags=mags)
    else:
        vs.arrays = empty._replace(data=dev(load_chunked(snap_dir, "data"), empty.data.dtype), mags=mags)
    vs.codes_on_host = host
    if raw is not None:
        vs.raw = torch.as_tensor(raw, device=vs.device)
        vs.keep_raw = True
    elif raw_host:
        # straight into the store's fresh (pinned) host rows or memmap
        load_chunked(snap_dir, "raw_host", out_factory=lambda shape, dtype: vs.raw_host.numpy())
    vs.n = int(meta["n"])
    names = ["planes" if vs.kind == "subbyte" else "data"]
    if raw is not None:
        names.append("raw")
    elif raw_host:
        names.append("raw_host")
    adopt_tracker(snap_dir, vs.tracker, names)
    return vs


def _read_meta(path: Path) -> dict:
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), strict_map_key=False)


def _handle_kind(meta: dict) -> str:
    """The DenseIndexHandle kind of a dense snapshot's store."""
    return _SUBBYTE_NAME[int(meta["resolution"])] if meta["kind"] == "subbyte" else meta["kind"]


def load_dense(d, snap_dir: Path, meta: dict) -> np.ndarray:
    """Rebuild the dense handle ``d``'s index from the dense snapshot in
    ``snap_dir`` (``meta``: its parsed ``dense.msgpack``); returns the
    alive mask over the store's capacity."""
    d.kind = _handle_kind(meta)
    d.range = tuple(meta["configured_range"])
    d._build()
    return _load_index(d.index, snap_dir, meta, d.keep_raw)


def _load_index(idx, snap_dir: Path, meta: dict, keep_raw_mode) -> np.ndarray:
    """Load a dense snapshot into the fresh HNSWIndex ``idx``, on its
    store's device; returns the alive mask over the store's capacity."""
    z = np.load(snap_dir / "dense.npz")
    dim, device = idx.store.dim, idx.store.device
    idx.store.close()  # the fresh index's store is replaced
    idx.store = _load_store(snap_dir, meta, z, dim, device, keep_raw_mode)
    alive = np.ones(idx.store.capacity, bool)
    saved_alive = np.asarray(z["alive"], bool)[: idx.store.capacity]
    alive[: len(saved_alive)] = saved_alive
    if meta.get("scan_only"):
        # no graph: served by the scan at any size, tombstones in the mask
        # (on the host while the codes are spilled)
        idx.scan_only = True
        idx.levels = np.asarray(z["levels"], np.int8).copy()
        idx.level_counts = np.asarray(meta["level_counts"], np.int64)
        idx.entry, idx.entry_level = int(meta["entry"]), int(meta["entry_level"])
        if idx.store.codes_on_host:
            idx._alive_host = alive.copy()
            idx.alive = torch.ones((1,), dtype=torch.bool, device=idx.store.device)
        else:
            idx.alive = torch.as_tensor(alive, device=idx.store.device)
        idx.n_deleted = int(meta["n_deleted"])
        idx._sync_capacity()
    else:
        graph = {name: load_chunked(snap_dir, name) for name in _GRAPH_ARRAYS}
        graph.update(
            levels=z["levels"], up_slot=z["up_slot"], alive=alive, level_counts=meta["level_counts"],
            n_up=meta["n_up"], entry=meta["entry"], entry_level=meta["entry_level"],
            n_deleted=meta["n_deleted"],
        )
        idx.adopt_graph(graph)
        adopt_tracker(snap_dir, idx.tracker, list(_GRAPH_ARRAYS))
    return alive


def _load_sharded_dense(d, snap_dir: Path, manifest: dict, dense_rows: dict | None) -> None:
    """Rebuild the dense handle ``d``'s sharded engine: each shard from its
    sub-snapshot on its own device, the row maps from the manifest, and
    the handle's live rows from the shards' tombstones."""
    d.kind = _handle_kind(_read_meta(snap_dir / "dense_shard0" / "dense.msgpack"))
    d.range = tuple(manifest["configured_range"])
    d.shards = int(manifest["n_shards"])
    d._build()
    idx = d.index
    alive_parts = []
    for s, shard in enumerate(idx.shards):
        sub = snap_dir / f"dense_shard{s}"
        alive = _load_index(shard, sub, _read_meta(sub / "dense.msgpack"), d.keep_raw)
        alive_parts.append(alive[: shard.n])
    idx.n = int(manifest["n"])
    idx._global_of = [list(map(int, g)) for g in manifest["global_of"]]
    idx._loc_of = {int(g): (s, j) for s, lst in enumerate(idx._global_of) for j, g in enumerate(lst)}
    idx.scan_only = idx.shards[0].scan_only
    if dense_rows is not None:
        d._gen = int(dense_rows["gen"])
        d.internal_of = [int(x) for x in dense_rows["internal_of"]]
        d.field_rows = {f: [int(x) for x in v] for f, v in dense_rows["field_rows"].items()}
        # global alive: the shards' tombstones mapped to global rows
        alive_g = np.ones(max(idx.n, len(d.internal_of)), bool)
        for s, lst in enumerate(idx._global_of):
            if lst:
                alive_g[np.asarray(lst, np.int64)] = alive_parts[s][: len(lst)]
        d.row_of = {int(iid): r for r, iid in enumerate(d.internal_of) if r < len(alive_g) and alive_g[r]}


def load_collection_state(coll, snap_dir: str | Path) -> None:
    snap_dir = Path(snap_dir)
    maps_path = snap_dir / "maps.msgpack"
    dense_rows = None
    if maps_path.exists():
        with open(maps_path, "rb") as f:
            maps = msgpack.unpackb(f.read(), strict_map_key=False)
        coll.etoi = {k: v for k, v in maps["etoi"]}
        coll.itoe = {v: k for k, v in maps["etoi"]}
        coll.dtoi = {k: list(v) for k, v in maps["dtoi"]}
        coll.raw = {int(k): v for k, v in maps["raw"]}
        coll.next_internal = maps["next_internal"]
        dense_rows = maps.get("dense_rows")
        if dense_rows is not None:
            dense_rows = {
                "gen": dense_rows["gen"],
                "internal_of": list(dense_rows["internal_of"]),
                "field_rows": {f: list(v) for f, v in dense_rows["field_rows"].items()},
            }
        log_p = snap_dir / "maps.log"
        if log_p.exists():
            dense_rows = _replay_map_log(coll, dense_rows, log_p)

    sharded_p = snap_dir / "dense_sharded.msgpack"
    if sharded_p.exists() and coll.dense is not None:
        _load_sharded_dense(coll.dense, snap_dir, _read_meta(sharded_p), dense_rows)

    dense_meta_p = snap_dir / "dense.msgpack"
    if dense_meta_p.exists() and coll.dense is not None:
        meta = _read_meta(dense_meta_p)
        d = coll.dense
        alive = load_dense(d, snap_dir, meta)
        if dense_rows is None and "internal_of" in meta:
            # pre-dense_rows layout kept the row maps in dense.msgpack
            dense_rows = {
                "gen": meta.get("gen", 0),
                "internal_of": meta["internal_of"],
                "field_rows": meta.get("field_rows", {}),
            }
        if dense_rows is not None:
            d._gen = int(dense_rows["gen"])
            d.internal_of = [int(x) for x in dense_rows["internal_of"]]
            d.field_rows = {f: [int(x) for x in v] for f, v in dense_rows["field_rows"].items()}
            d.row_of = {int(iid): r for r, iid in enumerate(d.internal_of) if alive[r]}
    if (snap_dir / "sparse.msgpack").exists() and coll.sparse is not None:
        _load_sparse(coll.sparse, snap_dir)
    if (snap_dir / "tfidf.msgpack").exists() and coll.tfidf is not None:
        _load_tfidf(coll.tfidf, snap_dir)
    # incremental-maps bookkeeping
    d = coll.dense
    coll._maps_saved = {
        "dense_gen": getattr(d, "_gen", 0) if d is not None else None,
        "dense_mark": len(d.internal_of) if d is not None else 0,
    }
