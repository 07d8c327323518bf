"""Collection and dense index handle (port of cosdata_tpu/core/collection.py).

``Collection`` owns a collection's id maps, slim per-vector records,
transactions (explicit, WAL-buffered and indexed in the background;
implicit, streamed and indexed inline), versions and snapshots, its dense
index, its sparse inverted index and its tf-idf (BM25) index, and hybrid
reciprocal-rank fusion of any two of the dense, sparse and text legs.
``DenseIndexHandle`` sits below it: every REST and gRPC dense search ends
in its ``search``. It keeps the sample-then-configure protocol
(quantization "auto" buffers ``sample_threshold`` rows, tunes the u8 range
on them, then builds), the engine routing and flush-time compaction. u8,
sub-byte (binary, quaternary, octal), f16 and f32 storage with cosine or
dot are ported, and the HNSW graph serves unfiltered searches above
``flat_serve_threshold`` and permissive filters above the serving limits,
as in the reference. Every tensor lives on the ``device`` the collection
was given, apart from the spill tiers: ``raw_storage`` "host" or "disk"
keeps the raw rows on the host, and codes that outgrow the device budget
spill there too (``ops/storage.py``); ``flush`` moves them back once they
fit. A handle with ``shards > 1`` serves a ``ShardedHNSWIndex``
(``parallel/sharded_hnsw.py``), one sub-index per shard cycled over the
CUDA devices, which picks each shard's route itself and is never
compacted at flush.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from cosdata_tpu_torch.core.transaction import (
    ExplicitTransaction,
    ImplicitTransaction,
    TransactionStatus,
)
from cosdata_tpu_torch.indexes.hnsw import HNSWIndex, HNSWParams
from cosdata_tpu_torch.indexes.inverted import InvertedIndex
from cosdata_tpu_torch.indexes.tf_idf import TFIDFIndex
from cosdata_tpu_torch.ops.storage import SUBBYTE_ALIAS, as_rows
from cosdata_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex
from cosdata_tpu_torch.store.meta import MetaStore
from cosdata_tpu_torch.store.versioning import VersionControl
from cosdata_tpu_torch.store.wal import OP_DELETE, OP_UPSERT, read_wal


def tune_dense_range(values, clamp_margin_percent: float = 1.0):
    """Range auto-tune: the smallest threshold of a fixed ladder with at
    most ``clamp_margin_percent`` of the values clipped on each side."""
    values = np.asarray(values, np.float32).ravel()
    n = max(values.size, 1)
    start = -1.0
    for t in (-0.025, -0.05, -0.1, -0.2, -0.3, -0.4, -0.5):
        if float((values < t).sum()) / n * 100.0 <= clamp_margin_percent:
            start = t
            break
    end = 1.0
    for t in (0.025, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5):
        if float((values > t).sum()) / n * 100.0 <= clamp_margin_percent:
            end = t
            break
    return (start, end)


def _post_filter_topk(rows, scores, row_mask, cap: int, top_k: int):
    """Keep each row's first top_k candidates surviving the mask (rows are
    already score-descending)."""
    ok = np.zeros(cap + 1, bool)
    ok[: len(row_mask)] = row_mask
    keep = (rows >= 0) & ok[np.maximum(rows, 0)]
    # stable partition: survivors first, in their (descending-score) order
    order = np.argsort(~keep, axis=1, kind="stable")[:, :top_k]
    out_rows = np.take_along_axis(rows, order, axis=1)
    out_scores = np.take_along_axis(scores, order, axis=1)
    kept = np.take_along_axis(keep, order, axis=1)
    out_rows = np.where(kept, out_rows, -1)
    out_scores = np.where(kept, out_scores, -np.inf).astype(np.float32)
    return out_rows, out_scores


_METRIC_ALIAS = {
    "cosine": "cosine",
    "cosinesimilarity": "cosine",
    "dot": "dot",
    "dotproduct": "dot",
    "euclidean": "euclidean",
    "hamming": "hamming",
}


class DenseIndexHandle:
    """HNSW index + the auto-tuning sample buffer."""

    def __init__(
        self,
        dimension: int,
        device,
        distance_metric: str = "cosine",
        quantization: dict | None = None,
        hnsw_params: dict | None = None,
        seed: int = 0,
        raw_storage: str = "device",
        shards: int = 1,
    ):
        quantization = quantization or {"type": "auto", "sample_threshold": 100}
        self.device = torch.device(device)
        #: shards > 1: the engine is a ShardedHNSWIndex with one sub-index
        #: per shard, cycled over the CUDA devices (or on ``device`` itself
        #: when that is not a CUDA device)
        self.shards = max(int(shards or 1), 1)
        self.descriptor = {
            "index_type": "dense",
            "distance_metric": distance_metric,
            "quantization": quantization,
            "hnsw_params": hnsw_params or {},
            "raw_storage": raw_storage,
        }
        if self.shards > 1:
            self.descriptor["shards"] = self.shards
        #: where the raw rows live: the device, host RAM, a memory-mapped
        #: file, or nowhere (codes only)
        if raw_storage not in ("device", "host", "disk", "none"):
            raise ValueError(f"unknown raw_storage {raw_storage}")
        self.keep_raw = {"device": True, "host": "host", "disk": "disk", "none": False}[raw_storage]
        self.dimension = dimension
        key = str(distance_metric).lower().replace("_", "")
        if key not in _METRIC_ALIAS:
            raise ValueError(f"unknown distance metric '{distance_metric}'")
        self.metric = _METRIC_ALIAS[key]
        params = HNSWParams()
        for k, v in (hnsw_params or {}).items():
            if hasattr(params, k) and v is not None:
                setattr(params, k, v)
        self.params = params
        self.seed = seed
        #: guards the sample buffer and the build transition
        self._lock = threading.RLock()
        #: buffered (internal ids, rows, metadata) batches before the build
        self._sample: list[tuple[list[int], torch.Tensor, list]] = []
        self._sample_rows = 0
        # per-row metadata value ids (row-aligned with the store)
        self.field_rows: dict[str, list[int]] = {}
        self.sample_threshold = 0
        self.kind = "u8"
        self.range = (-1.0, 1.0)
        self.index: HNSWIndex | ShardedHNSWIndex | None = None
        #: row-map generation: bumped when compaction rebuilds the row
        #: space, forcing the next maps snapshot to rewrite its base
        self._gen = 0
        #: unfiltered searches at or below this row count take the exact
        #: scan; above it the graph
        self.flat_serve_threshold = 1_572_864
        #: filtered searches at or below this row count always take the
        #: exact masked scan; above it permissive filters take the graph
        self.graph_filter_min = 20_000
        # internal id <-> dense row maps
        self.row_of: dict[int, int] = {}
        self.internal_of: list[int] = []
        #: internal_of as an array for the search's row -> id map. Building
        #: it from the list on every search cost 36 ms of host time at 1M
        #: rows, half of a b1024 search (beside an NVIDIA H100 80GB HBM3,
        #: 700 W); internal_of only grows between compactions, so the
        #: generation and its length key the copy
        self._internal_arr = np.empty(0, np.int64)
        self._internal_key = (0, 0)
        qt = quantization.get("type", "auto")
        if qt == "auto":
            self.sample_threshold = int(quantization.get("sample_threshold", 100))
        elif qt == "scalar":
            dt = quantization.get("data_type", "u8")
            if dt not in ("u8", "f16", "f32", *SUBBYTE_ALIAS):
                raise ValueError(f"unknown data_type {dt}")
            # the store maps a sub-byte name to its resolution; sub-byte
            # buckets span the fixed [-1, 1], so the range is unused there
            self.kind = dt
            rng = quantization.get("range")
            if rng:
                lo, hi = float(rng["min"]), float(rng["max"])
                if not (hi > lo):
                    raise ValueError(
                        f"quantization range must satisfy max > min (got min={lo}, max={hi})"
                    )
                self.range = (lo, hi)
            self._build()
        else:
            raise ValueError(f"unknown quantization type {qt}")

    @property
    def is_configured(self) -> bool:
        return self.index is not None

    def _build(self, initial_capacity: int = 1024):
        if self.shards > 1:
            self.index = ShardedHNSWIndex(
                dim=self.dimension,
                devices=None if self.device.type == "cuda" else [self.device],
                n_shards=self.shards,
                metric=self.metric,
                kind=self.kind,
                range_=self.range,
                params=self.params,
                seed=self.seed,
                keep_raw=self.keep_raw,
            )
            return
        self.index = HNSWIndex(
            dim=self.dimension,
            device=self.device,
            metric=self.metric,
            kind=self.kind,
            range_=self.range,
            params=self.params,
            seed=self.seed,
            keep_raw=self.keep_raw,
            initial_capacity=initial_capacity,
        )

    def add_batch(self, internal_ids: list[int], vectors, meta_ids: list[dict | None] | None = None):
        """Add rows (numpy array or tensor, (B, dimension)) under internal ids."""
        meta_ids = meta_ids or [None] * len(internal_ids)
        if self.index is None:
            with self._lock:
                if self.index is None:
                    rows = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
                    self._sample.append((list(internal_ids), rows, list(meta_ids)))
                    self._sample_rows += len(internal_ids)
                    if self._sample_rows >= self.sample_threshold:
                        self.finalize_sampling()
                    return
            # configured concurrently: fall through to the indexed path
        rows = self.index.add(vectors)
        for iid, row, m in zip(internal_ids, rows.tolist(), meta_ids):
            self.row_of[iid] = row
            self.internal_of.append(iid)
            for field, lst in self.field_rows.items():
                lst.append((m or {}).get(field, -1))
            if m:
                for field in m:
                    if field not in self.field_rows:
                        # backfill new field with -1 for existing rows
                        self.field_rows[field] = [-1] * (len(self.internal_of) - 1)
                        self.field_rows[field].append(m.get(field, -1))

    def finalize_sampling(self):
        if self.index is not None:
            return
        with self._lock:
            if self.index is not None:
                return  # another thread built while we waited
            pending, self._sample, self._sample_rows = self._sample, [], 0
            if pending:
                allv = torch.cat([v for _, v, _ in pending])
                self.range = tune_dense_range(allv.cpu().numpy())
            self._build()
            if pending:
                ids = [i for b, _, _ in pending for i in b]
                metas = [m for _, _, b in pending for m in b]
                self.add_batch(ids, allv, metas)

    def flush(self):
        self.finalize_sampling()
        self.maybe_compact()
        if self.index is not None and not getattr(self.index, "is_sharded", False):
            # spilled codes go back to the device once the budget fits
            # (the compaction may have shrunk the store); a sharded engine
            # has no promotion, as in the reference
            self.index.maybe_promote()

    #: tombstone fraction that triggers a rebuild at flush time
    COMPACT_THRESHOLD = 0.25

    def maybe_compact(self):
        """Rebuild the index without tombstoned rows once they reach the
        threshold: a fresh index takes the live raw rows (re-quantized
        under the same kind and range) and builds its graph through ``add``
        (the bulk build for an empty index and 8,192 rows or more, waves
        below), as the reference does at flush points."""
        idx = self.index
        if idx is None or idx.n == 0:
            return
        if getattr(idx, "is_sharded", False):
            # a sharded engine only tombstones: a rebuild across shards is
            # a reshard, not a flush-time side effect
            return
        if idx.n_deleted / idx.n < self.COMPACT_THRESHOLD:
            return
        if not idx.store.keep_raw:
            return
        alive_items = sorted(self.row_of.items(), key=lambda kv: kv[1])
        if not alive_items:
            return
        internals = [iid for iid, _ in alive_items]
        rows = np.asarray([r for _, r in alive_items])
        raw = idx.store.raw_rows(rows)
        idx.store.close()
        old_fields = {f: [lst[r] for r in rows] for f, lst in self.field_rows.items()}
        self._build(initial_capacity=len(internals))
        self.index.add(raw)
        self.row_of = {iid: i for i, iid in enumerate(internals)}
        self.internal_of = list(internals)
        self.field_rows = {f: list(v) for f, v in old_fields.items()}
        self._gen += 1

    def delete(self, internal_id: int):
        row = self.row_of.pop(internal_id, None)
        if row is not None and self.index is not None:
            self.index.delete(row)

    def search(self, queries, top_k: int, ef: int | None = None, row_mask: np.ndarray | None = None):
        """Returns host (internal_ids (B, k), scores (B, k)); -1 padded.

        ``row_mask``: boolean filter over store rows (metadata filtering).
        Unfiltered searches up to ``flat_serve_threshold`` rows take the
        exact scan, larger ones the graph. Selective filters (<= 10%) take
        the exact masked scan; permissive ones on an index above
        ``graph_filter_min`` and ``flat_serve_threshold`` take the graph
        with oversampling and a post-filter, and any query left with fewer
        than top_k survivors escalates to the exact masked scan. A
        scan-only index (no graph) takes the exact scan at any size. A
        sharded engine picks each shard's route itself and runs a masked
        search as the exact masked scan on every shard."""
        self.finalize_sampling()
        idx = self.index
        if getattr(idx, "is_sharded", False):
            rows, scores = idx.search(queries, top_k=top_k, ef=ef, row_mask=row_mask)
        elif row_mask is None and (idx.n <= self.flat_serve_threshold or idx.scan_only):
            rows, scores = idx.search_brute(queries, top_k=top_k)
        elif row_mask is not None:
            selectivity = float(row_mask.mean()) if len(row_mask) else 0.0
            if (
                selectivity <= 0.10
                or idx.n <= self.graph_filter_min
                or idx.n <= self.flat_serve_threshold
                or idx.scan_only
            ):
                rows, scores = idx.search_brute(queries, top_k=top_k, mask=row_mask)
            else:
                boost = min(max(int(2.0 / max(selectivity, 1e-3)), 2), 8)
                fetch = max(min(top_k * boost, idx.params.ef_search), top_k)
                rows, scores = idx.search(queries, top_k=fetch, ef=ef)
                rows, scores = _post_filter_topk(rows, scores, row_mask, idx.cap, top_k)
                # escalate: a query with fewer than top_k survivors gets the
                # exact masked scan
                short = (rows >= 0).sum(axis=1) < min(top_k, int(row_mask.sum()))
                if short.any():
                    qs = as_rows(queries, idx.store.device)[torch.as_tensor(np.flatnonzero(short))]
                    rows[short], scores[short] = idx.search_brute(qs, top_k=top_k, mask=row_mask)
        else:
            rows, scores = idx.search(queries, top_k=top_k, ef=ef)
        internal = np.full_like(rows, -1)
        key = (self._gen, len(self.internal_of))
        if self._internal_key != key:
            self._internal_arr = np.asarray(self.internal_of, np.int64)
            self._internal_key = key
        io = self._internal_arr
        ok = rows >= 0
        internal[ok] = io[rows[ok]]
        return internal, scores

    def row_mask_for(self, mask_fn) -> np.ndarray:
        """Compile a metadata mask over store rows."""
        n_rows = len(self.internal_of)
        field_ids = {f: np.asarray(lst[:n_rows], np.int64) for f, lst in self.field_rows.items()}
        for f in list(field_ids):
            if len(field_ids[f]) < n_rows:
                field_ids[f] = np.pad(field_ids[f], (0, n_rows - len(field_ids[f])), constant_values=-1)
        return mask_fn(field_ids, n_rows)


class Collection:
    #: a committed version whose upserts land on an EMPTY dense index and
    #: total at least this many rows is coalesced into one ingest (one
    #: quantize-and-write pass per 131,072 rows); below it, per-op ingests
    #: keep ProcessingStats granular
    COALESCE_MIN = 8192

    def __init__(self, meta: MetaStore, data_dir: str | Path, config: dict, device):
        self.meta = meta
        self.config = config
        self.device = torch.device(device)
        self.name = config["name"]
        self.data_dir = Path(data_dir) / "collections" / self.name
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.description = config.get("description")
        self.dense_vector = config.get("dense_vector") or {"enabled": False}
        self.sparse_vector = config.get("sparse_vector") or {"enabled": False}
        self.tf_idf_options = config.get("tf_idf_options") or {"enabled": False}
        self.metadata_schema = config.get("metadata_schema")
        self.schema = None
        if self.metadata_schema:
            from cosdata_tpu_torch.metadata.schema import MetadataSchema

            self.schema = MetadataSchema(self.metadata_schema)
        self.store_raw_text = bool(config.get("store_raw_text", False))

        self.vcs = VersionControl(meta, self.name)
        self.lock = threading.RLock()
        self.app_config = None  # set by AppContext

        # id maps (the reference's etoi/itoe/dtoi TreeMaps, collection.rs:149-164)
        self.etoi: dict = {}
        self.itoe: dict[int, object] = {}
        self.dtoi: dict[object, list[int]] = {}
        #: slim per-vector host records: id/document_id/metadata/text ONLY.
        #: Dense values live in the device store and are reconstructed on GET
        self.raw: dict[int, dict] = {}
        self.next_internal = 0
        #: id-map deltas since the last snapshot (appended to maps.log —
        #: O(delta) commit IO)
        self._map_log: list = []

        self.dense: DenseIndexHandle | None = None
        self.sparse: InvertedIndex | None = None
        self.sparse_descriptor: dict | None = None
        self.tfidf: TFIDFIndex | None = None
        self.tfidf_descriptor: dict | None = None

        # transactions
        self.current_explicit: ExplicitTransaction | None = None
        self.txns: dict[str, ExplicitTransaction] = {}
        self.implicit: ImplicitTransaction | None = None

    # ------------------------------------------------------------ indexes

    def create_dense_index(
        self, distance_metric="cosine", quantization=None, hnsw_params=None,
        raw_storage="device", shards=None,
    ):
        with self.lock:
            if not self.dense_vector.get("enabled"):
                raise ValueError("dense vectors not enabled for this collection")
            if self.dense is not None:
                raise ValueError("dense index already exists")
            if shards is None:
                shards = (self.config.get("config") or {}).get("shards", 1)
            self.dense = DenseIndexHandle(
                dimension=int(self.dense_vector["dimension"]),
                device=self.device,
                distance_metric=distance_metric,
                quantization=quantization,
                hnsw_params=hnsw_params,
                raw_storage=raw_storage,
                shards=shards,
            )
            self._persist_descriptors()
            return self.dense.descriptor

    def create_sparse_index(self, quantization: int = 64, sample_threshold: int = 1000,
                            early_terminate_threshold: float = 0.0,
                            scan_budget: int | None = None,
                            scan_budget_total: int | None = None):
        """``scan_budget``/``scan_budget_total`` pin the posting-scan
        budgets per collection (pinning both to the same value makes served
        quality independent of dispatch batch size)."""
        with self.lock:
            if not self.sparse_vector.get("enabled"):
                raise ValueError("sparse vectors not enabled for this collection")
            if self.sparse is not None:
                raise ValueError("sparse index already exists")
            self.sparse = InvertedIndex(
                self.device,
                quantization=quantization,
                sample_threshold=sample_threshold,
                early_terminate_threshold=early_terminate_threshold,
                scan_budget=scan_budget,
                scan_budget_total=scan_budget_total,
            )
            self.sparse_descriptor = {
                "index_type": "sparse",
                "quantization": quantization,
                "sample_threshold": sample_threshold,
            }
            if scan_budget is not None:
                self.sparse_descriptor["scan_budget"] = int(scan_budget)
            if scan_budget_total is not None:
                self.sparse_descriptor["scan_budget_total"] = int(scan_budget_total)
            self._persist_descriptors()
            return self.sparse_descriptor

    def create_tf_idf_index(self, k1: float = 1.2, b: float = 0.75, sample_threshold: int = 1000,
                            scan_budget: int | None = None, scan_budget_total: int | None = None):
        with self.lock:
            if not self.tf_idf_options.get("enabled"):
                raise ValueError("tf-idf not enabled for this collection")
            if self.tfidf is not None:
                raise ValueError("tf-idf index already exists")
            self.tfidf = TFIDFIndex(
                self.device, k1=k1, b=b, sample_threshold=sample_threshold,
                scan_budget=scan_budget, scan_budget_total=scan_budget_total,
            )
            self.tfidf_descriptor = {"index_type": "tf_idf", "k1": k1, "b": b, "sample_threshold": sample_threshold}
            if scan_budget is not None:
                self.tfidf_descriptor["scan_budget"] = int(scan_budget)
            if scan_budget_total is not None:
                self.tfidf_descriptor["scan_budget_total"] = int(scan_budget_total)
            self._persist_descriptors()
            return self.tfidf_descriptor

    def _persist_descriptors(self):
        """Persist index configs (IndexOps::persist parity). No-op while
        restoring from those very descriptors."""
        if getattr(self, "_restoring", False):
            return
        self.meta.put("indexes", self.name, self.list_indexes())

    def delete_index(self, index_type: str):
        with self.lock:
            if index_type == "dense":
                self.dense = None
            elif index_type == "sparse":
                self.sparse = None
                self.sparse_descriptor = None  # else list/restart resurrect it
            elif index_type == "tf-idf":
                self.tfidf = None
                self.tfidf_descriptor = None
            else:
                raise ValueError(f"unknown index type {index_type}")
            self._persist_descriptors()

    def list_indexes(self) -> list[dict]:
        out = []
        if self.dense:
            out.append(self.dense.descriptor)
        if self.sparse_descriptor:
            out.append(self.sparse_descriptor)
        if self.tfidf_descriptor:
            out.append(self.tfidf_descriptor)
        return out

    # ------------------------------------------------------- validation

    def validate_vector(self, v: dict, upsert: bool) -> None:
        """Mirrors run_upload validation (collection.rs:392-432)."""
        if "id" not in v or v["id"] is None:
            raise ValueError("vector id is required")
        if not upsert and v["id"] in self.etoi:
            raise ValueError(f"vector with id {v['id']} already exists")
        dense = v.get("dense_values")
        if dense is not None:
            if not self.dense_vector.get("enabled"):
                raise ValueError("dense values not supported by this collection")
            if len(dense) != int(self.dense_vector["dimension"]):
                raise ValueError(
                    f"dense vector dimension mismatch: expected "
                    f"{self.dense_vector['dimension']}, got {len(dense)}"
                )
            if not all(isinstance(x, (int, float)) for x in dense):
                raise ValueError("dense_values must be numbers")
        sp = v.get("sparse_values")
        if sp is not None:
            if not self.sparse_vector.get("enabled"):
                raise ValueError("sparse values not supported by this collection")
            for pair in sp:
                if (
                    not isinstance(pair, (list, tuple))
                    or len(pair) != 2
                    or not isinstance(pair[0], (int, float))
                    or not isinstance(pair[1], (int, float))
                ):
                    raise ValueError("sparse_values must be [dimension, value] pairs")
        if v.get("metadata"):
            if self.schema is None:
                raise ValueError("collection has no metadata schema")
            self.schema.value_ids(v["metadata"])  # validates fields/values
        if v.get("text") is not None and not (
            self.tf_idf_options.get("enabled") or self.store_raw_text
        ):
            raise ValueError("text not supported by this collection")

    # ------------------------------------------------------- transactions

    def create_transaction(self) -> ExplicitTransaction:
        with self.lock:
            if self.current_explicit is not None:
                raise RuntimeError("a transaction is already open for this collection")
            txn = ExplicitTransaction()
            self.current_explicit = txn
            self.txns[txn.txn_id] = txn
            return txn

    def get_transaction(self, txn_id: str) -> ExplicitTransaction:
        txn = self.txns.get(txn_id)
        if txn is None:
            raise KeyError(f"transaction {txn_id} not found")
        return txn

    def txn_upsert(self, txn_id: str, vectors: list[dict], upsert: bool) -> None:
        """Buffer into the WAL — NO indexing yet (collection.rs:434)."""
        with self.lock:
            txn = self._open_txn(txn_id)
            for v in vectors:
                self.validate_vector(v, upsert)
            txn.wal.append_upsert(vectors)

    def txn_delete(self, txn_id: str, vector_id) -> None:
        with self.lock:
            txn = self._open_txn(txn_id)
            txn.wal.append_delete(vector_id)

    def _open_txn(self, txn_id: str) -> ExplicitTransaction:
        txn = self.get_transaction(txn_id)
        if txn is not self.current_explicit or txn.committed or txn.aborted:
            raise RuntimeError(f"transaction {txn_id} is not open")
        return txn

    def commit_transaction(self, txn_id: str) -> int:
        """Allot version, flush the WAL, bump current version; indexing runs
        in the background (transactions/repo.rs:46-99)."""
        with self.lock:
            txn = self._open_txn(txn_id)
            version = self.vcs.allot_version()
            wal_path = self.data_dir / f"{version}.wal"
            txn.wal.flush(wal_path)
            self.vcs.set_current_version(
                version,
                {"kind": "explicit", "txn_id": txn.txn_id},
                upserted=txn.wal.records_upserted,
                deleted=txn.wal.records_deleted,
                total_ops=txn.wal.total_operations,
            )
            txn.committed = True
            self.current_explicit = None
            return version

    def abort_transaction(self, txn_id: str) -> None:
        with self.lock:
            txn = self._open_txn(txn_id)
            txn.aborted = True
            self.current_explicit = None
            # keep the record (status stays queryable), drop the payloads
            txn.wal.ops = []

    # ------------------------------------------------------- indexing

    def index_version(self, version: int, txn: ExplicitTransaction | None = None):
        """Apply a committed version's WAL to the index (the work the
        reference's IndexingManager threads do, indexing_manager.rs:60-181)."""
        wal_path = self.data_dir / f"{version}.wal"
        header, ops = read_wal(wal_path)
        status = txn.status if txn else TransactionStatus()
        status.start(header.get("total_ops", len(ops)))
        upserted = deleted = 0
        done = 0
        if header.get("durable"):
            # implicit (streaming) WAL crash replay: ops were applied inline
            # in strict order and acknowledged, so replay keeps that order
            for op, payload in ops:
                if op == OP_UPSERT:
                    self.index_embeddings(payload)
                    upserted += len(payload)
                else:
                    self.delete_embedding(payload)
                    deleted += 1
                done += 1
                status.progress(upserted, deleted, done)
            self.flush_indexes()
            self.save_snapshot()
            status.complete(version)
            self.vcs.update_background_version(version)
            wal_path.unlink(missing_ok=True)
            return
        up_payloads = [p for op, p in ops if op == OP_UPSERT]
        total_up = sum(len(p) for p in up_payloads)
        dense_empty = self.dense is None or self.dense.index is None or self.dense.index.n == 0
        if len(up_payloads) > 1 and dense_empty and total_up >= self.COALESCE_MIN:
            # coalesce a fresh collection's upserts into ONE ingest; duplicate
            # ids keep the last occurrence (apply-in-order upsert semantics)
            seen: dict = {}
            for p in up_payloads:
                for v in p:
                    seen[v["id"]] = v
            self.index_embeddings(list(seen.values()))
            upserted = total_up
            done = len(up_payloads)
            status.progress(upserted, deleted, done)
        elif up_payloads:
            for op, payload in ops:
                if op == OP_UPSERT:
                    self.index_embeddings(payload)
                    upserted += len(payload)
                    done += 1
                    status.progress(upserted, deleted, done)
        # deletes apply AFTER all upserts — reference parity: its
        # IndexingManager applies deletes serially after the upserts
        # (indexing_manager.rs:174-176)
        for op, payload in ops:
            if op == OP_DELETE:
                self.delete_embedding(payload)
                deleted += 1
                done += 1
                status.progress(upserted, deleted, done)
        self.flush_indexes()
        self.save_snapshot()
        status.complete(version)
        self.vcs.update_background_version(version)
        wal_path.unlink(missing_ok=True)

    def index_embeddings(self, vectors: list[dict]) -> None:
        """Assign internal ids, update maps, fan out to the dense index
        (collection.rs:439-533)."""
        from cosdata_tpu_torch.utils.profiling import profiler

        # engine lock too (coll -> engine order): index mutations must not
        # interleave with in-flight searches
        with self.lock, self._engine_dispatch_lock, profiler.timer("index.embeddings"):
            dense_batch: list[tuple[int, list[float], dict | None]] = []
            for v in vectors:
                ext = v["id"]
                if ext in self.etoi:
                    self.delete_embedding(ext)  # upsert semantics
                iid = self.next_internal
                self.next_internal += 1
                self.etoi[ext] = iid
                self.itoe[iid] = ext
                doc = v.get("document_id")
                if doc is not None:
                    self.dtoi.setdefault(doc, []).append(iid)
                rec = {"id": ext}
                if doc is not None:
                    rec["document_id"] = doc
                if v.get("metadata") is not None:
                    rec["metadata"] = v["metadata"]
                if v.get("text") is not None:
                    rec["text"] = v["text"]
                self.raw[iid] = rec
                self._map_log.append(("u", iid, rec))
                if v.get("dense_values") is not None and self.dense is not None:
                    mids = (
                        self.schema.value_ids(v.get("metadata"))
                        if (self.schema and v.get("metadata") is not None)
                        else None
                    )
                    dense_batch.append((iid, v["dense_values"], mids))
                sp = v.get("sparse_values")
                if sp is not None and self.sparse is not None:
                    pairs = np.asarray(sp, np.float32).reshape(-1, 2)
                    self.sparse.add(iid, pairs[:, 0].astype(np.int64), pairs[:, 1])
                if v.get("text") is not None and self.tfidf is not None:
                    self.tfidf.add(iid, v["text"])
            if dense_batch:
                ids = [i for i, _, _ in dense_batch]
                arr = np.asarray([d for _, d, _ in dense_batch], np.float32)
                metas = [m for _, _, m in dense_batch]
                self.dense.add_batch(ids, arr, metas)

    def delete_embedding(self, external_id) -> None:
        with self.lock, self._engine_dispatch_lock:
            external_id = self._resolve_key(external_id, self.etoi)
            iid = self.etoi.pop(external_id, None)
            if iid is None:
                return
            self.itoe.pop(iid, None)
            self._map_log.append(("d", iid, external_id))
            rec = self.raw.pop(iid, None)
            if rec and rec.get("document_id") is not None:
                lst = self.dtoi.get(rec["document_id"], [])
                if iid in lst:
                    lst.remove(iid)
            if self.dense is not None:
                self.dense.delete(iid)
            if self.sparse is not None:
                self.sparse.delete(iid)
            if self.tfidf is not None:
                self.tfidf.delete(iid)

    def flush_indexes(self):
        with self.lock, self._engine_dispatch_lock:
            if self.dense is not None:
                self.dense.flush()
            if self.sparse is not None:
                self.sparse.flush()
            if self.tfidf is not None:
                self.tfidf.flush()

    def save_snapshot(self):
        from cosdata_tpu_torch.store.snapshots import save_collection_state

        # exclude concurrent ingest AND searches while chunk epochs are
        # compared/recorded
        with self.lock, self._engine_dispatch_lock:
            save_collection_state(self, self.data_dir / "snapshot")
            if getattr(self.app_config, "enable_context_history", False):
                save_collection_state(
                    self,
                    self.data_dir / f"snapshot-v{self.vcs.current_version}",
                    archive=True,
                )

    # --------------------------------------------------- streaming (implicit)

    def stream_upsert(self, vectors: list[dict]) -> None:
        """Immediately-indexed implicit transaction path
        (streaming/repo.rs:9-50, indexing_manager.rs:269-289)."""
        with self.lock:
            for v in vectors:
                self.validate_vector(v, upsert=True)
            imp = self._ensure_implicit()
            imp.wal.append_upsert(vectors)
            self.index_embeddings(vectors)

    def stream_delete(self, vector_id) -> None:
        with self.lock:
            imp = self._ensure_implicit()
            imp.wal.append_delete(vector_id)
            self.delete_embedding(vector_id)

    def _ensure_implicit(self) -> ImplicitTransaction:
        if self.implicit is None:
            version = self.vcs.allot_version()
            self.vcs.set_current_version(
                version, {"kind": "implicit", "epoch_id": int(time.time())}
            )
            self.implicit = ImplicitTransaction(str(self.data_dir / f"{version}.wal"), version)
        return self.implicit

    def close_epoch(self) -> None:
        """Epoch close: flush indexes, finalize + delete implicit WAL
        (collection.rs:264-278)."""
        with self.lock:
            if self.implicit is None:
                return
            self.flush_indexes()
            self.save_snapshot()
            self.implicit.wal.close()
            Path(self.implicit.wal.path).unlink(missing_ok=True)
            self.vcs.update_background_version(self.implicit.version)
            self.implicit = None

    # -------------------------------------------------------------- search

    def _format_results(self, internal_ids, scores, return_raw_text: bool):
        out = []
        for row_ids, row_scores in zip(internal_ids, scores):
            items = []
            for iid, s in zip(row_ids, row_scores):
                if iid < 0:
                    continue
                rec = self.raw.get(int(iid))
                if rec is None:
                    continue
                items.append(
                    {
                        "id": rec["id"],
                        "document_id": rec.get("document_id"),
                        "score": float(s),
                        "text": rec.get("text") if return_raw_text else None,
                    }
                )
            out.append(items)
        return out

    def search_dense(self, query_vectors, top_k=10, return_raw_text=False, filter_dto=None):
        from cosdata_tpu_torch.utils.profiling import profiler

        with profiler.timer("search.dense"):
            return self._search_dense(query_vectors, top_k, return_raw_text, filter_dto)

    def _search_dense(self, query_vectors, top_k=10, return_raw_text=False, filter_dto=None):
        if filter_dto is None:
            # unfiltered requests coalesce into one device dispatch
            ids, scores = self._batcher(
                "_dense_batcher", lambda q, k: self.dense.search(q, k)
            ).search(np.asarray(query_vectors, np.float32), top_k)
        else:
            if self.schema is None:
                raise ValueError("collection has no metadata schema to filter on")
            from cosdata_tpu_torch.metadata.filtering import compile_filter

            mask_fn = compile_filter(self.schema, filter_dto)
            # build the mask INSIDE the dispatch lock: ingest and compaction
            # renumber rows under coll+engine locks
            with self._engine_dispatch_lock:
                self.dense.finalize_sampling()
                row_mask = self.dense.row_mask_for(mask_fn)
                ids, scores = self.dense.search(
                    np.asarray(query_vectors, np.float32), top_k, row_mask=row_mask
                )
        return self._format_results(ids, scores, return_raw_text)

    @property
    def _engine_dispatch_lock(self):
        """One lock per collection serializing every engine search call —
        batched or bypass — so concurrent searches never race inside the
        index handle."""
        lock = self.__dict__.get("_engine_lock")
        if lock is None:
            with self.lock:
                lock = self.__dict__.setdefault("_engine_lock", threading.RLock())
        return lock

    def _batcher(self, attr: str, run):
        """Lazily build the per-engine MicroBatcher exactly once."""
        batcher = self.__dict__.get(attr)
        if batcher is None:
            from cosdata_tpu_torch.core.microbatch import MicroBatcher

            with self.lock:
                batcher = self.__dict__.get(attr)
                if batcher is None:
                    batcher = MicroBatcher(run, dispatch_lock=self._engine_dispatch_lock)
                    self.__dict__[attr] = batcher
        return batcher

    def _sparse_ids(self, query_terms_list, top_k, early_terminate_threshold=None):
        """Internal (ids, scores) of the sparse engine leg.

        rerank_sparse_with_raw_values / reranking factor (config.toml:5-6)
        are re-read per call."""

        def run(qs, k):
            return self.sparse.search(
                qs, top_k=k,
                rerank=bool(getattr(self.app_config, "rerank_sparse_with_raw_values", False)),
                rerank_factor=int(getattr(self.app_config, "sparse_raw_values_reranking_factor", 5)),
            )

        if early_terminate_threshold is not None:
            # per-request override (dtos.rs:44): mutates engine state, so
            # hold the shared dispatch lock — coalesced batches in flight
            # must not observe another request's threshold
            with self._engine_dispatch_lock:
                old = self.sparse.early_terminate_threshold
                self.sparse.early_terminate_threshold = early_terminate_threshold
                try:
                    return run(query_terms_list, top_k)
                finally:
                    self.sparse.early_terminate_threshold = old
        return self._batcher("_sparse_batcher", run).search(list(query_terms_list), top_k)

    def search_sparse(self, query_terms_list, top_k=10, early_terminate_threshold=None,
                      return_raw_text=False):
        ids, scores = self._sparse_ids(query_terms_list, top_k, early_terminate_threshold)
        return self._format_results(ids, scores, return_raw_text)

    def _tfidf_ids(self, queries, top_k):
        """Internal (ids, scores) of the text leg; concurrent requests
        coalesce into one engine call."""
        return self._batcher(
            "_tfidf_batcher", lambda qs, k: self.tfidf.search(qs, top_k=k)
        ).search(list(queries), top_k)

    def search_tfidf(self, queries, top_k=10, return_raw_text=False):
        ids, scores = self._tfidf_ids(queries, top_k)
        return self._format_results(ids, scores, return_raw_text)

    def hybrid_search(self, query: dict, top_k=10, fusion_constant_k=60.0, return_raw_text=False):
        """RRF fusion of two legs, each fetching 3*top_k
        (search/repo.rs:168-341)."""
        return self.hybrid_search_batch([query], top_k, fusion_constant_k, return_raw_text)[0]

    @property
    def _hybrid_pool(self):
        """Shared leg-runner pool (one per collection, built lazily): the
        leg groups of a hybrid batch run concurrently, so one leg's host
        work overlaps the other's device work."""
        pool = self.__dict__.get("_hybrid_executor")
        if pool is None:
            import concurrent.futures as _futures

            with self.lock:
                pool = self.__dict__.get("_hybrid_executor")
                if pool is None:
                    pool = _futures.ThreadPoolExecutor(3, thread_name_prefix="hybrid-leg")
                    self.__dict__["_hybrid_executor"] = pool
        return pool

    def hybrid_search_batch(self, queries, top_k=10, fusion_constant_k=60.0, return_raw_text=False):
        """Batched hybrid: legs are regrouped across queries (all dense
        sub-queries in one engine call, the sparse ones by early-termination
        threshold, all text sub-queries in one; search/repo.rs:343-555) and
        fused by the vectorized RRF (core/fusion.py). Returns one result
        list per query."""
        from cosdata_tpu_torch.core.fusion import rrf_fuse

        fetch = top_k * 3
        b = len(queries)
        dense_q, dense_slots = [], []
        sparse_groups: dict = {}  # threshold -> (queries, slots)
        text_q, text_slots = [], []
        for i, query in enumerate(queries):
            keys = [kk for kk in ("query_vector", "query_terms", "query_text") if kk in query]
            if len(keys) != 2:
                raise ValueError("hybrid query must combine two of query_vector/query_terms/query_text")
            for leg_no, kk in enumerate(keys):
                if kk == "query_vector":
                    dense_q.append(query["query_vector"])
                    dense_slots.append((i, leg_no))
                elif kk == "query_terms":
                    thr = query.get("sparse_early_terminate_threshold")
                    g = sparse_groups.setdefault(thr, ([], []))
                    g[0].append(query["query_terms"])
                    g[1].append((i, leg_no))
                else:
                    text_q.append(query["query_text"])
                    text_slots.append((i, leg_no))
        jobs = []
        if dense_q:
            jobs.append(("dense", dense_q, dense_slots, None))
        for thr, (qs, slots) in sparse_groups.items():
            jobs.append(("sparse", qs, slots, thr))
        if text_q:
            jobs.append(("text", text_q, text_slots, None))

        def run_leg(job):
            kind, qs, slots, thr = job
            if kind == "dense":
                ids, _ = self._batcher(
                    "_dense_batcher", lambda q, k: self.dense.search(q, k)
                ).search(np.asarray(qs, np.float32), fetch)
            elif kind == "sparse":
                ids, _ = self._sparse_ids(qs, fetch, thr)
            else:
                ids, _ = self._tfidf_ids(qs, fetch)
            return np.asarray(ids, np.int64), slots

        if not jobs:  # empty batch: nothing to fuse
            return []
        if len(jobs) > 1:
            results = list(self._hybrid_pool.map(run_leg, jobs))
        else:
            results = [run_leg(jobs[0])]
        leg_a = np.full((b, fetch), -1, np.int64)
        leg_b = np.full((b, fetch), -1, np.int64)
        for ids, slots in results:
            w = min(fetch, ids.shape[1])
            rows = np.fromiter((s[0] for s in slots), np.int64, len(slots))
            legno = np.fromiter((s[1] for s in slots), np.int64, len(slots))
            for leg_no, dst in ((0, leg_a), (1, leg_b)):
                sel = legno == leg_no
                if sel.any():
                    dst[rows[sel], :w] = ids[sel, :w]
        fused_ids, fused_sc = rrf_fuse([leg_a, leg_b], top_k, fetch, float(fusion_constant_k))
        return self._format_results(fused_ids, fused_sc, return_raw_text)

    # ------------------------------------------------- version-context query

    def restore_indexes_from_meta(self) -> None:
        """Recreate index handles from the persisted descriptors
        (IndexOps::load_data role, indexes/mod.rs:176-213)."""
        self._restoring = True
        try:
            self._restore_indexes_inner()
        finally:
            self._restoring = False

    def _restore_indexes_inner(self) -> None:
        for desc in self.meta.get("indexes", self.name, default=[]) or []:
            t = desc.get("index_type")
            try:
                if t == "dense" and self.dense is None:
                    self.create_dense_index(
                        distance_metric=desc.get("distance_metric", "cosine"),
                        quantization=desc.get("quantization"),
                        hnsw_params=desc.get("hnsw_params"),
                        raw_storage=desc.get("raw_storage", "device"),
                        shards=desc.get("shards", 1),
                    )
                elif t == "sparse" and self.sparse is None:
                    self.create_sparse_index(
                        quantization=desc.get("quantization", 64),
                        sample_threshold=desc.get("sample_threshold", 1000),
                        scan_budget=desc.get("scan_budget"),
                        scan_budget_total=desc.get("scan_budget_total"),
                    )
                elif t == "tf_idf" and self.tfidf is None:
                    self.create_tf_idf_index(
                        k1=desc.get("k1", 1.2),
                        b=desc.get("b", 0.75),
                        sample_threshold=desc.get("sample_threshold", 1000),
                        scan_budget=desc.get("scan_budget"),
                        scan_budget_total=desc.get("scan_budget_total"),
                    )
            except ValueError:
                pass  # index type disabled for this collection config

    def checkout_version(self, version: int) -> "Collection":
        """Read-only view of the collection at an older version, loaded from
        the per-version snapshot that ``enable_context_history`` retains."""
        version = int(version)
        if version == self.vcs.current_version:
            return self
        with self.lock:
            cache = self.__dict__.setdefault("_history_views", {})
            if version in cache:
                cache[version] = cache.pop(version)  # LRU move-to-back
                return cache[version]
            snap = self.data_dir / f"snapshot-v{version}"
            if not snap.exists():
                raise KeyError(
                    f"version {version} not found in context history "
                    "(enable_context_history retains per-version snapshots)"
                )
            from cosdata_tpu_torch.store.snapshots import load_collection_state

            clone = Collection(self.meta, self.data_dir.parent.parent, self.config, self.device)
            clone.app_config = self.app_config
            clone.restore_indexes_from_meta()
            load_collection_state(clone, snap)
            cache[version] = clone
            # each view pins a full store copy: keep only the few most recent
            limit = int(getattr(self.app_config, "history_view_cache", 2))
            while len(cache) > max(limit, 1):
                cache.pop(next(iter(cache)))
            return clone

    # -------------------------------------------------------------- vectors

    def _resolve_key(self, key, table: dict):
        """External/document ids arrive as JSON values (int or str) on
        upsert but always as STRINGS from URL path segments; probe the
        as-given form first, then the other numeric spelling."""
        if key in table:
            return key
        if isinstance(key, str):
            try:
                alt = int(key)
            except ValueError:
                return key
            if alt in table:
                return alt
        elif isinstance(key, int) and str(key) in table:
            return str(key)
        return key

    def get_vector(self, external_id) -> dict | None:
        iid = self.etoi.get(self._resolve_key(external_id, self.etoi))
        if iid is None:
            return None
        return self._full_record(iid)

    def vectors_by_document(self, document_id) -> list[dict]:
        out = []
        for i in self.dtoi.get(self._resolve_key(document_id, self.dtoi), []):
            rec = self._full_record(i)
            if rec is not None:
                out.append(rec)
        return out

    def _full_record(self, iid: int) -> dict | None:
        """The full vector record: slim host fields + the dense values
        gathered back from the store's raw rows and the sparse pairs from
        the inverted index (vectors/repo.rs contract)."""
        rec = self.raw.get(iid)
        if rec is None:
            return None
        out = dict(rec)
        out.setdefault("document_id", None)
        d = self.dense
        if d is not None and d.index is not None and d.index.store.keep_raw:
            row = d.row_of.get(iid)
            if row is not None:
                if getattr(d.index, "is_sharded", False):
                    vals = d.index.raw_rows([row])[0]
                else:
                    vals = d.index.store.raw_rows([row])[0].cpu().numpy()
                out["dense_values"] = [float(x) for x in vals]
        if self.sparse is not None:
            pairs = self.sparse.raw_pairs(iid)
            if pairs is not None:
                out["sparse_values"] = pairs
        return out

    # ---------------------------------------------------------------- info

    def indexing_status(self) -> dict:
        """Rollup over transaction statuses (collection.rs:577-645)."""
        counts = {"not_started": 0, "in_progress": 0, "complete": 0}
        total_upserted = 0
        with self.lock:  # create_transaction inserts concurrently
            txns = list(self.txns.values())
        for txn in txns:
            st = txn.status.to_dict()
            counts[st["status"]] += 1
            total_upserted += st["records_upserted"]
        return {
            "collection_name": self.name,
            "status_counts": counts,
            "total_records_upserted": total_upserted,
            "current_version": self.vcs.current_version,
            "background_version": self.vcs.background_version,
        }

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "dense_vector": self.dense_vector,
            "sparse_vector": self.sparse_vector,
            "tf_idf_options": self.tf_idf_options,
            "metadata_schema": self.metadata_schema,
            "store_raw_text": self.store_raw_text,
            "config": self.config.get("config", {}),
        }
