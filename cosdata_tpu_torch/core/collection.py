"""Dense index handle (port of the dense part of cosdata_tpu/core/collection.py).

``DenseIndexHandle`` is the entry below the front ends: the reference's
``Collection.search_dense`` and every REST and gRPC dense-search handler end
in its ``search``. It keeps the sample-then-configure protocol (quantization
"auto" buffers ``sample_threshold`` rows, tunes the u8 range on them, then
builds) and the engine routing. u8, sub-byte (binary, quaternary, octal),
f16 and f32 storage with cosine or dot are ported; every route that needs
the graph raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from cosdata_tpu_torch.indexes.hnsw import HNSWIndex, HNSWParams
from cosdata_tpu_torch.ops.storage import SUBBYTE_ALIAS


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


_METRIC_ALIAS = {
    "cosine": "cosine",
    "cosinesimilarity": "cosine",
    "dot": "dot",
    "dotproduct": "dot",
    "euclidean": "euclidean",
    "hamming": "hamming",
}


class DenseIndexHandle:
    """Scan-served dense index + the auto-tuning sample buffer."""

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
        if int(shards or 1) > 1:
            raise NotImplementedError("sharded dense indexes are not ported yet (ROADMAP queue 1: multi-GPU)")
        self.device = torch.device(device)
        self.descriptor = {
            "index_type": "dense",
            "distance_metric": distance_metric,
            "quantization": quantization,
            "hnsw_params": hnsw_params or {},
            "raw_storage": raw_storage,
        }
        if raw_storage not in ("device", "host", "disk", "none"):
            raise ValueError(f"unknown raw_storage {raw_storage}")
        if raw_storage in ("host", "disk"):
            raise NotImplementedError(
                f"raw_storage={raw_storage!r} is not ported yet (ROADMAP queue 1: spill tiers)"
            )
        self.keep_raw = raw_storage == "device"
        self.dimension = dimension
        key = str(distance_metric).lower().replace("_", "")
        if key not in _METRIC_ALIAS:
            raise ValueError(f"unknown distance metric '{distance_metric}'")
        self.metric = _METRIC_ALIAS[key]
        if self.metric not in ("cosine", "dot"):
            raise NotImplementedError(
                f"{self.metric} dense search is not ported yet "
                "(ROADMAP queue 1: euclidean and hamming stage 1)"
            )
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
        self.index: HNSWIndex | None = None
        #: unfiltered searches at or below this row count take the exact
        #: scan; above it they need the graph
        self.flat_serve_threshold = 1_572_864
        #: filtered searches at or below this row count always take the
        #: exact masked scan; above it permissive filters need the graph
        self.graph_filter_min = 20_000
        # internal id <-> dense row maps
        self.row_of: dict[int, int] = {}
        self.internal_of: list[int] = []
        #: internal_of as an array for the search's row -> id map. Building
        #: it from the list on every search cost 36 ms of host time at 1M
        #: rows, half of a b1024 search (beside an NVIDIA H100 80GB HBM3,
        #: 700 W); internal_of only grows, so its length keys the copy
        self._internal_arr = np.empty(0, np.int64)
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

    def _build(self):
        self.index = HNSWIndex(
            dim=self.dimension,
            device=self.device,
            metric=self.metric,
            kind=self.kind,
            range_=self.range,
            params=self.params,
            seed=self.seed,
            keep_raw=self.keep_raw,
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

    def delete(self, internal_id: int):
        row = self.row_of.pop(internal_id, None)
        if row is not None and self.index is not None:
            self.index.delete(row)

    def search(self, queries, top_k: int, ef: int | None = None, row_mask: np.ndarray | None = None):
        """Returns host (internal_ids (B, k), scores (B, k)); -1 padded.

        ``row_mask``: boolean filter over store rows (metadata filtering)."""
        self.finalize_sampling()
        n = self.index.n
        if row_mask is None:
            needs_graph = n > self.flat_serve_threshold
        else:
            selectivity = float(row_mask.mean()) if len(row_mask) else 0.0
            needs_graph = not (
                selectivity <= 0.10
                or n <= self.graph_filter_min
                or n <= self.flat_serve_threshold
            )
        if needs_graph:
            raise NotImplementedError(
                f"searching {n} rows{' with a permissive filter' if row_mask is not None else ''} "
                "needs the HNSW graph, which is not ported yet (ROADMAP queue 1: the graph)"
            )
        rows, scores = self.index.search_brute(queries, top_k=top_k, mask=row_mask)
        internal = np.full_like(rows, -1)
        if len(self._internal_arr) != len(self.internal_of):
            self._internal_arr = np.asarray(self.internal_of, np.int64)
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
