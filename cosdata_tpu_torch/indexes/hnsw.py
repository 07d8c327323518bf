"""Scan-served part of the HNSW index (port of cosdata_tpu/indexes/hnsw.py).

The port has no graph yet. Rows go into the store along the reference's
scan-only ingest route, and searches take the exact scan
(:meth:`HNSWIndex.search_brute`), which is what ``DenseIndexHandle`` serves
every unfiltered search with up to ``flat_serve_threshold`` rows, and
every search of an index loaded from a scan-only snapshot (``scan_only``),
at any size. Graph build and graph search raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cosdata_tpu_torch.indexes.flat import GROUP, k_bins_for
from cosdata_tpu_torch.ops.flat_scan import fused_flat_search, fused_flat_search_codes
from cosdata_tpu_torch.ops.storage import VectorStore, as_rows
from cosdata_tpu_torch.ops.topk import NEG_INF, topk

_GRAPH = "the HNSW graph is not ported yet (ROADMAP queue 1: the graph)"


@dataclass
class HNSWParams:
    """Hyperparameters, defaults as in the reference."""

    num_layers: int = 9
    neighbors_count: int = 32
    level_0_neighbors_count: int = 64
    ef_construction: int = 128
    ef_search: int = 256
    level_prob_base: float = 10.0
    expand: int = 4
    visited_cap: int = 2048
    max_iters: int = 96
    wave_size: int = 1024
    ef_upper: int = 8
    neighbor_selection: str = "heuristic"

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class HNSWIndex:
    """A store with tombstones, served by the exact scan."""

    #: capacities at/above one scan chunk use the exact-scan engine
    SCAN_CHUNK = 1 << 16

    def __init__(
        self,
        dim: int,
        device,
        metric: str = "cosine",
        kind: str = "u8",
        resolution: int = 2,
        range_: tuple[float, float] = (-1.0, 1.0),
        params: HNSWParams | None = None,
        keep_raw: bool = True,
        seed: int = 0,
        initial_capacity: int = 1024,
    ):
        self.params = params or HNSWParams()
        self.seed = seed
        self.store = VectorStore(
            dim=dim, device=device, kind=kind, metric=metric, resolution=resolution,
            range=range_, keep_raw=keep_raw, initial_capacity=initial_capacity,
        )
        self.alive = torch.ones((self.store.capacity,), dtype=torch.bool, device=self.store.device)
        self.n_deleted = 0
        #: the rows came from a snapshot without a graph: the reference
        #: serves such an index by the exact scan at any size and under any
        #: filter, and so does the port
        self.scan_only = False

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def cap(self) -> int:
        return self.store.capacity

    def _sync_capacity(self) -> None:
        grow = self.store.capacity - self.alive.shape[0]
        if grow:
            self.alive = torch.nn.functional.pad(self.alive, (0, grow), value=True)

    def add(self, x) -> np.ndarray:
        """Insert a batch along the scan-only route; returns internal ids."""
        ids = self.store.add(x)
        self._sync_capacity()
        return ids

    def bulk_build(self, x) -> np.ndarray:
        raise NotImplementedError(_GRAPH)

    def search(self, queries, top_k: int = 10, ef: int | None = None):
        raise NotImplementedError(_GRAPH)

    def delete(self, internal_id: int) -> None:
        self.alive[int(internal_id)] = False
        self.n_deleted += 1

    def _rerank_factor(self) -> int:
        """Exact-rerank shortlist depth as a multiple of top_k: 1-2 bit codes
        order so noisily that the true top-k routinely sits outside a 5x
        shortlist, so they take 20x."""
        if self.store.kind == "subbyte" and self.store.resolution <= 2:
            return 20
        return 5

    def search_brute(
        self, queries, top_k: int = 10, mask: np.ndarray | None = None, rerank: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact masked scan + exact rerank; host (ids, scores), -1 padded."""
        out = self.search_brute_device(queries, top_k, mask, rerank)
        if out is None:
            b = as_rows(queries, "cpu").shape[0]
            return (
                np.full((b, top_k), -1, np.int64),
                np.full((b, top_k), -np.inf, np.float32),
            )
        ids, vals = out
        return ids.cpu().numpy().astype(np.int64), vals.cpu().numpy()

    def _valid(self, mask: np.ndarray | None) -> torch.Tensor:
        valid = self.store.valid_mask() & self.alive
        if mask is not None:
            m = np.zeros(self.cap, bool)
            m[: len(mask)] = mask
            valid = valid & torch.from_numpy(m).to(self.store.device)
        return valid

    def search_brute_device(
        self, queries, top_k: int = 10, mask: np.ndarray | None = None, rerank: bool = True
    ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Device (ids, vals), or None for an empty index. u8 scan codes are
        quantized from the exact f32 queries and the u8 rerank uses the
        f16-rounded queries; other kinds scan and rerank with the exact f32
        queries (reference parity)."""
        store = self.store
        queries = as_rows(queries, store.device)
        if self.n == 0:
            return None
        do_rerank = bool(rerank and store.keep_raw)
        keep = min(self._rerank_factor() * top_k if do_rerank else top_k, self.cap)
        if self.cap >= self.SCAN_CHUNK:
            if self.cap % self.SCAN_CHUNK:
                store.grow_to(-(-self.cap // self.SCAN_CHUNK) * self.SCAN_CHUNK)
                self._sync_capacity()
            if store.kind != "u8":
                lo, hi = store.range
                return fused_flat_search(
                    store.metric, store.score_kind, store.dim, store.dim_pad, store.resolution,
                    keep, top_k, self.SCAN_CHUNK, do_rerank, store.ship_queries(queries),
                    lo, hi, store.arrays, store.raw if do_rerank else None, self._valid(mask),
                )
            qc = store.ship_query_codes(queries)
            q_re = store.pad_dims(queries, ship_f16=True) if do_rerank else None
            return fused_flat_search_codes(
                store.metric, store.dim, store.dim_pad, k_bins_for(keep), GROUP, keep,
                top_k, do_rerank, qc, store.arrays, store.raw if do_rerank else None, q_re,
                self._valid(mask),
            )
        q = store.quantize_queries(queries)
        vals, ids = topk(store.scores_all(q), keep, mask=self._valid(mask)[None, :])
        if do_rerank:
            re = store.rerank_scores(queries, ids)
            vals = torch.where(vals > NEG_INF / 2, re, NEG_INF)
            vals, pos = torch.topk(vals, top_k, dim=1)
            ids = torch.gather(ids, 1, pos)
        else:
            vals, ids = vals[:, :top_k], ids[:, :top_k]
        ids = torch.where(vals > NEG_INF / 2, ids, -1)
        return ids, vals
