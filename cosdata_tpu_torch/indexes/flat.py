"""Flat (brute-force) dense index (port of cosdata_tpu/indexes/flat.py).

Stores at or above ``SCAN_THRESHOLD`` rows of capacity take an exact-scan
engine of ops/flat_scan.py: u8 stores the codes engine (stage 2 is the
u8_bin_max kernel), sub-byte and float stores the chunked scan (sub-byte
code dots by kernel K2). Smaller stores score the whole store with one
product and a top-k. A store whose codes spilled to the host tier takes
the streamed scan, and raw rows on the host or on disk rerank the
shortlist there (``VectorStore.rerank_host_topk``).
"""

from __future__ import annotations

import numpy as np
import torch

from cosdata_tpu_torch.ops.flat_scan import (
    exact_rerank_sorted,
    fused_flat_search,
    fused_flat_search_codes,
    fused_flat_search_codes_f16q,
    streamed_flat_topk,
)
from cosdata_tpu_torch.ops.storage import VectorStore, as_rows
from cosdata_tpu_torch.ops.topk import NEG_INF, topk

#: rows per bin of the scan engine (one warp of the u8_bin_max kernel)
GROUP = 32


def k_bins_for(k_fetch: int) -> int:
    """Bins to expand: the true top-J rows live in the top-J bins; 64 leaves
    headroom, and every extra bin costs a GROUP-row rescore."""
    return max(64, -(-k_fetch // GROUP) * 2)


class FlatIndex:
    #: at/above one chunk of capacity, use the exact-scan engine
    SCAN_THRESHOLD = 1 << 16
    #: the scan engine's capacity granularity
    SCAN_CHUNK = 1 << 16

    def __init__(
        self,
        dim: int,
        device,
        metric: str = "cosine",
        kind: str = "u8",
        resolution: int = 2,
        range_: tuple[float, float] = (-1.0, 1.0),
        keep_raw: bool | str = True,
        initial_capacity: int = 1024,
        raw_dtype: str = "f32",
    ):
        if initial_capacity >= self.SCAN_THRESHOLD:
            # presize to a scan-chunk multiple: growth later would transiently
            # hold old+new copies of every array (incl. the raw rows)
            initial_capacity = -(-initial_capacity // self.SCAN_CHUNK) * self.SCAN_CHUNK
        self.store = VectorStore(
            dim=dim, device=device, kind=kind, metric=metric, resolution=resolution,
            range=range_, keep_raw=keep_raw, initial_capacity=initial_capacity,
            raw_dtype=raw_dtype,
        )
        self.alive = torch.ones((self.store.capacity,), dtype=torch.bool, device=self.store.device)

    @classmethod
    def from_store(cls, store: VectorStore) -> FlatIndex:
        """An index over an existing store (e.g. VectorStore.from_arrays)."""
        idx = cls.__new__(cls)
        idx.store = store
        idx.alive = torch.ones((store.capacity,), dtype=torch.bool, device=store.device)
        return idx

    @property
    def n(self) -> int:
        return self.store.n

    def _sync_alive(self) -> None:
        grow = self.store.capacity - self.alive.shape[0]
        if grow:
            self.alive = torch.nn.functional.pad(self.alive, (0, grow), value=True)

    def add(self, x) -> np.ndarray:
        ids = self.store.add(x)
        self._sync_alive()
        return ids

    def delete(self, internal_id: int) -> None:
        self.alive[int(internal_id)] = False

    def maybe_promote(self) -> bool:
        """Move spilled codes back to the device when the budget fits
        (``VectorStore.maybe_promote_codes``); the scan takes K1 again."""
        return self.store.maybe_promote_codes()

    def _mask(self) -> torch.Tensor:
        """valid & alive on the device, for the resident and the streamed
        scan alike (the reference caches it, and a host copy for the
        streamed scan, against remote-link round trips; on a local device
        it is one cheap elementwise op)."""
        return self.store.valid_mask() & self.alive

    def search(
        self, queries, top_k: int = 10, rerank: bool = False, rerank_factor: int = 5
    ) -> tuple[np.ndarray, np.ndarray]:
        store = self.store
        if rerank and store.raw_on_host:
            # the quantized shortlist from the device, reranked against the
            # host or disk raw rows
            queries = as_rows(queries, store.device)
            fetch = max(min(top_k * rerank_factor, max(store.capacity, 1)), top_k)
            ids, _ = self.search_device(queries, fetch, rerank=False)
            return store.rerank_host_topk(queries, ids.cpu().numpy().astype(np.int64), top_k)
        ids, vals = self.search_device(queries, top_k, rerank, rerank_factor)
        return ids.cpu().numpy().astype(np.int64), vals.cpu().numpy()

    def search_device(
        self, queries, top_k: int = 10, rerank: bool = False, rerank_factor: int = 5
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One search, returning device tensors (ids (B, k), vals (B, k))."""
        store = self.store
        queries = as_rows(queries, store.device)
        b = queries.shape[0]
        if self.n == 0:
            return (
                torch.full((b, top_k), -1, dtype=torch.int64, device=store.device),
                torch.full((b, top_k), -np.inf, dtype=torch.float32, device=store.device),
            )
        k_fetch = min(top_k * rerank_factor if rerank else top_k, store.capacity)
        if store.codes_on_host:
            # no rerank stage here (host raw rows rerank in search())
            top_s, top_i = streamed_flat_topk(store.metric, store, queries, k_fetch, self._mask())
            return top_i[:, :top_k], top_s[:, :top_k]
        do_rerank = bool(rerank and store.keep_raw is True)
        if store.capacity >= self.SCAN_THRESHOLD:
            if store.capacity % self.SCAN_CHUNK:
                store.grow_to(-(-store.capacity // self.SCAN_CHUNK) * self.SCAN_CHUNK)
                self._sync_alive()
            mask = self._mask()
            if store.kind != "u8":
                lo, hi = store.range
                return fused_flat_search(
                    store.metric, store.score_kind, store.dim, store.dim_pad, store.resolution,
                    k_fetch, top_k, self.SCAN_CHUNK, do_rerank, store.ship_queries(queries),
                    lo, hi, store.arrays, store.raw if do_rerank else None, mask,
                )
            k_bins = k_bins_for(k_fetch)
            if not do_rerank:
                qc = store.ship_query_codes(queries)
                ids, vals = fused_flat_search_codes(
                    store.metric, store.dim, store.dim_pad, k_bins, GROUP, k_fetch,
                    k_fetch, False, qc, store.arrays, None, None, mask,
                )
                return ids[:, :top_k], vals[:, :top_k]
            # one f16-rounded query tensor feeds the scan and the rerank
            q_f16 = store.pad_dims(queries, ship_f16=True)
            lo, hi = store.range
            ids, vals = fused_flat_search_codes_f16q(
                store.metric, store.dim, store.dim_pad, k_bins, GROUP, k_fetch,
                k_fetch, q_f16, lo, hi, store.arrays, mask,
            )
            return exact_rerank_sorted(
                store.metric, store.dim, store.dim_pad, top_k, q_f16, store.raw, ids, vals
            )
        mask = self._mask()
        q = store.quantize_queries(queries)
        vals, ids = topk(store.scores_all(q), k_fetch, mask=mask[None, :], ties_by_index=store.metric == "hamming")
        if do_rerank:
            re = store.rerank_scores(queries, ids)
            re = torch.where(vals > NEG_INF / 2, re, NEG_INF)
            vals, pos = torch.topk(re, top_k, dim=1)
            ids = torch.gather(ids, 1, pos)
        else:
            vals, ids = vals[:, :top_k], ids[:, :top_k]
        ids = torch.where(vals > NEG_INF / 2, ids, -1)
        return ids, vals
