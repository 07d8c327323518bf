"""Data-parallel HNSW across devices (port of
cosdata_tpu/parallel/sharded_hnsw.py).

Each shard is an independent :class:`HNSWIndex` over its part of the rows,
on its own device (shards cycle over the devices given, so four shards on
one card are four sub-indexes on that card). Inserts go round-robin in
contiguous blocks; a search fans out to every shard, each shard's device
work is dispatched before any result is copied to the host (so shards on
different cards overlap), and the per-shard top-k lists merge on the host
into global ids.

Each shard picks its own route: a spilled shard takes the streamed scan,
a masked search, a shard at or under ``flat_serve_threshold`` rows or a
scan-only shard takes the exact scan (K1 or K2 once its capacity reaches a
scan chunk), any other the graph. Shards with host raw rows return a 5x
shortlist in quantized order that is reranked exactly on the host side
before the merge.

Not ported: the reference's ``ship_dtype`` (its wire formats are not
ported). Each shard measures its growth against the whole card's budget,
as in the reference (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from cosdata_tpu_torch.indexes.hnsw import HNSWIndex, HNSWParams, _empty_result


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ShardedHNSWIndex:
    #: marker for the serving layer: DenseIndexHandle routes a sharded
    #: engine through :meth:`search`, which picks each shard's route
    is_sharded = True

    #: per-shard scan/graph crossover (DenseIndexHandle.flat_serve_threshold)
    flat_serve_threshold = 1_572_864

    def __init__(
        self,
        dim: int,
        devices: list | None = None,
        n_shards: int | None = None,
        metric: str = "cosine",
        kind: str = "u8",
        resolution: int = 2,
        range_: tuple[float, float] = (-1.0, 1.0),
        params: HNSWParams | None = None,
        seed: int = 0,
        initial_capacity_per_shard: int = 1024,
        keep_raw: bool | str = True,
    ):
        """``devices`` defaults to every visible CUDA device and is cycled
        to ``n_shards``; shard i is built on ``devices[i]`` with seed
        ``seed + i``. Pass ``["cpu"] * n`` to shard on the CPU."""
        if not devices:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("no CUDA device is visible: pass devices (e.g. ['cpu'] * n) explicitly")
        devices = [torch.device(d) for d in devices]
        if n_shards is not None:
            devices = (devices * n_shards)[:n_shards]
        self.devices = devices
        self.params = params or HNSWParams()
        self.shards: list[HNSWIndex] = [
            HNSWIndex(
                dim=dim, device=dev, metric=metric, kind=kind, resolution=resolution, range_=range_,
                params=self.params, seed=seed + i, initial_capacity=initial_capacity_per_shard,
                keep_raw=keep_raw,
            )
            for i, dev in enumerate(devices)
        ]
        self.scan_only = self.shards[0].scan_only if self.shards else False
        #: per-shard local row -> global id, and the reverse map
        self._global_of: list[list[int]] = [[] for _ in devices]
        self._loc_of: dict[int, tuple[int, int]] = {}
        #: ``_global_of[s]`` as an array, rebuilt only after shard s grew,
        #: so that a search does not convert each shard's list anew
        self._gmap_arrays: dict[int, np.ndarray] = {}
        self.n = 0
        #: rotation cursor, so batches smaller than the shard count still
        #: spread over the shards across add() calls
        self._rr = 0

    def add(self, x) -> np.ndarray:
        """Round-robin block insert of (B, dim) rows (numpy, list or a
        tensor on any device); returns the global ids."""
        if not torch.is_tensor(x):
            x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        n_sh = len(self.shards)
        gids = np.arange(self.n, self.n + len(x), dtype=np.int64)
        # balanced contiguous blocks of this batch, rotated by the cursor
        blocks = np.array_split(np.arange(len(x)), n_sh)
        splits = [blocks[(s - self._rr) % n_sh] for s in range(n_sh)]
        self._rr = (self._rr + 1) % n_sh
        for s, part in enumerate(splits):
            if len(part) == 0:
                continue
            self.shards[s].add(x[int(part[0]) : int(part[-1]) + 1])
            base = len(self._global_of[s])
            for j, g in enumerate(gids[part].tolist()):
                self._loc_of[g] = (s, base + j)
            self._global_of[s].extend(gids[part].tolist())
        self.n += len(x)
        return gids

    @property
    def n_deleted(self) -> int:
        return sum(s.n_deleted for s in self.shards)

    @property
    def store(self):
        """The first shard's store: the serving layer reads the kind,
        metric and raw-row tier from it (the same on every shard)."""
        return self.shards[0].store

    def _gmap(self, s: int) -> np.ndarray:
        """Shard ``s``'s local row -> global id map (the lists only grow)."""
        arr = self._gmap_arrays.get(s)
        if arr is None or len(arr) != len(self._global_of[s]):
            arr = self._gmap_arrays[s] = np.asarray(self._global_of[s], np.int64)
        return arr

    def _local_mask(self, s: int, row_mask: np.ndarray) -> np.ndarray:
        """A global row mask (indexed by global insert order) in shard
        ``s``'s local row space."""
        gmap = self._gmap(s)
        safe = np.minimum(gmap, len(row_mask) - 1)
        local = np.zeros(self.shards[s].cap, bool)
        if len(gmap):
            local[: len(gmap)] = np.where(gmap < len(row_mask), row_mask[safe], False)
        return local

    def search(self, queries, top_k: int = 10, ef: int | None = None, row_mask: np.ndarray | None = None):
        """Fan out to every shard and merge the global top-k on the host.
        Returns host (global ids (B, k), scores (B, k)), -1 / -inf padded.

        Every shard's device call is issued before any result is copied
        back. A masked search takes the exact masked scan on every shard."""
        pending = []
        for s, shard in enumerate(self.shards):
            if shard.n == 0:
                continue
            mask_l = self._local_mask(s, row_mask) if row_mask is not None else None
            # host-raw shards return a 5x shortlist in quantized order,
            # reranked exactly below before the merge
            fetch = top_k * 5 if shard.store.raw_on_host else top_k
            if shard.store.codes_on_host:
                # spilled: the streamed scan (host arrays, reranked already)
                out = shard.search_brute(queries, fetch, mask=mask_l)
            elif mask_l is not None or shard.n <= self.flat_serve_threshold or shard.scan_only:
                out = shard.search_brute_device(queries, fetch, mask=mask_l)
            else:
                out = shard.search_device(queries, top_k=fetch, ef=ef)
            if out is not None:
                pending.append((s, out))
        if not pending:
            return _empty_result(queries, top_k)
        all_ids, all_scores = [], []
        for s, (ids_out, scores_out) in pending:
            ids = _host(ids_out).astype(np.int64)
            scores = _host(scores_out).astype(np.float32)
            shard = self.shards[s]
            if shard.store.raw_on_host and not shard.store.codes_on_host:
                # exact scores, so that shards compare with each other
                re = shard.store.rerank_scores_host(queries, np.maximum(ids, 0))
                scores = np.where(ids >= 0, re, -np.inf).astype(np.float32)
            gmap = self._gmap(s)
            ok = ids >= 0
            gids = np.full_like(ids, -1)
            gids[ok] = gmap[ids[ok]]
            all_ids.append(gids)
            all_scores.append(np.where(ok, scores, -np.inf))
        cat_ids = np.concatenate(all_ids, axis=1)
        cat_scores = np.concatenate(all_scores, axis=1)
        order = np.argsort(-cat_scores, axis=1)[:, :top_k]
        return np.take_along_axis(cat_ids, order, axis=1), np.take_along_axis(cat_scores, order, axis=1)

    def refine(self) -> None:
        for shard in self.shards:
            shard.refine()

    def delete(self, global_id: int) -> None:
        loc = self._loc_of.pop(int(global_id), None)
        if loc is None:
            return
        s, row = loc
        self.shards[s].delete(row)

    def raw_rows(self, global_rows) -> np.ndarray:
        """Raw f32 rows by global row id, as a host array (zeros for an
        unknown id)."""
        global_rows = np.atleast_1d(np.asarray(global_rows, np.int64))
        out = np.zeros((len(global_rows), self.shards[0].store.dim), np.float32)
        for i, g in enumerate(global_rows.tolist()):
            loc = self._loc_of.get(g)
            if loc is None:
                continue
            s, row = loc
            out[i] = self.shards[s].store.raw_rows([row])[0].cpu().numpy()
        return out
