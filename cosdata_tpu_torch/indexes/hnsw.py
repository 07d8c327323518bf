"""Dense HNSW index on fixed-degree adjacency tables (port of
cosdata_tpu/indexes/hnsw.py).

- The graph is device tensors: level-0 adjacency ``adj0`` (cap, m0) and
  one upper table ``up_adj`` (cap_up, L, m) addressed through a node ->
  slot map ``up_slot`` (about a tenth of the nodes reach level 1). Each
  table has a score table beside it (``adj0_d``, ``up_d``).
- Ingest builds the graph: an empty index given at least
  ``BULK_THRESHOLD`` rows takes :meth:`bulk_build` (exact kNN lists below
  ``RP_THRESHOLD`` members, random-projection-tree leaves above),
  everything else takes insertion waves of ``wave_size`` rows (one beam
  search for the whole wave, intra-wave links from a causal (W, W) score
  matrix, reverse edges by a keep-m-closest merge).
- Search descends the level hierarchy with the batched beam search of
  ``ops/hnsw_kernels.py``, drops tombstoned ids, reranks the top
  ``5 * k`` in exact f32 against the exact queries, and takes the top-k.
- Deletes are tombstones filtered at result time; edges through dead
  nodes keep the graph navigable.
- An index loaded from a snapshot without a graph is ``scan_only``: it
  takes rows without building a graph and every search takes the exact
  scan (:meth:`search_brute`), as the reference's scan-only index does.
  A hamming index is scan-only from construction and holds no adjacency:
  its XOR popcount has no dot formulation for the graph's scoring (the
  reference's ``hnsw.py:397-403``).
- The spill tier: when growth passes the device budget the store spills
  its codes to the host, and the index turns ``scan_only``, frees its
  graph and keeps its tombstones in a host mirror (``_alive_host``);
  searches stream the codes through the scan (:meth:`_search_streamed`).
  :meth:`force_spill` spills on demand, with ``keep_graph=True`` keeping
  the level-0 adjacency (``graph_on_spill``), which serves graph searches
  by beam waves that gather their candidates' rows on the host
  (:meth:`_search_graph_hostcodes`). :meth:`maybe_promote` moves the codes
  back once they fit. Raw rows on the host or on disk rerank there.

Not ported: the per-level compiled split programs, the cache of small
search constants, the power-of-two batch padding (the visited set is
still chosen from the padded batch size, as the reference chooses it)
and the build log; ``last_build_stats`` stays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cosdata_tpu_torch.indexes.flat import GROUP, k_bins_for
from cosdata_tpu_torch.ops import hnsw_kernels as HK
from cosdata_tpu_torch.ops.flat_scan import (
    flat_scan_topk,
    fused_flat_search,
    fused_flat_search_codes,
    streamed_flat_topk,
)
from cosdata_tpu_torch.ops.storage import VectorStore, as_rows, gather_queries, quantize_batch, rerank
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k, topk, unique_mask_ids
from cosdata_tpu_torch.store.chunked import DirtyTracker


def _next_pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


@dataclass
class HNSWParams:
    """Hyperparameters, defaults as in the reference."""

    num_layers: int = 9
    neighbors_count: int = 32
    level_0_neighbors_count: int = 64
    ef_construction: int = 128
    ef_search: int = 256
    level_prob_base: float = 10.0
    expand: int = 4  # beam entries expanded per wave
    visited_cap: int = 2048  # per-query visited ring size
    max_iters: int = 96  # beam-search wave bound
    wave_size: int = 1024  # insert wave width
    ef_upper: int = 8  # beam width above level 0
    # "heuristic" = HNSW diversity pruning (Algorithm 4); "closest" =
    # keep-m-closest
    neighbor_selection: str = "heuristic"

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _rp_split_body(seg, vals, valid, n_segs: int):
    """One RP-tree level: split every segment at its approximate median
    (256-bucket histogram; the threshold bucket goes whole to one side).
    The histogram is one ``torch.bincount`` (the reference's one-hot
    product exists to avoid scatter on the TPU)."""
    nbuck = 256
    lo = torch.where(valid, vals, torch.inf).min()
    hi = torch.where(valid, vals, -torch.inf).max()
    b = torch.clamp(((vals - lo) / torch.clamp_min(hi - lo, 1e-30) * nbuck).to(torch.int64), 0, nbuck - 1)
    hist = torch.bincount((seg.long() * nbuck + b)[valid], minlength=n_segs * nbuck).reshape(n_segs, nbuck)
    half = (hist.sum(1) + 1) // 2
    thresh = (torch.cumsum(hist, 1) >= half[:, None]).to(torch.uint8).argmax(1)
    side = b > thresh[torch.clamp_max(seg.long(), n_segs - 1)]
    return torch.where(valid, seg * 2 + side.to(seg.dtype), 0)


def _empty_result(queries, top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """The answer of an empty index: -1 ids, -inf scores."""
    x = queries if torch.is_tensor(queries) else np.asarray(queries)
    b = 1 if x.ndim == 1 else x.shape[0]
    return np.full((b, top_k), -1, np.int64), np.full((b, top_k), -np.inf, np.float32)


def _merge_candidates(cand_ids, cand_scores, wave_row_scores, wave_ids, level_ok, c: int):
    """Top-c of (searched candidates from the graph) ∪ (causally earlier
    wave mates at this level), deduplicated."""
    wm = torch.where(level_ok[None, :], wave_row_scores, NEG_INF)
    ids = torch.cat([cand_ids, wave_ids[None, :].expand(wm.shape)], dim=1)
    scores = torch.where(unique_mask_ids(ids), torch.cat([cand_scores, wm], dim=1), NEG_INF)
    return _top_m(ids, scores, min(c, scores.shape[1]))


def _visited_impl(b: int, id_span: int, budget: int = 256 << 20) -> str:
    """Exact per-query bit tables unless (B, ceil(N/32)) words would pass
    the budget."""
    return "bitmask" if b * (-(-id_span // 32)) * 4 <= budget else "ring"


def _fused_search(
    metric, kind, d, d_true, resolution, ef0, ef_upper, expand, vcap, max_iters,
    keep, k, rerank_on, lo, hi,
    q_raw,  # (B, Dpad) exact f32 queries
    store, raw, adj0, up_adj, up_slot, alive, entry: int,
    upper_levels: list[int],  # active upper levels, descending
    visited_impl: str = "bitmask",
):
    """A whole ANN search: upper-level descent -> level-0 beam -> tombstone
    mask -> exact rerank against the exact queries -> top-k."""
    qkind = "f32" if kind == "float" else kind
    q = quantize_batch(q_raw, lo, hi, qkind, resolution, d_true)
    b = q_raw.shape[0]
    start = torch.full((b, 1), entry, dtype=torch.int64, device=q_raw.device)
    for level in upper_levels:
        ids, _ = HK.beam_search(
            metric, kind, d, ef_upper, expand, vcap, max_iters, q, store, up_adj[:, level - 1], up_slot,
            start, use_row_of=True, visited_impl=visited_impl,
        )
        start = ids[:, : max(ef_upper, 1)]
    ids, scores = HK.beam_search(
        metric, kind, d, ef0, expand, vcap, max_iters, q, store, adj0, up_slot, start,
        use_row_of=False, visited_impl=visited_impl,
    )
    ids, scores = ids[:, :keep], scores[:, :keep]
    valid = (ids >= 0) & alive[torch.clamp_min(ids, 0)]
    if rerank_on:
        scores = rerank(metric, q_raw, raw, ids)
    top_s, pos = lax_top_k(torch.where(valid, scores, NEG_INF), k)
    top_i = torch.where(top_s > NEG_INF / 2, torch.gather(ids, 1, pos), -1)
    return top_i, top_s


def _bulk_knn_edges(metric, kind, d, m, scan_chunk, heuristic, node_ids, store, mask):
    """Exact top-2m neighbors of each node (self excluded) by the chunked
    scan (kernel K2 for sub-byte stores), then diversity pruning to m."""
    q = gather_queries("f32" if kind == "float" else kind, store, node_ids)
    vals, ids = flat_scan_topk(metric, kind, d, 2 * m + 1, scan_chunk, q, store, mask, ref_select=True)
    self_hit = ids == node_ids[:, None]
    vals = torch.where(self_hit, NEG_INF, vals)
    ids = torch.where(self_hit, -1, ids)
    vals, pos = lax_top_k(vals, 2 * m)
    ids = torch.gather(ids, 1, pos)
    if heuristic:
        return HK.select_diverse(ids, vals, HK.pairwise_scores(metric, kind, d, ids, store), m)
    return _top_m(ids, vals, m)


def _prune_candidates(metric, kind, d, m, chunk, heuristic, node_ids, cand_ids, cand_scores, store):
    """Forward edges of a bulk build: per node, dedup its candidates (a
    tuple of per-tree parts, concatenated per chunk), keep the best 2m,
    then diversity-prune to m, in node chunks of ``chunk`` (the chunk
    changes time, not results). Returns (ids (N, m), scores (N, m))."""
    parts_i = cand_ids if isinstance(cand_ids, (list, tuple)) else (cand_ids,)
    parts_s = cand_scores if isinstance(cand_scores, (list, tuple)) else (cand_scores,)
    n = parts_i[0].shape[0]
    keep_c = min(2 * m, sum(p.shape[1] for p in parts_i))
    out_i = torch.empty((n, m), dtype=torch.int64, device=node_ids.device)
    out_s = torch.empty((n, m), dtype=torch.float32, device=node_ids.device)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        ids_c = torch.cat([p[sl] for p in parts_i], dim=1).long()
        sc_c = torch.cat([p[sl] for p in parts_s], dim=1)
        ok = unique_mask_ids(ids_c) & (ids_c >= 0) & (ids_c != node_ids[sl].long()[:, None])
        top_s, pos = lax_top_k(torch.where(ok, sc_c, NEG_INF), keep_c)
        top_i = torch.where(top_s > NEG_INF / 2, torch.gather(ids_c, 1, pos), -1)
        if heuristic:
            g, sm, mg = HK._decode_rows(kind, d, store, torch.clamp_min(top_i, 0))
            pair = HK._block_scores(metric, kind, d, store, g, sm, mg, g, sm, mg)
            out_i[sl], out_s[sl] = HK.select_diverse(top_i, top_s, pair, m)
            continue
        t_s, t_pos = lax_top_k(top_s, min(m, keep_c))
        t_i = torch.gather(top_i, 1, t_pos)
        if t_i.shape[1] < m:
            t_i = torch.nn.functional.pad(t_i, (0, m - t_i.shape[1]), value=-1)
            t_s = torch.nn.functional.pad(t_s, (0, m - t_s.shape[1]), value=NEG_INF)
        out_i[sl], out_s[sl] = torch.where(t_s > NEG_INF / 2, t_i, -1), t_s
    return out_i, out_s


def _top_m(cand_ids, cand_scores, m: int):
    top_s, pos = lax_top_k(cand_scores, min(m, cand_scores.shape[1]))
    top_i = torch.where(top_s > NEG_INF / 2, torch.gather(cand_ids, 1, pos), -1)
    return top_i, torch.where(top_i >= 0, top_s, NEG_INF)


def _merge_neighbors_3d(adj, dists, rows, level, inc_ids, inc_dists, m: int, dedup: bool = True):
    """merge_neighbors over the (cap_up, L, m) upper table at one level, in
    place (the level's (cap_up, m) views write through)."""
    HK.merge_neighbors(adj[:, level], dists[:, level], rows, inc_ids, inc_dists, m, dedup=dedup)
    return adj, dists


class HNSWIndex:
    """Batched-wave HNSW over a :class:`VectorStore` on one device."""

    #: capacities at/above one scan chunk use the exact-scan engine
    SCAN_CHUNK = 1 << 16
    #: empty-index batches at least this large take the bulk build
    BULK_THRESHOLD = 8192
    #: members above this count build by RP-tree leaf kNN instead of the
    #: exact full sweep
    RP_THRESHOLD = 32768
    RP_LEAF = 8192
    RP_TREES = 2
    #: NN-descent rounds after the level-0 bulk build (keep RP_TREES >= 2
    #: when 0: the second tree is what bridges single-tree leaf islands)
    NN_DESCENT_ROUNDS = 0
    #: the reference's per-leaf approx_max_k recall target; the port's
    #: leaf top-k is exact
    LEAF_RECALL_TARGET = 0.85
    #: NN-descent neighbor subsample per side
    NN_SAMPLE = 8
    #: upper levels at or below this member count build in one exact
    #: member x member block
    UPPER_EXACT_MAX = 12288
    #: nodes per diversity-prune chunk of a bulk build (time, not results)
    PRUNE_CHUNK = 8192
    #: euclidean kNN lists over rows of varied norms gather hubs (rows near
    #: the origin are near every row: in-degrees up to ~2,000 at 1M rows,
    #: against ~150 by cosine) and leave thousands of rows no list points
    #: to; the reference's design (two trees, keep-m-closest reverse edges)
    #: then misses whole query neighbourhoods. A euclidean RP-tree level 0
    #: takes more trees and re-prunes each row's list together with its
    #: best incoming edges by the diversity heuristic, as HNSW prunes the
    #: list an insertion's reverse edge overflows (PERF.md §6, PR 9)
    EUCLIDEAN_RP_TREES = 4
    EUCLIDEAN_REPRUNE = 1

    def __init__(
        self,
        dim: int,
        device,
        metric: str = "cosine",
        kind: str = "u8",
        resolution: int = 2,
        range_: tuple[float, float] = (-1.0, 1.0),
        params: HNSWParams | None = None,
        keep_raw: bool | str = True,
        seed: int = 0,
        initial_capacity: int = 1024,
    ):
        self.params = p = params or HNSWParams()
        self.seed = seed
        self.store = VectorStore(
            dim=dim, device=device, kind=kind, metric=metric, resolution=resolution,
            range=range_, keep_raw=keep_raw, initial_capacity=initial_capacity,
        )
        dev = self.store.device
        cap = self.store.capacity
        self.adj0 = torch.full((cap, p.level_0_neighbors_count), -1, dtype=torch.int32, device=dev)
        self.adj0_d = torch.full((cap, p.level_0_neighbors_count), NEG_INF, dtype=torch.float32, device=dev)
        self.cap_up = max(1024, cap // 4)
        self.up_adj = torch.full((self.cap_up, p.num_layers, p.neighbors_count), -1, dtype=torch.int32, device=dev)
        self.up_d = torch.full(
            (self.cap_up, p.num_layers, p.neighbors_count), NEG_INF, dtype=torch.float32, device=dev
        )
        self.up_slot = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        self.up_slot_host = np.full((cap,), -1, np.int32)
        self.n_up = 0
        self.levels = np.zeros((cap,), np.int8)
        self.level_counts = np.zeros(p.num_layers + 1, np.int64)  # nodes at level >= l
        self.entry = -1
        self.entry_level = -1
        self.alive = torch.ones((cap,), dtype=torch.bool, device=dev)
        self.n_deleted = 0
        self.rng = np.random.default_rng(seed)
        #: adjacency dirty epochs ("adj0": store rows, "up": slot rows), so
        #: snapshots rewrite only touched chunks
        self.tracker = DirtyTracker()
        #: set by bulk_build: {"ingest_s", "graph_s"} of the last build
        self.last_build_stats: dict | None = None
        #: the index holds no graph (hamming, loaded from a scan-only
        #: snapshot, or its codes spilled): rows are appended without graph
        #: work and every search takes the scan
        self.scan_only = False
        #: the codes spilled with the level-0 adjacency kept (force_spill)
        self.graph_on_spill = False
        #: tombstones on the host while the codes are spilled (the device
        #: ``alive`` is then a (1,) placeholder)
        self._alive_host: np.ndarray | None = None
        #: {"waves", "rows", "bytes"} uploaded by the last host-codes search
        self.last_hostcodes_stats: dict | None = None
        if metric == "hamming":
            self._drop_graph()

    @classmethod
    def from_arrays(cls, arrays: dict, *, metric: str, device, params: HNSWParams | None = None,
                    seed: int = 0) -> HNSWIndex:
        """An index holding the reference index's state, given as numpy
        arrays: the store's (see ``VectorStore.from_arrays``) plus the
        graph's ``adj0``, ``adj0_d``, ``up_adj``, ``up_d``, ``up_slot``,
        ``levels``, ``level_counts``, ``n_up``, ``entry``, ``entry_level``
        and ``alive``."""
        store = VectorStore.from_arrays(arrays, metric=metric, device=device)
        idx = cls(store.dim, device, metric=metric, kind=store.kind, resolution=store.resolution,
                  range_=store.range, params=params, keep_raw=False, seed=seed, initial_capacity=1)
        idx.store = store
        idx.adopt_graph(arrays)
        return idx

    def adopt_graph(self, arrays: dict) -> None:
        """Take over a graph given as numpy arrays (``from_arrays``' graph
        keys; ``alive`` and ``n_deleted`` optional) sized to the store."""
        dev = self.store.device

        def t(name, dtype):
            return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=dev)

        self.adj0, self.adj0_d = t("adj0", torch.int32), t("adj0_d", torch.float32)
        self.up_adj, self.up_d = t("up_adj", torch.int32), t("up_d", torch.float32)
        self.cap_up = int(self.up_adj.shape[0])
        self.up_slot = t("up_slot", torch.int32)
        self.up_slot_host = np.asarray(arrays["up_slot"], np.int32).copy()
        self.levels = np.asarray(arrays["levels"], np.int8).copy()
        self.level_counts = np.asarray(arrays["level_counts"], np.int64).copy()
        self.n_up = int(arrays["n_up"])
        self.entry, self.entry_level = int(arrays["entry"]), int(arrays["entry_level"])
        if "alive" in arrays:
            self.alive = t("alive", torch.bool)
        if "n_deleted" in arrays:
            self.n_deleted = int(arrays["n_deleted"])
        self.scan_only = False
        self._sync_capacity()

    # ------------------------------------------------------------------ util

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def cap(self) -> int:
        return self.store.capacity

    def _kind(self) -> str:
        return self.store.score_kind

    def _sync_capacity(self) -> None:
        """Pad the per-row graph state to the store's capacity (a scan-only
        index keeps no adjacency); a store that spilled its codes turns the
        index scan-only first."""
        cap = self.store.capacity
        pad = torch.nn.functional.pad
        if self.store.codes_on_host and not self.graph_on_spill:
            self._maybe_spill_to_scan_only()
        if self._alive_host is not None:
            if len(self._alive_host) < cap:
                self._alive_host = np.pad(self._alive_host, (0, cap - len(self._alive_host)), constant_values=True)
        else:
            if self.alive.shape[0] < cap:
                self.alive = pad(self.alive, (0, cap - self.alive.shape[0]), value=True)
            if self.up_slot.shape[0] < cap:
                self.up_slot = pad(self.up_slot, (0, cap - self.up_slot.shape[0]), value=-1)
        if len(self.up_slot_host) < cap:
            self.up_slot_host = np.pad(self.up_slot_host, (0, cap - len(self.up_slot_host)), constant_values=-1)
        if len(self.levels) < cap:
            self.levels = np.pad(self.levels, (0, cap - len(self.levels)))
        if self.adj0.shape[0] < cap and not self.scan_only:
            rows = cap - self.adj0.shape[0]
            self.adj0 = pad(self.adj0, (0, 0, 0, rows), value=-1)
            self.adj0_d = pad(self.adj0_d, (0, 0, 0, rows), value=NEG_INF)

    def _grow_up(self, need: int) -> None:
        while self.cap_up < need:
            self.cap_up *= 2
        grow = self.cap_up - self.up_adj.shape[0]
        if grow > 0:
            self.up_adj = torch.nn.functional.pad(self.up_adj, (0, 0, 0, 0, 0, grow), value=-1)
            self.up_d = torch.nn.functional.pad(self.up_d, (0, 0, 0, 0, 0, grow), value=NEG_INF)

    def _sample_levels(self, w: int) -> np.ndarray:
        """Geometric levels: P(level >= n) = base^-n, capped at num_layers
        (the reference's draws from the same generator)."""
        u = self.rng.random(w)
        return np.minimum(
            np.floor(-np.log(np.maximum(u, 1e-300)) / np.log(self.params.level_prob_base)),
            self.params.num_layers,
        ).astype(np.int8)

    def _active_upper_levels(self) -> list[int]:
        return [lv for lv in range(self.params.num_layers, 0, -1) if self.level_counts[lv] > 0]

    def _assign_levels(self, ids: np.ndarray) -> np.ndarray:
        """Draw the new nodes' levels, count them and give the upper ones
        slots; returns the levels."""
        p = self.params
        lv = self._sample_levels(len(ids))
        self.levels[ids] = lv
        for lvl in range(p.num_layers + 1):
            self.level_counts[lvl] += int((lv >= lvl).sum())
        upper = ids[lv >= 1]
        if len(upper):
            self._grow_up(self.n_up + len(upper))
            slots = np.arange(self.n_up, self.n_up + len(upper), dtype=np.int32)
            self.up_slot[torch.as_tensor(upper, device=self.store.device)] = torch.as_tensor(
                slots, device=self.store.device
            )
            self.up_slot_host[upper] = slots
            self.n_up += len(upper)
        return lv

    def _set_entry(self, ids: np.ndarray, lv: np.ndarray) -> None:
        best = int(lv.argmax())
        if lv[best] > self.entry_level or self.entry < 0:
            self.entry, self.entry_level = int(ids[best]), int(lv[best])

    # ----------------------------------------------------------------- build

    def add(self, x) -> np.ndarray:
        """Insert a batch; returns internal ids. An empty index given at
        least BULK_THRESHOLD rows takes :meth:`bulk_build`; otherwise
        insertion waves of ``wave_size`` rows."""
        x = as_rows(x, self.store.device)
        if self.graph_on_spill:
            # the kept graph is read-only (its edge scores and upper levels
            # were freed): ingest turns the index scan-only
            self.graph_on_spill = False
            self._drop_graph()
        if self.scan_only:
            return self._add_rows(x)
        if self.n == 0 and len(x) >= self.BULK_THRESHOLD:
            return self.bulk_build(x)
        out = []
        for i in range(0, len(x), self.params.wave_size):
            out.append(self._add_wave(x[i : i + self.params.wave_size]))
            if self.scan_only:
                # the store spilled mid-add: the rest goes in without graph work
                rest = x[i + self.params.wave_size :]
                if len(rest):
                    out.append(self._add_rows(rest))
                break
        return np.concatenate(out) if out else np.empty((0,), np.int64)

    def _add_rows(self, x) -> np.ndarray:
        """Append rows to a scan-only index (no graph work)."""
        ids = self.store.add(x)
        self._sync_capacity()
        self._count_scan_rows(ids)
        return ids

    def _count_scan_rows(self, ids: np.ndarray) -> None:
        self.level_counts[0] += len(ids)
        if self.entry < 0 and len(ids):
            self.entry, self.entry_level = int(ids[0]), 0

    def _drop_graph(self, keep_adj0: bool = False) -> None:
        """Free the graph (placeholders of one row stay) and turn
        scan-only; ``keep_adj0`` keeps the level-0 ids for the host-codes
        beam and leaves the index a graph index."""
        p = self.params
        dev = self.store.device
        self.scan_only = not keep_adj0
        if not keep_adj0:
            self.adj0 = torch.full((1, p.level_0_neighbors_count), -1, dtype=torch.int32, device=dev)
        self.adj0_d = torch.full((1, p.level_0_neighbors_count), NEG_INF, dtype=torch.float32, device=dev)
        self.up_adj = torch.full((1, p.num_layers, p.neighbors_count), -1, dtype=torch.int32, device=dev)
        self.up_d = torch.full((1, p.num_layers, p.neighbors_count), NEG_INF, dtype=torch.float32, device=dev)
        self.up_slot = torch.full((1,), -1, dtype=torch.int32, device=dev)
        self.cap_up = 1

    def _alive_to_host(self) -> None:
        """Move the tombstones to the host mirror (the device copy becomes a
        (1,) placeholder)."""
        self._alive_host = self.alive.cpu().numpy().copy()
        self.alive = torch.ones((1,), dtype=torch.bool, device=self.store.device)

    def _maybe_spill_to_scan_only(self) -> None:
        """Once the store has spilled its codes (growth past the budget, or
        force_spill): serve by the streamed exact scan, with the tombstones
        on the host and the graph freed."""
        if not self.store.codes_on_host:
            return
        if self._alive_host is None:
            self._alive_to_host()
        if not self.scan_only:
            self._drop_graph()

    def bulk_build(self, x) -> np.ndarray:
        """Build the whole graph of an empty index from k-nearest-neighbor
        lists: exact (by the chunked scan) up to RP_THRESHOLD members, from
        RP-tree leaves above; diversity-pruned forward edges plus
        keep-m-closest reverse edges, level by level."""
        p = self.params
        if self.store.n != 0:
            raise RuntimeError("bulk_build requires an empty index")
        t0 = time.time()
        ids = self.store.add(as_rows(x, self.store.device))
        self._sync_capacity()
        ingest_s = time.time() - t0
        if self.scan_only:
            # the ingest spilled the codes: serve by the scan
            self._count_scan_rows(ids)
            self.last_build_stats = {"ingest_s": round(ingest_s, 1), "graph_s": 0.0}
            return ids
        t_graph0 = time.time()
        n = len(ids)
        lv = self._assign_levels(ids)
        m0 = p.level_0_neighbors_count
        max_lv = int(lv.max()) if n else 0
        if n > self.RP_THRESHOLD:
            self._bulk_level_rp(ids, m0, level=0)
            for lvl in range(1, max_lv + 1):
                members = ids[lv >= lvl]
                if len(members) >= 2:
                    self._bulk_level_rp(members, p.neighbors_count, lvl)
        else:
            self._bulk_level(ids, None, m0, level=0)
            for lvl in range(1, max_lv + 1):
                members = ids[lv >= lvl]
                if len(members) >= 2:
                    self._bulk_level(members, members, p.neighbors_count, lvl)
        self._set_entry(ids, lv)
        self.tracker.bump()
        self.tracker.mark_all("adj0", self.cap)
        self.tracker.mark_all("up", self.cap_up)
        if self.store.device.type == "cuda":
            torch.cuda.synchronize(self.store.device)
        self.last_build_stats = {"ingest_s": round(ingest_s, 1), "graph_s": round(time.time() - t_graph0, 1)}
        return ids

    def _rp_order(self, members: np.ndarray, leaf: int, seed: int) -> np.ndarray:
        """Partition members into balanced leaves by recursive approximate
        median splits of random projections. Returns (num_leaves, Lmax)
        int32, -1 padded, Lmax a multiple of 512."""
        n_mem = len(members)
        depth = max(int(np.ceil(np.log2(max(n_mem / leaf, 1.0)))), 0)
        num_leaves = 1 << depth
        if depth == 0:
            out = np.full((1, max(-(-n_mem // 512) * 512, 512)), -1, np.int64)
            out[0, :n_mem] = members
            return out.astype(np.int32)
        rng = np.random.default_rng(seed)
        rot = rng.normal(size=(self.store.dim_pad, depth)).astype(np.float32)
        store = self.store
        dev = store.device
        contiguous = bool(n_mem and members[0] == 0 and members[-1] == n_mem - 1 and n_mem == store.n)
        sel = slice(0, n_mem) if contiguous else torch.as_tensor(members, device=dev)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        rot_dev = torch.as_tensor(rot, device=dev)
        if store.keep_raw is True:
            proj = store.raw[sel].to(torch.float32) @ rot_dev
        elif store.kind == "u8" and not store.codes_on_host:
            # the device codes, not host raw rows: an affine quantization
            # of the same geometry, projected where they live
            proj = store.arrays.data[sel].to(torch.float32) @ rot_dev
        elif store.raw_on_host:
            # host raw rows: uploaded in pieces and projected on the device
            step = 1 << 17
            proj = torch.cat([
                store.upload_rows([store.raw_host], torch.as_tensor(members[s : s + step], dtype=torch.int64))[0]
                @ rot_dev
                for s in range(0, n_mem, step)
            ])
        else:
            # sub-byte without raw rows: a random balanced partition
            perm = rng.permutation(n_mem)
            per_leaf = -(-n_mem // num_leaves)
            l_max = -(-per_leaf // 512) * 512
            out = np.full((num_leaves, l_max), -1, np.int64)
            for i in range(num_leaves):
                part = perm[i::num_leaves]
                out[i, : len(part)] = members[part]
            return out.astype(np.int32)
        mp = self._bucket(n_mem, 1024)
        vals_all = torch.nn.functional.pad(proj, (0, 0, 0, mp - n_mem))
        valid = torch.arange(mp, device=dev) < n_mem
        seg = torch.zeros(mp, dtype=torch.int64, device=dev)
        for lvl in range(depth):
            seg = _rp_split_body(seg, vals_all[:, lvl], valid, 1 << lvl)
        seg = seg[:n_mem].cpu().numpy()
        counts = np.bincount(seg, minlength=num_leaves)
        l_max = -(-int(counts.max()) // 512) * 512
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order = np.argsort(seg, kind="stable")
        sorted_seg = seg[order]
        rank = np.arange(n_mem) - starts[sorted_seg]
        out = np.full((num_leaves, l_max), -1, np.int64)
        out[sorted_seg, rank] = members[order]
        return out.astype(np.int32)

    @staticmethod
    def _bucket(n: int, lo: int = 1024) -> int:
        """Round up to {2^k, 1.5*2^k}."""
        v = lo
        while v < n:
            if (v & (v - 1)) == 0 and n <= v * 3 // 2:
                return v * 3 // 2
            v *= 2
        return v

    def _bulk_level_rp(self, members: np.ndarray, m_l: int, level: int) -> None:
        """RP-tree bulk construction of one level: per-tree leaf kNN ->
        diversity prune -> forward writes + reverse edges (+ NN-descent
        rounds at level 0). Small upper levels take one exact block."""
        p = self.params
        store = self.store
        dev = store.device
        n_mem = len(members)
        kind = self._kind()
        heur = p.neighbor_selection == "heuristic"
        if level >= 1 and n_mem <= self.UPPER_EXACT_MAX:
            mp = 512 if n_mem <= 512 else self.UPPER_EXACT_MAX
            mem_pad = np.full(mp, -1, np.int64)
            mem_pad[:n_mem] = members
            slots_pad = np.full(mp, -1, np.int64)
            slots_pad[:n_mem] = self.up_slot_host[members]
            HK.upper_level_exact(
                store.metric, kind, store.dim_pad, m_l, heur, torch.as_tensor(mem_pad, device=dev),
                torch.as_tensor(slots_pad, device=dev), self.up_slot, self.up_adj[:, level - 1],
                self.up_d[:, level - 1], store.arrays,
            )
            return
        kk = min(2 * m_l, self.RP_LEAF - 1)
        euclidean = store.metric == "euclidean"
        # upper levels are navigation-only: one tree suffices; level 0 with
        # no NN-descent needs the second tree to bridge leaf islands
        rp_trees = self.EUCLIDEAN_RP_TREES if euclidean else self.RP_TREES
        trees = rp_trees if (n_mem > self.RP_LEAF and level == 0) else 1
        if level == 0 and self.NN_DESCENT_ROUNDS == 0 and trees < 2:
            trees = 2
        mp = self._bucket(n_mem, 1024)
        parts_i, parts_s = [], []
        for t in range(trees):
            order = self._rp_order(members, self.RP_LEAF, seed=101 + 31 * t + level)
            l_sz = order.shape[1]
            leaf_chunk = max(1, (1 << 26) // max(l_sz * l_sz, 1))
            flat = order.reshape(-1)
            valid = flat >= 0
            pos = np.zeros(self.cap, np.int64)
            pos[flat[valid]] = np.flatnonzero(valid)
            pos_mem = np.full(mp, -1, np.int64)
            pos_mem[:n_mem] = pos[members]
            ids_m, sc_m = HK.leaf_knn_gather(
                store.metric, kind, store.dim_pad, kk, leaf_chunk, torch.as_tensor(order, device=dev),
                torch.as_tensor(pos_mem, device=dev), store.arrays, rt=self.LEAF_RECALL_TARGET,
            )
            parts_i.append(ids_m)
            parts_s.append(sc_m)
        mem_pad = np.full(mp, -1, np.int64)
        mem_pad[:n_mem] = members
        mem_dev = torch.as_tensor(mem_pad, device=dev)
        fwd_ids, fwd_d = _prune_candidates(
            store.metric, kind, store.dim_pad, m_l, self.PRUNE_CHUNK, heur, mem_dev, tuple(parts_i),
            tuple(parts_s), store.arrays,
        )
        del parts_i, parts_s
        if level == 0:
            HK.finalize_level0(
                store.metric, kind, store.dim_pad, m_l, self.NN_DESCENT_ROUNDS, self.NN_SAMPLE, 256,
                self.adj0, self.adj0_d, mem_dev, fwd_ids, fwd_d, store.arrays,
            )
            for _ in range(self.EUCLIDEAN_REPRUNE if euclidean else 0):
                self._reprune_level0(mem_dev, m_l)
        else:
            slots_pad = np.full(mp, -1, np.int64)
            slots_pad[:n_mem] = self.up_slot_host[members]
            HK.upper_level_apply(
                m_l, mem_dev, torch.as_tensor(slots_pad, device=dev), self.up_slot, fwd_ids, fwd_d,
                self.up_adj[:, level - 1], self.up_d[:, level - 1],
            )

    def _reprune_level0(self, mem_dev: torch.Tensor, m: int) -> None:
        """Each member's level-0 list together with its m best incoming
        edges, diversity-pruned back to m (the heuristic the reverse edges
        of an insertion get in HNSW)."""
        store = self.store
        safe = torch.clamp_min(mem_dev, 0)
        cur_i, cur_d = self.adj0[safe].long(), self.adj0_d[safe]
        cur_i = torch.where(mem_dev[:, None] >= 0, cur_i, -1)
        inc_i, inc_d = HK.incoming_edges(self.adj0.shape[0], mem_dev, cur_i, cur_d, m)
        ids, d = _prune_candidates(
            store.metric, self._kind(), store.dim_pad, m, self.PRUNE_CHUNK, True, mem_dev,
            (cur_i, inc_i[safe]), (cur_d, inc_d[safe]), store.arrays,
        )
        HK._write_rows(self.adj0, self.adj0_d, mem_dev, ids, d)

    def _bulk_level(self, members, candidates, m_l: int, level: int) -> None:
        """Exact-kNN forward edges + reverse merge for one level; the
        neighbors come from ``candidates`` (node ids; None = every row)."""
        p = self.params
        dev = self.store.device
        node_chunk = 2048
        scan_chunk = min(65536, self.cap)
        if self.cap % scan_chunk:
            # grow to a scan-chunk multiple
            self.store.grow_to(-(-self.cap // scan_chunk) * scan_chunk)
            self._sync_capacity()
        mask = self.store.valid_mask()
        if candidates is not None:
            member_mask = torch.zeros_like(mask)
            member_mask[torch.as_tensor(candidates, device=dev)] = True
            mask &= member_mask
        src, fwd, dist = [], [], []
        for s in range(0, len(members), node_chunk):
            part = members[s : s + node_chunk]
            f_ids, f_d = _bulk_knn_edges(
                self.store.metric, self._kind(), self.store.dim_pad, m_l, scan_chunk,
                p.neighbor_selection == "heuristic", torch.as_tensor(part, device=dev), self.store.arrays, mask,
            )
            if level == 0:
                rows = torch.as_tensor(part, device=dev)
                self.adj0[rows] = f_ids.to(torch.int32)
                self.adj0_d[rows] = f_d
            else:
                slots = torch.as_tensor(self.up_slot_host[part].astype(np.int64), device=dev)
                self.up_adj[slots, level - 1] = f_ids.to(torch.int32)
                self.up_d[slots, level - 1] = f_d
            src.append(part)
            fwd.append(f_ids)
            dist.append(f_d)
        # reverse edges for the whole level in one grouped merge; dedup is
        # required (reverse edges heavily overlap the near-symmetric rows)
        self._apply_back_edges(
            level, m_l, np.concatenate(src), torch.cat(fwd).cpu().numpy(), torch.cat(dist).cpu().numpy(), dedup=True
        )

    def _search_levels(self, q, b: int, ef0: int, ef_up: int, record_from: int = 0):
        """Descend the hierarchy; returns (ids, scores) at level 0 plus a
        dict of per-upper-level results for levels <= record_from."""
        p = self.params
        store = self.store
        per_level = {}
        vimpl = _visited_impl(b, self.up_slot.shape[0])
        start = torch.full((b, 1), self.entry, dtype=torch.int64, device=store.device)
        for lvl in self._active_upper_levels():
            ef = ef0 if lvl <= record_from else ef_up
            ids, scores = HK.beam_search(
                store.metric, self._kind(), store.dim_pad, ef, p.expand, p.visited_cap, p.max_iters, q,
                store.arrays, self.up_adj[:, lvl - 1], self.up_slot, start, use_row_of=True, visited_impl=vimpl,
            )
            if lvl <= record_from:
                per_level[lvl] = (ids, scores)
            start = ids[:, : max(p.ef_upper, 1)]
        ids, scores = HK.beam_search(
            store.metric, self._kind(), store.dim_pad, ef0, p.expand, p.visited_cap, p.max_iters, q,
            store.arrays, self.adj0, self.up_slot, start, use_row_of=False, visited_impl=vimpl,
        )
        return ids, scores, per_level

    def _forward_edges(self, merged_ids, merged_scores, m_l: int):
        if self.params.neighbor_selection == "heuristic":
            store = self.store
            pair = HK.pairwise_scores(store.metric, self._kind(), store.dim_pad, merged_ids, store.arrays)
            return HK.select_diverse(merged_ids, merged_scores, pair, m_l)
        return _top_m(merged_ids, merged_scores, m_l)

    def _write_level(self, level: int, ids: np.ndarray, member: np.ndarray, fwd_ids, fwd_d, m_l: int) -> None:
        """Forward rows of the wave members ``member`` at ``level``, then
        their back edges."""
        dev = self.store.device
        mem_j = torch.as_tensor(member, device=dev)
        rows_fwd, dist_fwd = fwd_ids[mem_j], fwd_d[mem_j]
        if level == 0:
            rows = torch.as_tensor(ids[member], device=dev)
            self.adj0[rows] = rows_fwd.to(torch.int32)
            self.adj0_d[rows] = dist_fwd
        else:
            slots = torch.as_tensor(self.up_slot_host[ids[member]].astype(np.int64), device=dev)
            self.up_adj[slots, level - 1] = rows_fwd.to(torch.int32)
            self.up_d[slots, level - 1] = dist_fwd
        self._apply_back_edges(level, m_l, ids[member], rows_fwd.cpu().numpy(), dist_fwd.cpu().numpy())

    def _empty_level(self, b: int):
        dev = self.store.device
        return (
            torch.full((b, self.params.ef_construction), -1, dtype=torch.int64, device=dev),
            torch.full((b, self.params.ef_construction), NEG_INF, dtype=torch.float32, device=dev),
        )

    @staticmethod
    def _pad_wave(ids: np.ndarray) -> np.ndarray:
        """Wave ids padded (with the last id) to a power of two >= 64: the
        search side's width, as in the reference; padded rows are never
        written."""
        w = len(ids)
        wp = max(64, 1 << int(np.ceil(np.log2(w))))
        return np.concatenate([ids, np.full(wp - w, ids[-1], ids.dtype)]) if w < wp else ids

    def _add_wave(self, x: torch.Tensor) -> np.ndarray:
        p = self.params
        store = self.store
        n0 = store.n
        ids = store.add(x)
        self._sync_capacity()
        if self.scan_only:
            # this wave's growth spilled the codes
            self._count_scan_rows(ids)
            return ids
        w = len(ids)
        pad_ids = self._pad_wave(ids)
        wp = len(pad_ids)
        ids_dev = torch.as_tensor(pad_ids, device=store.device)
        lv = self._assign_levels(ids)
        q_wave = store.gather_as_queries(ids_dev)
        max_lv = int(lv.max()) if w else 0
        # search the existing graph for candidates (per level)
        if n0 > 0 and self.entry >= 0:
            c_ids, c_scores, per_level = self._search_levels(
                q_wave, wp, p.ef_construction, p.ef_upper, record_from=max_lv
            )
        else:
            (c_ids, c_scores), per_level = self._empty_level(wp), {}
        wavemat = HK.wave_scores(store.metric, self._kind(), store.dim_pad, q_wave, ids_dev, store.arrays, causal=True)
        lv_padded = np.full(wp, -1, np.int64)
        lv_padded[:w] = lv
        levels_dev = torch.as_tensor(lv_padded, device=store.device)
        for lvl in range(max_lv + 1):
            m_l = p.level_0_neighbors_count if lvl == 0 else p.neighbors_count
            if lvl == 0:
                cl_ids, cl_scores = c_ids, c_scores
            else:
                cl_ids, cl_scores = per_level.get(lvl) or self._empty_level(wp)
            merged_ids, merged_scores = _merge_candidates(
                cl_ids, cl_scores, wavemat, ids_dev, levels_dev >= lvl, 2 * m_l
            )
            fwd_ids, fwd_d = self._forward_edges(merged_ids, merged_scores, m_l)
            member = np.where(lv >= lvl)[0]
            if len(member):
                self._write_level(lvl, ids, member, fwd_ids, fwd_d, m_l)
        self._set_entry(ids, lv)
        self.tracker.bump()
        self.tracker.mark_rows("adj0", ids)
        self.tracker.mark_rows("up", self.up_slot_host[ids])
        return ids

    def refine(self) -> None:
        """One refinement pass: re-search every node's candidates against
        the finished graph and rebuild its forward edges (back edges merged
        keep-m-closest)."""
        if self.scan_only or self.graph_on_spill:
            return
        p = self.params
        store = self.store
        n = self.n
        if n == 0 or self.entry < 0:
            return
        self.tracker.bump()
        self.tracker.mark_all("adj0", self.cap)
        self.tracker.mark_all("up", self.cap_up)
        for start in range(0, n, p.wave_size):
            ids = np.arange(start, min(start + p.wave_size, n), dtype=np.int64)
            pad_ids = self._pad_wave(ids)
            wp = len(pad_ids)
            ids_dev = torch.as_tensor(pad_ids, device=store.device)
            q = store.gather_as_queries(ids_dev)
            lv = self.levels[ids]
            max_lv = int(lv.max()) if len(ids) else 0
            c_ids, c_scores, per_level = self._search_levels(q, wp, p.ef_construction, p.ef_upper, record_from=max_lv)
            for lvl in range(max_lv + 1):
                m_l = p.level_0_neighbors_count if lvl == 0 else p.neighbors_count
                if lvl == 0:
                    cl_ids, cl_scores = c_ids, c_scores
                else:
                    cl_ids, cl_scores = per_level.get(lvl) or self._empty_level(wp)
                # drop self-matches (the node is in the graph it searched)
                self_mask = cl_ids == ids_dev[:, None]
                cl_ids = torch.where(self_mask, -1, cl_ids)
                cl_scores = torch.where(self_mask, NEG_INF, cl_scores)
                merged_ids, merged_scores = _top_m(cl_ids, cl_scores, 2 * m_l)
                fwd_ids, fwd_d = self._forward_edges(merged_ids, merged_scores, m_l)
                member = np.where(lv >= lvl)[0]
                if len(member):
                    self._write_level(lvl, ids, member, fwd_ids, fwd_d, m_l)

    def _apply_back_edges(self, level: int, m_l: int, src, f_ids, f_d, dedup: bool = True) -> None:
        """Group forward edges by target on the host (one lexsort) and run
        the keep-m-closest merge on the device, in blocks of targets."""
        w, m = f_ids.shape
        u = np.repeat(src, m)
        v = f_ids.ravel()
        d = f_d.ravel()
        ok = v >= 0
        u, v, d = u[ok], v[ok], d[ok]
        if len(v) == 0:
            return
        order = np.lexsort((-d, v))
        u, v, d = u[order], v[order], d[order]
        uniq_v, starts, counts = np.unique(v, return_index=True, return_counts=True)
        if level == 0:
            self.tracker.mark_rows("adj0", uniq_v)
        else:
            self.tracker.mark_rows("up", self.up_slot_host[uniq_v])
        col = np.arange(len(v)) - np.repeat(starts, counts)
        grp = np.repeat(np.arange(len(uniq_v)), counts)
        # each target keeps its m_l best incoming edges
        keep = col < m_l
        g = 1 << int(np.ceil(np.log2(min(max(int(counts.max()), 4), m_l))))
        t_block = 16384
        dev = self.store.device
        for base in range(0, len(uniq_v), t_block):
            hi = min(base + t_block, len(uniq_v))
            nblk = hi - base
            sel = keep & (grp >= base) & (grp < hi)
            inc_ids = np.full((nblk, g), -1, np.int64)
            inc_d = np.full((nblk, g), np.float32(NEG_INF))
            inc_ids[grp[sel] - base, col[sel]] = u[sel]
            inc_d[grp[sel] - base, col[sel]] = d[sel]
            blk_v = uniq_v[base:hi].astype(np.int64)
            inc_ids_t = torch.as_tensor(inc_ids, device=dev)
            inc_d_t = torch.as_tensor(inc_d, device=dev)
            if level == 0:
                HK.merge_neighbors(self.adj0, self.adj0_d, torch.as_tensor(blk_v, device=dev), inc_ids_t, inc_d_t,
                                   m_l, dedup=dedup)
            else:
                rows = self.up_slot_host[blk_v].astype(np.int64)
                _merge_neighbors_3d(self.up_adj, self.up_d, torch.as_tensor(rows, device=dev), level - 1,
                                    inc_ids_t, inc_d_t, m_l, dedup=dedup)

    # ---------------------------------------------------------------- search

    def search(
        self, queries, top_k: int = 10, ef: int | None = None, rerank: bool = True, rerank_keep: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ANN search. Returns host (ids (B, k), scores (B, k)); id -1 pads."""
        if self.store.codes_on_host and self.graph_on_spill:
            return self._search_graph_hostcodes(queries, top_k, ef, rerank)
        if self.scan_only:
            return self.search_brute(queries, top_k, rerank=rerank)
        host_rerank = rerank and self.store.raw_on_host
        if host_rerank:
            # the device returns the whole shortlist in quantized order; the
            # exact rerank runs against the host raw rows
            ef_eff = max(int(ef or self.params.ef_search), top_k)
            keep = min(max(rerank_keep or 5 * top_k, top_k), ef_eff)
            out = self.search_device(queries, keep, ef, rerank=False, rerank_keep=keep)
        else:
            out = self.search_device(queries, top_k, ef, rerank, rerank_keep)
        if out is None:
            return _empty_result(queries, top_k)
        ids, scores = out
        ids = ids.cpu().numpy().astype(np.int64)
        if host_rerank:
            return self.store.rerank_host_topk(queries, ids, top_k)
        return ids, scores.cpu().numpy()

    def search_device(
        self, queries, top_k: int = 10, ef: int | None = None, rerank: bool = True, rerank_keep: int | None = None
    ):
        """Like :meth:`search` but returns device tensors, or None for an
        empty index: beam search with ``ef`` (default ef_search), keep
        ``rerank_keep`` candidates (default 5*k), exact f32 rerank, top-k."""
        store = self.store
        queries = as_rows(queries, store.device)
        b = queries.shape[0]
        if self.n == 0 or self.entry < 0:
            return None
        p = self.params
        ef = max(int(ef or p.ef_search), top_k)
        # wide beams converge in fewer, wider waves
        expand = max(p.expand, ef // 64)
        vcap = max(p.visited_cap, 512 * expand)
        keep = min(max(rerank_keep or 5 * top_k, top_k), ef)
        do_rerank = bool(rerank and store.keep_raw is True)
        return _fused_search(
            store.metric, self._kind(), store.dim_pad, store.dim, store.resolution, ef, p.ef_upper, expand, vcap,
            p.max_iters, keep, top_k, do_rerank, store.range[0], store.range[1], store.ship_queries(queries),
            store.arrays, store.raw, self.adj0, self.up_adj, self.up_slot, self.alive, self.entry,
            self._active_upper_levels(),
            # the reference pads the batch to a power of two >= 8 and picks
            # the visited set from the padded size
            visited_impl=_visited_impl(max(8, _next_pow2(b)), self.up_slot.shape[0]),
        )

    def delete(self, internal_id: int) -> None:
        if self._alive_host is not None:
            self._alive_host[int(internal_id)] = False
        else:
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
        """Exact masked scan + exact rerank; host (ids, scores), -1 padded.
        Spilled codes take the streamed scan; host or disk raw rows rerank
        a deeper shortlist on the host side."""
        if self.store.codes_on_host:
            return self._search_streamed(queries, top_k, mask, rerank)
        host_rerank = rerank and self.store.raw_on_host
        fetch = self._host_fetch(top_k) if host_rerank else top_k
        out = self.search_brute_device(queries, fetch, mask, rerank)
        if out is None:
            return _empty_result(queries, top_k)
        ids, vals = out
        ids = ids.cpu().numpy().astype(np.int64)
        if host_rerank:
            return self.store.rerank_host_topk(queries, ids, top_k)
        return ids, vals.cpu().numpy()

    def _host_fetch(self, top_k: int) -> int:
        """Shortlist depth for a host rerank: never fewer than top_k columns
        (the scan pads with -1 past n), else the coarse-code ladder's."""
        return max(min(self._rerank_factor() * top_k, max(self.n, 1)), top_k)

    def _search_streamed(self, queries, top_k: int, mask: np.ndarray | None, rerank: bool):
        """The exact scan of spilled codes (``streamed_flat_topk``), reranked
        against the host raw rows when there are any."""
        store = self.store
        queries = as_rows(queries, store.device)
        if self.n == 0:
            return _empty_result(queries, top_k)
        valid = np.zeros(store.capacity, bool)
        valid[: self.n] = True
        if self._alive_host is not None:
            valid &= self._alive_host[: store.capacity]
        if mask is not None:
            m = np.zeros(store.capacity, bool)
            m[: len(mask)] = mask
            valid &= m
        host_rerank = rerank and store.raw_on_host
        fetch = self._host_fetch(top_k) if host_rerank else top_k
        top_s, top_i = streamed_flat_topk(
            store.metric, store, queries, fetch, torch.from_numpy(valid).to(store.device)
        )
        ids, vals = top_i.cpu().numpy().astype(np.int64), top_s.cpu().numpy()
        if host_rerank:
            return store.rerank_host_topk(queries, ids, top_k)
        return ids[:, :top_k], vals[:, :top_k]

    def force_spill(self, keep_graph: bool = False) -> None:
        """Move the codes to the host tier on demand (growth past the budget
        spills by itself). ``keep_graph=True`` keeps a u8 graph's level-0
        adjacency on the device and serves graph searches by host-gathered
        beam waves (:meth:`_search_graph_hostcodes`); the edge scores and
        upper levels are freed, and a later ``add`` turns the index
        scan-only. Otherwise the index turns scan-only at once."""
        if self.store.codes_on_host:
            return
        if not self.store._spillable():
            raise RuntimeError("store is not spillable (device-raw keeps rows in HBM)")
        if not keep_graph or self.level_counts[0] == 0 or self.store.kind != "u8" or self.scan_only:
            self.store._move_codes(host=True)
            self._maybe_spill_to_scan_only()
            return
        self.store._move_codes(host=True)
        self.graph_on_spill = True
        self._alive_to_host()
        self._drop_graph(keep_adj0=True)

    #: beam entries expanded per wave by the host-codes engine: each wave
    #: costs a host round trip, so fewer, wider waves
    HOSTCODES_EXPAND = 8
    #: random alive entry seeds, standing in for the freed upper levels
    HOSTCODES_SEEDS = 32

    def _host_rows_chunk(self, ids_mat: np.ndarray, alive: np.ndarray):
        """The unique alive rows of an id matrix from the spilled codes, on
        the device (gathered into the store's pinned staging buffer), and
        each id's row in them (-1 for none). Returns (chunk, slots, rows)."""
        store = self.store
        a = store.arrays
        flat = ids_mat.reshape(-1)
        ok = flat >= 0
        ok[ok] = alive[flat[ok]]
        uniq, inv = np.unique(flat[ok], return_inverse=True)
        # one row at least, so the clamped gather of dead slots stays in range
        gather = torch.from_numpy(uniq if len(uniq) else np.zeros(1, np.int64))
        data, sums, mags = store.upload_rows([a.data, a.sums, a.mags], gather)
        slots = np.full(ids_mat.shape, -1, np.int64)
        slots.reshape(-1)[ok] = inv
        chunk = a._replace(data=data, sums=sums, mags=mags)
        return chunk, torch.from_numpy(slots).to(store.device), len(uniq)

    def _search_graph_hostcodes(self, queries, top_k: int, ef: int | None, rerank: bool):
        """Graph search of a kept-graph spilled index: the level-0 adjacency
        is on the device, the codes on the host. The beam starts from the
        entry and HOSTCODES_SEEDS - 1 random alive rows (the reference's
        generator and seed, so the seeds are the reference's); each wave
        selects its fresh candidates on the device, downloads their ids,
        gathers their unique rows on the host, uploads them and merges
        their scores on the device. Reranks against the host raw rows."""
        store = self.store
        queries = as_rows(queries, store.device)
        b = queries.shape[0]
        if self.n == 0 or self.entry < 0:
            return _empty_result(queries, top_k)
        alive = self._alive_host
        ef_eff = max(int(ef or self.params.ef_search), top_k)
        q = store.ship_query_codes(queries)
        rng = np.random.default_rng(0xC05DA7A)
        cand = np.flatnonzero(alive[: self.n])
        if not len(cand):
            return _empty_result(queries, top_k)
        n_seed = min(self.HOSTCODES_SEEDS - 1, len(cand))
        seeds = rng.choice(cand, size=n_seed, replace=False)
        start = np.full((b, n_seed + 1), -1, np.int64)
        start[:, 0] = self.entry if alive[self.entry] else int(seeds[0])
        start[:, 1:] = seeds[None, :]
        chunk, slots, rows = self._host_rows_chunk(start, alive)
        row_bytes = store.dim_pad + 8
        stats = {"waves": 0, "rows": rows, "bytes": rows * row_bytes}
        ids, scores, expanded, visited = HK.beam_hostcodes_init(
            store.metric, store.dim_pad, ef_eff, -(-self.cap // 32), q, chunk, slots,
            torch.from_numpy(start).to(store.device),
        )
        for _ in range(self.params.max_iters):
            nbrs, expanded, visited, done = HK.beam_wave_select(
                ids, scores, expanded, visited, self.adj0, self.HOSTCODES_EXPAND
            )
            if bool(done):
                break
            # the download syncs the stream, so the last wave's upload from
            # the staging buffer is done before it is refilled
            nbrs_np = nbrs.cpu().numpy()
            chunk, slots, rows = self._host_rows_chunk(nbrs_np, alive)
            stats["waves"] += 1
            stats["rows"] += rows
            stats["bytes"] += rows * row_bytes
            ids, scores, expanded = HK.beam_wave_merge(
                store.metric, store.dim_pad, q, chunk, slots, nbrs, ids, scores, expanded
            )
        self.last_hostcodes_stats = stats
        sc = scores.cpu().numpy()
        ids = np.where(sc > NEG_INF / 2, ids.cpu().numpy(), -1)
        if rerank and store.raw_on_host:
            keep = min(5 * top_k, ef_eff)
            return store.rerank_host_topk(queries, ids[:, :keep], top_k)
        return ids[:, :top_k], sc[:, :top_k]

    def maybe_promote(self) -> bool:
        """Move spilled codes back to the device once they fit (the store
        decides). The tombstones return to the device; a kept graph lost its
        edge scores and upper levels, so the index serves by the scan
        (scan-only) until a compaction rebuilds it."""
        if not self.store.codes_on_host or not self.store.maybe_promote_codes():
            return False
        if self._alive_host is not None:
            alive = np.ones(self.store.capacity, bool)
            alive[: len(self._alive_host)] = self._alive_host[: self.store.capacity]
            self.alive = torch.from_numpy(alive).to(self.store.device)
            self._alive_host = None
        if self.graph_on_spill:
            self.graph_on_spill = False
            self._drop_graph()
        self._sync_capacity()
        return True

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
        do_rerank = bool(rerank and store.keep_raw is True)
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
        vals, ids = topk(store.scores_all(q), keep, mask=self._valid(mask)[None, :],
                         ties_by_index=store.metric == "hamming")
        if do_rerank:
            re = store.rerank_scores(queries, ids)
            vals = torch.where(vals > NEG_INF / 2, re, NEG_INF)
            vals, pos = torch.topk(vals, top_k, dim=1)
            ids = torch.gather(ids, 1, pos)
        else:
            vals, ids = vals[:, :top_k], ids[:, :top_k]
        ids = torch.where(vals > NEG_INF / 2, ids, -1)
        return ids, vals
