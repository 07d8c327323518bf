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

Not ported: the spill tier's graph code (``force_spill``,
``maybe_promote``, the streamed scan and the host-codes graph search,
ROADMAP queue 1: spill tiers), the per-level compiled split programs, the
cache of small search constants, the power-of-two batch padding (the
visited set is still chosen from the padded batch size, as the
reference chooses it) and the build log; ``last_build_stats`` stays.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cosdata_tpu_torch.indexes.flat import GROUP, k_bins_for
from cosdata_tpu_torch.ops import hnsw_kernels as HK
from cosdata_tpu_torch.ops.flat_scan import fused_flat_search, fused_flat_search_codes, flat_scan_topk
from cosdata_tpu_torch.ops.storage import VectorStore, as_rows, gather_queries, quantize_batch, rerank
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k, topk, unique_mask_ids
from cosdata_tpu_torch.store.chunked import DirtyTracker

_SPILL = "spilled HNSW indexes are not ported yet (ROADMAP queue 1: spill tiers)"


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
        #: the index holds no graph (loaded from a scan-only snapshot): rows
        #: are appended without graph work and every search takes the scan
        self.scan_only = False

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
                  range_=store.range, params=params, keep_raw=store.keep_raw, seed=seed, initial_capacity=1)
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
        index keeps no adjacency)."""
        cap = self.store.capacity
        pad = torch.nn.functional.pad
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
        if self.scan_only:
            ids = self.store.add(x)
            self._sync_capacity()
            self.level_counts[0] += len(ids)
            if self.entry < 0 and len(ids):
                self.entry, self.entry_level = int(ids[0]), 0
            return ids
        if self.n == 0 and len(x) >= self.BULK_THRESHOLD:
            return self.bulk_build(x)
        out = [self._add_wave(x[i : i + self.params.wave_size]) for i in range(0, len(x), self.params.wave_size)]
        return np.concatenate(out) if out else np.empty((0,), np.int64)

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
        if store.keep_raw:
            base = store.raw
        elif store.kind == "u8":
            base = store.arrays.data
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
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        proj = base[sel].to(torch.float32) @ torch.as_tensor(rot, device=dev)
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
        # upper levels are navigation-only: one tree suffices; level 0 with
        # no NN-descent needs the second tree to bridge leaf islands
        trees = self.RP_TREES if (n_mem > self.RP_LEAF and level == 0) else 1
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
        else:
            slots_pad = np.full(mp, -1, np.int64)
            slots_pad[:n_mem] = self.up_slot_host[members]
            HK.upper_level_apply(
                m_l, mem_dev, torch.as_tensor(slots_pad, device=dev), self.up_slot, fwd_ids, fwd_d,
                self.up_adj[:, level - 1], self.up_d[:, level - 1],
            )

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
        if self.scan_only:
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
        if self.scan_only:
            return self.search_brute(queries, top_k, rerank=rerank)
        out = self.search_device(queries, top_k, ef, rerank, rerank_keep)
        if out is None:
            b = as_rows(queries, "cpu").shape[0]
            return np.full((b, top_k), -1, np.int64), np.full((b, top_k), -np.inf, np.float32)
        ids, scores = out
        return ids.cpu().numpy().astype(np.int64), scores.cpu().numpy()

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
        do_rerank = bool(rerank and store.keep_raw)
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
        self.alive[int(internal_id)] = False
        self.n_deleted += 1

    def _rerank_factor(self) -> int:
        """Exact-rerank shortlist depth as a multiple of top_k: 1-2 bit codes
        order so noisily that the true top-k routinely sits outside a 5x
        shortlist, so they take 20x."""
        if self.store.kind == "subbyte" and self.store.resolution <= 2:
            return 20
        return 5

    def force_spill(self, keep_graph: bool = False) -> None:
        raise NotImplementedError(_SPILL)

    def maybe_promote(self) -> bool:
        raise NotImplementedError(_SPILL)

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
