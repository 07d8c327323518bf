"""Sparse (SPLADE-style) inverted index.

Port of ``cosdata_tpu/indexes/inverted.py``: the reference's power-of-4
trie of per-dimension quantized posting lists (upstream
src/models/inverted_index.rs:39-367, src/indexes/inverted/mod.rs) as flat
host CSR arrays plus scoring on the device:

- postings live in one flat array sorted by (dim asc, quantized bucket
  **desc**), so the early-termination rule (low-valued query dims only
  scan the top buckets, sparse_ann_query.rs:89-126) is a prefix slice of
  the dim's range;
- ingest appends numpy buffers; the CSR folds pending postings in with
  one stable sort + a two-run merge at flush or search time;
- value quantization: ``clamp((v / upper_bound) * maxval, 0, maxval)``
  truncated (inverted_index.rs:168-172); the upper bound is tuned from a
  sample (inverted/mod.rs:194-247);
- with raw rows kept (the default), candidates nominated from budgeted
  posting prefixes (and, at scale, from a dense u8 head matrix of the
  high-df dims) are scored exactly from their raw rows; without them,
  quantized scores by sort + segment-sum or scatter-add;
- deletes are tombstones; dead postings are compacted out at flush.

The host parts (sampling, CSR build/fold/compaction, the scan-budget
allocator, dedup) are the reference's numpy code. Every device tensor
lives on the index's explicit ``device``. Changed from the reference: the
environment switches ``COSDATA_SPARSE_EXHAUSTIVE`` and ``COSDATA_SPARSE_NOM``
are the class attributes ``EXHAUSTIVE`` and ``NOM``; query batches are not
padded to a power of two (that served only XLA's compile cache); scoring
without raw rows takes the segment route wherever the gathered width is at
most 65,536 (the reference's off-TPU rule); the test-only helpers
``_impact_alloc``, ``_query_segments`` and the unused ``_rerank`` are not
ported.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from cosdata_tpu_torch.ops import sparse_kernels as SK
from cosdata_tpu_torch.store.chunked import DirtyTracker

_PAD_MIN = 256

#: query-batch chunk for the segment-sum route (bounds the (B, PAD) sort)
SEG_QUERY_CHUNK = 256

#: below this capacity the nominate engine has no dense head to back it up
#: (HEAD_MIN_CAP) and the exhaustive rescore is cheap, so small corpora
#: route to it
EXHAUSTIVE_MAX_CAP = 32768


def _next_pow2(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


def _dev(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def tune_upper_bound(values: np.ndarray, clamp_margin_percent: float = 1.0) -> float:
    """Smallest bound in 1..10 with <= margin%% of sampled values above it
    (inverted/mod.rs:194-247)."""
    values = np.asarray(values, np.float32)
    n = max(values.size, 1)
    for bound in range(1, 10):
        above = float((values > bound).sum()) / n * 100.0
        if above <= clamp_margin_percent:
            return float(bound)
    return 10.0


def impact_segments_batch(
    b: int,
    qi: np.ndarray,  # (P,) int64 query index per pair, sorted ascending
    list_start: np.ndarray,  # (P,) int64 posting offset of each pair's list
    weights: np.ndarray,  # (P,) f32 impact weight == emission multiplier
    caps: np.ndarray,  # (P,) int64 max postings takeable from this pair
    cnt: np.ndarray,  # (L, NB+2) int32 cum table: cnt[l, t] = #vals bucket>=t
    cidx: np.ndarray,  # (P,) int64 row of each pair in `cnt`
    units: np.ndarray,  # (P,) f32 value width of one bucket (sparse: 1.0)
    nb: int,
    budget: int,
    segcap: int,
    conservative: bool,  # True: ceil (exact for integer values);
    #                      False: floor+1 (strict undercount, float values)
    pad_min: int = 16,
):
    """Impact-threshold scan-budget allocation + segment emission for a
    whole query batch, vectorized.

    Keeps postings with impact ``weight_i * value >= T`` where T is
    bisected per query to the largest budget-feasible threshold (the
    early-termination principle of sparse_ann_query.rs:89-126 made exact).
    Per-list cut counts come from precomputed per-list cumulative
    bucket-count tables, so each bisection step is one gather + one
    bincount over all (query, list) pairs. Leftover budget is spent
    greedily in pair order (pairs arrive best-weight-first per query).

    Returns (starts, lens, mults) as (B, maxd) arrays, -1/-0 padded.
    """
    P = len(qi)
    maxd0 = max(pad_min, 1)
    if P == 0:
        return (
            np.full((b, maxd0), -1, np.int32),
            np.zeros((b, maxd0), np.int32),
            np.zeros((b, maxd0), np.float32),
        )
    caps = caps.astype(np.int64)
    w = np.maximum(weights.astype(np.float64), 1e-30)
    units64 = np.maximum(units.astype(np.float64), 1e-30)
    # bisect T per query: feasible(T) = total cut postings <= budget,
    # monotone in T; the smallest feasible T keeps the most postings
    lo = np.zeros(b, np.float64)
    hi = np.full(b, float(np.max(w * units64 * nb)) + 1.0, np.float64)
    alloc = np.zeros(P, np.int64)  # cut at T=hi is 0: always feasible
    rows = cnt[cidx]  # (P, NB+2) gathered once
    for _ in range(36):
        mid = 0.5 * (lo + hi)
        x = mid[qi] / w / units64  # threshold in bucket units
        if conservative:
            t_idx = np.ceil(x)
        else:
            t_idx = np.floor(x) + 1.0
        t_idx = np.clip(t_idx, 0, nb + 1).astype(np.int64)
        cut = np.minimum(rows[np.arange(P), t_idx], caps)
        tot = np.bincount(qi, weights=cut, minlength=b)
        feas = tot <= budget
        fp = feas[qi]
        alloc = np.where(fp, cut, alloc)
        hi = np.where(feas, mid, hi)
        lo = np.where(feas, lo, mid)
    # spend leftover budget greedily in pair order (structural guarantee:
    # sum(alloc) <= budget per query both before and after the fill)
    room = caps - alloc
    cum_prev = np.cumsum(room) - room  # exclusive prefix over ALL pairs
    qstart = np.searchsorted(qi, np.arange(b))
    base = np.concatenate([cum_prev, [0]])[np.minimum(qstart, P - 1)]
    prev_in_q = cum_prev - base[qi]
    rem = budget - np.bincount(qi, weights=alloc, minlength=b)
    extra = np.clip(rem[qi] - prev_in_q, 0, room).astype(np.int64)
    alloc = alloc + extra
    # ---- segment emission (segcap-wide slices of each kept prefix) ----
    nseg = -(-alloc // segcap)
    per_q = np.bincount(qi, weights=nseg, minlength=b).astype(np.int64)
    maxd = max(pad_min, _next_pow2(int(per_q.max()) if len(per_q) else 1))
    total_segs = int(nseg.sum())
    starts_out = np.full((b, maxd), -1, np.int32)
    lens_out = np.zeros((b, maxd), np.int32)
    mults_out = np.zeros((b, maxd), np.float32)
    if total_segs == 0:
        return starts_out, lens_out, mults_out
    pair_idx = np.repeat(np.arange(P), nseg)
    within = np.arange(total_segs) - np.repeat(np.cumsum(nseg) - nseg, nseg)
    qi_seg = qi[pair_idx]
    qseg_first = np.searchsorted(qi_seg, np.arange(b))
    col = np.arange(total_segs) - qseg_first[qi_seg]
    starts_out[qi_seg, col] = (
        list_start[pair_idx] + within * segcap
    ).astype(np.int32)
    lens_out[qi_seg, col] = np.minimum(
        segcap, alloc[pair_idx] - within * segcap
    ).astype(np.int32)
    mults_out[qi_seg, col] = weights[pair_idx].astype(np.float32)
    return starts_out, lens_out, mults_out


def rescore_dispatch(
    starts, lens, csr_ids, doc_dims_dev, doc_vals_dev, q_idx, q_w,
    alive_dev, top_k: int, segcap: int, dup_slack: int,
    n_cap: int, mults=None, csr_vals=None, aligned: bool = False,
    exhaustive: bool = False, nom: int = 0,
):
    """Query-chunked dispatch of the candidate nominate + rescore function
    and the host duplicate collapse.

    Default engine: contribution nomination + exact rescore of the `nom`
    winners only (``nominate_rescore_topk``). The rescore-every-slot
    function (``candidates_rescore_topk``) serves ``exhaustive=True``,
    calls without mults/csr_vals, and capacities below EXHAUSTIVE_MAX_CAP.
    ``nom`` (0 = derived from top_k) is the nomination width."""
    dev = csr_ids.device
    b = len(starts)
    fetch = min(top_k * dup_slack, n_cap)
    r = doc_dims_dev.shape[1]
    maxd = starts.shape[1]
    exhaustive = (
        exhaustive
        or mults is None
        or csr_vals is None
        # below the dense-head gate nothing restores accumulation recall,
        # and the exhaustive rescore is cheap at this scale
        or n_cap < EXHAUSTIVE_MAX_CAP
    )
    # nomination width: every duplicate nomination (one doc hit by several
    # query dims) burns a slot, so scale nom with fetch (4x) with a 512
    # floor; the final host dedup collapses the duplicates
    nom = nom or min(max(4 * fetch, 512), n_cap)
    # bound BOTH workspaces: the (chunk_q, maxd*segcap) candidate-id
    # expansion and the (chunk_q, cand_chunk, R) gather blocks
    chunk_q = min(SEG_QUERY_CHUNK, b)
    while chunk_q > 1 and chunk_q * maxd * segcap > (1 << 25):
        chunk_q //= 2
    gather_w = nom if not exhaustive else 16384
    while chunk_q > 8 and chunk_q * gather_w * r > (1 << 27):
        chunk_q //= 2
    cand_chunk = max(2048, min(16384, (1 << 27) // max(chunk_q * r, 1)))
    outs = []
    for s in range(0, b, chunk_q):
        e = s + chunk_q
        st, ln = _dev(starts[s:e], dev), _dev(lens[s:e], dev)
        qi, qw = _dev(q_idx[s:e], dev), _dev(q_w[s:e], dev)
        if exhaustive:
            outs.append(SK.candidates_rescore_topk(
                st, ln, csr_ids, doc_dims_dev, doc_vals_dev, qi, qw,
                alive_dev, fetch, segcap, cand_chunk, aligned=aligned,
            ))
        else:
            outs.append(SK.nominate_rescore_topk(
                st, ln, _dev(mults[s:e], dev), csr_ids, csr_vals,
                doc_dims_dev, doc_vals_dev, qi, qw, alive_dev,
                fetch, nom, segcap, 1 << 16, aligned=aligned,
            ))
    scores = torch.cat([o[0] for o in outs]).cpu().numpy()
    ids = torch.cat([o[1] for o in outs]).cpu().numpy()
    return _dedup_topk(ids, scores, top_k)


def _dedup_topk(ids: np.ndarray, scores: np.ndarray, top_k: int):
    """Collapse duplicate ids per row (identical exact scores from multi-
    dim nomination), keep rank order, return (ids, scores) at top_k.
    Sort-based, O(b·k log k)."""
    b, kk = ids.shape
    rank = np.broadcast_to(np.arange(kk, dtype=np.int64), (b, kk))
    # sort by (id, rank): duplicates become adjacent, first occurrence first
    order_id = np.argsort(ids * np.int64(kk + 1) + rank, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, order_id, axis=1)
    dup_s = np.zeros((b, kk), bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    keep = np.ones((b, kk), bool)
    np.put_along_axis(keep, order_id, ~dup_s, axis=1)
    order = np.argsort(~keep, axis=1, kind="stable")[:, :top_k]
    out_i = np.take_along_axis(ids, order, axis=1)
    out_s = np.take_along_axis(scores, order, axis=1)
    kept = np.take_along_axis(keep, order, axis=1)
    out_i = np.where(kept, out_i, -1)
    out_s = np.where(kept & (out_i >= 0), out_s, 0.0).astype(np.float32)
    if out_i.shape[1] < top_k:
        out_i = np.pad(out_i, ((0, 0), (0, top_k - out_i.shape[1])), constant_values=-1)
        out_s = np.pad(out_s, ((0, 0), (0, top_k - out_s.shape[1])))
    return out_i, out_s


def _merge_sorted(a_keys, a_vals: list, b_keys, b_vals: list):
    """Merge two key-sorted runs (stable: a before b on ties). Returns
    (keys, [vals...]) — O(n) placement + one searchsorted."""
    na, nb = len(a_keys), len(b_keys)
    if na == 0:
        return b_keys, b_vals
    if nb == 0:
        return a_keys, a_vals
    pos_a = np.arange(na) + np.searchsorted(b_keys, a_keys, side="left")
    pos_b = np.arange(nb) + np.searchsorted(a_keys, b_keys, side="right")
    out_keys = np.empty(na + nb, a_keys.dtype)
    out_keys[pos_a] = a_keys
    out_keys[pos_b] = b_keys
    outs = []
    for av, bv in zip(a_vals, b_vals):
        o = np.empty(na + nb, av.dtype)
        o[pos_a] = av
        o[pos_b] = bv
        outs.append(o)
    return out_keys, outs


class InvertedIndex:
    """Sparse index over (dim u32, value f32) pairs keyed by internal id,
    scored on ``device``."""

    COMPACT_THRESHOLD = 0.25
    #: rescore every budgeted posting slot instead of nominating (the
    #: reference's COSDATA_SPARSE_EXHAUSTIVE=1; the recall oracle sets it)
    EXHAUSTIVE = False
    #: nomination width of the rescore dispatch (the reference's
    #: COSDATA_SPARSE_NOM); 0 derives it from top_k
    NOM = 0

    def __init__(
        self,
        device,
        quantization: int = 64,  # 16|32|64|128|256 -> 4..8 bits (dtos.rs:98-128)
        sample_threshold: int = 1000,
        early_terminate_threshold: float = 0.0,  # config.toml:33
        clamp_margin_percent: float = 1.0,
        values_upper_bound: float | None = None,  # fixed -> skips sampling
        keep_raw: bool = True,
        scan_budget: int | None = None,
        scan_budget_total: int | None = None,
    ):
        if quantization not in (16, 32, 64, 128, 256):
            raise ValueError("quantization must be one of 16/32/64/128/256")
        self.device = torch.device(device)
        self.bits = int(math.log2(quantization))
        self.maxval = (1 << self.bits) - 1
        self.sample_threshold = sample_threshold
        self.early_terminate_threshold = early_terminate_threshold
        self.clamp_margin_percent = clamp_margin_percent
        self.keep_raw = keep_raw
        self.is_configured = values_upper_bound is not None
        self.values_upper_bound = float(values_upper_bound or 1.0)
        self._sample: list[tuple[int, np.ndarray, np.ndarray]] = []
        #: guards the pending buffers AND the dirty flag: ingest appends
        #: under the collection lock while searches fold under the engine
        #: dispatch lock. RLock: _build_csr holds it across fold + upload +
        #: flag clear.
        self._pend_lock = threading.RLock()
        # pending ingest buffers (vectorized; folded into the CSR at build)
        self._pend_docs: list[np.ndarray] = []
        self._pend_dims: list[np.ndarray] = []
        self._pend_buckets: list[np.ndarray] = []
        # host CSR sorted by key = dim*256 + (255 - bucket)
        self._h_keys = np.zeros(0, np.int64)
        self._h_ids = np.zeros(0, np.int32)
        self._h_buckets = np.zeros(0, np.int32)
        self._csr_range: dict[int, tuple[int, int]] = {}
        self.n_cap = 1024
        self._alive = np.ones(self.n_cap, bool)
        self._has_doc = np.zeros(self.n_cap, bool)
        self._alive_dev = None
        self.n = 0  # max internal id + 1 seen
        self.n_docs = 0
        self.live_docs = 0
        # raw pairs for the exact rescore, padded (n_cap, max_nnz)
        self._raw_nnz = np.zeros(self.n_cap, np.int32)
        self._raw_max = 16
        self._raw_dims = np.zeros((self.n_cap, self._raw_max), np.int64)
        self._raw_vals = np.zeros((self.n_cap, self._raw_max), np.float32)
        # device CSR mirrors (built lazily at search/flush time)
        self._csr_dirty = True
        self._csr_ids = None  # (P,) int32 device
        self._csr_vals = None  # (P,) f32 device (bucket values)
        self._csr_aligned = False
        self._dim_start_dev = None
        #: dirty epochs: "raw" = per-doc raw rows, "csr" = flat CSR arrays
        self.tracker = DirtyTracker()
        #: per-(query, dim) device gather segment width
        self.SEGCAP = 512
        # operator-pinned budgets: pinning scan_budget == scan_budget_total
        # makes served results independent of dispatch batch size
        if scan_budget is not None:
            self.SCAN_BUDGET = int(scan_budget)
        if scan_budget_total is not None:
            self.SCAN_BUDGET_TOTAL = int(scan_budget_total)
        # vectorized allocator tables (filled by _rebuild_ranges)
        self._dim_uniq = np.zeros(0, np.int64)
        self._dim_start = np.zeros(0, np.int64)
        self._dim_len = np.zeros(0, np.int64)
        self._dim_cnt = np.zeros((0, self.maxval + 2), np.int32)
        # dense-head engine state (filled by _rebuild_ranges/_ensure_head)
        self._head_col = np.zeros(0, np.int32)
        self._head_didx = np.zeros(0, np.int64)
        self._head_codes_dev = None
        self._head_scale = None
        self._head_gen = None
        self._doc_rows_gen = None

    # ----------------------------------------------------------------- write

    def quantize(self, v: np.ndarray) -> np.ndarray:
        """inverted_index.rs:168-172 (truncating cast, clamped)."""
        q = np.clip((v / self.values_upper_bound) * self.maxval, 0.0, self.maxval)
        return np.minimum(q.astype(np.int32), self.maxval)

    def add(self, internal_id: int, dims: np.ndarray, values: np.ndarray) -> None:
        dims = np.asarray(dims, np.int64)
        values = np.asarray(values, np.float32)
        if not self.is_configured:
            self._sample.append((internal_id, dims, values))
            if len(self._sample) >= self.sample_threshold:
                self._finalize_sampling()
            return
        self._insert(internal_id, dims, values)

    def add_batch(
        self,
        internal_ids: np.ndarray,
        flat_dims: np.ndarray,
        flat_values: np.ndarray,
        nnz: np.ndarray,
    ) -> None:
        """Vectorized bulk ingest: ``flat_dims/values`` are the concatenated
        per-doc pairs, ``nnz[i]`` the count of doc ``internal_ids[i]``. One
        quantize + one buffer append for the whole batch."""
        internal_ids = np.asarray(internal_ids, np.int64)
        flat_dims = np.asarray(flat_dims, np.int64)
        flat_values = np.asarray(flat_values, np.float32)
        nnz = np.asarray(nnz, np.int64)
        if not self.is_configured:
            off = 0
            for i, c in zip(internal_ids, nnz):
                self.add(int(i), flat_dims[off : off + c], flat_values[off : off + c])
                off += c
            return
        doc_of = np.repeat(internal_ids, nnz).astype(np.int32)
        q = self.quantize(flat_values)
        with self._pend_lock:
            self._pend_docs.append(doc_of)
            self._pend_dims.append(flat_dims)
            self._pend_buckets.append(q.astype(np.int32))
            self._csr_dirty = True
        hi = int(internal_ids.max()) if len(internal_ids) else -1
        if hi >= self.n:
            self.n = hi + 1
        if hi >= self.n_cap:
            self._grow_cap(hi + 1)
        if self.keep_raw:
            max_nnz = int(nnz.max()) if len(nnz) else 0
            if max_nnz > self._raw_max:
                new_max = _next_pow2(max_nnz)
                self._raw_dims = np.pad(
                    self._raw_dims, ((0, 0), (0, new_max - self._raw_max))
                )
                self._raw_vals = np.pad(
                    self._raw_vals, ((0, 0), (0, new_max - self._raw_max))
                )
                self._raw_max = new_max
            # padded (B, raw_max) rows, dim-sorted per row (pad key = +inf)
            bsz = len(internal_ids)
            dpad = np.full((bsz, self._raw_max), np.iinfo(np.int64).max, np.int64)
            vpad = np.zeros((bsz, self._raw_max), np.float32)
            rows = np.repeat(np.arange(bsz), nnz)
            offs = np.concatenate([[0], np.cumsum(nnz)[:-1]])
            cols = np.arange(len(flat_dims)) - np.repeat(offs, nnz)
            dpad[rows, cols] = flat_dims
            vpad[rows, cols] = flat_values
            order = np.argsort(dpad, axis=1, kind="stable")
            dpad = np.take_along_axis(dpad, order, axis=1)
            vpad = np.take_along_axis(vpad, order, axis=1)
            dpad[dpad == np.iinfo(np.int64).max] = 0
            self._raw_nnz[internal_ids] = nnz
            self._raw_dims[internal_ids] = dpad
            self._raw_vals[internal_ids] = vpad
            self.tracker.bump()
            self.tracker.mark_rows("raw", internal_ids)
        # count UNIQUE ids: a duplicate id in one batch would be counted
        # twice, skewing the live/total ratio compaction keys on
        uniq = np.unique(internal_ids)
        new_doc = ~self._has_doc[uniq]
        revived = (~new_doc) & (~self._alive[uniq])
        self.n_docs += int(new_doc.sum())
        self.live_docs += int(new_doc.sum() + revived.sum())
        self._has_doc[uniq] = True
        self._alive[uniq] = True
        self._alive_dev = None

    def _finalize_sampling(self):
        if not self._sample:
            # nothing sampled yet: do NOT lock in the default upper bound —
            # a warm-up search or a sparse-less commit before the first
            # sparse upsert would otherwise disable auto-tuning for good
            return
        all_vals = np.concatenate([v for _, _, v in self._sample])
        self.values_upper_bound = tune_upper_bound(all_vals, self.clamp_margin_percent)
        self.is_configured = True
        pending, self._sample = self._sample, []
        for iid, d, v in pending:
            self._insert(iid, d, v)

    def flush(self):
        """Index whatever is buffered even if the sample threshold wasn't hit
        (the reference configures on pre-commit as well, indexes/mod.rs:85-118),
        and compact tombstoned postings past the threshold."""
        if not self.is_configured:
            self._finalize_sampling()
        self._maybe_compact()

    def _grow_cap(self, need: int):
        new_cap = _next_pow2(need)
        grow = new_cap - self.n_cap
        self._alive = np.concatenate([self._alive, np.ones(grow, bool)])
        self._has_doc = np.concatenate([self._has_doc, np.zeros(grow, bool)])
        self._raw_nnz = np.concatenate([self._raw_nnz, np.zeros(grow, np.int32)])
        self._raw_dims = np.concatenate(
            [self._raw_dims, np.zeros((grow, self._raw_max), np.int64)]
        )
        self._raw_vals = np.concatenate(
            [self._raw_vals, np.zeros((grow, self._raw_max), np.float32)]
        )
        self.n_cap = new_cap
        self._alive_dev = None

    def _insert(self, internal_id: int, dims: np.ndarray, values: np.ndarray):
        internal_id = int(internal_id)
        nnz = len(dims)
        q = self.quantize(values)
        with self._pend_lock:
            self._pend_docs.append(np.full(nnz, internal_id, np.int32))
            self._pend_dims.append(dims.astype(np.int64))
            self._pend_buckets.append(q.astype(np.int32))
            self._csr_dirty = True
        if internal_id >= self.n:
            self.n = internal_id + 1
        if internal_id >= self.n_cap:
            self._grow_cap(internal_id + 1)
        if self.keep_raw:
            if nnz > self._raw_max:
                new_max = _next_pow2(nnz)
                self._raw_dims = np.pad(
                    self._raw_dims, ((0, 0), (0, new_max - self._raw_max))
                )
                self._raw_vals = np.pad(
                    self._raw_vals, ((0, 0), (0, new_max - self._raw_max))
                )
                self._raw_max = new_max
            order = np.argsort(dims, kind="stable")
            self._raw_nnz[internal_id] = nnz
            self._raw_dims[internal_id, :nnz] = dims[order]
            self._raw_vals[internal_id, :nnz] = values[order]
            self.tracker.bump()
            self.tracker.mark_range("raw", internal_id, internal_id + 1)
        if not self._has_doc[internal_id]:
            self._has_doc[internal_id] = True
            self.n_docs += 1
            self.live_docs += 1
        elif not self._alive[internal_id]:
            self.live_docs += 1
        if not self._alive[internal_id]:
            self._alive[internal_id] = True
            self._alive_dev = None

    def raw_pairs(self, internal_id: int) -> list | None:
        """Stored (dim, value) pairs of one live document (GET /vectors/{id})."""
        internal_id = int(internal_id)
        if (
            not self.keep_raw
            or internal_id >= self.n_cap
            or not self._has_doc[internal_id]
            or not self._alive[internal_id]
        ):
            return None
        nnz = int(self._raw_nnz[internal_id])
        if nnz == 0:
            return None
        return [
            [int(d), float(v)]
            for d, v in zip(
                self._raw_dims[internal_id, :nnz],
                self._raw_vals[internal_id, :nnz],
            )
        ]

    def delete(self, internal_id: int) -> None:
        # the doc may still sit in the sampling buffer: purge it there too,
        # or _finalize_sampling would resurrect it as an undeletable ghost
        if self._sample:
            self._sample = [
                rec for rec in self._sample if rec[0] != internal_id
            ]
        if internal_id < self.n_cap:
            if self._has_doc[internal_id] and self._alive[internal_id]:
                self.live_docs -= 1
            self._alive[internal_id] = False
            self._alive_dev = None
            self._raw_nnz[internal_id] = 0

    def _maybe_compact(self):
        """Drop dead documents' postings from the CSR (vectorized filter)."""
        dead = self.n_docs - self.live_docs
        if self.n_docs == 0 or dead / self.n_docs < self.COMPACT_THRESHOLD:
            return
        self._fold_pending()
        keep = self._alive[self._h_ids]
        if not keep.all():
            self._h_keys = self._h_keys[keep]
            self._h_ids = self._h_ids[keep]
            self._h_buckets = self._h_buckets[keep]
            self.tracker.bump()
            self.tracker.mark_all("csr", max(len(self._h_keys), 1))
            self._rebuild_ranges()
            self._csr_ids = None  # force device re-upload
        self.n_docs = self.live_docs

    # ---------------------------------------------------------------- search

    def _fold_pending(self):
        """Merge pending postings into the sorted host CSR: one stable sort
        of the delta + a two-run merge."""
        with self._pend_lock:
            if not self._pend_docs:
                return
            docs = np.concatenate(self._pend_docs)
            dims = np.concatenate(self._pend_dims)
            buckets = np.concatenate(self._pend_buckets)
            self._pend_docs, self._pend_dims, self._pend_buckets = [], [], []
        keys = dims * 256 + (255 - buckets)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        docs = docs[order]
        buckets = buckets[order]
        self._h_keys, (self._h_ids, self._h_buckets) = _merge_sorted(
            self._h_keys, [self._h_ids, self._h_buckets],
            keys, [docs, buckets],
        )
        self.tracker.bump()
        self.tracker.mark_all("csr", len(self._h_keys))
        self._rebuild_ranges()
        self._csr_ids = None

    def _rebuild_ranges(self):
        dims_sorted = self._h_keys >> 8
        uniq, starts, counts = np.unique(
            dims_sorted, return_index=True, return_counts=True
        )
        self._csr_range = {
            int(d): (int(s), int(c)) for d, s, c in zip(uniq, starts, counts)
        }
        # vectorized lookup arrays + per-dim cumulative bucket-count tables
        # (cnt[d, t] = postings of dim d with bucket >= t) for the batch
        # scan-budget allocator
        self._dim_uniq = uniq.astype(np.int64)
        self._dim_start = starts.astype(np.int64)
        self._dim_len = counts.astype(np.int64)
        nb = self.maxval + 1
        d_idx = np.repeat(np.arange(len(uniq), dtype=np.int64), counts)
        hist = np.bincount(
            d_idx * nb + self._h_buckets, minlength=len(uniq) * nb
        ).reshape(len(uniq), nb)
        cum = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
        self._dim_cnt = np.concatenate(
            [cum, np.zeros((len(uniq), 1), cum.dtype)], axis=1
        ).astype(np.int32)
        self._select_head()

    #: dense-head engine knobs. Dims with df >= HEAD_MIN_DF become rows of
    #: a device (Dh, n_cap) u8 matrix scored by one matrix product per
    #: n_cap chunk, every posting of every head dim with no budget. Rare
    #: dims stay in the CSR; their short lists are gathered and rescored
    #: exactly. The head engages once the corpus is big enough for budget
    #: truncation to matter.
    HEAD_MIN_DF = 64
    HEAD_MIN_CAP = 32768
    HEAD_BYTES_MAX = 1 << 30
    HEAD_DH_MAX = 8192

    def _select_head(self):
        """Pick head dims from the df tables (called by _rebuild_ranges)."""
        uniq = self._dim_uniq
        self._head_col = np.full(len(uniq), -1, np.int32)
        self._head_didx = np.zeros(0, np.int64)
        if not self.keep_raw or self.n_cap < self.HEAD_MIN_CAP:
            return
        dh_cap = min(self.HEAD_DH_MAX, self.HEAD_BYTES_MAX // max(self.n_cap, 1))
        if dh_cap < 128:
            return
        cand = np.nonzero(self._dim_len >= self.HEAD_MIN_DF)[0]
        if len(cand) > dh_cap:
            top = cand[np.argsort(-self._dim_len[cand], kind="stable")[:dh_cap]]
            cand = np.sort(top)
        if not len(cand):
            return
        self._head_col[cand] = np.arange(len(cand), dtype=np.int32)
        self._head_didx = cand.astype(np.int64)

    def _ensure_head(self):
        """Build/refresh the device (Dh, n_cap) u8 dense head matrix."""
        gen = (
            self.tracker._epoch, len(self._dim_uniq), self.n_cap,
            len(self._h_keys),
        )
        if self._head_gen == gen:
            return
        hd = self._head_didx
        if not len(hd):
            self._head_codes_dev = None
            self._head_gen = gen
            return
        dh_pad = max(_next_pow2(len(hd)), 128)
        mat = np.zeros((dh_pad, self.n_cap), np.uint8)
        # requantize the RAW values at the full 255-level u8 range: the
        # head matrix is a nomination structure, and the index's own maxval
        # (as low as 15) would waste the byte's precision.
        docs = np.repeat(
            np.arange(self.n_cap, dtype=np.int64), self._raw_nnz
        )
        rmask = (
            np.arange(self._raw_max)[None, :] < self._raw_nnz[:, None]
        )
        rdims = self._raw_dims[rmask]
        rvals = np.maximum(self._raw_vals[rmask], 0.0)
        pos = np.searchsorted(self._dim_uniq, rdims)
        safe = np.minimum(pos, max(len(self._dim_uniq) - 1, 0))
        cols = self._head_col[safe]
        sel = (cols >= 0) & (self._dim_uniq[safe] == rdims)
        # a doc may repeat a dim (scoring sums the contributions): group-sum
        # duplicate (col, doc) cells before quantizing
        keys = cols[sel].astype(np.int64) * self.n_cap + docs[sel]
        uk, inv_idx = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv_idx, weights=rvals[sel].astype(np.float64))
        # each row's codes span [0, its largest cell]: the reference spans
        # [0, values_upper_bound] and clips above it, and a doc that repeats
        # a dim sums past the bound, clips, and loses its nomination (its
        # exact score is the sum). The row scale goes into the query side
        # (_query_rows), so the product ranks by dequantized values.
        rows = uk // self.n_cap
        scale = np.zeros(dh_pad, np.float64)
        np.maximum.at(scale, rows, sums)
        scale[scale <= 0] = 1.0
        mat.reshape(-1)[uk] = np.minimum(sums / scale[rows] * 255.0, 255.0).astype(np.uint8)
        self._head_codes_dev = _dev(mat, self.device)
        self._head_scale = scale.astype(np.float32)
        self._head_gen = gen

    #: duplicate-candidate slack for the gather-rescore: a doc nominated by
    #: several query dims occupies that many shortlist slots before the
    #: host dedup
    DUP_SLACK = 8

    def _ensure_doc_rows(self):
        """Device copies of the padded raw rows for the exact rescore, dims
        translated to compact CSR indices (searchsorted against _dim_uniq)."""
        gen = (self.tracker._epoch, len(self._dim_uniq))
        if self._doc_rows_gen == gen:
            return
        dd = np.minimum(
            np.searchsorted(self._dim_uniq, self._raw_dims),
            max(len(self._dim_uniq) - 1, 0),
        ).astype(np.int32)
        self._doc_dims_dev = _dev(dd, self.device)
        # negatives clip to 0: the sparse space is non-negative (quantize
        # clamps at 0, inverted_index.rs:168-172)
        self._doc_vals_dev = _dev(np.maximum(self._raw_vals, 0.0).astype(np.float32), self.device)
        self._doc_rows_gen = gen

    def _build_csr(self):
        """Fold pending postings and upload the device CSR if stale."""
        if not (self._csr_dirty or self._csr_ids is None):
            return
        # hold the pend lock across fold + upload + flag clear: an append
        # landing between an unlocked fold and the flag clear would be hidden
        with self._pend_lock:
            if self._csr_dirty or self._csr_ids is None:
                self._fold_pending()
                if len(self._h_ids) == 0:
                    self._csr_ids = None
                else:
                    # 128-ALIGNED device layout: every dim's list starts at
                    # a GATHER_LANE multiple (pad id -1 / value 0), so the
                    # gathers fetch whole 128-lane rows
                    lane = SK.GATHER_LANE
                    counts = self._dim_len
                    padc = -(-counts // lane) * lane
                    starts_pad = np.concatenate(
                        [[0], np.cumsum(padc)]
                    )[:-1].astype(np.int64)
                    total = int(padc.sum())
                    ids_pad = np.full(total, -1, np.int32)
                    vals_pad = np.zeros(total, np.float32)
                    within = np.arange(len(self._h_ids)) - np.repeat(
                        self._dim_start, counts
                    )
                    dst = np.repeat(starts_pad, counts) + within
                    ids_pad[dst] = self._h_ids
                    vals_pad[dst] = self._h_buckets.astype(np.float32)
                    self._dim_start_dev = starts_pad
                    self._csr_ids = _dev(ids_pad, self.device)
                    self._csr_vals = _dev(vals_pad, self.device)
                    self._csr_aligned = True
                self._csr_dirty = False

    #: per-query total posting-scan budget, distributed over the query's
    #: present dims. Postings are stored value-bucket descending, so
    #: truncation keeps the highest-contribution postings (the reference's
    #: early-termination principle, sparse_ann_query.rs:68-147).
    SCAN_BUDGET = 65536
    #: total postings per DISPATCH: small batches split this among fewer
    #: queries, so a lone query scans up to 4M postings at the same
    #: workspace as a 64-query batch at 64k each
    SCAN_BUDGET_TOTAL = 64 * 65536
    MAX_DIM_POSTINGS = 16384

    def _effective_budget(self, batch: int) -> int:
        """Per-query scan budget for a dispatch of `batch` queries: the
        total per dispatch is what is bounded, with SCAN_BUDGET the floor."""
        return max(self.SCAN_BUDGET, self.SCAN_BUDGET_TOTAL // max(batch, 1))

    def _segments_batch(self, queries, budget: int, exclude_head: bool = False):
        """All queries' segment descriptors in one vectorized numpy pass.
        Dims are ranked by query value within each query; the scan budget
        is a HARD per-query bound allocated by impact thresholding (see
        impact_segments_batch)."""
        b = len(queries)
        counts = np.asarray([len(q) for q in queries], np.int64)
        if counts.sum() == 0 or len(self._dim_uniq) == 0:
            maxd = max(_PAD_MIN // 16, 1)
            return (
                np.full((b, maxd), -1, np.int32),
                np.zeros((b, maxd), np.int32),
                np.zeros((b, maxd), np.float32),
            )
        qi = np.repeat(np.arange(b), counts)
        flat = np.concatenate(
            [np.asarray(q, np.float64).reshape(-1, 2) for q in queries if len(q)]
        )
        dims = flat[:, 0].astype(np.int64)
        vals = flat[:, 1].astype(np.float32)
        qqv = self.quantize(vals).astype(np.int64)
        pos = np.searchsorted(self._dim_uniq, dims)
        safe = np.minimum(pos, len(self._dim_uniq) - 1)
        # zero-multiplier pairs contribute nothing to any score (the
        # reference accumulates qv*bucket too): drop them
        ok = (self._dim_uniq[safe] == dims) & (qqv > 0)
        if exclude_head and len(self._head_col):
            # head dims are scanned in FULL by the dense-head product; their
            # postings must not consume the tail scan budget
            ok &= self._head_col[safe] < 0
        if not ok.any():
            maxd = max(_PAD_MIN // 16, 1)
            return (
                np.full((b, maxd), -1, np.int32),
                np.zeros((b, maxd), np.int32),
                np.zeros((b, maxd), np.float32),
            )
        qi, didx, qqv = qi[ok], safe[ok], qqv[ok]
        # early termination: low-valued query dims only scan the top value
        # buckets (sparse_ann_query.rs:89-126); thresholds scale by maxval
        low_threshold = int(self.early_terminate_threshold * self.maxval)
        etv = min(int(self.maxval * self.early_terminate_threshold), self.maxval)
        base_len = self._dim_len[didx]
        eff = np.where(
            qqv <= low_threshold,
            np.minimum(base_len, self._dim_cnt[didx, etv]),
            base_len,
        )
        # the per-dim cap scales with the budget
        maxper = max(self.MAX_DIM_POSTINGS, budget // 8)
        caps = np.minimum(eff, maxper)
        order = np.lexsort((-qqv, qi))  # best query value first per query
        qi, didx, qqv, caps = qi[order], didx[order], qqv[order], caps[order]
        # emitted segment offsets address the ALIGNED device CSR
        dev_start = self._dim_start_dev if self._dim_start_dev is not None else self._dim_start
        return impact_segments_batch(
            b, qi, dev_start[didx], qqv.astype(np.float32), caps,
            self._dim_cnt, didx, np.ones(len(qi), np.float32),
            self.maxval, budget, self.SEGCAP, conservative=True,
            pad_min=_PAD_MIN // 16,
        )

    def _query_rows(self, queries, with_head: bool = False):
        """(q_idx (B, QD) int32 compact dim ids, -1 padded; q_w (B, QD)
        raw non-negative weights; q_head (B, Dh) f32 or None)."""
        b = len(queries)
        counts = np.asarray([len(q) for q in queries], np.int64)
        qd_max = max(_next_pow2(int(counts.max()) if len(counts) else 1), 8)
        q_idx = np.full((b, qd_max), -1, np.int32)
        q_w = np.zeros((b, qd_max), np.float32)
        q_head = np.zeros((b, self._head_codes_dev.shape[0]), np.float32) if with_head else None
        for i, q in enumerate(queries):
            if not len(q):
                continue
            arr = np.asarray(q, np.float64).reshape(-1, 2)
            dims = arr[:, 0].astype(np.int64)
            # exact scoring uses RAW query values (non-negative space);
            # quantization exists only for the posting layout
            vals = np.maximum(arr[:, 1].astype(np.float32), 0.0)
            pos = np.searchsorted(self._dim_uniq, dims)
            safe = np.minimum(pos, max(len(self._dim_uniq) - 1, 0))
            ok = self._dim_uniq[safe] == dims
            kk = min(int(ok.sum()), qd_max)
            q_idx[i, :kk] = safe[ok][:kk]
            q_w[i, :kk] = vals[ok][:kk]
            if with_head:
                hc = self._head_col[safe[ok]]
                hsel = hc >= 0
                # raw query values (not qqv): the doc side is already
                # bucketed, quantizing the query too would double the
                # nomination error; the final rescore is exact either way
                np.add.at(q_head[i], hc[hsel], vals[ok][hsel])
        if with_head:
            q_head *= self._head_scale[None, :]
        return q_idx, q_w, q_head

    def search(
        self,
        queries: list[list[tuple[int, float]]],
        top_k: int = 10,
        rerank: bool = False,
        rerank_factor: int = 5,  # config.toml:5 sparse_raw_values_reranking_factor
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch search. Returns host (ids (B, k), scores (B, k)), -1 padded."""
        b = len(queries)
        if b == 0:
            return np.full((b, top_k), -1, np.int64), np.zeros((b, top_k), np.float32)
        # finalize BEFORE the emptiness check: docs buffered below the
        # sample threshold keep self.n == 0 until sampling finalizes
        if not self.is_configured:
            self._finalize_sampling()
        if self.n == 0:
            return np.full((b, top_k), -1, np.int64), np.zeros((b, top_k), np.float32)
        self._build_csr()
        if self._csr_ids is None:
            return np.full((b, top_k), -1, np.int64), np.zeros((b, top_k), np.float32)
        if self._alive_dev is None:
            self._alive_dev = _dev(self._alive, self.device)
        k_fetch = min(top_k * (rerank_factor if rerank else 1), self.n_cap)
        budget = self._effective_budget(b)
        use_head = bool(len(self._head_didx))
        starts, lens, mults = self._segments_batch(
            queries, budget, exclude_head=use_head
        )
        if use_head:
            # dense-head + CSR-tail engine: head dims scanned fully by the
            # matrix product, tail candidates gathered + rescored, union
            # rescored exactly from raw rows (see _search_head)
            return self._search_head(queries, starts, lens, mults, top_k)
        if self.keep_raw:
            # gather-rescore: budgeted prefixes nominate candidates, each
            # scored EXACTLY from its raw row (the optional raw rerank is
            # subsumed: the scores are already exact)
            return self._rescore_csr(queries, starts, lens, mults, top_k)
        out_ids, scores = _score_csr(
            starts, lens, mults, self._csr_ids, self._csr_vals,
            self._alive_dev, self.n_cap, k_fetch, self.SEGCAP,
            aligned=self._csr_aligned,
        )
        return out_ids[:, :top_k], scores[:, :top_k]

    def _rescore_csr(self, queries, starts, lens, mults, top_k):
        """The candidate gather-rescore, query-chunked to a bounded
        workspace, + host duplicate collapse."""
        self._ensure_doc_rows()
        q_idx, q_w, _ = self._query_rows(queries)
        return rescore_dispatch(
            starts, lens, self._csr_ids, self._doc_dims_dev,
            self._doc_vals_dev, q_idx, q_w, self._alive_dev,
            top_k, self.SEGCAP, self.DUP_SLACK, self.n_cap,
            mults=mults, csr_vals=self._csr_vals, aligned=self._csr_aligned,
            exhaustive=self.EXHAUSTIVE, nom=self.NOM,
        )

    #: nomination width multiplier: each source (head product, tail gather)
    #: contributes max(NOMINATE*k, 64) candidates to the exact final
    #: rescore; nomination ranks in quantized space, so near-ties need the
    #: slack to reach the exact rescore
    NOMINATE = 8

    def _search_head(self, queries, starts, lens, mults, top_k):
        """Dense-head + CSR-tail search.

        1. Head nomination: q_head @ head_codes, every posting of every
           high-df dim scored, no budget.
        2. Tail nomination: budgeted short-list gather + exact raw-row
           rescore.
        3. Final: exact raw rescore of the union, host dedup, top-k.
        """
        self._ensure_doc_rows()
        self._ensure_head()
        b = len(queries)
        dev = self.device
        q_idx, q_w, q_head = self._query_rows(queries, with_head=True)
        nom = int(min(max(self.NOMINATE * top_k, 64), self.n_cap))
        chunk = min(self.n_cap, 1 << 16)
        maxd = starts.shape[1]
        r = self._doc_dims_dev.shape[1]
        nom_width = min(max(4 * nom, 512), self.n_cap)
        fits_one = (
            not self.EXHAUSTIVE
            and b <= SEG_QUERY_CHUNK
            and b * maxd * self.SEGCAP <= (1 << 25)
            and b * nom_width * r <= (1 << 27)
        )
        qi, qw, qh = _dev(q_idx, dev), _dev(q_w, dev), _dev(q_head, dev)
        if fits_one:
            # ONE device call: head product + tail nomination + union +
            # exact rescore, no host hop between them
            f_sc, f_ids = SK.head_tail_union_rescore(
                _dev(starts, dev), _dev(lens, dev), _dev(mults, dev),
                self._csr_ids, self._csr_vals, self._doc_dims_dev,
                self._doc_vals_dev, qi, qw, qh, self._head_codes_dev,
                self._alive_dev, top_k, nom, nom_width, self.SEGCAP,
                1 << 16, chunk, self._csr_aligned,
            )
            return _dedup_topk(f_ids.cpu().numpy(), f_sc.cpu().numpy(), top_k)
        _h_sc, h_ids = SK.head_matmul_topk(qh, self._head_codes_dev, self._alive_dev, nom, chunk)
        t_ids, _t_sc = rescore_dispatch(
            starts, lens, self._csr_ids, self._doc_dims_dev,
            self._doc_vals_dev, q_idx, q_w, self._alive_dev,
            nom, self.SEGCAP, self.DUP_SLACK, self.n_cap,
            mults=mults, csr_vals=self._csr_vals, aligned=self._csr_aligned,
            exhaustive=self.EXHAUSTIVE, nom=self.NOM,
        )
        cand = torch.cat([h_ids, _dev(t_ids, dev)], dim=1)
        f_sc, f_ids = SK.rescore_ids_topk(
            cand, self._doc_dims_dev, self._doc_vals_dev, qi, qw,
            self._alive_dev, min(2 * top_k, cand.shape[1]),
        )
        return _dedup_topk(f_ids.cpu().numpy(), f_sc.cpu().numpy(), top_k)


def _score_csr(starts, lens, mults, csr_ids, csr_vals, alive_dev,
               n_cap: int, k_fetch: int, segcap: int,
               aligned: bool = False):
    """Quantized scoring without raw rows, query-chunked so one call's
    footprint stays bounded. Narrow gathers (at most 65,536 slots) take
    the sort + segment-sum route, with no n_cap-sized buffers; wide ones
    scatter-add into (chunk, n_cap) score rows at ~2^26 elements. Both are
    the reference's FxHashMap walk (sparse_ann_query.rs:89-126) batched."""
    dev = csr_ids.device
    b, maxd = starts.shape
    pad = maxd * segcap
    segment_route = pad <= (1 << 16)
    chunk = min(SEG_QUERY_CHUNK, b)
    while chunk > 8 and (chunk * pad > (1 << 25) or (
        not segment_route and chunk * n_cap > (1 << 26)
    )):
        chunk //= 2
    outs = []
    for s in range(0, b, chunk):
        e = s + chunk
        args = (_dev(starts[s:e], dev), _dev(lens[s:e], dev), _dev(mults[s:e], dev), csr_ids, csr_vals,
                alive_dev)
        if segment_route:
            outs.append(SK.csr_segment_topk(*args, k_fetch, segcap, aligned=aligned))
        else:
            outs.append(SK.csr_accumulate_topk(*args, n_cap, k_fetch, segcap, aligned=aligned))
    scores = torch.cat([o[0] for o in outs]).cpu().numpy()
    out_ids = torch.cat([o[1] for o in outs]).cpu().numpy()
    return out_ids, scores
