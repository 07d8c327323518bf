"""TF-IDF / BM25 full-text index.

Port of ``cosdata_tpu/indexes/tf_idf.py``: the reference's hash-sharded
trie of term postings (upstream src/indexes/tf_idf/mod.rs:48-389) as host
postings plus scoring on the device:

- documents: tokenize → stopword → Snowball stem → xxhash32 term ids, BM25
  term frequency with k1/b applied at index time (mod.rs:310-371);
- the average document length is tuned on a sample (mod.rs:177-207);
- query scoring: score(doc) = Σ_t idf(t) × tf(doc, t) with
  idf = ln1p((N - df + 0.5) / (df + 0.5)) over live documents
  (sparse_ann_query.rs:298-302), the exact top-k;
- the device CSR holds each term's postings tf-descending in a list that
  starts at a multiple of ``GATHER_LANE``; budgeted prefixes nominate
  candidates, each scored exactly from its own row of (term, tf) pairs; at
  scale the high-df terms become columns of a dense u8 head matrix scored
  by one matrix product per ``n_cap`` chunk.

The host parts (sampling, live accounting, compaction, the CSR build, the
tf-bucket allocator tables, head selection) are the reference's numpy
code, and the device functions are the sparse index's
(``indexes/inverted.py``, ``ops/sparse_kernels.py``). Every device tensor
lives on the index's explicit ``device``. Changed from the reference: the
environment switch ``COSDATA_SPARSE_EXHAUSTIVE`` is the class attribute
``EXHAUSTIVE``; query batches are not padded to a power of two (that served
only XLA's compile cache), though the route gate still decides on the
reference's padded batch, so both take the same route; postings are plain
lists per term.
"""

from __future__ import annotations

import numpy as np
import torch

from cosdata_tpu_torch.indexes.inverted import (
    _PAD_MIN,
    SEG_QUERY_CHUNK,
    _dedup_topk,
    _dev,
    _next_pow2,
    impact_segments_batch,
    rescore_dispatch,
)
from cosdata_tpu_torch.ops import sparse_kernels as SK
from cosdata_tpu_torch.text.processing import count_tokens, process_text, process_text_query


class TFIDFIndex:
    """BM25 index over documents keyed by internal id, scored on ``device``."""

    #: dead fraction of the documents that triggers posting compaction at flush
    COMPACT_THRESHOLD = 0.25
    #: rescore every budgeted posting slot instead of nominating (the
    #: reference's COSDATA_SPARSE_EXHAUSTIVE=1; the recall oracle sets it)
    EXHAUSTIVE = False
    #: per-query posting-scan budget; postings are tf-descending, so a cut
    #: keeps the strongest candidates
    SCAN_BUDGET = 65536
    #: total postings per dispatch: small batches split this among fewer queries
    SCAN_BUDGET_TOTAL = 64 * 65536
    MAX_TERM_POSTINGS = 16384
    #: per-(query, term) device gather segment width
    SEGCAP = 512
    #: tf-bucket resolution of the allocator's per-term count tables
    TF_BUCKETS = 128
    #: dense-head knobs: terms with df >= HEAD_MIN_DF become rows of a
    #: device (Dh, n_cap) u8 tf matrix, every posting of every head term
    #: scored with no budget. BM25's top-k sums idf·tf across terms, so
    #: per-posting nomination alone loses documents whose mass is spread
    #: over common terms; the head product sums them (quantized) before
    #: the exact rescore.
    HEAD_MIN_DF = 64
    HEAD_MIN_CAP = 32768
    HEAD_BYTES_MAX = 1 << 30
    HEAD_DH_MAX = 8192
    #: nomination width multiplier into the exact final rescore
    NOMINATE = 8

    def __init__(
        self,
        device,
        k1: float = 1.2,
        b: float = 0.75,
        sample_threshold: int = 1000,
        max_token_len: int = 40,
        average_document_length: float | None = None,  # fixed -> no sampling
        scan_budget: int | None = None,
        scan_budget_total: int | None = None,
    ):
        self.device = torch.device(device)
        self.k1 = float(k1)
        self.b = float(b)
        self.max_token_len = max_token_len
        self.sample_threshold = sample_threshold
        self.is_configured = average_document_length is not None
        self.average_document_length = float(average_document_length or 1.0)
        self._sample: list[tuple[int, str]] = []
        self._sample_len_sum = 0
        #: term id -> doc ids and their tfs, in insert order
        self._postings: dict[int, list[int]] = {}
        self._tfs: dict[int, list[float]] = {}
        self.total_documents = 0
        # live accounting: df and N in the idf count live documents only
        self.live_documents = 0
        self.n_cap = 1024
        self._alive = np.ones(self.n_cap, bool)
        self._has_doc = np.zeros(self.n_cap, bool)
        self._alive_dev = None
        self.n = 0
        # operator-pinned budgets (pinning both makes served quality
        # independent of the dispatch batch size)
        if scan_budget is not None:
            self.SCAN_BUDGET = int(scan_budget)
        if scan_budget_total is not None:
            self.SCAN_BUDGET_TOTAL = int(scan_budget_total)
        # device CSR of (doc id, tf) postings and per-doc (term, tf) rows
        self._csr_dirty = True
        self._df_dirty = False
        self._csr_ids = None
        self._csr_vals = None
        self._doc_terms_dev = None
        self._doc_tfs_dev = None
        self._csr_gen = 0
        # vectorized allocator tables (filled by _build_csr)
        self._h_tfs = np.zeros(0, np.float32)
        self._h_ids_sorted = np.zeros(0, np.int32)
        self._term_sorted = np.zeros(0, np.int64)
        self._term_start = np.zeros(0, np.int64)
        self._term_start_dev = np.zeros(0, np.int64)
        self._term_len = np.zeros(0, np.int64)
        self._term_heads = np.zeros(0, np.float32)
        self._csr_term_idx = np.zeros(0, np.int64)
        self._live_df_arr = np.zeros(0, np.int64)
        self._tf_cnt = np.zeros((0, self.TF_BUCKETS + 2), np.int32)
        # dense-head state (filled by _select_head/_ensure_head)
        self._head_col = np.zeros(0, np.int32)
        self._head_tidx = np.zeros(0, np.int64)
        self._head_codes_dev = None
        self._head_scale = 1.0
        self._head_gen = None

    # ----------------------------------------------------------------- write

    def add(self, internal_id: int, text: str) -> None:
        if not self.is_configured:
            self._sample.append((internal_id, text))
            self._sample_len_sum += count_tokens(text, self.max_token_len)
            if len(self._sample) >= self.sample_threshold:
                self._finalize_sampling()
            return
        self._insert(internal_id, text)

    def _finalize_sampling(self):
        if not self._sample:
            # nothing sampled: do not lock avgdl at the 1.0 default, which
            # every later document's stored tf would carry
            return
        self.average_document_length = self._sample_len_sum / len(self._sample)
        self.is_configured = True
        pending, self._sample = self._sample, []
        for iid, text in pending:
            self._insert(iid, text)

    def flush(self):
        if not self.is_configured:
            self._finalize_sampling()
        self._maybe_compact()

    def _insert(self, internal_id: int, text: str):
        internal_id = int(internal_id)
        for term, tf in process_text(text, self.max_token_len, self.average_document_length, self.k1, self.b):
            ids = self._postings.get(term)
            if ids is None:
                ids = self._postings[term] = []
                self._tfs[term] = []
            ids.append(internal_id)
            self._tfs[term].append(tf)
        self._csr_dirty = True
        if internal_id >= self.n:
            self.n = internal_id + 1
        if internal_id >= self.n_cap:
            new_cap = _next_pow2(internal_id + 1)
            self._alive = np.concatenate([self._alive, np.ones(new_cap - self.n_cap, bool)])
            self._has_doc = np.concatenate([self._has_doc, np.zeros(new_cap - self.n_cap, bool)])
            self.n_cap = new_cap
            self._alive_dev = None
        # a re-added id is not counted twice, and a deleted one comes back
        # to life. The collection gives every upsert a fresh internal id; a
        # deleted id re-added through this API keeps its stale postings
        # until the next compaction.
        if not self._has_doc[internal_id]:
            self.total_documents += 1
            self.live_documents += 1
        elif not self._alive[internal_id]:
            self.live_documents += 1
        if not self._alive[internal_id]:
            self._alive[internal_id] = True
            self._alive_dev = None
            self._df_dirty = True
        self._has_doc[internal_id] = True

    def delete(self, internal_id: int) -> None:
        # purge the sampling buffer too: _finalize_sampling would otherwise
        # bring the document back as an undeletable ghost
        if self._sample:
            kept = []
            for rec in self._sample:
                if rec[0] == internal_id:
                    self._sample_len_sum -= count_tokens(rec[1], self.max_token_len)
                else:
                    kept.append(rec)
            self._sample = kept
        if internal_id < self.n_cap:
            if self._has_doc[internal_id] and self._alive[internal_id]:
                self.live_documents -= 1
                self._df_dirty = True
            self._alive[internal_id] = False
            self._alive_dev = None

    def _maybe_compact(self):
        """Drop dead documents' postings once they reach the threshold."""
        dead = self.total_documents - self.live_documents
        if self.total_documents == 0 or dead / self.total_documents < self.COMPACT_THRESHOLD:
            return
        for term in list(self._postings):
            ids = np.asarray(self._postings[term], np.int64)
            keep = self._alive[ids]
            if keep.all():
                continue
            if not keep.any():
                del self._postings[term]
                del self._tfs[term]
                continue
            self._postings[term] = ids[keep].tolist()
            self._tfs[term] = [t for t, k in zip(self._tfs[term], keep) if k]
        self.total_documents = self.live_documents
        self._csr_dirty = True

    # ---------------------------------------------------------------- search

    def _build_csr(self):
        """Upload the postings as one flat device CSR (rebuilt after writes).

        Each term's postings are ordered tf-descending (one global lexsort),
        so a term's scan budget keeps its highest-tf documents."""
        if not self._csr_dirty:
            return
        terms = sorted(self._postings)  # sorted: vectorized lookup
        term_lens = [len(self._postings[t]) for t in terms]
        if sum(term_lens) == 0:
            self._csr_ids = None
            self._csr_dirty = False
            self._term_sorted = np.zeros(0, np.int64)
            return
        flat_ids = np.concatenate([np.asarray(self._postings[t], np.int32) for t in terms])
        flat_tfs = np.concatenate([np.asarray(self._tfs[t], np.float32) for t in terms])
        term_idx = np.repeat(np.arange(len(terms)), term_lens)
        order = np.lexsort((-flat_tfs, term_idx))
        self._h_tfs = flat_tfs[order]
        self._h_ids_sorted = flat_ids[order]
        self._term_sorted = np.asarray(terms, np.int64)
        self._term_len = np.asarray(term_lens, np.int64)
        self._term_start = np.concatenate([[0], np.cumsum(self._term_len)[:-1]]).astype(np.int64)
        self._csr_term_idx = term_idx[order]
        # per-term cumulative tf-bucket counts: cnt[t, i] = postings with
        # bucket >= i, bucket = floor(tf / head * NB); the allocator cuts
        # lists at tf >= T/idf by one table gather
        nb = self.TF_BUCKETS
        heads = np.maximum(self._h_tfs[self._term_start], 1e-30)
        self._term_heads = heads
        buckets = np.minimum((self._h_tfs / heads[self._csr_term_idx] * nb).astype(np.int64), nb)
        hist = np.bincount(
            self._csr_term_idx * (nb + 1) + buckets, minlength=len(terms) * (nb + 1)
        ).reshape(len(terms), nb + 1)
        cum = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
        self._tf_cnt = np.concatenate([cum, np.zeros((len(terms), 1), cum.dtype)], axis=1).astype(np.int32)
        self._refresh_live_df()
        # GATHER_LANE-aligned device layout: each term's list starts at a
        # lane multiple (pad id -1, tf 0), so the gathers fetch whole rows
        lane = SK.GATHER_LANE
        padc = -(-self._term_len // lane) * lane
        starts_pad = np.concatenate([[0], np.cumsum(padc)])[:-1].astype(np.int64)
        ids_pad = np.full(int(padc.sum()), -1, np.int32)
        tfs_pad = np.zeros(int(padc.sum()), np.float32)
        within = np.arange(len(self._h_ids_sorted)) - np.repeat(self._term_start, self._term_len)
        dst = np.repeat(starts_pad, self._term_len) + within
        ids_pad[dst] = self._h_ids_sorted
        tfs_pad[dst] = self._h_tfs
        self._term_start_dev = starts_pad
        self._csr_ids = _dev(ids_pad, self.device)
        self._csr_vals = _dev(tfs_pad, self.device)
        # per-doc (compact term index, tf) rows for the exact rescore:
        # score(doc) = Σ idf[term] * tf over the doc's own row
        order_d = np.argsort(flat_ids, kind="stable")
        docs_sorted = flat_ids[order_d]
        terms_sorted = term_idx[order_d].astype(np.int32)
        tfs_sorted = flat_tfs[order_d]
        _, starts_d, counts_d = np.unique(docs_sorted, return_index=True, return_counts=True)
        r_max = max(_next_pow2(int(counts_d.max())), 8)
        doc_terms = np.zeros((self.n_cap, r_max), np.int32)
        doc_tfs = np.zeros((self.n_cap, r_max), np.float32)
        cols = np.arange(len(docs_sorted)) - np.repeat(starts_d, counts_d)
        keep = cols < r_max
        doc_terms[docs_sorted[keep], cols[keep]] = terms_sorted[keep]
        doc_tfs[docs_sorted[keep], cols[keep]] = tfs_sorted[keep]
        self._doc_terms_dev = _dev(doc_terms, self.device)
        self._doc_tfs_dev = _dev(doc_tfs, self.device)
        self._csr_gen += 1
        self._select_head()
        self._csr_dirty = False

    def _select_head(self):
        """Pick the head terms from the df tables (called by _build_csr)."""
        nt = len(self._term_sorted)
        self._head_col = np.full(nt, -1, np.int32)
        self._head_tidx = np.zeros(0, np.int64)
        if self.n_cap < self.HEAD_MIN_CAP or nt == 0:
            return
        dh_cap = min(self.HEAD_DH_MAX, self.HEAD_BYTES_MAX // max(self.n_cap, 1))
        if dh_cap < 128:
            return
        cand = np.nonzero(self._term_len >= self.HEAD_MIN_DF)[0]
        if len(cand) > dh_cap:
            cand = np.sort(cand[np.argsort(-self._term_len[cand], kind="stable")[:dh_cap]])
        if not len(cand):
            return
        self._head_col[cand] = np.arange(len(cand), dtype=np.int32)
        self._head_tidx = cand.astype(np.int64)

    def _ensure_head(self):
        """Build or refresh the device (Dh, n_cap) u8 head tf matrix."""
        gen = (self._csr_gen, self.n_cap)
        if self._head_gen == gen:
            return
        hd = self._head_tidx
        self._head_gen = gen
        if not len(hd):
            self._head_codes_dev = None
            self._head_scale = 1.0
            return
        mat = np.zeros((max(_next_pow2(len(hd)), 128), self.n_cap), np.uint8)
        cols = self._head_col[self._csr_term_idx]
        sel = cols >= 0
        # one global tf scale: the BM25 tf is bounded by k1 + 1, so codes
        # keep their order across terms and nothing clips; nomination only
        # (the exact rescore follows)
        tf_max = float(self._h_tfs.max()) if len(self._h_tfs) else 1.0
        self._head_scale = max(tf_max, 1e-30)
        q255 = np.minimum(self._h_tfs[sel] / self._head_scale * 255.0, 255.0).astype(np.uint8)
        flat = cols[sel].astype(np.int64) * self.n_cap + self._h_ids_sorted[sel]
        mat.reshape(-1)[flat] = q255
        self._head_codes_dev = _dev(mat, self.device)

    def _refresh_live_df(self):
        """Live document frequency of each term (the idf counts live docs)."""
        self._live_df_arr = np.bincount(
            self._csr_term_idx,
            weights=self._alive[self._h_ids_sorted].astype(np.float64),
            minlength=len(self._term_sorted),
        ).astype(np.int64)
        self._df_dirty = False

    def search(self, queries: list[str], top_k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Batch search. Returns host (ids (B, k), scores (B, k)), -1 padded."""
        b = len(queries)
        empty = (np.full((b, top_k), -1, np.int64), np.zeros((b, top_k), np.float32))
        if b == 0:
            return empty
        # flush before the emptiness check: documents still in the sample
        # buffer count as live only once sampling finalizes
        self.flush()
        if self.live_documents <= 0:
            return empty
        self._build_csr()
        if self._csr_ids is None:
            return empty
        if self._df_dirty:
            self._refresh_live_df()
        # the whole batch's scan budgets in one vectorized pass, allocated
        # by impact (idf * tf) thresholding: rare high-idf terms keep their
        # short lists whole, head-term lists are cut at the globally weakest
        # contributions; a lone query gets the whole dispatch budget
        budget = max(self.SCAN_BUDGET, self.SCAN_BUDGET_TOTAL // b)
        term_lists = [process_text_query(text, self.max_token_len) for text in queries]
        qi = np.repeat(np.arange(b), [len(t) for t in term_lists])
        flat_terms = np.asarray([t for terms in term_lists for t in terms], np.int64)
        if len(flat_terms) and len(self._term_sorted):
            safe = np.minimum(np.searchsorted(self._term_sorted, flat_terms), len(self._term_sorted) - 1)
            ok = (self._term_sorted[safe] == flat_terms) & (self._live_df_arr[safe] > 0)
        else:
            safe = np.zeros(0, np.int64)
            ok = np.zeros(len(flat_terms), bool)
        qi, tidx = qi[ok], safe[ok]
        df = self._live_df_arr[tidx]
        n_live = self.live_documents
        idf = np.log1p((n_live - df + 0.5) / (df + 0.5)).astype(np.float32)
        pos_w = idf > 0.0
        qi, tidx, idf = qi[pos_w], tidx[pos_w], idf[pos_w]
        # head terms are scanned whole by the head product (no budget); only
        # the tail terms go through the budgeted posting-prefix nomination
        self._ensure_head()
        use_head = self._head_codes_dev is not None
        if use_head:
            is_head = self._head_col[tidx] >= 0
            qi_h, tidx_h, idf_h = qi[is_head], tidx[is_head], idf[is_head]
            qi, tidx, idf = qi[~is_head], tidx[~is_head], idf[~is_head]
        maxper = max(self.MAX_TERM_POSTINGS, budget // 8)
        caps = np.minimum(self._term_len[tidx], maxper)
        order = np.lexsort((-idf, qi))  # highest-idf terms first per query
        qi, tidx, idf, caps = qi[order], tidx[order], idf[order], caps[order]
        units = (self._term_heads[tidx] / self.TF_BUCKETS).astype(np.float32)
        starts, lens, mults = impact_segments_batch(
            b, qi, self._term_start_dev[tidx], idf, caps, self._tf_cnt, tidx, units,
            self.TF_BUCKETS, budget, self.SEGCAP, conservative=False, pad_min=_PAD_MIN // 16,
        )
        if self._alive_dev is None:
            self._alive_dev = _dev(self._alive, self.device)
        # the exact rescore scores the whole query (head and tail terms)
        if use_head:
            qi_all = np.concatenate([qi, qi_h])
            tidx_all = np.concatenate([tidx, tidx_h])
            idf_all = np.concatenate([idf, idf_h])
            order_all = np.argsort(qi_all, kind="stable")
            qi_all, tidx_all, idf_all = qi_all[order_all], tidx_all[order_all], idf_all[order_all]
        else:
            qi_all, tidx_all, idf_all = qi, tidx, idf
        qt_max = max(_next_pow2(int(np.bincount(qi_all, minlength=b).max()) if len(qi_all) else 1), 8)
        q_idx = np.full((b, qt_max), -1, np.int32)
        q_w = np.zeros((b, qt_max), np.float32)
        if len(qi_all):
            cols = np.arange(len(qi_all)) - np.searchsorted(qi_all, np.arange(b))[qi_all]
            q_idx[qi_all, cols] = tidx_all.astype(np.int32)
            q_w[qi_all, cols] = idf_all
        if not use_head:
            return rescore_dispatch(
                starts, lens, self._csr_ids, self._doc_terms_dev, self._doc_tfs_dev, q_idx, q_w,
                self._alive_dev, min(top_k, self.n_cap), self.SEGCAP, 8, self.n_cap,
                mults=mults, csr_vals=self._csr_vals, aligned=True, exhaustive=self.EXHAUSTIVE,
            )
        return self._search_head(starts, lens, mults, q_idx, q_w, qi_h, tidx_h, idf_h, b, top_k)

    def _search_head(self, starts, lens, mults, q_idx, q_w, qi_h, tidx_h, idf_h, b, top_k):
        """Dense head + CSR tail: head nomination by the matrix product,
        tail nomination and exact rescore, and the exact final rescore of
        their union, in one call where the workspace allows, else three."""
        dev = self.device
        nom = int(min(max(self.NOMINATE * top_k, 64), self.n_cap))
        nom_width = min(max(4 * nom, 512), self.n_cap)
        q_head = np.zeros((b, self._head_codes_dev.shape[0]), np.float32)
        np.add.at(q_head, (qi_h, self._head_col[tidx_h]), idf_h)
        qi, qw, qh = _dev(q_idx, dev), _dev(q_w, dev), _dev(q_head, dev)
        chunk = min(self.n_cap, 1 << 16)
        # the reference pads the batch to a power of two (at least 8) and
        # gates on that size: gate on it too, so the same route is taken
        bp = max(_next_pow2(b), 8)
        fits_one = (
            not self.EXHAUSTIVE
            and bp <= SEG_QUERY_CHUNK
            and bp * starts.shape[1] * self.SEGCAP <= (1 << 25)
            and bp * nom_width * self._doc_terms_dev.shape[1] <= (1 << 27)
        )
        if fits_one:
            f_sc, f_ids = SK.head_tail_union_rescore(
                _dev(starts, dev), _dev(lens, dev), _dev(mults, dev), self._csr_ids, self._csr_vals,
                self._doc_terms_dev, self._doc_tfs_dev, qi, qw, qh, self._head_codes_dev,
                self._alive_dev, top_k, nom, nom_width, self.SEGCAP, 1 << 16, chunk, True,
            )
            return _dedup_topk(f_ids.cpu().numpy(), f_sc.cpu().numpy(), top_k)
        t_ids, _t_sc = rescore_dispatch(
            starts, lens, self._csr_ids, self._doc_terms_dev, self._doc_tfs_dev, q_idx, q_w,
            self._alive_dev, nom, self.SEGCAP, 8, self.n_cap,
            mults=mults, csr_vals=self._csr_vals, aligned=True, exhaustive=self.EXHAUSTIVE,
        )
        _h_sc, h_ids = SK.head_matmul_topk(qh, self._head_codes_dev, self._alive_dev, nom, chunk)
        cand = torch.cat([h_ids, _dev(t_ids, dev)], dim=1)
        f_sc, f_ids = SK.rescore_ids_topk(
            cand, self._doc_terms_dev, self._doc_tfs_dev, qi, qw, self._alive_dev,
            min(2 * top_k, cand.shape[1]),
        )
        return _dedup_topk(f_ids.cpu().numpy(), f_sc.cpu().numpy(), top_k)
