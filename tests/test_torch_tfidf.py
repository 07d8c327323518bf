"""The port's TFIDFIndex (cosdata_tpu_torch/indexes/tf_idf.py, device
"cpu") against the reference's (cosdata_tpu/indexes/tf_idf.py, XLA on the
CPU), as tests/test_sparse.py runs it. The same seeded zipf texts (bench.py's
BM25 corpus shape: words ``w{i}``, pareto(1.1) ids, at most 2,000 docs)
and queries (a doc's rarest words) go through both, with the reference's
native text path off so both compute the tf in double precision, on each
search route the reference has:

- below ``HEAD_MIN_CAP``: the budgeted posting prefixes and the exact
  rescore only;
- the dense head engaged (``HEAD_MIN_CAP`` and ``HEAD_MIN_DF`` patched
  down on both classes, as tests/test_sparse.py does): head product, tail
  nomination and the exact rescore of their union in one call;
- the same in three calls, for a batch over ``SEG_QUERY_CHUNK``.

On each route ids must be equal where the reference's scores are untied
(never the last column), scores at rtol 1e-6, and the port must reach
recall 1.0 against a brute-force Σ idf·tf computed from its own texts.
Deletes (also from the sampling buffer), a re-add, compaction at 25%,
live df under churn, the empty and the unconfigured index follow."""

import numpy as np
import pytest
import torch

from cosdata_tpu.indexes import tf_idf as JT
from cosdata_tpu.text import processing as JP
from cosdata_tpu_torch.indexes import inverted as TI
from cosdata_tpu_torch.indexes import tf_idf as TT
from cosdata_tpu_torch.ops import sparse_kernels as TK
from cosdata_tpu_torch.text.processing import process_text, process_text_query

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-6
K = 10


def corpus(n=2000, vocab=400, doc_len=20, seed=3, nq=24):
    """bench.py's BM25 corpus at a small size; query j is doc j's 4 rarest words."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    z = rng.pareto(1.1, size=n * doc_len).astype(np.int64) % vocab
    docs = [" ".join(words[w] for w in z[i * doc_len : (i + 1) * doc_len]) for i in range(n)]
    queries = [" ".join(words[w] for w in np.sort(z[j * doc_len : (j + 1) * doc_len])[-4:]) for j in range(nq)]
    return docs, queries


@pytest.fixture(autouse=True)
def reference_python_text(monkeypatch):
    monkeypatch.setattr(JP, "_native", None)


def build(docs, deletes=(), sample_threshold=64, **kw):
    j = JT.TFIDFIndex(sample_threshold=sample_threshold, **kw)
    t = TT.TFIDFIndex("cpu", sample_threshold=sample_threshold, **kw)
    for idx in (j, t):
        for i, d in enumerate(docs):
            idx.add(i, d)
        for i in deletes:
            idx.delete(i)
        idx.flush()
    return j, t


def _untied(s):
    """Positions whose score differs from both neighbours; the last column
    counts as tied (a score just past the top-k may equal it)."""
    s = np.asarray(s, np.float64)
    tol = 1e-5 * np.abs(s) + ATOL
    gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [0.0]]) > tol)


def same_results(t_out, j_out):
    ti, ts = (np.asarray(x) for x in t_out)
    ji, js = (np.asarray(x) for x in j_out)
    assert ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    for srow, trow, jrow in zip(js, ti, ji):
        u = _untied(srow)
        assert (trow[u] == jrow[u]).all(), (trow, jrow)
    assert (ji[:, 0] >= 0).all()


def brute_recall(t, docs, queries, out, dead=()):
    """Tie-tolerant recall@K against Σ idf·tf over live docs, computed from
    the texts: an id counts when its exact score reaches the K-th best."""
    tfs = [dict(process_text(d, 40, t.average_document_length, t.k1, t.b)) for d in docs]
    live = [i for i in range(len(docs)) if i not in set(dead)]
    df = {}
    for i in live:
        for term in tfs[i]:
            df[term] = df.get(term, 0) + 1
    n = len(live)
    hits = 0
    for q, row, srow in zip(queries, *out):
        idf = {term: np.log1p((n - df[term] + 0.5) / (df[term] + 0.5)) for term in process_text_query(q) if term in df}
        sc = np.full(len(docs), -np.inf)
        for i in live:
            sc[i] = sum(idf[term] * float(np.float32(tf)) for term, tf in tfs[i].items() if term in idf and idf[term] > 0)
        kth = np.sort(sc)[-K]
        ok = row >= 0
        assert ok.sum() == K
        np.testing.assert_allclose(srow, sc[row], rtol=1e-5, atol=1e-6)
        hits += int((sc[row] >= kth - 1e-5 * abs(kth) - 1e-6).sum())
    return hits / (K * len(queries))


def spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    return calls


ROUTES = {
    # route: (head engaged, query batch multiplier, the function that must run)
    "rescore": (False, 1, "candidates_rescore_topk"),
    "fused_head": (True, 1, "head_tail_union_rescore"),
    "separate_head": (True, 12, "head_matmul_topk"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_reference(route, monkeypatch):
    head, mult, fn = ROUTES[route]
    if head:
        for cls in (JT.TFIDFIndex, TT.TFIDFIndex):
            monkeypatch.setattr(cls, "HEAD_MIN_CAP", 512)
            monkeypatch.setattr(cls, "HEAD_MIN_DF", 4)
    docs, queries = corpus()
    queries = queries * mult
    assert len(queries) > TI.SEG_QUERY_CHUNK or mult == 1
    dead = (3, 50, 777)
    j, t = build(docs, deletes=dead)
    calls = spy(monkeypatch, TK, fn)
    unfused = spy(monkeypatch, TK, "head_tail_union_rescore")
    t_out, j_out = t.search(queries, K), j.search(queries, K)
    assert calls and (t._head_codes_dev is not None) == head
    assert bool(unfused) == (route == "fused_head")
    same_results(t_out, j_out)
    assert brute_recall(t, docs, queries[:24], (t_out[0][:24], t_out[1][:24]), dead) == 1.0
    assert not np.isin(t_out[0], dead).any()


def test_head_codes_scale_by_the_global_tf_maximum(monkeypatch):
    for cls in (JT.TFIDFIndex, TT.TFIDFIndex):
        monkeypatch.setattr(cls, "HEAD_MIN_CAP", 512)
        monkeypatch.setattr(cls, "HEAD_MIN_DF", 4)
    docs, queries = corpus()
    j, t = build(docs)
    t.search(queries[:2], K)
    j.search(queries[:2], K)
    codes = t._head_codes_dev.numpy()
    np.testing.assert_array_equal(codes, np.asarray(j._head_codes_dev))
    assert codes.max() == 255 and t._head_scale == j._head_scale == float(t._h_tfs.max())
    # each code is its tf on the 255-level scale, truncated
    cols = t._head_col[t._csr_term_idx]
    sel = cols >= 0
    got = codes[cols[sel], t._h_ids_sorted[sel]].astype(np.float64)
    want = t._h_tfs[sel].astype(np.float64) / t._head_scale * 255.0
    assert (got <= want + 1e-3).all() and (got > want - 1.0 - 1e-3).all()


def test_exhaustive_oracle_matches_reference(monkeypatch):
    """The recall oracle: unbounded budgets, every tail slot rescored."""
    for cls in (JT.TFIDFIndex, TT.TFIDFIndex):
        monkeypatch.setattr(cls, "HEAD_MIN_CAP", 512)
        monkeypatch.setattr(cls, "HEAD_MIN_DF", 4)
    docs, queries = corpus()
    j, t = build(docs, deletes=(9,))
    for idx in (j, t):
        idx.SCAN_BUDGET = idx.MAX_TERM_POSTINGS = 1 << 30
    monkeypatch.setenv("COSDATA_SPARSE_EXHAUSTIVE", "1")
    monkeypatch.setattr(t, "EXHAUSTIVE", True)
    calls = spy(monkeypatch, TK, "candidates_rescore_topk")
    t_out = t.search(queries, K)
    same_results(t_out, j.search(queries, K))
    assert calls
    assert brute_recall(t, docs, queries, t_out, (9,)) == 1.0


def test_single_query_gets_the_whole_budget():
    docs, queries = corpus(n=800)
    j, t = build(docs)
    for q in queries[:4]:
        same_results(t.search([q], K), j.search([q], K))


def test_deletes_readd_and_compaction():
    docs, queries = corpus(n=1200)
    dead = list(range(0, 1200, 5))  # 20%: below the compaction threshold
    j, t = build(docs, deletes=dead)
    for idx in (j, t):
        idx.search(queries[:1], K)  # builds the CSR
    assert t.live_documents == j.live_documents == 1200 - len(dead)
    assert t.total_documents == j.total_documents == 1200
    np.testing.assert_array_equal(t._live_df_arr, j._live_df_arr)
    same_results(t.search(queries, K), j.search(queries, K))
    # a deleted id re-added through the index API comes back to life
    for idx in (j, t):
        idx.add(5, docs[5])
    assert t.live_documents == j.live_documents == 1200 - len(dead) + 1
    t_out = t.search(queries, K)
    same_results(t_out, j.search(queries, K))
    np.testing.assert_array_equal(t._live_df_arr, j._live_df_arr)
    # more deletes past 25% of the documents: compaction at the next flush
    more = list(range(1, 1200, 5))
    for idx in (j, t):
        for i in more:
            idx.delete(i)
        idx.flush()
    assert t.total_documents == t.live_documents == j.total_documents == j.live_documents
    assert sum(map(len, t._postings.values())) == sum(len(p.ids) for p in j._postings.values())
    for term, ids in t._postings.items():
        assert ids == j._postings[term].ids and t._tfs[term] == j._tfs[term]
    t_out = t.search(queries, K)
    same_results(t_out, j.search(queries, K))
    np.testing.assert_array_equal(t._live_df_arr, j._live_df_arr)
    assert not np.isin(t_out[0], [i for i in dead + more if i != 5]).any()


def test_sampling_buffer_delete_and_avgdl():
    docs, queries = corpus(n=300)
    j = JT.TFIDFIndex(sample_threshold=100)
    t = TT.TFIDFIndex("cpu", sample_threshold=100)
    for idx in (j, t):
        for i in range(99):
            idx.add(i, docs[i])
        assert not idx.is_configured
        idx.delete(7)  # purged from the sampling buffer
        idx.add(99, docs[99])
        assert not idx.is_configured
        idx.add(100, docs[100])
        assert idx.is_configured
        for i in range(101, 300):
            idx.add(i, docs[i])
    assert t.average_document_length == j.average_document_length
    assert t.live_documents == j.live_documents == 299
    t_out = t.search(queries, K)
    same_results(t_out, j.search(queries, K))
    assert 7 not in t_out[0]


def test_empty_and_unconfigured_index():
    t = TT.TFIDFIndex("cpu")
    j = JT.TFIDFIndex()
    for out in (t.search(["hello"], 3), j.search(["hello"], 3), t.search([], 3)):
        assert (out[0] == -1).all() and (out[1] == 0).all()
    assert t.search([], 3)[0].shape == (0, 3)
    # two documents stay in the sampling buffer: a search finalizes them
    for idx in (t, j):
        idx.add(0, "the quick brown fox")
        idx.add(1, "a lazy brown dog")
        assert not idx.is_configured
    t_out, j_out = t.search(["brown dog", "fox", "zebra"], 3), j.search(["brown dog", "fox", "zebra"], 3)
    assert t.is_configured and t.average_document_length == j.average_document_length == 3.0
    np.testing.assert_array_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[1], j_out[1], rtol=RTOL)
    assert t_out[0][0, 0] == 1 and (t_out[0][2] == -1).all()
    # every document deleted: empty answers again
    for idx in (t, j):
        idx.delete(0)
        idx.delete(1)
    assert (t.search(["brown"], 3)[0] == -1).all() and (j.search(["brown"], 3)[0] == -1).all()


def test_device_tensors_live_on_the_index_device(monkeypatch):
    monkeypatch.setattr(TT.TFIDFIndex, "HEAD_MIN_CAP", 512)
    monkeypatch.setattr(TT.TFIDFIndex, "HEAD_MIN_DF", 4)
    docs, queries = corpus(n=600)
    _, t = build(docs)
    t.search(queries[:2], K)
    for x in (t._csr_ids, t._csr_vals, t._alive_dev, t._doc_terms_dev, t._doc_tfs_dev, t._head_codes_dev):
        assert x.device == torch.device("cpu")
    assert t._csr_ids.dtype == torch.int32 and t._doc_tfs_dev.dtype == torch.float32
    assert t._head_codes_dev.dtype == torch.uint8 and t._csr_ids.numel() % TK.GATHER_LANE == 0
