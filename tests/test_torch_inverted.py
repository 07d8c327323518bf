"""The port's InvertedIndex (cosdata_tpu_torch/indexes/inverted.py, device
"cpu") against the reference's (cosdata_tpu/indexes/inverted.py, XLA on the
CPU): the same zipf corpora (at most 4,096 docs, vocab at most 2,000, numpy
seeds) and queries go through both, on every route the reference has:

- the exhaustive rescore (capacity below EXHAUSTIVE_MAX_CAP);
- contribution nomination (EXHAUSTIVE_MAX_CAP patched down);
- the dense head + CSR tail in one call, and its three-call form under the
  exhaustive oracle (HEAD_MIN_CAP/HEAD_MIN_DF patched down, as
  tests/test_sparse.py does);
- ``keep_raw=False`` on the sort + segment-sum and the scatter-add routes;

plus single-query budgets, deletes and compaction, ``add_batch`` against
``add``, sampling and ``tune_upper_bound``, ``early_terminate_threshold``,
and the host CSR and segment descriptors, which must be bit-equal.

Tolerance: scores rtol 1e-5, atol 1e-6. Ids must be equal where the
reference's scores are untied; tie groups inside a row are compared as
sets, and the group at the last column by its scores only.

On the dense-head route the port departs from the reference on purpose
(ROADMAP queue 3): the reference's head codes clip at the value bound, so
a doc that repeats a dim loses its nomination, and its rescores keep a doc
once per nominating posting, so copies crowd docs out. There the port must
find the exact top-k (against a brute-force score) and be at least as good
as the reference, column by column."""

import numpy as np
import pytest
import torch

from cosdata_tpu.indexes import inverted as JI
from cosdata_tpu_torch.indexes import inverted as TI

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
K = 10


def zipf_corpus(n, vocab, nnz, seed, scale=20):
    rng = np.random.default_rng(seed)
    dims = (rng.pareto(1.2, size=(n, nnz)) * scale).astype(np.int64) % vocab
    vals = rng.gamma(2.0, 0.8, size=(n, nnz)).astype(np.float32)
    return dims, vals


def rare_queries(dims, vals, rows, nnz_q):
    """Each query: a doc's nnz_q rarest (highest) dims with its values."""
    out = []
    for j in rows:
        pick = np.argsort(dims[j])[-nnz_q:]
        out.append([(int(d), float(v)) for d, v in zip(dims[j][pick], vals[j][pick])])
    return out


def build(dims, vals, deletes=(), **kw):
    """The same corpus in both indexes, through add_batch."""
    n, nnz = dims.shape
    kw.setdefault("values_upper_bound", 5.0)
    j = JI.InvertedIndex(quantization=64, **kw)
    t = TI.InvertedIndex("cpu", quantization=64, **kw)
    for idx in (j, t):
        idx.add_batch(np.arange(n), dims.ravel(), vals.ravel(), np.full(n, nnz))
        for i in deletes:
            idx.delete(i)
        idx.flush()
    return j, t


def _untied(s):
    """Positions whose score differs from both neighbours; the last column
    counts as tied (a score just past the top-k may equal it)."""
    s = np.asarray(s, np.float64)
    tol = RTOL * np.abs(s) + ATOL
    gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [0.0]]) > tol)


def same_results(t_out, j_out):
    """search() outputs (ids, scores) of the port against the reference's."""
    ti, ts = (np.asarray(x) for x in t_out)
    ji, js = (np.asarray(x) for x in j_out)
    assert ti.shape == ji.shape and ts.shape == js.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    for srow, trow, jrow in zip(js, ti, ji):
        u = _untied(srow)
        assert (trow[u] == jrow[u]).all(), (trow, jrow)
        start = 0
        for pos in range(1, len(srow)):
            if abs(srow[pos] - srow[pos - 1]) > RTOL * abs(srow[pos - 1]) + ATOL:
                assert set(trow[start:pos]) == set(jrow[start:pos])
                start = pos
    assert (ji[:, 0] >= 0).all()


@pytest.fixture(scope="module")
def corpus():
    dims, vals = zipf_corpus(4096, 2000, 24, 0)
    return dims, vals, rare_queries(dims, vals, range(0, 160, 10), 8)


def spy(monkeypatch, module, name):
    """Count the calls of module.name."""
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    return calls


def test_exhaustive_route(corpus, monkeypatch):
    from cosdata_tpu_torch.ops import sparse_kernels as TK

    dims, vals, queries = corpus
    calls = spy(monkeypatch, TK, "candidates_rescore_topk")
    j, t = build(dims, vals, deletes=(0, 30, 77))
    assert t.n_cap < TI.EXHAUSTIVE_MAX_CAP and not len(t._head_didx)
    same_results(t.search(queries, K), j.search(queries, K))
    assert calls
    # the deleted docs never come back, even for their own terms
    ids, _ = t.search(rare_queries(dims, vals, (0, 30), 8), K)
    assert 0 not in ids[0] and 30 not in ids[1]


def test_single_query_budget(corpus):
    """A lone query gets the whole dispatch budget in both packages."""
    dims, vals, queries = corpus
    j, t = build(dims, vals)
    assert t._effective_budget(1) == j._effective_budget(1) == t.SCAN_BUDGET_TOTAL
    for q in queries[:4]:
        same_results(t.search([q], K), j.search([q], K))


def test_nominate_route(corpus, monkeypatch):
    dims, vals, queries = corpus
    monkeypatch.setattr(JI, "EXHAUSTIVE_MAX_CAP", 1)
    monkeypatch.setattr(TI, "EXHAUSTIVE_MAX_CAP", 1)
    from cosdata_tpu_torch.ops import sparse_kernels as TK

    calls = spy(monkeypatch, TK, "nominate_rescore_topk")
    j, t = build(dims, vals, deletes=(5,))
    same_results(t.search(queries, K), j.search(queries, K))
    assert calls
    # the nomination width switch (the reference's COSDATA_SPARSE_NOM)
    monkeypatch.setenv("COSDATA_SPARSE_NOM", "96")
    monkeypatch.setattr(t, "NOM", 96)
    same_results(t.search(queries, K), j.search(queries, K))


@pytest.fixture
def head_pair(monkeypatch):
    for cls in (JI.InvertedIndex, TI.InvertedIndex):
        monkeypatch.setattr(cls, "HEAD_MIN_CAP", 1024)
        monkeypatch.setattr(cls, "HEAD_MIN_DF", 8)
    dims, vals = zipf_corpus(1500, 400, 16, 11, scale=12)
    j, t = build(dims, vals, deletes=(2, 9))
    return j, t, rare_queries(dims, vals, range(16), 8) + [
        [(int(d), float(v)) for d, v in zip(dims[r][:8], vals[r][:8])] for r in range(16, 32)
    ], dims, vals


def brute_scores(dims, vals, q, dead=()):
    """Exact Σ max(q, 0)·max(v, 0) over each doc's pairs, dead docs -inf."""
    row = np.zeros(dims.max() + 1, np.float64)
    for d, v in q:
        if d < len(row):
            row[d] += max(v, 0.0)
    sc = (row[dims] * np.maximum(vals, 0)).sum(1)
    sc[list(dead)] = -np.inf
    return sc


def exact_and_dominant(t_out, j_out, dims, vals, queries, dead):
    """The port's rows are the exact top-k (tie-tolerant, against brute
    force), with exact scores, and at least as good as the reference's."""
    ti, ts = t_out
    ji, js = j_out
    for q, trow, tsc, jsc in zip(queries, ti, ts, js):
        sc = brute_scores(dims, vals, q, dead)
        kth = np.sort(sc)[-K]
        assert (sc[trow] >= kth - RTOL * abs(kth) - ATOL).all()
        np.testing.assert_allclose(tsc, sc[trow], rtol=RTOL, atol=ATOL)
        assert (tsc >= jsc - RTOL * np.abs(jsc) - ATOL).all()


def test_head_route(head_pair):
    j, t, queries, dims, vals = head_pair
    t_out, j_out = t.search(queries, K), j.search(queries, K)
    exact_and_dominant(t_out, j_out, dims, vals, queries, (2, 9))
    # every head row spans [0, its largest cell]: nothing clips
    codes = t._head_codes_dev.numpy()
    rows = codes.max(1)
    assert len(t._head_didx) > 0 and codes.dtype == np.uint8 and set(rows[: len(t._head_didx)]) == {255}
    # and dequantizes to the reference's codes wherever those did not clip
    ref = np.asarray(j._head_codes_dev).astype(np.float64)
    ub, scale = j.values_upper_bound, t._head_scale.astype(np.float64)[:, None]
    ok = ref < 255
    err = np.abs(codes * scale / 255 - ref * ub / 255)[ok]
    assert (err <= (scale / 255 + ub / 255).repeat(codes.shape[1], 1)[ok]).all()


def test_head_route_exhaustive_oracle(head_pair, monkeypatch):
    """The recall oracle: unbounded budget, every tail slot rescored, head
    product and tail in three calls."""
    j, t, queries, dims, vals = head_pair
    for idx in (j, t):
        idx.SCAN_BUDGET = 1 << 30
    monkeypatch.setenv("COSDATA_SPARSE_EXHAUSTIVE", "1")
    monkeypatch.setattr(t, "EXHAUSTIVE", True)
    exact_and_dominant(t.search(queries, K), j.search(queries, K), dims, vals, queries, (2, 9))


def test_repeated_dim_keeps_its_nomination(monkeypatch):
    """Every doc holds head dim 5 once at the value bound; doc 1199 holds it
    four times. The reference's code clips all of them to 255 and its head
    nominates the lowest ids, so its top-k misses doc 1199, whose exact
    score is four times the others'; the port's row spans the largest
    cell and ranks doc 1199 first."""
    for cls in (JI.InvertedIndex, TI.InvertedIndex):
        monkeypatch.setattr(cls, "HEAD_MIN_CAP", 1024)
        monkeypatch.setattr(cls, "HEAD_MIN_DF", 8)
    n = 1200
    dims = np.stack([np.full(n, 5), 100 + np.arange(n) % 300, 400 + np.arange(n) % 500, np.full(n, 5)], 1)
    dims[:-1, 3] = 900 + np.arange(n - 1) % 200
    vals = np.full((n, 4), 4.0, np.float32)
    rows = [(i, dims[i], vals[i]) for i in range(n)]
    rows[-1] = (n - 1, np.asarray([5, 5, 5, 5]), vals[-1])
    for idx_cls, kw in ((JI.InvertedIndex, {}), (TI.InvertedIndex, {"device": "cpu"})):
        idx = idx_cls(quantization=64, values_upper_bound=4.0, **kw)
        for i, d, v in rows:
            idx.add(i, d, v)
        idx.flush()
        ids, scores = idx.search([[(5, 1.0)]], K)
        if idx_cls is JI.InvertedIndex:
            assert n - 1 not in ids[0]
        else:
            assert ids[0, 0] == n - 1 and scores[0, 0] == 16.0


@pytest.mark.parametrize("route", ["segment", "scatter"])
def test_keep_raw_false_routes(route, monkeypatch):
    """Quantized scores without raw rows: narrow gathers sort + segment-sum,
    wide ones (a 300-dim query: more than 65,536 gathered slots) scatter-add."""
    from cosdata_tpu_torch.ops import sparse_kernels as TK

    dims, vals = zipf_corpus(3000, 1200, 24, 3)
    j, t = build(dims, vals, deletes=(1, 4), keep_raw=False)
    if route == "segment":
        queries = rare_queries(dims, vals, range(12), 8)
    else:
        rng = np.random.default_rng(4)
        queries = [[(int(d), float(v)) for d, v in zip(rng.choice(1200, 300, replace=False),
                                                       rng.uniform(0.5, 4.0, 300))] for _ in range(3)]
    calls = spy(monkeypatch, TK, "csr_segment_topk" if route == "segment" else "csr_accumulate_topk")
    ti, ts = t.search(queries, K)
    ji, js = j.search(queries, K)
    assert calls
    # quantized scores are integer sums: exact
    np.testing.assert_array_equal(ts, js)
    same_results((ti, ts), (ji, js))


def test_segments_and_csr_bit_equal(corpus):
    dims, vals, queries = corpus
    j, t = build(dims, vals, deletes=(3,))
    j._build_csr()
    t._build_csr()
    for name in ("_h_keys", "_h_ids", "_h_buckets", "_dim_uniq", "_dim_start", "_dim_len", "_dim_cnt",
                 "_dim_start_dev", "_raw_dims", "_raw_vals", "_raw_nnz", "_alive"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t._csr_ids.numpy(), np.asarray(j._csr_ids))
    np.testing.assert_array_equal(t._csr_vals.numpy(), np.asarray(j._csr_vals))
    for budget in (700, 65536):
        for a, b in zip(t._segments_batch(queries, budget), j._segments_batch(queries, budget)):
            np.testing.assert_array_equal(a, b)
    # the allocator itself, on a hand-made table
    rng = np.random.default_rng(5)
    p = 40
    qi = np.sort(rng.integers(0, 6, p))
    args = (6, qi, rng.integers(0, 10_000, p) * 128, rng.integers(1, 64, p).astype(np.float32),
            rng.integers(1, 3000, p), np.sort(rng.integers(0, 3000, (p, 66)), axis=1)[:, ::-1].astype(np.int32),
            np.arange(p), np.ones(p, np.float32), 63, 4096, 512)
    for conservative in (True, False):
        for a, b in zip(TI.impact_segments_batch(*args, conservative=conservative),
                        JI.impact_segments_batch(*args, conservative=conservative)):
            np.testing.assert_array_equal(a, b)


def test_delete_and_compaction(corpus):
    dims, vals, queries = corpus
    dead = list(range(0, 4096, 3))  # a third: past the 25% compaction threshold
    j, t = build(dims, vals, deletes=dead)
    assert len(t._h_ids) == len(j._h_ids) < dims.size
    assert t.live_docs == j.live_docs == 4096 - len(dead)
    np.testing.assert_array_equal(t._h_keys, j._h_keys)
    same_results(t.search(queries, K), j.search(queries, K))
    ids, _ = t.search(queries, K)
    assert not np.isin(ids, dead).any()


def test_add_batch_matches_add(corpus):
    dims, vals, queries = corpus
    n = 600
    one = TI.InvertedIndex("cpu", quantization=64, sample_threshold=50)
    bulk = TI.InvertedIndex("cpu", quantization=64, sample_threshold=50)
    ref = JI.InvertedIndex(quantization=64, sample_threshold=50)
    for i in range(n):
        one.add(i, dims[i], vals[i])
        ref.add(i, dims[i], vals[i])
    for i in range(50):
        bulk.add(i, dims[i], vals[i])
    bulk.add_batch(np.arange(50, n), dims[50:n].ravel(), vals[50:n].ravel(), np.full(n - 50, dims.shape[1]))
    for idx in (one, bulk, ref):
        idx.flush()
    a, b, r = (idx.search(queries, K) for idx in (one, bulk, ref))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    same_results(a, r)


def test_sampling_tunes_the_same_bound(corpus):
    dims, vals, queries = corpus
    assert TI.tune_upper_bound(vals.ravel()) == JI.tune_upper_bound(vals.ravel())
    skew = np.concatenate([np.full(990, 2.5), np.full(10, 9.0)])
    assert TI.tune_upper_bound(skew) == JI.tune_upper_bound(skew) == 3.0
    t = TI.InvertedIndex("cpu", quantization=32, sample_threshold=100)
    j = JI.InvertedIndex(quantization=32, sample_threshold=100)
    for idx in (t, j):
        for i in range(99):
            idx.add(i, dims[i], vals[i])
        assert not idx.is_configured
        idx.delete(7)  # purged from the sample buffer
        idx.add(99, dims[99], vals[99])
        assert not idx.is_configured
        idx.add(100, dims[100], vals[100])
    assert t.is_configured and j.is_configured
    assert t.values_upper_bound == j.values_upper_bound
    np.testing.assert_array_equal(t.quantize(vals[:5]), j.quantize(vals[:5]))
    same_results(t.search(queries[:4], K), j.search(queries[:4], K))
    assert t.raw_pairs(7) is None and t.raw_pairs(8) == j.raw_pairs(8)


@pytest.mark.parametrize("threshold", [0.3, 1.0])
def test_early_terminate_threshold(corpus, threshold):
    dims, vals, queries = corpus
    j, t = build(dims, vals, early_terminate_threshold=threshold, keep_raw=False)
    for a, b in zip(t._segments_batch(queries, 65536), j._segments_batch(queries, 65536)):
        np.testing.assert_array_equal(a, b)
    ti, ts = t.search(queries, K)
    ji, js = j.search(queries, K)
    np.testing.assert_array_equal(ts, js)
    same_results((ti, ts), (ji, js))


def test_device_tensors_live_on_the_index_device(corpus):
    dims, vals, queries = corpus
    _, t = build(dims[:500], vals[:500])
    t.search(queries[:2], K)
    for x in (t._csr_ids, t._csr_vals, t._alive_dev, t._doc_dims_dev, t._doc_vals_dev):
        assert x.device == torch.device("cpu")
    assert t._csr_ids.dtype == torch.int32 and t._doc_vals_dev.dtype == torch.float32
