"""The port's sparse scoring functions (cosdata_tpu_torch/ops/sparse_kernels.py)
against the reference's (cosdata_tpu/ops/sparse_kernels.py, XLA on the CPU)
on the same inputs: a 3,000-doc zipf corpus (vocab 1,500, 24 pairs per doc,
numpy seed 0) in the reference index's own 128-aligned device CSR, its
compact doc rows, and segment descriptors its allocator emits for 12
queries (each a doc's 8 rarest dims).

Tolerance: scores rtol 1e-5, atol 1e-6. Ids must be equal where the
reference's scores are untied; tied positions are compared as sets (the
tie group that reaches the last column only by its scores, since a top-k
cut through a tie may keep different members). Gathers and segment
descriptors must be bit-equal.

The exact rescores differ from the reference on purpose in one way: the
reference returns a doc once per posting that nominated it and dedups on
the host, so copies of a few docs can crowd better ones out of its k_fetch
slots; the port keeps each doc once. Its list then starts with the
reference's list deduplicated and goes on with the docs the copies crowded
out (ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosdata_tpu.indexes.inverted import InvertedIndex as JIndex
from cosdata_tpu.ops import sparse_kernels as JK
from cosdata_tpu_torch.ops import sparse_kernels as TK

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
N, VOCAB, NNZ, NQ, K = 3000, 1500, 24, 12, 10


def zipf_corpus(n, vocab, nnz, seed):
    """bench.py's sparse corpus shape at test scale: zipf-ish dims, gamma values."""
    rng = np.random.default_rng(seed)
    dims = (rng.pareto(1.2, size=(n, nnz)) * 20).astype(np.int64) % vocab
    vals = rng.gamma(2.0, 0.8, size=(n, nnz)).astype(np.float32)
    return dims, vals


def rare_queries(dims, vals, nq, nnz_q):
    """Each query: a doc's nnz_q rarest (highest) dims with its values."""
    out = []
    for j in range(nq):
        pick = np.argsort(dims[j])[-nnz_q:]
        out.append([(int(d), float(v)) for d, v in zip(dims[j][pick], vals[j][pick])])
    return out


def query_rows(dim_uniq, queries, qd):
    q_idx = np.full((len(queries), qd), -1, np.int32)
    q_w = np.zeros((len(queries), qd), np.float32)
    for i, q in enumerate(queries):
        arr = np.asarray(q, np.float64)
        d = arr[:, 0].astype(np.int64)
        pos = np.minimum(np.searchsorted(dim_uniq, d), len(dim_uniq) - 1)
        ok = dim_uniq[pos] == d
        q_idx[i, : ok.sum()] = pos[ok]
        q_w[i, : ok.sum()] = np.maximum(arr[ok, 1].astype(np.float32), 0.0)
    return q_idx, q_w


@pytest.fixture(scope="module")
def inp():
    dims, vals = zipf_corpus(N, VOCAB, NNZ, 0)
    idx = JIndex(quantization=64, values_upper_bound=5.0)
    idx.add_batch(np.arange(N), dims.ravel(), vals.ravel(), np.full(N, NNZ))
    for i in (3, 11, 400):
        idx.delete(i)
    idx._build_csr()
    idx._ensure_doc_rows()
    queries = rare_queries(dims, vals, NQ, 8)
    starts, lens, mults = idx._segments_batch(queries, 2048)
    q_idx, q_w = query_rows(idx._dim_uniq, queries, 8)
    alive = idx._alive.copy()
    return {
        "starts": starts, "lens": lens, "mults": mults,
        "post_ids": np.asarray(idx._csr_ids), "post_vals": np.asarray(idx._csr_vals),
        "doc_dims": np.asarray(idx._doc_dims_dev), "doc_vals": np.asarray(idx._doc_vals_dev),
        "q_idx": q_idx, "q_w": q_w, "alive": alive, "n_cap": idx.n_cap,
    }


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(x)


def _untied(s):
    """Positions whose score differs from both neighbours; the last column
    counts as tied (a score just past the top-k may equal it)."""
    s = np.asarray(s, np.float64)
    tol = RTOL * np.abs(s) + ATOL
    gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [0.0]]) > tol)


def same_topk(t_out, j_out):
    """(scores, ids) of the port against the reference's, row by row."""
    ts, ti = (np.asarray(x) for x in t_out)
    js, ji = (np.asarray(x) for x in j_out)
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    for srow, trow, jrow in zip(js, ti, ji):
        u = _untied(srow)
        assert (trow[u] == jrow[u]).all()
        # tie groups inside the row hold the same ids
        start = 0
        for pos in range(1, len(srow) + 1):
            if pos == len(srow) or abs(srow[pos] - srow[pos - 1]) > RTOL * abs(srow[pos - 1]) + ATOL:
                if pos < len(srow):
                    assert set(trow[start:pos]) == set(jrow[start:pos])
                start = pos


def dedup(out):
    """The reference's (scores, ids) with later copies of an id removed,
    per row, as lists."""
    rows = []
    for srow, irow in zip(*(np.asarray(x) for x in out)):
        seen, keep = set(), []
        for sc, i in zip(srow, irow):
            if i >= 0 and i not in seen:
                seen.add(i)
                keep.append((sc, i))
        rows.append(keep)
    return rows


def starts_with_dedup(t_out, j_out):
    """Port rows hold distinct ids, and each begins with the reference's row
    deduplicated."""
    ts, ti = (np.asarray(x) for x in t_out)
    for srow, irow, want in zip(ts, ti, dedup(j_out)):
        live = irow[irow >= 0]
        assert len(set(live)) == len(live)
        m = len(want)
        assert len(live) >= m
        same_topk(([srow[:m]], [irow[:m]]), ([[w[0] for w in want]], [[w[1] for w in want]]))


def test_score_doc_rows(inp):
    rng = np.random.default_rng(1)
    cand = rng.integers(0, inp["n_cap"], size=(NQ, 300))
    dd, dv = inp["doc_dims"][cand], inp["doc_vals"][cand]
    want = np.asarray(JK._score_doc_rows(j(dd), j(dv), j(inp["q_idx"]), j(inp["q_w"])))
    got = TK._score_doc_rows(t(dd), t(dv), t(inp["q_idx"]), t(inp["q_w"])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_segments(inp, aligned):
    args = ("starts", "lens", "post_ids", "post_vals")
    ji, jv, jok = (np.asarray(x) for x in JK._gather_segments(*(j(inp[a]) for a in args), 512, aligned))
    ti, tv, tok = (x.numpy() for x in TK._gather_segments(*(t(inp[a]) for a in args), 512, aligned))
    assert (tok == jok).all() and jok.any()
    assert (ti[jok] == ji[jok]).all() and (tv[jok] == jv[jok]).all()


@pytest.mark.parametrize("aligned", [True, False])
def test_csr_accumulate_topk(inp, aligned):
    args = ("starts", "lens", "mults", "post_ids", "post_vals", "alive")
    want = JK.csr_accumulate_topk(*(j(inp[a]) for a in args), n_cap=inp["n_cap"], k=K, segcap=512,
                                  aligned=aligned)
    got = TK.csr_accumulate_topk(*(t(inp[a]) for a in args), inp["n_cap"], K, 512, aligned=aligned)
    same_topk(got, want)


@pytest.mark.parametrize("aligned", [True, False])
def test_csr_segment_topk(inp, aligned):
    args = ("starts", "lens", "mults", "post_ids", "post_vals", "alive")
    want = JK.csr_segment_topk(*(j(inp[a]) for a in args), k=K, segcap=512, aligned=aligned)
    got = TK.csr_segment_topk(*(t(inp[a]) for a in args), K, 512, aligned=aligned)
    same_topk(got, want)


@pytest.mark.parametrize("slot_chunk", [1024, 1 << 16])
def test_nominate_rescore_topk(inp, slot_chunk):
    args = ("starts", "lens", "mults", "post_ids", "post_vals", "doc_dims", "doc_vals", "q_idx", "q_w",
            "alive")
    want = JK.nominate_rescore_topk(*(j(inp[a]) for a in args), vocab_pad=2048, k_fetch=40, nom=256,
                                    segcap=512, slot_chunk=slot_chunk, aligned=True)
    got = TK.nominate_rescore_topk(*(t(inp[a]) for a in args), 40, 256, 512, slot_chunk, aligned=True)
    starts_with_dedup(got, want)


@pytest.mark.parametrize("cand_chunk", [700, 2048])
def test_candidates_rescore_topk(inp, cand_chunk):
    args = ("starts", "lens", "post_ids", "doc_dims", "doc_vals", "q_idx", "q_w", "alive")
    want = JK.candidates_rescore_topk(*(j(inp[a]) for a in args), vocab_pad=2048, k_fetch=40, segcap=512,
                                      cand_chunk=cand_chunk, aligned=True)
    got = TK.candidates_rescore_topk(*(t(inp[a]) for a in args), 40, 512, cand_chunk, aligned=True)
    starts_with_dedup(got, want)


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(2)
    codes = np.where(rng.random((128, 4096)) < 0.05, rng.integers(1, 256, (128, 4096)), 0).astype(np.uint8)
    q = np.where(rng.random((NQ, 128)) < 0.2, rng.gamma(2.0, 0.8, (NQ, 128)), 0).astype(np.float32)
    alive = np.ones(4096, bool)
    alive[[5, 77, 3000]] = False
    return codes, q, alive


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_head_matmul_topk(head, chunk):
    codes, q, alive = head
    want = JK.head_matmul_topk(j(q), j(codes), j(alive), k=64, chunk=chunk)
    got = TK.head_matmul_topk(t(q), t(codes), t(alive), 64, chunk)
    same_topk(got, want)


def test_rescore_ids_topk(inp):
    rng = np.random.default_rng(3)
    cand = rng.integers(-1, inp["n_cap"], size=(NQ, 200))
    args = ("doc_dims", "doc_vals", "q_idx", "q_w", "alive")
    want = JK.rescore_ids_topk(j(cand.astype(np.int32)), *(j(inp[a]) for a in args), vocab_pad=2048, k=30)
    got = TK.rescore_ids_topk(t(cand), *(t(inp[a]) for a in args), 30)
    starts_with_dedup(got, want)


def test_head_tail_union_rescore(inp):
    rng = np.random.default_rng(4)
    n_cap = inp["n_cap"]
    codes = np.where(rng.random((128, n_cap)) < 0.05, rng.integers(1, 256, (128, n_cap)), 0).astype(np.uint8)
    q_head = np.where(rng.random((NQ, 128)) < 0.2, rng.gamma(2.0, 0.8, (NQ, 128)), 0).astype(np.float32)
    args = ("starts", "lens", "mults", "post_ids", "post_vals", "doc_dims", "doc_vals", "q_idx", "q_w")
    want = JK.head_tail_union_rescore(
        *(j(inp[a]) for a in args), j(q_head), j(codes), j(inp["alive"]), vocab_pad=2048, top_k=K,
        nom_out=64, nom_width=512, segcap=512, slot_chunk=1 << 16, head_chunk=1024, aligned=True,
    )
    got = TK.head_tail_union_rescore(
        *(t(inp[a]) for a in args), t(q_head), t(codes), t(inp["alive"]), K, 64, 512, 512, 1 << 16,
        1024, True,
    )
    # the union holds the tail's deduplicated nominees, a superset of the
    # reference's: each port row is at least as good, column by column, and
    # keeps every reference doc that scores above the port's last column
    ts, ti = (np.asarray(x) for x in got)
    for srow, irow, want_row in zip(ts, ti, dedup(want)):
        w_s = np.asarray([w[0] for w in want_row])
        m = min(len(w_s), len(srow))
        assert (srow[:m] >= w_s[:m] - (RTOL * np.abs(w_s[:m]) + ATOL)).all()
        kept = {i: sc for sc, i in zip(srow, irow)}
        for sc, i in want_row:
            if sc > srow[-1] + RTOL * abs(srow[-1]) + ATOL:
                np.testing.assert_allclose(kept[i], sc, rtol=RTOL, atol=ATOL)


def test_copies_do_not_crowd_out_docs():
    """Ten docs each hold all twelve query dims: twelve postings nominate
    each, so the reference's 80 slots hold seven of them; the port keeps
    all ten, each once."""
    n_doc, n_dim = 10, 12
    post_ids = np.tile(np.arange(n_doc, dtype=np.int32), n_dim)
    post_ids = np.pad(post_ids.reshape(n_dim, n_doc), ((0, 0), (0, 128 - n_doc)), constant_values=-1).ravel()
    starts = (np.arange(n_dim, dtype=np.int32) * 128)[None, :]
    lens = np.full((1, n_dim), n_doc, np.int32)
    doc_dims = np.tile(np.arange(n_dim, dtype=np.int32), (16, 1))
    doc_vals = (1.0 + np.arange(16, dtype=np.float32)[:, None] / 16) * np.ones((16, n_dim), np.float32)
    q_idx, q_w = np.arange(n_dim, dtype=np.int32)[None, :], np.ones((1, n_dim), np.float32)
    alive = np.ones(16, bool)
    args = (starts, lens, post_ids, doc_dims, doc_vals, q_idx, q_w, alive)
    want = JK.candidates_rescore_topk(*(j(a) for a in args), vocab_pad=128, k_fetch=80, segcap=128,
                                      cand_chunk=2048, aligned=True)
    got = TK.candidates_rescore_topk(*(t(a) for a in args), 80, 128, 2048, aligned=True)
    assert len(dedup(want)[0]) == 7
    live = got[1][0][got[1][0] >= 0].tolist()
    assert live == list(range(9, -1, -1))
