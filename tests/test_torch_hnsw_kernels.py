"""Port parity of the HNSW graph kernels: cosdata_tpu_torch/ops/hnsw_kernels.py,
the graph helpers of ops/topk.py and ops/storage.py, and the module
functions of indexes/hnsw.py, against the reference functions on the same
numpy-seeded inputs (a 2,000 x 64 clustered store, u8, quaternary and
f32, the port's store loaded from the reference's arrays).

Tolerances: integer kernels (id dedup, top-k merges of given scores,
scatter merges, RP splits) are compared exactly; f32 scores at rtol 1e-5,
atol 1e-6. Scores of u8 and sub-byte stores come from exact integer code
dots, but XLA may fuse their f32 epilogue into multiply-adds, so they too
differ in the last bit, and f32 stores sum their products in another
order: a near-tie can flip a selection. So ids and edge lists computed from
scores must agree on at least 99% of the entries (edge lists compared as
sets per row: the diversity heuristic ranks every kept candidate at
``score + 1e9``, which ties them all), and scores at the tolerance above
wherever the ids agree."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import hnsw_kernels as JK
from cosdata_tpu.ops import storage as JS
from cosdata_tpu.ops import topk as JT
from cosdata_tpu_torch.indexes import hnsw as TH
from cosdata_tpu_torch.ops import hnsw_kernels as TK
from cosdata_tpu_torch.ops import storage as TS
from cosdata_tpu_torch.ops import topk as TT

torch.set_num_threads(1)

D, N, CAP, B, M = 64, 2000, 2048, 16, 16
RTOL, ATOL = 1e-5, 1e-6
KINDS = {"u8": ("u8", 2), "quaternary": ("subbyte", 2), "f32": ("f32", 2)}


def _clustered(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(n // 100, 16), d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = np.float32(0.5 / np.sqrt(d))

    def rows(m):
        x = rng.standard_normal((m, d)).astype(np.float32) * noise
        x += centers[rng.integers(0, len(centers), m)]
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return rows(n), rows(nq)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tl(x):
    return torch.from_numpy(np.array(x)).long()


def _j(x):
    return jnp.asarray(np.asarray(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def data():
    x, q = _clustered(N, D, B, seed=5)
    # a level-0 graph: each row's 12 exact neighbors plus 4 random ids
    rng = np.random.default_rng(1)
    nn = np.argsort(-(x @ x.T), axis=1)[:, 1:13]
    adj = np.full((CAP, M), -1, np.int32)
    adj[:N, :12] = nn
    adj[:N, 12:] = rng.integers(0, N, size=(N, 4))
    adj[rng.integers(0, N, 50), 14:] = -1  # ragged rows
    # an upper level over every 10th row, addressed by slots
    members = np.arange(0, N, 10)
    slot = np.full(CAP, -1, np.int32)
    slot[members] = np.arange(len(members))
    sub = x[members]
    up = members[np.argsort(-(sub @ sub.T), axis=1)[:, 1:9]].astype(np.int32)
    return {"x": x, "q": q, "adj": adj, "members": members, "slot": slot, "up": up}


@pytest.fixture(scope="module", params=list(KINDS))
def case(request, data):
    """Reference and port stores and query batches of one kind."""
    kind, res = KINDS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        j = JS.VectorStore(dim=D, kind=kind, metric="cosine", resolution=res, range=(-0.3, 0.3),
                           initial_capacity=CAP, ship_dtype="f32")
        j.add(data["x"])
        arrays = {k: np.asarray(v) for k, v in j._arrays._asdict().items()}
        arrays.update(raw=np.asarray(j._raw), n=j.n, capacity=j.capacity, dim=D, range=j.range)
        t = TS.VectorStore.from_arrays(arrays, metric="cosine", device="cpu")
        jq = j.quantize_queries(data["q"])
        tq = t.quantize_queries(data["q"])
    skind = "float" if kind == "f32" else kind
    return {"name": request.param, "kind": skind, "j": j, "t": t, "jq": jq, "tq": tq, "dp": t.dim_pad}


def _scores_close(got, want):
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _distinct_close(got, want, distinct):
    """Euclidean scores of distinct rows within the tolerance: a row against
    itself is the f32 residue of |x|² + |x|² - 2x·x, which depends on the
    summation order."""
    np.testing.assert_allclose(_n(got)[distinct], np.asarray(want)[distinct], rtol=RTOL, atol=ATOL)


def _ids_agree(got, want, share=0.99):
    got, want = _n(got), np.asarray(want)
    assert got.shape == want.shape
    assert (got == want).mean() >= share, (got == want).mean()


def _row_sets_agree(got, want, share=0.99):
    """Rows compared as sets; at least ``share`` of the reference's entries
    found in the port's rows."""
    got, want = _n(got), np.asarray(want)
    hit = total = 0
    for g, w in zip(got, want):
        w = set(w[w >= 0].tolist())
        hit += len(w & set(g[g >= 0].tolist()))
        total += len(w)
    assert hit >= share * total, (hit, total)


# ---------------------------------------------------------------- ops/topk


@pytest.mark.parametrize("shape", [(4, 50), (3, 5, 40), (2, 512)])
def test_unique_mask_ids(shape):
    ids = np.random.default_rng(sum(shape)).integers(-1, 30, size=shape).astype(np.int32)
    np.testing.assert_array_equal(_n(TT.unique_mask_ids(_tl(ids))), np.asarray(JT.unique_mask_ids(_j(ids))))


def test_merge_topk():
    rng = np.random.default_rng(3)
    va = np.round(rng.normal(size=(6, 20)), 1).astype(np.float32)  # ties
    vb = np.round(rng.normal(size=(6, 30)), 1).astype(np.float32)
    ia, ib = rng.integers(0, 99, (6, 20)), rng.integers(0, 99, (6, 30))
    jv, ji = JT.merge_topk(_j(va), _j(ia.astype(np.int32)), _j(vb), _j(ib.astype(np.int32)), 25)
    tv, ti = TT.merge_topk(_t(va), _tl(ia), _t(vb), _tl(ib), 25)
    np.testing.assert_array_equal(_n(tv), np.asarray(jv))
    np.testing.assert_array_equal(_n(ti), np.asarray(ji))


# ---------------------------------------------------------------- ops/storage


def test_gather_as_queries(case):
    ids = np.random.default_rng(4).integers(0, N, 37)
    want = case["j"].gather_as_queries(_j(ids.astype(np.int32)))
    got = case["t"].gather_as_queries(_tl(ids))
    for w, g in zip(want, got):
        w, g = np.asarray(w), _n(g)
        np.testing.assert_array_equal(g.view(w.dtype) if g.dtype != w.dtype and g.itemsize == w.itemsize else g, w)


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_scores_gathered(case, metric):
    ids = np.random.default_rng(6).integers(-1, N, size=(B, 70)).astype(np.int32)
    want = JS._scores_gathered(metric, case["kind"], case["dp"], case["jq"], case["j"]._arrays, _j(ids))
    got = TS.scores_gathered(metric, case["kind"], case["dp"], case["tq"], case["t"].arrays, _tl(ids))
    _scores_close(got, want)


@pytest.mark.parametrize("res", [1, 2, 3])
def test_word_major_rows_code_dot(res):
    """The beam's sub-byte code dots from word-major codes equal the ones in
    dimension order and numpy's, with padding lanes (d_true 70 of 128)."""
    from cosdata_tpu_torch.ops import distance as TD
    from cosdata_tpu_torch.ops import quantize as TQ
    from cosdata_tpu_torch.ops.kernels.subbyte_scan import word_major_codes

    rng = np.random.default_rng(res)
    x = np.zeros((300, 128), np.float32)
    x[:, :70] = rng.uniform(-1, 1, (300, 70))
    st = TQ.quantize_subbyte(torch.from_numpy(x), res, d_true=70)
    ids = rng.integers(0, 300, size=(8, 40))
    got = TD.diag_code_dot(word_major_codes(st.planes[:, :8]), TS.word_major_rows(st.planes, _tl(ids)))
    want = TD.diag_code_dot(TQ.subbyte_values(st.planes[:, :8], 128), TQ.subbyte_values(st.planes, 128)[_tl(ids)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    step = np.float32(2.0 / (1 << res))
    codes = np.clip(np.floor((x + np.float32(1.0)) / step), 0, (1 << res) - 1).astype(np.int64)
    codes[:, 70:] = 0
    np.testing.assert_array_equal(got.numpy(), np.einsum("bd,bkd->bk", codes[:8], codes[ids]))


# ---------------------------------------------------------------- scoring and selection


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_decode_rows_and_block_scores(case, metric):
    ids = np.random.default_rng(8).integers(0, N, size=(3, 24))
    kind, dp = case["kind"], case["dp"]
    jg = JK._decode_rows(kind, dp, case["j"]._arrays, _j(ids))
    tg = TK._decode_rows(kind, dp, case["t"].arrays, _tl(ids))
    for i, (w, g) in enumerate(zip(jg, tg)):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        if i == 0 and kind == "subbyte":
            # the port's codes are word-major: dimension i*W + w at w*32 + i
            w = w.reshape(*w.shape[:-1], 32, dp // 32).swapaxes(-1, -2).reshape(w.shape)
        np.testing.assert_array_equal(_n(g), w)
    want = JK._block_scores(metric, kind, dp, case["j"]._arrays, *jg, *jg)
    got = TK._block_scores(metric, kind, dp, case["t"].arrays, *tg, *tg)
    if metric == "euclidean":
        _distinct_close(got, want, ids[:, :, None] != ids[:, None, :])
    else:
        _scores_close(got, want)


def test_pairwise_scores(case):
    ids = np.random.default_rng(9).integers(-1, N, size=(300, 32)).astype(np.int32)
    want = JK.pairwise_scores("cosine", case["kind"], case["dp"], _j(ids), case["j"]._arrays, chunk=128)
    got = TK.pairwise_scores("cosine", case["kind"], case["dp"], _tl(ids), case["t"].arrays, chunk=64)
    _scores_close(got, want)


def _candidates(case, w=128, c=32):
    """Each of w nodes' c best distinct candidates by the store's scores,
    desc: (ids (w, c) with padded tails, scores)."""
    rng = np.random.default_rng(10)
    nodes = rng.integers(0, N, w)
    pool = np.stack([rng.choice(np.setdiff1d(np.arange(N), [v]), 200, replace=False) for v in nodes])
    pool = pool.astype(np.int32)
    q = case["j"].gather_as_queries(_j(nodes.astype(np.int32)))
    sc = np.asarray(JS._scores_gathered("cosine", case["kind"], case["dp"], q, case["j"]._arrays, _j(pool)))
    order = np.argsort(-sc, axis=1, kind="stable")[:, :c]
    ids = np.take_along_axis(pool, order, 1)
    sc = np.take_along_axis(sc, order, 1)
    ids[:, -3:] = -1  # padded tails
    return ids, np.where(ids >= 0, sc, -3.0e38).astype(np.float32)


def test_select_diverse(case):
    ids, sc = _candidates(case)
    j_pair = JK.pairwise_scores("cosine", case["kind"], case["dp"], _j(ids), case["j"]._arrays)
    ji, jd = JK.select_diverse(_j(ids), _j(sc), j_pair, 12)
    t_pair = TK.pairwise_scores("cosine", case["kind"], case["dp"], _tl(ids), case["t"].arrays)
    ti, td = TK.select_diverse(_tl(ids), _t(sc), t_pair, 12)
    _row_sets_agree(ti, ji)
    # on the reference's own pair scores the selection is the reference's
    ti, td = TK.select_diverse(_tl(ids), _t(sc), _t(j_pair), 12)
    np.testing.assert_array_equal(_n(ti), np.asarray(ji))
    np.testing.assert_array_equal(_n(td), np.asarray(jd))


def test_merge_neighbors():
    rng = np.random.default_rng(12)
    rows_n, m, t, g = 300, 8, 40, 6
    adj = rng.integers(-1, rows_n, size=(rows_n, m)).astype(np.int32)
    dist = np.where(adj >= 0, rng.random((rows_n, m)), -3.0e38).astype(np.float32)
    rows = rng.choice(rows_n, t, replace=False).astype(np.int32)
    rows[-4:] = -1  # padding rows are dropped, not written to the last row
    inc = rng.integers(-1, rows_n, size=(t, g)).astype(np.int32)
    inc_d = np.where(inc >= 0, rng.random((t, g)), -3.0e38).astype(np.float32)
    for dedup in (True, False):
        ja, jd = JK.merge_neighbors(_j(adj), _j(dist), _j(rows), _j(inc), _j(inc_d), m, dedup=dedup)
        ta, td = TK.merge_neighbors(_t(adj), _t(dist), _t(rows), _t(inc), _t(inc_d), m, dedup=dedup)
        np.testing.assert_array_equal(_n(ta), np.asarray(ja))
        np.testing.assert_array_equal(_n(td), np.asarray(jd))


@pytest.mark.parametrize("causal", [True, False])
def test_wave_scores(case, causal):
    ids = np.random.default_rng(13).choice(N, 64, replace=False)
    jq = case["j"].gather_as_queries(_j(ids.astype(np.int32)))
    want = JK.wave_scores("cosine", case["kind"], case["dp"], jq, _j(ids.astype(np.int32)), case["j"]._arrays,
                          causal=causal)
    tq = case["t"].gather_as_queries(_tl(ids))
    got = TK.wave_scores("cosine", case["kind"], case["dp"], tq, _tl(ids), case["t"].arrays, causal=causal)
    _scores_close(got, want)


# ---------------------------------------------------------------- beam search


@pytest.mark.parametrize("impl", ["bitmask", "ring"])
@pytest.mark.parametrize("level", [0, 1])
def test_beam_search(case, data, impl, level):
    kind, dp = case["kind"], case["dp"]
    if level == 0:
        adj, row_of, use = data["adj"], np.arange(CAP, dtype=np.int32), False
        start = np.full((B, 1), 7, np.int32)
        ef, expand = 48, 4
    else:
        adj, row_of, use = data["up"], data["slot"], True
        start = np.tile(np.array([[0, 10, -1]], np.int32), (B, 1))
        ef, expand = 8, 2
    args = (ef, expand, 512, 40)
    ji, js = JK.beam_search("cosine", kind, dp, *args, case["jq"], case["j"]._arrays, _j(adj), _j(row_of), _j(start),
                            use_row_of=use, visited_impl=impl)
    ti, ts = TK.beam_search("cosine", kind, dp, *args, case["tq"], case["t"].arrays, _t(adj), _t(row_of), _tl(start),
                            use_row_of=use, visited_impl=impl)
    _ids_agree(ti, ji)
    same = _n(ti) == np.asarray(ji)
    np.testing.assert_allclose(_n(ts)[same], np.asarray(js)[same], rtol=RTOL, atol=ATOL)


def test_bitmask_marks_bit_31():
    """Ids whose bit is the word's sign bit mark and probe like any other."""
    visited = torch.zeros((2, 4), dtype=torch.int32)
    ids = torch.tensor([[31, 63, 0, -1], [95, 31, 30, 127]])
    seen, word, bitv = TK._probe_bits(visited, ids)
    assert not seen.any()
    TK._mark_bits(visited, word, bitv, ids >= 0)
    seen, _, _ = TK._probe_bits(visited, ids)
    np.testing.assert_array_equal(seen.numpy(), [[True, True, True, True], [True, True, True, True]])
    assert visited.view(-1).numpy().view(np.uint32).tolist() == [2**31 + 1, 2**31, 0, 0, 2**31 + 2**30, 0, 2**31,
                                                                  2**31]


# ---------------------------------------------------------------- bulk kernels


def test_leaf_knn_gather(case):
    rng = np.random.default_rng(14)
    perm = rng.permutation(N)[:1900]
    leaves = np.full((4, 512), -1, np.int32)
    for i in range(4):
        part = perm[i::4]
        leaves[i, : len(part)] = part
    flat = leaves.reshape(-1)
    pos = np.zeros(CAP, np.int64)
    pos[flat[flat >= 0]] = np.flatnonzero(flat >= 0)
    pos_mem = np.full(2048, -1, np.int32)
    pos_mem[:1900] = pos[perm]
    ji, js = JK.leaf_knn_gather("cosine", case["kind"], case["dp"], 24, 2, _j(leaves), _j(pos_mem), case["j"]._arrays)
    ti, ts = TK.leaf_knn_gather("cosine", case["kind"], case["dp"], 24, 2, _t(leaves), _t(pos_mem), case["t"].arrays)
    _ids_agree(ti, ji)
    same = _n(ti) == np.asarray(ji)
    np.testing.assert_allclose(_n(ts)[same], np.asarray(js)[same], rtol=RTOL, atol=ATOL)


def test_leaf_knn_gather_wide_leaf(case):
    """A leaf of 4,096 rows, where the reference selects by
    ``approx_max_k``: XLA on the CPU computes it exactly, as the port's
    ``torch.topk`` does, so the edges agree there too."""
    perm = np.random.default_rng(15).permutation(N)
    leaves = np.full((1, 4096), -1, np.int32)
    leaves[0, :N] = perm
    pos_mem = np.full(2048, -1, np.int32)
    pos_mem[perm] = np.arange(N)
    ji, js = JK.leaf_knn_gather("cosine", case["kind"], case["dp"], 24, 1, _j(leaves), _j(pos_mem), case["j"]._arrays)
    ti, ts = TK.leaf_knn_gather("cosine", case["kind"], case["dp"], 24, 1, _t(leaves), _t(pos_mem), case["t"].arrays)
    _ids_agree(ti, ji)
    same = _n(ti) == np.asarray(ji)
    np.testing.assert_allclose(_n(ts)[same], np.asarray(js)[same], rtol=RTOL, atol=ATOL)


def _fwd_edges(seed, cap, w, m):
    rng = np.random.default_rng(seed)
    mem = np.full(w, -1, np.int32)
    mem[: cap - 10] = rng.permutation(cap)[: cap - 10]
    fwd = np.full((w, m), -1, np.int32)
    fwd_d = np.full((w, m), -3.0e38, np.float32)
    for i in range(cap - 10):
        nn = rng.choice(cap, size=m, replace=False)
        nn = nn[nn != mem[i]][: m - 1]
        fwd[i, : len(nn)] = nn
        fwd_d[i, : len(nn)] = np.round(rng.uniform(0.1, 1.0, len(nn)), 3)  # ties
    return mem, fwd, fwd_d


def _same_tables(t_out, j_out):
    ta, td = (_n(v) for v in t_out)
    ja, jd = (np.asarray(v) for v in j_out)
    for r in range(ja.shape[0]):
        got = sorted(zip(td[r].tolist(), ta[r].tolist()))
        want = sorted(zip(jd[r].tolist(), ja[r].tolist()))
        assert [d for d, _ in got] == [d for d, _ in want], r
    # ties at a row's cut may pick other ids: almost all entries agree
    _row_sets_agree(ta, ja, 0.98)


@pytest.mark.parametrize("src_chunk", [64, 65536])
def test_apply_forward_and_reverse(monkeypatch, src_chunk):
    cap, m, w = 96, 6, 256
    monkeypatch.setattr(JK, "REV_SRC_CHUNK", src_chunk)
    monkeypatch.setattr(TK, "REV_SRC_CHUNK", src_chunk)
    mem, fwd, fwd_d = _fwd_edges(41, cap, w, m)
    adj = np.full((cap, m), -1, np.int32)
    dist = np.full((cap, m), -3.0e38, np.float32)
    want = JK.apply_forward_and_reverse(_j(adj), _j(dist), _j(mem), _j(fwd), _j(fwd_d), m)
    got = TK.apply_forward_and_reverse(_t(adj), _t(dist), _t(mem), _t(fwd), _t(fwd_d), m)
    _same_tables(got, want)
    # reverse edges again from the finished table
    want = JK.reverse_from_table(want[0], want[1], _j(mem), m)
    got = TK.reverse_from_table(got[0], got[1], _t(mem), m)
    _same_tables(got, want)


def test_reverse_edges_row_chunks():
    """The merge's row chunks (the reference's fori_loop) give the one-pass
    answer."""
    cap, m = 300, 6
    mem, fwd, fwd_d = _fwd_edges(42, cap, cap, m)
    adj = np.full((cap, m), -1, np.int32)
    dist = np.full((cap, m), -3.0e38, np.float32)
    want = JK._reverse_edges_body(_j(adj), _j(dist), _j(mem), _j(fwd), _j(fwd_d), m, m, chunk=128)
    got = TK._reverse_edges_body(_t(adj), _t(dist), _t(mem), _t(fwd), _t(fwd_d), m, m, chunk=100)
    _same_tables(got, want)


def _level0_table(case, data):
    """The fixture graph's rows with scores from the store."""
    adj = data["adj"]
    q = case["j"].gather_as_queries(_j(np.arange(CAP, dtype=np.int32)))
    sc = np.asarray(JS._scores_gathered("cosine", case["kind"], case["dp"], q, case["j"]._arrays, _j(adj)))
    return adj, np.where(adj >= 0, sc, -3.0e38).astype(np.float32)


def test_grouped_scores(case):
    ids = np.random.default_rng(15).integers(0, N, 64)
    cand = np.random.default_rng(16).integers(0, N, size=(64, 20))
    kind, dp = case["kind"], case["dp"]
    jq = JK._decode_rows(kind, dp, case["j"]._arrays, _j(ids))
    jc = JK._decode_rows(kind, dp, case["j"]._arrays, _j(cand))
    tq = TK._decode_rows(kind, dp, case["t"].arrays, _tl(ids))
    tc = TK._decode_rows(kind, dp, case["t"].arrays, _tl(cand))
    want = JK._grouped_scores("cosine", kind, case["j"]._arrays, *jq, *jc)
    got = TK._grouped_scores("cosine", kind, case["t"].arrays, *tq, *tc)
    _scores_close(got, want)


def test_nn_descent_and_finalize(case, data):
    adj, dist = _level0_table(case, data)
    mem = np.full(2048, -1, np.int32)
    mem[:N] = np.arange(N)
    args = ("cosine", case["kind"], case["dp"], M, 4, 256)
    want = JK.nn_descent_round(*args, _j(adj), _j(dist), _j(mem), case["j"]._arrays)
    got = TK.nn_descent_round(*args, _t(adj), _t(dist), _t(mem), case["t"].arrays)
    _row_sets_agree(got[0], want[0])
    # the level-0 tail: forward writes, reverse edges, one descent round, reverse again
    fwd, fwd_d = adj[:N][:, ::-1].copy(), dist[:N][:, ::-1].copy()
    fwd_p = np.full((2048, M), -1, np.int32)
    fwd_p[:N] = fwd
    fwd_dp = np.full((2048, M), -3.0e38, np.float32)
    fwd_dp[:N] = fwd_d
    empty_a, empty_d = np.full((CAP, M), -1, np.int32), np.full((CAP, M), -3.0e38, np.float32)
    want = JK.finalize_level0("cosine", case["kind"], case["dp"], M, 1, 4, 256, _j(empty_a), _j(empty_d), _j(mem),
                              _j(fwd_p), _j(fwd_dp), case["j"]._arrays)
    got = TK.finalize_level0("cosine", case["kind"], case["dp"], M, 1, 4, 256, _t(empty_a), _t(empty_d), _t(mem),
                             _t(fwd_p), _t(fwd_dp), case["t"].arrays)
    _row_sets_agree(got[0], want[0], 0.99)


@pytest.mark.parametrize("heuristic", [True, False])
def test_upper_level_exact_and_apply(case, data, heuristic):
    members, slot = data["members"], data["slot"]
    mem = np.full(512, -1, np.int32)
    mem[: len(members)] = members
    slots = np.full(512, -1, np.int32)
    slots[: len(members)] = slot[members]
    cap_up = 256
    adj_l = np.full((cap_up, 8), -1, np.int32)
    dist_l = np.full((cap_up, 8), -3.0e38, np.float32)
    want = JK.upper_level_exact("cosine", case["kind"], case["dp"], 8, heuristic, _j(mem), _j(slots), _j(slot),
                                _j(adj_l), _j(dist_l), case["j"]._arrays)
    got = TK.upper_level_exact("cosine", case["kind"], case["dp"], 8, heuristic, _t(mem), _t(slots), _t(slot),
                               _t(adj_l), _t(dist_l), case["t"].arrays)
    _row_sets_agree(got[0], want[0])
    # the large-level tail on given forward edges
    fwd = np.full((512, 8), -1, np.int32)
    fwd[: len(members)] = data["up"]
    fwd_d = np.where(fwd >= 0, np.float32(0.5), np.float32(-3.0e38)) - np.arange(8, dtype=np.float32) * 0.01
    fwd_d = fwd_d.astype(np.float32)
    want = JK.upper_level_apply(8, _j(mem), _j(slots), _j(slot), _j(fwd), _j(fwd_d), _j(adj_l), _j(dist_l))
    got = TK.upper_level_apply(8, _t(mem), _t(slots), _t(slot), _t(fwd), _t(fwd_d), _t(adj_l), _t(dist_l))
    _same_tables(got, want)


def test_gather_pair():
    sc = np.random.default_rng(17).normal(size=(50, 50)).astype(np.float32)
    pos = np.random.default_rng(18).integers(0, 50, size=(50, 7))
    want = JK._gather_pair(_j(sc), _j(pos.astype(np.int32)))
    np.testing.assert_array_equal(_n(TK._gather_pair(_t(sc), _tl(pos))), np.asarray(want))


# ---------------------------------------------------------------- indexes/hnsw.py functions


def test_rp_split_body():
    rng = np.random.default_rng(19)
    n, mp = 1000, 1536
    vals = np.zeros(mp, np.float32)
    vals[:n] = rng.normal(size=n)
    valid = np.arange(mp) < n
    seg = np.zeros(mp, np.int32)
    for lvl in range(3):
        want = np.asarray(JH._rp_split_body(_j(seg), _j(vals), _j(valid), 1 << lvl))
        got = TH._rp_split_body(_tl(seg), _t(vals), _t(valid), 1 << lvl).numpy()
        np.testing.assert_array_equal(got, want)
        seg = want
        vals[:n] = rng.normal(size=n)


def test_merge_candidates():
    rng = np.random.default_rng(20)
    w, c = 64, 40
    cand = rng.integers(-1, 500, size=(w, c)).astype(np.int32)
    cand_s = np.round(rng.normal(size=(w, c)), 2).astype(np.float32)
    wave = rng.choice(np.arange(500, 800), w, replace=False).astype(np.int32)
    wave_s = np.round(rng.normal(size=(w, w)), 2).astype(np.float32)
    ok = rng.random(w) < 0.5
    ji, js = JH._merge_candidates(_j(cand), _j(cand_s), _j(wave_s), _j(wave), _j(ok), 24)
    ti, ts = TH._merge_candidates(_tl(cand), _t(cand_s), _t(wave_s), _tl(wave), _t(ok), 24)
    np.testing.assert_array_equal(_n(ti), np.asarray(ji))
    np.testing.assert_array_equal(_n(ts), np.asarray(js))


@pytest.mark.parametrize("b,span", [(8, 1 << 20), (1024, 1 << 20), (1024, 1 << 22), (4096, 1 << 20)])
def test_visited_impl(b, span):
    assert TH._visited_impl(b, span) == JH._visited_impl(b, span)


def test_fused_search(case, data):
    kind, dp = case["kind"], case["dp"]
    t, j = case["t"], case["j"]
    up_adj = np.full((256, 2, 8), -1, np.int32)
    up_adj[: len(data["members"]), 0] = data["up"]
    alive = np.ones(CAP, bool)
    alive[[3, 77, 1500]] = False
    ef, keep, k = 40, 30, 10
    static = (ef, 8, 4, 512, 40, 1, keep, k, True)
    jq_raw = _j(np.pad(data["q"], ((0, 0), (0, dp - D))))
    ji, js = JH._fused_search(
        "cosine", kind, dp, D, j.resolution, *static, j.range[0], j.range[1], jq_raw, j._arrays, j._raw,
        _j(data["adj"]), _j(up_adj), _j(data["slot"]), _j(alive), jnp.int32(data["members"][0]),
        jnp.asarray([1], jnp.int32),
    )
    ti, ts = TH._fused_search(
        "cosine", kind, dp, D, t.resolution, ef, 8, 4, 512, 40, keep, k, True, t.range[0], t.range[1],
        t.ship_queries(data["q"]), t.arrays, t.raw, _t(data["adj"]), _t(up_adj), _t(data["slot"]), _t(alive),
        int(data["members"][0]), [1],
    )
    _ids_agree(ti, ji)
    same = _n(ti) == np.asarray(ji)
    np.testing.assert_allclose(_n(ts)[same], np.asarray(js)[same], rtol=RTOL, atol=ATOL)
    assert not np.isin(_n(ti), [3, 77, 1500]).any()


@pytest.mark.parametrize("heuristic", [True, False])
def test_bulk_knn_edges(case, heuristic):
    kind, dp = case["kind"], case["dp"]
    nodes = np.random.default_rng(21).choice(N, 100, replace=False)
    valid = np.arange(CAP) < N
    ji, jd = JH._bulk_knn_edges("cosine", kind, dp, 8, 1024, heuristic, _j(nodes.astype(np.int32)),
                                case["j"]._arrays, _j(valid))
    ti, td = TH._bulk_knn_edges("cosine", kind, dp, 8, 1024, heuristic, _tl(nodes), case["t"].arrays, _t(valid))
    # the scans' top-k order their ties differently: compare as sets
    _row_sets_agree(ti, ji, 0.97)
    assert not (_n(ti) == nodes[:, None]).any()


@pytest.mark.parametrize("heuristic", [True, False])
def test_prune_candidates(case, heuristic):
    rng = np.random.default_rng(22)
    nodes = rng.choice(N, 200, replace=False).astype(np.int32)
    parts_i, parts_s = [], []
    for _ in range(2):
        ids = rng.integers(-1, N, size=(200, 30)).astype(np.int32)
        q = case["j"].gather_as_queries(_j(nodes))
        sc = np.asarray(JS._scores_gathered("cosine", case["kind"], case["dp"], q, case["j"]._arrays, _j(ids)))
        parts_i.append(ids)
        parts_s.append(np.where(ids >= 0, sc, -3.0e38).astype(np.float32))
    ji, jd = JH._prune_candidates("cosine", case["kind"], case["dp"], 8, 64, heuristic, _j(nodes),
                                  tuple(_j(p) for p in parts_i), tuple(_j(p) for p in parts_s), case["j"]._arrays)
    ti, td = TH._prune_candidates("cosine", case["kind"], case["dp"], 8, 50, heuristic, _tl(nodes),
                                  tuple(_t(p) for p in parts_i), tuple(_t(p) for p in parts_s), case["t"].arrays)
    _row_sets_agree(ti, ji)


def test_top_m():
    rng = np.random.default_rng(23)
    ids = rng.integers(-1, 99, size=(10, 30)).astype(np.int32)
    sc = np.where(ids >= 0, np.round(rng.normal(size=(10, 30)), 1), -3.0e38).astype(np.float32)
    ji, js = JH._top_m(_j(ids), _j(sc), 12)
    ti, ts = TH._top_m(_tl(ids), _t(sc), 12)
    np.testing.assert_array_equal(_n(ti), np.asarray(ji))
    np.testing.assert_array_equal(_n(ts), np.asarray(js))


def test_merge_neighbors_3d():
    rng = np.random.default_rng(24)
    cap_up, levels, m = 64, 3, 6
    adj = rng.integers(-1, 500, size=(cap_up, levels, m)).astype(np.int32)
    dist = np.where(adj >= 0, rng.random(adj.shape), -3.0e38).astype(np.float32)
    rows = rng.choice(cap_up, 20, replace=False).astype(np.int32)
    rows[-3:] = -1
    inc = rng.integers(-1, 500, size=(20, 4)).astype(np.int32)
    inc_d = np.where(inc >= 0, rng.random((20, 4)), -3.0e38).astype(np.float32)
    ja, jd = JH._merge_neighbors_3d(_j(adj), _j(dist), _j(rows), 1, _j(inc), _j(inc_d), m)
    ta, td = TH._merge_neighbors_3d(_t(adj), _t(dist), _t(rows), 1, _t(inc), _t(inc_d), m)
    np.testing.assert_array_equal(_n(ta), np.asarray(ja))
    np.testing.assert_array_equal(_n(td), np.asarray(jd))


def _wave_chunk(store_arrays, ids_mat, to):
    """The host-codes engine's upload: the unique rows of an id matrix
    (all ids alive here) as a u8 chunk of one package, and their slots."""
    flat = ids_mat.reshape(-1)
    ok = flat >= 0
    uniq, inv = np.unique(flat[ok], return_inverse=True)
    slots = np.full(ids_mat.shape, -1, np.int64)
    slots.reshape(-1)[ok] = inv
    rows = {k: np.asarray(getattr(store_arrays, k))[uniq] for k in ("data", "sums", "mags")}
    return store_arrays._replace(**{k: to(v) for k, v in rows.items()}), slots


def test_spill_graph_engine_not_ported(data):
    """The host-codes graph engine (the spill tier's, ported now under its
    old test name): beam_hostcodes_init, then waves of beam_wave_select and
    beam_wave_merge on a u8 store, in lockstep with the reference's, each
    fed the same uploaded rows. Visited words, candidate ids, expanded
    flags and beam ids agree bit for bit, beam scores at rtol 2e-5."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        j = JS.VectorStore(dim=D, kind="u8", metric="cosine", range=(-0.3, 0.3), initial_capacity=CAP,
                           ship_dtype="f32")
        j.add(data["x"])
        arrays = {k: np.asarray(v) for k, v in j._arrays._asdict().items()}
        arrays.update(n=j.n, capacity=j.capacity, dim=D, range=j.range)
        t = TS.VectorStore.from_arrays(arrays, metric="cosine", device="cpu")
        jq = j.ship_query_codes(data["q"])
    tq = t.ship_query_codes(data["q"])
    rng = np.random.default_rng(9)
    start = np.concatenate([np.full((B, 1), 7), rng.integers(0, N, size=(B, 8))], axis=1)
    start[3, 5] = -1
    start[4, 2] = start[4, 1]  # a duplicate start id
    ef, w, expand = 40, -(-CAP // 32), 8
    jc, slots = _wave_chunk(j._arrays, start, _j)
    tc, _ = _wave_chunk(t.arrays, start, _t)
    ji, js, je, jv = JK.beam_hostcodes_init("cosine", t.dim_pad, ef, w, jq, jc, _j(slots.astype(np.int32)),
                                            _j(start.astype(np.int32)))
    ti, ts, te, tv = TK.beam_hostcodes_init("cosine", t.dim_pad, ef, w, tq, tc, _tl(slots), _tl(start))
    waves = 0
    for _ in range(12):
        np.testing.assert_array_equal(_n(ti), np.asarray(ji))
        np.testing.assert_allclose(_n(ts), np.asarray(js), rtol=2e-5, atol=ATOL)
        np.testing.assert_array_equal(_n(te), np.asarray(je))
        np.testing.assert_array_equal(_n(tv).view(np.uint32), np.asarray(jv))
        jn, je, jv, jdone = JK.beam_wave_select(ji, js, je, jv, _j(data["adj"]), expand)
        tn, te, tv, tdone = TK.beam_wave_select(ti, ts, te, tv, _t(data["adj"]), expand)
        np.testing.assert_array_equal(_n(tn), np.asarray(jn))
        np.testing.assert_array_equal(_n(te), np.asarray(je))
        np.testing.assert_array_equal(_n(tv).view(np.uint32), np.asarray(jv))
        assert bool(tdone) == bool(jdone)
        if bool(jdone):
            break
        nbrs = np.asarray(jn).astype(np.int64)
        jc, slots = _wave_chunk(j._arrays, nbrs, _j)
        tc, _ = _wave_chunk(t.arrays, nbrs, _t)
        ji, js, je = JK.beam_wave_merge("cosine", t.dim_pad, jq, jc, _j(slots.astype(np.int32)), jn, ji, js, je)
        ti, ts, te = TK.beam_wave_merge("cosine", t.dim_pad, tq, tc, _tl(slots), tn, ti, ts, te)
        waves += 1
    assert waves >= 3


# ---------------------------------------------------------------- euclidean


def test_euclidean_pairwise_and_grouped_scores(case):
    ids = np.random.default_rng(31).integers(-1, N, size=(300, 32)).astype(np.int32)
    want = JK.pairwise_scores("euclidean", case["kind"], case["dp"], _j(ids), case["j"]._arrays, chunk=128)
    got = TK.pairwise_scores("euclidean", case["kind"], case["dp"], _tl(ids), case["t"].arrays, chunk=64)
    safe = np.maximum(ids, 0)
    _distinct_close(got, want, safe[:, :, None] != safe[:, None, :])
    rows = np.random.default_rng(32).integers(0, N, 64)
    cand = np.random.default_rng(33).integers(0, N, size=(64, 20))
    kind, dp = case["kind"], case["dp"]
    jq, jc = (JK._decode_rows(kind, dp, case["j"]._arrays, _j(v)) for v in (rows, cand))
    tq, tc = (TK._decode_rows(kind, dp, case["t"].arrays, _tl(v)) for v in (rows, cand))
    want = JK._grouped_scores("euclidean", kind, case["j"]._arrays, *jq, *jc)
    got = TK._grouped_scores("euclidean", kind, case["t"].arrays, *tq, *tc)
    _distinct_close(got, want, rows[:, None] != cand)
    with pytest.raises(ValueError, match="hamming"):
        TK._grouped_scores("hamming", kind, case["t"].arrays, *tq, *tc)


def test_euclidean_build_kernels(case, data):
    """The bulk build's kNN edges, one NN-descent round and an exact upper
    level, all by euclidean distance."""
    kind, dp = case["kind"], case["dp"]
    nodes = np.random.default_rng(34).choice(N, 100, replace=False)
    valid = np.arange(CAP) < N
    edges = (
        lambda: JH._bulk_knn_edges("euclidean", kind, dp, 8, 1024, True, _j(nodes.astype(np.int32)),
                                   case["j"]._arrays, _j(valid)),
        lambda: TH._bulk_knn_edges("euclidean", kind, dp, 8, 1024, True, _tl(nodes), case["t"].arrays, _t(valid)),
    )
    if kind == "subbyte":  # the exact scan scores by distance.score, which refuses it
        for fn in edges:
            with pytest.raises(ValueError, match="euclidean unsupported for sub-byte storage"):
                fn()
    else:
        _row_sets_agree(edges[1]()[0], edges[0]()[0], 0.97)
    adj, dist = _level0_table(case, data)
    mem = np.full(2048, -1, np.int32)
    mem[:N] = np.arange(N)
    args = ("euclidean", kind, dp, M, 4, 256)
    want = JK.nn_descent_round(*args, _j(adj), _j(dist), _j(mem), case["j"]._arrays)
    got = TK.nn_descent_round(*args, _t(adj), _t(dist), _t(mem), case["t"].arrays)
    _row_sets_agree(got[0], want[0])
    members, slot = data["members"], data["slot"]
    mem = np.full(512, -1, np.int32)
    mem[: len(members)] = members
    slots = np.full(512, -1, np.int32)
    slots[: len(members)] = slot[members]
    adj_l = np.full((256, 8), -1, np.int32)
    dist_l = np.full((256, 8), -3.0e38, np.float32)
    want = JK.upper_level_exact("euclidean", kind, dp, 8, True, _j(mem), _j(slots), _j(slot), _j(adj_l),
                                _j(dist_l), case["j"]._arrays)
    got = TK.upper_level_exact("euclidean", kind, dp, 8, True, _t(mem), _t(slots), _t(slot), _t(adj_l),
                               _t(dist_l), case["t"].arrays)
    _row_sets_agree(got[0], want[0])


def test_euclidean_fused_search(case, data):
    kind, dp = case["kind"], case["dp"]
    t, j = case["t"], case["j"]
    up_adj = np.full((256, 2, 8), -1, np.int32)
    up_adj[: len(data["members"]), 0] = data["up"]
    alive = np.ones(CAP, bool)
    alive[[3, 77, 1500]] = False
    ef, keep, k = 40, 30, 10
    jq_raw = _j(np.pad(data["q"], ((0, 0), (0, dp - D))))
    ji, js = JH._fused_search(
        "euclidean", kind, dp, D, j.resolution, ef, 8, 4, 512, 40, 1, keep, k, True, j.range[0], j.range[1],
        jq_raw, j._arrays, j._raw, _j(data["adj"]), _j(up_adj), _j(data["slot"]), _j(alive),
        jnp.int32(data["members"][0]), jnp.asarray([1], jnp.int32),
    )
    ti, ts = TH._fused_search(
        "euclidean", kind, dp, D, t.resolution, ef, 8, 4, 512, 40, keep, k, True, t.range[0], t.range[1],
        t.ship_queries(data["q"]), t.arrays, t.raw, _t(data["adj"]), _t(up_adj), _t(data["slot"]), _t(alive),
        int(data["members"][0]), [1],
    )
    _ids_agree(ti, ji)
    same = _n(ti) == np.asarray(ji)
    np.testing.assert_allclose(_n(ts)[same], np.asarray(js)[same], rtol=RTOL, atol=ATOL)
    assert (_n(ts) <= 0).all() and not np.isin(_n(ti), [3, 77, 1500]).any()
