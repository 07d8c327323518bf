"""Port parity of the euclidean and hamming metrics and of the approx
select mode against the reference, on numpy-seeded inputs on the CPU.

Tolerances:

- bit-exact: every hamming function (integer XOR popcounts), the u8
  euclidean scores, and the float euclidean scores on rows of small
  dyadic values (every product and sum is then exact in f32, in any
  order); float euclidean scores of random rows within rtol 1e-5 (the two
  packages sum the f32 dot products in another order);
- the approx select mode (``fused_flat_search_codes`` above the bin table,
  ``MAX_BIN_TABLE`` lowered) against the reference's ``select="approx"``
  on 70,000 x 64 rows (two 65,536-row chunks): scores within rtol 1e-5,
  ids equal wherever the reference's scores are untied;
- the hamming scan-only index and the euclidean HNSWIndex, FlatIndex and
  streamed routes: ids equal on untied slots, scores within rtol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.indexes import flat as JFlat
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import distance as JD
from cosdata_tpu.ops import flat_scan as JF
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.indexes import flat as TFlat
from cosdata_tpu_torch.indexes import hnsw as TH
from cosdata_tpu_torch.ops import distance as TD
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops import quantize as TQ
from cosdata_tpu_torch.ops import storage as TS
from cosdata_tpu_torch.ops.kernels import u8_scan

torch.set_num_threads(1)

D_TRUE, D_PAD = 60, 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(j):
    """A reference quantized batch as the port's (sub-byte planes as int32 words)."""
    if isinstance(j, JQ.QuantizedSubByte):
        return TQ.QuantizedSubByte(_t(np.asarray(j.planes).view(np.int32)), *(_t(v) for v in j[1:]))
    return {JQ.QuantizedU8: TQ.QuantizedU8, JQ.QuantizedFloat: TQ.QuantizedFloat}[type(j)](*(_t(v) for v in j))


def _rows(n, seed, dyadic=False):
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, D_PAD)).astype(np.float32)
    x[:, D_TRUE:] = 0.0
    return (np.round(x * 8) / 8).astype(np.float32) if dyadic else x


def _quantized(kind, seed, n, dyadic=False):
    x = jnp.asarray(_rows(n, seed, dyadic))
    if kind == "u8":
        return JQ.quantize_u8(x, -0.7, 0.8, D_TRUE)
    if kind in ("binary", "quaternary", "octal"):
        return JQ.quantize_subbyte(x, {"binary": 1, "quaternary": 2, "octal": 3}[kind], D_TRUE)
    return getattr(JQ, f"quantize_{kind}")(x)


# (name, reference function, port function, storage kind, dyadic rows)
FUNCTIONS = [
    ("hamming_u8", JD.hamming_u8, TD.hamming_u8, "u8", False),
    ("hamming_subbyte_binary", JD.hamming_subbyte, TD.hamming_subbyte, "binary", False),
    ("hamming_subbyte_quaternary", JD.hamming_subbyte, TD.hamming_subbyte, "quaternary", False),
    ("hamming_subbyte_octal", JD.hamming_subbyte, TD.hamming_subbyte, "octal", False),
    ("hamming_f16", JD.hamming_f16, TD.hamming_f16, "f16", False),
    ("hamming_f16_of_f32", JD.hamming_f16, TD.hamming_f16, "f32", False),
    ("euclidean_u8", JD.euclidean_u8, TD.euclidean_u8, "u8", False),
    ("euclidean_float_f32", JD.euclidean_float, TD.euclidean_float, "f32", True),
    ("euclidean_float_f16", JD.euclidean_float, TD.euclidean_float, "f16", True),
]


@pytest.mark.parametrize("case", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_distance_function_bit_exact(case):
    _, jfn, tfn, kind, dyadic = case
    jq, js = _quantized(kind, 1, 24, dyadic), _quantized(kind, 2, 700, dyadic)
    extra = (D_PAD,) if kind in ("binary", "quaternary", "octal") else ()
    want = np.asarray(jfn(jq, js, *extra))
    got = tfn(_port(jq), _port(js), *extra)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_hamming_from_bits_and_counts():
    """The integer counts equal numpy's XOR popcount of the u8 codes, and
    hamming_from_bits the reference's on 0/1 bits of any width."""
    rng = np.random.default_rng(3)
    qb, vb = rng.integers(0, 2, (17, 1000)).astype(np.int8), rng.integers(0, 2, (90, 1000)).astype(np.int8)
    want = np.asarray(JD.hamming_from_bits(jnp.asarray(qb), jnp.asarray(vb)))
    np.testing.assert_array_equal(TD.hamming_from_bits(_t(qb), _t(vb)).numpy(), want)
    jq, js = _quantized("u8", 4, 9, False), _quantized("u8", 5, 300, False)
    qu = (np.asarray(jq.data).astype(np.int32) + 128).astype(np.uint8)
    vu = (np.asarray(js.data).astype(np.int32) + 128).astype(np.uint8)
    pop = np.unpackbits(qu[:, None, :] ^ vu[None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(TD.hamming_u8(_port(jq), _port(js)).numpy(), pop.astype(np.float32))


@pytest.mark.parametrize("kind", ["f32", "f16"])
def test_euclidean_float_random_rows(kind):
    jq, js = _quantized(kind, 6, 24), _quantized(kind, 7, 700)
    want = np.asarray(JD.euclidean_float(jq, js))
    np.testing.assert_allclose(TD.euclidean_float(_port(jq), _port(js)).numpy(), want, rtol=1e-5, atol=1e-5)


SCORE_CASES = [(m, k) for m in ("euclidean", "hamming") for k in ("u8", "quaternary", "f16", "f32")]


@pytest.mark.parametrize("metric,kind", SCORE_CASES)
def test_score_dispatch(metric, kind):
    """``score`` for every metric and kind: negated distances equal to the
    reference's; euclidean on sub-byte storage raises its ValueError."""
    jq, js = _quantized(kind, 8, 16, True), _quantized(kind, 9, 300, True)
    skind = "subbyte" if kind == "quaternary" else "float" if kind in ("f16", "f32") else kind
    if metric == "euclidean" and skind == "subbyte":
        with pytest.raises(ValueError, match="euclidean unsupported for sub-byte storage"):
            TD.score(metric, skind, _port(jq), _port(js), D_PAD)
        return
    want = np.asarray(JD.score(metric, skind, jq, js, D_PAD))
    np.testing.assert_array_equal(TD.score(metric, skind, _port(jq), _port(js), D_PAD).numpy(), want)


def test_k1_euclidean_plain_chunking_is_invisible(monkeypatch):
    jq, js = _quantized("u8", 10, 8, False), _quantized("u8", 11, 2048, False)
    valid = torch.ones(2048, dtype=torch.bool)
    valid[100] = False
    valid[128:160] = False  # bin 4 wholly invalid
    t = u8_scan.bin_max_terms("euclidean", _port(jq), _port(js), valid, D_PAD)
    whole = u8_scan.u8_bin_max_plain("euclidean", 32, t)
    monkeypatch.setattr(u8_scan, "PLAIN_ROW_CHUNK", 96)
    np.testing.assert_array_equal(u8_scan.u8_bin_max_plain("euclidean", 32, t).numpy(), whole.numpy())
    assert (whole[:, 4] == u8_scan.SINK).all() and (whole[:, 3] > u8_scan.SINK).all()


# ---------------------------------------------------------------- the approx select mode

N_AP, CAP_AP, B_AP, K_FETCH, K = 70_000, 131_072, 16, 50, 10


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    prev = np.full(s.shape, np.inf)
    prev[:, 1:] = s[:, :-1] - s[:, 1:]
    nxt = np.full(s.shape, np.inf)
    nxt[:, :-1] = s[:, :-1] - s[:, 1:]
    return (prev > tol) & (nxt > tol)


def _compare(t_ids, t_vals, j_ids, j_vals, min_untied=0.3):
    j_ids, j_vals = np.asarray(j_ids), np.asarray(j_vals)
    t_ids, t_vals = np.asarray(t_ids), np.asarray(t_vals)
    assert t_ids.shape == j_ids.shape
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-5, atol=1e-6)
    u = _untied(j_vals)
    assert u.mean() > min_untied
    np.testing.assert_array_equal(t_ids[u], j_ids[u])


@pytest.fixture(scope="module")
def approx_case():
    """70,000 clustered rows, each scaled by a factor in [0.5, 1.5] so that
    euclidean, dot and cosine rank differently; 3 tombstones."""
    rng = np.random.default_rng(12)
    centres = rng.standard_normal((700, D_TRUE)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)

    def rows(m):
        x = centres[rng.integers(0, len(centres), m)] + rng.standard_normal((m, D_TRUE)).astype(np.float32) * 0.06
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    x = rows(N_AP) * rng.uniform(0.5, 1.5, (N_AP, 1)).astype(np.float32)
    xp = np.zeros((CAP_AP, D_PAD), np.float32)
    xp[:N_AP, :D_TRUE] = x
    qp = np.zeros((B_AP, D_PAD), np.float32)
    qp[:, :D_TRUE] = rows(B_AP)
    valid = np.zeros(CAP_AP, bool)
    valid[:N_AP] = True
    valid[[3, 40, 66_000]] = False
    store = JQ.quantize_u8(jnp.asarray(xp), -0.4, 0.4, D_TRUE)
    q = JQ.quantize_u8(jnp.asarray(qp), -0.4, 0.4, D_TRUE)
    return dict(store=store, q=q, raw16=xp.astype(np.float16), q16=qp.astype(np.float16), valid=valid)


@pytest.mark.parametrize("rerank", [True, False])
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean", "hamming"])
def test_approx_select_matches_reference(approx_case, metric, rerank, monkeypatch):
    c = approx_case
    monkeypatch.setattr(TF, "MAX_BIN_TABLE", B_AP * (CAP_AP // 32) - 1)
    before = u8_scan.u8_bin_max.launches
    j_ids, j_vals = JF.fused_flat_search_codes(
        metric, D_TRUE, D_PAD, 64, 32, K_FETCH, K, TF.CODES_CHUNK, rerank, c["q"], c["store"],
        jnp.asarray(c["raw16"]), jnp.asarray(c["q16"]), jnp.asarray(c["valid"]), select="approx",
    )
    t_ids, t_vals = TF.fused_flat_search_codes(
        metric, D_TRUE, D_PAD, 64, 32, K_FETCH, K, rerank, _port(c["q"]), _port(c["store"]),
        _t(c["raw16"]), _t(c["q16"]), _t(c["valid"]),
    )
    assert u8_scan.u8_bin_max.launches == before  # the CPU takes the plain version
    # hamming distances are small integers: many ties, fewer slots compared
    _compare(t_ids, t_vals, j_ids, j_vals, 0.05 if metric == "hamming" and not rerank else 0.3)
    assert c["valid"][t_ids.numpy()].all()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_approx_answers_as_bins(approx_case, metric, monkeypatch):
    """The two modes of the port answer alike on untied slots."""
    c = approx_case
    args = (metric, D_TRUE, D_PAD, 64, 32, K_FETCH, K, True, _port(c["q"]), _port(c["store"]),
            _t(c["raw16"]), _t(c["q16"]), _t(c["valid"]))
    b_ids, b_vals = TF.fused_flat_search_codes(*args)
    monkeypatch.setattr(TF, "MAX_BIN_TABLE", 0)
    a_ids, a_vals = TF.fused_flat_search_codes(*args)
    _compare(a_ids, a_vals, b_ids, b_vals)


# ---------------------------------------------------------------- indexes


def _unit_scaled(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D_TRUE)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (x * rng.uniform(0.5, 1.5, (n, 1))).astype(np.float32)


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)
    monkeypatch.setenv("COSDATA_FLAT_ENGINE", "codes")
    monkeypatch.setenv("COSDATA_SCAN_SELECT", "approx")
    monkeypatch.delenv("COSDATA_STREAM_CODES", raising=False)
    return monkeypatch


def _index_pair(metric, n, keep_raw=True, kind="u8"):
    j = JH.HNSWIndex(D_TRUE, metric=metric, kind=kind, range_=(-0.3, 0.3), keep_raw=keep_raw,
                     initial_capacity=n, ship_dtype="f32")
    t = TH.HNSWIndex(D_TRUE, "cpu", metric=metric, kind=kind, range_=(-0.3, 0.3), keep_raw=keep_raw,
                     initial_capacity=n)
    return j, t


def _compare_search(t_out, j_out):
    (t_ids, t_sc), (j_ids, j_sc) = t_out, j_out
    np.testing.assert_allclose(t_sc, j_sc, rtol=2e-5, atol=1e-6)
    u = _untied(j_sc, 1e-5)
    assert u.mean() > 0.05
    np.testing.assert_array_equal(np.asarray(t_ids)[u], np.asarray(j_ids)[u])


@pytest.mark.parametrize("cap", [4096, 70_000])
def test_hamming_index_is_scan_only(reference_env, cap):
    """Below and above one scan chunk of capacity: no adjacency, the
    reference's answers with and without the euclidean rerank, a
    tombstone never served, and the streamed route of a spill."""
    n = cap - 100
    x, q = _unit_scaled(n, 20), _unit_scaled(12, 21)
    j, t = _index_pair("hamming", n, keep_raw="host")
    for idx in (j, t):
        idx.add(x)
        assert idx.scan_only
    assert t.adj0.shape[0] == 1 and t.up_adj.shape[0] == 1 and t.n_up == 0
    for rerank in (True, False):
        _compare_search(t.search(q, K, rerank=rerank), j.search(q, K, rerank=rerank))
    victim = int(t.search(q[:1], K)[0][0, 0])
    for idx in (j, t):
        idx.delete(victim)
    assert victim not in t.search(q[:1], K)[0]
    _compare_search(t.search(q, K), j.search(q, K))
    # the port has no graph to keep and streams the scan; the reference
    # keeps "level 0" of a hamming index and its host-codes beam raises
    # (ROADMAP queue 3), so it spills without keep_graph here
    t.force_spill(keep_graph=True)
    j.force_spill()
    for idx in (j, t):
        assert idx.store.codes_on_host and idx.scan_only
    # the reference's spill of a scan-only index leaves its tombstones
    # behind (ROADMAP queue 3) and serves the deleted row again: its lists
    # without that row are in-order subsets of the port's (the dead row
    # also took a slot of the reference's shortlist)
    t_ids, j_ids = t.search(q, K)[0], np.asarray(j.search(q, K)[0])
    assert victim in j_ids[0] and victim not in t_ids
    for tr, jr in zip(t_ids.tolist(), j_ids.tolist()):
        kept = iter(tr)
        assert all(i in kept for i in jr if i != victim), (tr, jr)


def test_euclidean_index_routes(reference_env):
    """A euclidean u8 HNSWIndex beside the reference's: the graph (bulk
    build), the scan, and after force_spill(keep_graph=True) the streamed
    scan (K1 per chunk in the port) and the host-codes beam."""
    n = 3000
    x, q = _unit_scaled(n, 22), _unit_scaled(16, 23)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    for cls in (JH.HNSWIndex, TH.HNSWIndex):
        reference_env.setattr(cls, "BULK_THRESHOLD", 1000)
    j, t = _index_pair("euclidean", n, keep_raw="host")
    for idx in (j, t):
        idx.add(x)
        assert not idx.scan_only
    recall = lambda ids: np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])  # noqa: E731
    tg, jg = t.search(q, K, ef=64), j.search(q, K, ef=64)
    assert recall(tg[0]) >= recall(jg[0]) - 0.01 and recall(tg[0]) >= 0.9
    _compare_search(t.search_brute(q, K), j.search_brute(q, K))
    assert recall(t.search_brute(q, K)[0]) >= 0.98
    for idx in (j, t):
        idx.force_spill(keep_graph=True)
        assert idx.graph_on_spill
    _compare_search(t.search_brute(q, K), j.search_brute(q, K))
    th, jh = t.search(q, K, ef=64, rerank=False), j.search(q, K, ef=64, rerank=False)
    assert (np.asarray(th[0]) == np.asarray(jh[0])).mean() >= 0.95


@pytest.mark.parametrize("kind,metric", [("u8", "hamming"), ("u8", "euclidean"), ("f32", "euclidean"),
                                         ("f16", "hamming"), ("binary", "hamming")])
def test_flat_index_metrics(reference_env, kind, metric):
    """FlatIndex above the scan threshold, with and without the rerank."""
    n = 70_000
    x, q = _unit_scaled(n, 24), _unit_scaled(8, 25)
    sub = {"binary": 1}.get(kind)
    jk, tk = ("subbyte", "binary") if sub else (kind, kind)
    j = JFlat.FlatIndex(D_TRUE, metric=metric, kind=jk, resolution=sub or 2, range_=(-0.3, 0.3),
                        initial_capacity=n, ship_dtype="f32")
    t = TFlat.FlatIndex(D_TRUE, "cpu", metric=metric, kind=tk, range_=(-0.3, 0.3), initial_capacity=n)
    j.add(x)
    t.add(x)
    for rerank in (True, False):
        _compare_search(t.search(q, K, rerank=rerank), j.search(q, K, rerank=rerank))


def test_subbyte_euclidean_raises_at_score_time():
    t = TFlat.FlatIndex(D_TRUE, "cpu", metric="euclidean", kind="quaternary")
    t.add(_unit_scaled(100, 26))
    with pytest.raises(ValueError, match="euclidean unsupported for sub-byte storage"):
        t.search(_unit_scaled(2, 27), K)


def test_scores_gathered_and_rerank_metrics(approx_case):
    c = approx_case
    ids = np.random.default_rng(28).integers(-1, N_AP, size=(B_AP, 40)).astype(np.int32)
    want = np.asarray(JS._scores_gathered("euclidean", "u8", D_PAD, c["q"], c["store"], jnp.asarray(ids)))
    got = TS.scores_gathered("euclidean", "u8", D_PAD, _port(c["q"]), _port(c["store"]), _t(ids).long())
    # XLA fuses the jitted f32 epilogue into multiply-adds: the last bit differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    qf = c["q16"].astype(np.float32)
    for metric in ("euclidean", "hamming"):  # hamming reranks by euclidean distance
        want = np.asarray(JS._rerank(metric, jnp.asarray(qf), jnp.asarray(c["raw16"]), jnp.asarray(ids)))
        got = TS.rerank(metric, _t(qf), _t(c["raw16"]), _t(ids).long()).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TS.scores_gathered("hamming", "u8", D_PAD, _port(c["q"]), _port(c["store"]), _t(ids).long())


def test_euclidean_rp_build(reference_env):
    """The RP-tree bulk build of a euclidean index (thresholds lowered to
    1,000 rows and 512-row leaves in both packages) takes the port's
    euclidean level 0 (EUCLIDEAN_RP_TREES trees and one re-prune of each
    row's list with its incoming edges): every row listed, recall@10 no
    more than 0.01 below the reference's graph."""
    n = 4000
    x, q = _unit_scaled(n, 29), _unit_scaled(32, 30)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    for cls in (JH.HNSWIndex, TH.HNSWIndex):
        reference_env.setattr(cls, "BULK_THRESHOLD", 1000)
        reference_env.setattr(cls, "RP_THRESHOLD", 1000)
        reference_env.setattr(cls, "RP_LEAF", 512)
    calls = []
    reprune = TH.HNSWIndex._reprune_level0
    reference_env.setattr(TH.HNSWIndex, "_reprune_level0", lambda self, *a: calls.append(1) or reprune(self, *a))
    j, t = _index_pair("euclidean", n)
    for idx in (j, t):
        idx.add(x)
    assert calls == [1] * TH.HNSWIndex.EUCLIDEAN_REPRUNE
    assert (t.adj0[:n] >= 0).sum(1).min() > 0
    recall = lambda ids: np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])  # noqa: E731
    rt, rj = recall(t.search(q, K, ef=64)[0]), recall(np.asarray(j.search(q, K, ef=64)[0]))
    assert rt >= rj - 0.01, (rt, rj)
