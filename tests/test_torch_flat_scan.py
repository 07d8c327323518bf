"""Port parity: the exact-scan engine (cosdata_tpu_torch/ops/flat_scan.py) and
the u8 scoring helpers against the reference functions on the same inputs.

Tolerances: reranked and u8 scores within rtol 1e-5 (f32 sums taken in
another order); ids equal wherever the reference's scores are untied
(``torch.topk`` and ``lax.top_k`` order ties differently); recall@10
against an exact f32 oracle at least the reference's (its bin selection
runs on bf16 maxima, the port's on f32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import distance as JD
from cosdata_tpu.ops import flat_scan as JF
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.ops import distance as TD
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops import storage as TS
from cosdata_tpu_torch.ops.quantize import QuantizedU8

torch.set_num_threads(1)

D_TRUE, D_PAD, CAP, N, B = 100, 128, 16384, 15000, 16
GROUP, K_BINS, K_FETCH, K, CHUNK = 32, 64, 50, 10, 4096


def _t(x):
    return torch.from_numpy(np.array(x))


def _tq(qj) -> QuantizedU8:
    return QuantizedU8(*(_t(v) for v in qj))


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


@pytest.fixture(scope="module")
def case():
    x, qx = _clustered(N, D_TRUE, B, seed=7)
    lo, hi = -0.3, 0.3
    xp = np.zeros((CAP, D_PAD), np.float32)
    xp[:N, :D_TRUE] = x
    qp = np.zeros((B, D_PAD), np.float32)
    qp[:, :D_TRUE] = qx
    valid = np.zeros(CAP, bool)
    valid[:N] = True
    valid[[3, 40, 1000]] = False  # tombstones
    store = JQ.quantize_u8(jnp.asarray(xp), lo, hi, D_TRUE)
    q = JQ.quantize_u8(jnp.asarray(qp), lo, hi, D_TRUE)
    raw16 = xp.astype(np.float16)
    q16 = qp.astype(np.float16)
    scores = qx @ np.where(valid[:N, None], x, 0).T
    scores[:, ~valid[:N]] = -np.inf
    truth = np.argsort(-scores, axis=1)[:, :K]
    return dict(store=store, q=q, raw16=raw16, q16=q16, valid=valid, lo=lo, hi=hi, truth=truth)


def _recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(np.asarray(ids), truth)])


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    prev = np.full(s.shape, np.inf)
    prev[:, 1:] = s[:, :-1] - s[:, 1:]
    nxt = np.full(s.shape, np.inf)
    nxt[:, :-1] = s[:, :-1] - s[:, 1:]
    return (prev > tol) & (nxt > tol)


def _compare(t_ids, t_vals, j_ids, j_vals):
    j_ids, j_vals = np.asarray(j_ids), np.asarray(j_vals)
    t_ids, t_vals = t_ids.numpy(), t_vals.numpy()
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-5, atol=1e-6)
    u = _untied(j_vals)
    assert u.mean() > 0.5
    np.testing.assert_array_equal(t_ids[u], j_ids[u])


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("rerank", [True, False])
def test_fused_flat_search_codes(case, metric, rerank):
    c = case
    j_ids, j_vals = JF.fused_flat_search_codes(
        metric, D_TRUE, D_PAD, K_BINS, GROUP, K_FETCH, K, CHUNK, rerank,
        c["q"], c["store"], jnp.asarray(c["raw16"]), jnp.asarray(c["q16"]),
        jnp.asarray(c["valid"]), select="bins",
    )
    t_ids, t_vals = TF.fused_flat_search_codes(
        metric, D_TRUE, D_PAD, K_BINS, GROUP, K_FETCH, K, rerank,
        _tq(c["q"]), _tq(c["store"]), _t(c["raw16"]), _t(c["q16"]), _t(c["valid"]),
    )
    assert t_ids.shape == (B, K)
    _compare(t_ids, t_vals, j_ids, j_vals)
    assert _recall(t_ids, c["truth"]) >= _recall(j_ids, c["truth"])
    assert c["valid"][t_ids.numpy()].all()


def test_f16q_then_exact_rerank_sorted(case):
    """The FlatIndex chain: one f16 query tensor feeds the scan and the rerank."""
    c = case
    args = ("cosine", D_TRUE, D_PAD, K_BINS, GROUP, K_FETCH, K_FETCH)
    j_ids, j_vals = JF.fused_flat_search_codes_f16q(
        *args, CHUNK, jnp.asarray(c["q16"]), c["lo"], c["hi"], c["store"],
        jnp.asarray(c["valid"]), select="bins",
    )
    t_ids, t_vals = TF.fused_flat_search_codes_f16q(
        *args, _t(c["q16"]), c["lo"], c["hi"], _tq(c["store"]), _t(c["valid"])
    )
    _compare(t_ids, t_vals, j_ids, j_vals)
    # the rerank alone, on the reference's shortlist
    jr_ids, jr_vals = JF.exact_rerank_sorted(
        "cosine", D_TRUE, D_PAD, K, jnp.asarray(c["q16"]), jnp.asarray(c["raw16"]), j_ids, j_vals
    )
    tr_ids, tr_vals = TF.exact_rerank_sorted(
        "cosine", D_TRUE, D_PAD, K, _t(c["q16"]), _t(c["raw16"]), _t(j_ids).long(), _t(j_vals)
    )
    _compare(tr_ids, tr_vals, jr_ids, jr_vals)
    # and on the port's own shortlist
    to_ids, _ = TF.exact_rerank_sorted(
        "cosine", D_TRUE, D_PAD, K, _t(c["q16"]), _t(c["raw16"]), t_ids, t_vals
    )
    assert _recall(to_ids, c["truth"]) >= _recall(jr_ids, c["truth"]) >= 0.95


def test_bin_table_limit(case, monkeypatch):
    """Above the bin table's limit the scan answers in the approx mode, as
    the reference's falls back to it: its ids on untied slots."""
    c = case
    monkeypatch.setattr(TF, "MAX_BIN_TABLE", B * (CAP // GROUP) - 1)
    monkeypatch.setattr(TF, "CODES_CHUNK", CHUNK)
    j_ids, j_vals = JF.fused_flat_search_codes(
        "cosine", D_TRUE, D_PAD, K_BINS, GROUP, K_FETCH, K, CHUNK, False,
        c["q"], c["store"], c["q"].data, c["q"].mags, jnp.asarray(c["valid"]), select="approx",
    )
    t_ids, t_vals = TF.fused_flat_search_codes(
        "cosine", D_TRUE, D_PAD, K_BINS, GROUP, K_FETCH, K, False,
        _tq(c["q"]), _tq(c["store"]), None, None, _t(c["valid"]),
    )
    _compare(t_ids, t_vals, j_ids, j_vals)


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_score_small_store(case, metric):
    """The small-store path: whole-store u8 scores (ops/distance.score)."""
    c = case
    store = c["store"]._replace(
        data=c["store"].data[:2048], sums=c["store"].sums[:2048], mags=c["store"].mags[:2048]
    )
    want = np.asarray(JD.score(metric, "u8", c["q"], store, D_PAD))
    got = TD.score(metric, "u8", _tq(c["q"]), _tq(store), D_PAD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scores_gathered_and_rerank(case):
    c = case
    ids = np.random.default_rng(3).integers(-1, N, size=(B, 40)).astype(np.int32)
    want = np.asarray(JS._scores_gathered("cosine", "u8", D_PAD, c["q"], c["store"], jnp.asarray(ids)))
    got = TS.scores_gathered("cosine", "u8", D_PAD, _tq(c["q"]), _tq(c["store"]), _t(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    qf = c["q16"].astype(np.float32)
    want = np.asarray(JS._rerank("cosine", jnp.asarray(qf), jnp.asarray(c["raw16"]), jnp.asarray(ids)))
    got = TS.rerank("cosine", _t(qf), _t(c["raw16"]), _t(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_int8_products_do_not_wrap():
    """An int8 torch.mm wraps; the port's code products are exact int32."""
    a = torch.full((2, 256), -128, dtype=torch.int8)
    assert (TD.code_bmm(a, a) == 256 * 128 * 128).all()
    assert (TD.diag_code_dot(a, a[:, None, :].expand(2, 3, 256)) == 256 * 128 * 128).all()
