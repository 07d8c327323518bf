"""Port parity of the spill tiers' storage layer (cosdata_tpu_torch/ops/
storage.py and the streamed scan of ops/flat_scan.py) against the
reference's VectorStore and ``streamed_flat_topk``, on numpy rows made
from a seed (100-dim rows, so the lane padding to 128 is exercised).

- Host and disk raw rows round-trip through growth (the old memmap file
  is unlinked, the new one holds every row), as the reference's do.
- ``device_nbytes`` equals the reference's for every kind and tier, at
  the store's capacity and at a larger one, spilled or not.
- A store with raw rows on the device refuses growth past the budget with
  the reference's RuntimeError; a spillable one spills.
- Rows added to a spilled store hold the reference's host-tier codes, sums
  and magnitudes bit for bit (u8 over (-1.3, 0.7), sub-byte res 1/2/3).
- ``rerank_scores_host`` (cosine, dot; host and disk rows) within rtol 1e-5.
- ``streamed_flat_topk`` over 2,048-row chunks (STREAM_CHUNK lowered in
  both packages), with tombstones and a filter mask, against the
  reference's plain merge and, for u8, its codes merge (the Pallas K1 in
  interpret mode): scores within rtol 2e-5, ids equal where the
  reference's scores are untied."""

import os

import numpy as np
import pytest
import torch

from cosdata_tpu.ops import flat_scan as JF
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops import storage as TS

torch.set_num_threads(1)

DIM = 100
#: a budget of 4 KB: every kind's first growth past 128 rows spills
TINY_GB = str(4 / (1 << 20))
KINDS = {"u8": ("u8", 2), "binary": ("subbyte", 1), "quaternary": ("subbyte", 2), "octal": ("subbyte", 3)}
RANGE = (-1.3, 0.7)


def _rows(n, seed, scale=0.6):
    return (np.random.default_rng(seed).normal(size=(n, DIM)) * scale).astype(np.float32)


def _pair(kind, res, keep_raw, cap=128, metric="cosine"):
    j = JS.VectorStore(dim=DIM, kind=kind, metric=metric, resolution=res, range=RANGE, keep_raw=keep_raw,
                       initial_capacity=cap, ship_dtype="f32")
    t = TS.VectorStore(dim=DIM, device="cpu", kind=kind, metric=metric, resolution=res, range=RANGE,
                       keep_raw=keep_raw, initial_capacity=cap)
    return j, t


def _untied(s, rtol=2e-5):
    """Columns of a descending score row with no near-tie on either side;
    the last column is never counted (it may tie with a row cut off)."""
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-6
    with np.errstate(invalid="ignore"):  # -inf - -inf
        gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [0.0]]) > tol)


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_raw_tier_round_trip_and_growth(tier):
    j, t = _pair("u8", 2, tier)
    x = _rows(700, 1)
    first = t._raw_path
    j.add(x[:100])
    t.add(x[:100])
    t.add(x[100:])  # grows 128 -> 640 (doubling to n + b)
    j.add(x[100:])
    assert t.capacity == j.capacity and t.n == j.n == 700
    if tier == "disk":
        assert isinstance(t._raw_mm, np.memmap) and os.path.basename(t._raw_path).startswith("cosdata_raw_")
        assert t._raw_path != first and not os.path.exists(first) and os.path.exists(t._raw_path)
        assert t._raw_mm.shape == (t.capacity, t.dim_pad)
    else:
        assert t.raw_host.dtype == torch.float32 and not t.raw_host.is_pinned()
    rows = np.array([0, 99, 100, 511, 699])
    np.testing.assert_array_equal(t.raw_rows(rows).numpy(), j.raw_rows(rows))
    np.testing.assert_array_equal(t.raw_rows(rows).numpy(), x[rows])
    assert t.raw_on_host and t.raw is None and t.device_nbytes() == j.device_nbytes()
    path = t._raw_path
    t.close()
    if tier == "disk":
        assert not os.path.exists(path) and t.raw_host is None


@pytest.mark.parametrize("keep_raw", [True, False, "host", "disk"])
@pytest.mark.parametrize("kind", ["u8", "binary", "quaternary", "octal", "f16", "f32"])
def test_device_nbytes_matches_reference(kind, keep_raw, monkeypatch):
    k, res = KINDS.get(kind, (kind, 2))
    for raw_dtype in ("f32", "f16"):
        j = JS.VectorStore(dim=DIM, kind=k, resolution=res, keep_raw=keep_raw, raw_dtype=raw_dtype,
                           initial_capacity=300)
        t = TS.VectorStore(dim=DIM, device="cpu", kind=k, resolution=res, keep_raw=keep_raw,
                           raw_dtype=raw_dtype, initial_capacity=300)
        assert t.device_nbytes() == j.device_nbytes() > 0
        assert t.device_nbytes(4096) == j.device_nbytes(4096)
        assert t._spillable() == j._spillable()
        if t._spillable():
            monkeypatch.setenv("COSDATA_HBM_GB", TINY_GB)
            j.add(_rows(3000, 2))
            t.add(_rows(3000, 2))
            monkeypatch.delenv("COSDATA_HBM_GB")
            assert t.codes_on_host and j.codes_on_host
            assert t.device_nbytes() == j.device_nbytes() == 0
            assert t.device_nbytes(4096) == j.device_nbytes(4096)
        t.close()


def test_budget_reads_the_reference_setting(monkeypatch):
    monkeypatch.delenv("COSDATA_HBM_GB", raising=False)
    assert TS.device_budget_bytes("cpu") is None
    monkeypatch.setenv("COSDATA_HBM_GB", "1.5")
    assert TS.device_budget_bytes("cpu") == JS.hbm_budget_bytes() == 3 << 29


def test_device_raw_over_budget_raises(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", TINY_GB)
    for store in _pair("u8", 2, True):
        with pytest.raises(RuntimeError, match="raw_storage") as err:
            store.add(_rows(500, 3))
        assert "growing the store to 512 rows" in str(err.value)
    # f16/f32 stores never spill either
    t = TS.VectorStore(dim=DIM, device="cpu", kind="f32", keep_raw=False, initial_capacity=128)
    with pytest.raises(RuntimeError, match="raw_storage"):
        t.add(_rows(500, 3))


@pytest.mark.parametrize("kind", list(KINDS))
def test_spilled_add_matches_host_tier_bit_for_bit(kind, monkeypatch):
    """Rows quantized on the device and copied to the host tier equal the
    reference's host quantizer's codes, sums and magnitudes bit for bit."""
    k, res = KINDS[kind]
    j, t = _pair(k, res, False)
    monkeypatch.setenv("COSDATA_HBM_GB", TINY_GB)
    x = _rows(700, 4, scale=0.8)
    x[0, :5] = [-1.3, 0.7, 1.0, -1.0, 0.0]  # range and bucket edges
    j.add(x[:300])
    t.add(x[:300])
    j.add(x[300:])  # a second add into the spilled tier, after growth
    t.add(x[300:])
    assert j.codes_on_host and t.codes_on_host and t.capacity == j.capacity
    ja, ta = j._arrays, t.arrays
    padded = j._pad_dims_np(x)
    if k == "u8":
        want_codes = j._host_quantize_u8(padded)
        np.testing.assert_array_equal(ta.data[: t.n].numpy(), want_codes)
        np.testing.assert_array_equal(ta.data.numpy(), ja.data)
        np.testing.assert_array_equal(ta.sums[: t.n].numpy(), want_codes.sum(axis=1, dtype=np.int32))
    else:
        planes, sums, mags = j._host_quantize_subbyte(padded)
        np.testing.assert_array_equal(ta.planes[:, : t.n].numpy().view(np.uint32), planes)
        np.testing.assert_array_equal(ta.planes.numpy().view(np.uint32), ja.planes)
        np.testing.assert_array_equal(ta.sums[: t.n].numpy(), sums)
        np.testing.assert_array_equal(ta.mags[: t.n].numpy(), mags)
    # every row, empty ones included: the same bits as the reference's tier
    np.testing.assert_array_equal(ta.sums.numpy(), ja.sums)
    np.testing.assert_array_equal(ta.mags.numpy().view(np.uint32), np.asarray(ja.mags).view(np.uint32))


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_rerank_scores_host(metric, tier):
    j, t = _pair("u8", 2, tier, metric=metric)
    x, q = _rows(600, 5), _rows(6, 6)
    j.add(x)
    t.add(x)
    ids = np.random.default_rng(7).integers(0, 600, size=(6, 40))
    ids[2, 5:] = -1  # padding ids score row 0; callers mask them
    want = j.rerank_scores_host(q, ids)
    got = t.rerank_scores_host(q, ids)
    assert got.shape == want.shape == (6, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got_ids, got_s = t.rerank_host_topk(q, ids, 10)
    want = np.where(ids >= 0, want, -np.inf)
    order = np.argsort(-want, axis=1, kind="stable")[:, :10]
    np.testing.assert_allclose(got_s, np.take_along_axis(want, order, 1), rtol=1e-5, atol=1e-6)
    for g, w, s in zip(got_ids, np.take_along_axis(ids, order, 1), np.take_along_axis(want, order, 1)):
        u = _untied(s, 1e-5)
        assert (g[u] == w[u]).all()
    t.close()


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setattr(JF, "STREAM_CHUNK", 2048)
    monkeypatch.setattr(TF, "STREAM_CHUNK", 2048)
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)
    monkeypatch.delenv("COSDATA_STREAM_CODES", raising=False)
    return monkeypatch


def _compare_topk(t_s, t_i, j_s, j_i):
    t_s, t_i = t_s.numpy(), t_i.numpy()
    j_s, j_i = np.asarray(j_s), np.asarray(j_i)
    assert t_s.shape == j_s.shape
    np.testing.assert_allclose(t_s, j_s, rtol=2e-5, atol=1e-6)
    agree = total = 0
    for ts_, ti_, js_, ji_ in zip(t_s, t_i, j_s, j_i):
        u = _untied(js_)
        assert (ti_[u] == ji_[u]).all()
        agree += u.sum()
        total += len(u)
    assert agree > 0  # 1-bit codes tie most scores: few columns are compared there


@pytest.mark.parametrize("kind", list(KINDS))
def test_streamed_flat_topk_matches_reference(kind, streamed):
    k, res = KINDS[kind]
    j, t = _pair(k, res, False)
    streamed.setenv("COSDATA_HBM_GB", TINY_GB)
    x, q = _rows(5000, 8), _rows(7, 9)
    j.add(x)
    t.add(x)
    assert j.codes_on_host and t.codes_on_host and j.capacity == t.capacity == 5000 + 128 - 5000 % 128
    cap = t.capacity
    rng = np.random.default_rng(10)
    valid = np.zeros(cap, bool)
    valid[: t.n] = True
    valid[::7] = False  # tombstones
    valid &= rng.random(cap) < 0.8  # a filter
    valid_t = torch.from_numpy(valid)
    for metric in ("cosine", "dot"):
        for k_fetch in (10, 50):
            j_s, j_i = JF.streamed_flat_topk(metric, j, q, k_fetch, valid)
            t_s, t_i = TF.streamed_flat_topk(metric, t, q, k_fetch, valid_t)
            _compare_topk(t_s, t_i, j_s, j_i)
            assert TF.streamed_flat_topk.last_stats["chunks"] == -(-t.n // 2048)
            got = t_i.numpy()
            assert valid[got[got >= 0]].all()
            if k == "u8":
                # the reference's codes merge: its Pallas K1 per chunk
                streamed.setenv("COSDATA_STREAM_CODES", "interpret")
                c_s, c_i = JF.streamed_flat_topk(metric, j, q, k_fetch, valid)
                streamed.delenv("COSDATA_STREAM_CODES")
                _compare_topk(t_s, t_i, c_s, c_i)


@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_streamed_metrics_match_reference(metric, streamed):
    """A spilled u8 store streamed by euclidean distance (K1 per chunk in the
    port) and by hamming distance (the plain merge in both packages)."""
    j, t = _pair("u8", 2, False, metric=metric)
    streamed.setenv("COSDATA_HBM_GB", TINY_GB)
    x, q = _rows(5000, 11), _rows(7, 12)
    j.add(x)
    t.add(x)
    assert j.codes_on_host and t.codes_on_host
    valid = np.zeros(t.capacity, bool)
    valid[: t.n] = True
    valid[::7] = False  # tombstones
    for k_fetch in (10, 50):
        j_s, j_i = JF.streamed_flat_topk(metric, j, q, k_fetch, valid)
        t_s, t_i = TF.streamed_flat_topk(metric, t, q, k_fetch, torch.from_numpy(valid))
        _compare_topk(t_s, t_i, j_s, j_i)
        got = t_i.numpy()
        assert valid[got[got >= 0]].all()
