"""Port parity: the plain version of K2's fused entry (the sub-byte score
epilogue, the row mask and the maxima of every 32 rows) and the chunked
scan's shortlist taken from those maxima, against the reference on the
same numpy inputs.

Tolerances: scores within rtol 2e-5 (as tests/test_torch_u8_scan.py holds
K1's epilogue; XLA may contract the reference's epilogue into FMAs), group
maxima equal to the maxima of the port's own scores bit for bit, ids equal
wherever the reference's scores are untied, and with ``ref_select`` the
reference's tie order. The CUDA kernel is held against the same plain
version, bit for bit, on the card by chip_smoke.py (phase 5)."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import flat_scan as JF
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops.pallas import subbyte_scan as JP
from cosdata_tpu.ops.topk import NEG_INF as J_NEG_INF
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops import quantize as TQ
from cosdata_tpu_torch.ops.kernels import group_topk as G
from cosdata_tpu_torch.ops.kernels import subbyte_scan as K
from cosdata_tpu_torch.ops.topk import NEG_INF
from cosdata_tpu_torch.tools import kernel_variants, measure

torch.set_num_threads(1)

D_PAD, C, B = 128, 384, 9
RTOL = 2e-5


def _port(j) -> TQ.QuantizedSubByte:
    """The reference's quantized batch as the port's (uint32 planes as int32 words)."""
    planes = torch.from_numpy(np.asarray(j.planes).view(np.int32).copy())
    return TQ.QuantizedSubByte(planes, *(torch.from_numpy(np.array(v)) for v in j[1:]))


def _batch(n, res, d_true, seed, zero_mags=()):
    """A quantized batch of n rows from a seeded generator, in both packages;
    the rows ``zero_mags`` get a zero magnitude (the cosine's 0 branch)."""
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, D_PAD)).astype(np.float32)
    j = JQ.quantize_subbyte(jnp.asarray(x), res, d_true)
    if len(zero_mags):
        j = j._replace(mags=j.mags.at[np.asarray(zero_mags)].set(0.0))
    return j, _port(j)


def _valid(n, seed):
    v = np.random.default_rng(seed).random(n) < 0.5
    v[:32] = False  # a whole group masked
    v[64:96] = True
    return v


@pytest.mark.parametrize("masked", [False, True], ids=["all", "half"])
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("d_true", [100, D_PAD], ids=["ragged", "full"])
@pytest.mark.parametrize("res", [1, 2, 3])
def test_fused_plain_matches_pallas_scores(res, d_true, metric, masked):
    """(a) scores against the reference's Pallas subbyte_scores in interpret
    mode, masked as its scan masks them; (b) the group maxima are the maxima
    of those scores over each 32 rows."""
    jq, tq = _batch(B, res, d_true, seed=res, zero_mags=[2])
    js, ts = _batch(C, res, d_true, seed=10 + res, zero_mags=[5, 77, 300])
    valid = _valid(C, res) if masked else None
    want = JP.subbyte_scores(metric, jq, js, D_PAD, block=128, interpret=True)
    if masked:
        want = jnp.where(jnp.asarray(valid)[None, :], want, J_NEG_INF)
    want = np.asarray(want)
    scores, gmax = K.subbyte_scores_fused(metric, tq, ts, D_PAD, None if valid is None else torch.from_numpy(valid))
    assert scores.dtype == gmax.dtype == torch.float32
    assert scores.shape == (B, C) and gmax.shape == (B, C // 32)
    np.testing.assert_allclose(scores.numpy(), want, rtol=RTOL, atol=1e-6)
    if metric == "cosine":  # a zero magnitude scores 0 (where the row is valid)
        np.testing.assert_array_equal(scores[2].numpy(), np.where(valid, 0.0, np.float32(NEG_INF)) if masked else 0.0)
        assert (scores[:, 77] == (0.0 if not masked or valid[77] else np.float32(NEG_INF))).all()
    if masked:
        assert (scores[:, ~valid] == np.float32(NEG_INF)).all()
    np.testing.assert_array_equal(gmax.numpy(), scores.view(B, -1, 32).amax(dim=2).numpy())
    np.testing.assert_allclose(gmax.numpy(), want.reshape(B, -1, 32).max(axis=2), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("c", [1, 31, 200, 4128 + 5])
def test_group_maxima_of_a_ragged_store(c):
    """A last group of fewer than 32 rows is the maximum of the rows it has;
    scores are those of subbyte_scores over every row, masked."""
    jq, tq = _batch(4, 2, 100, seed=7)
    _, ts = _batch(c, 2, 100, seed=8)
    valid = torch.from_numpy(np.random.default_rng(c).random(c) < 0.7)
    scores, gmax = K.subbyte_scores_fused("cosine", tq, ts, D_PAD, valid)
    assert gmax.shape == (4, -(-c // 32))
    want = torch.where(valid[None, :], K.subbyte_scores("cosine", tq, ts, D_PAD), NEG_INF)
    np.testing.assert_array_equal(scores.numpy(), want.numpy())
    for g in range(gmax.shape[1]):
        np.testing.assert_array_equal(gmax[:, g].numpy(), want[:, 32 * g : 32 * g + 32].amax(dim=1).numpy())


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper launches nothing: it is the plain code
    product and score_epilogue_plain; subbyte_scores is its unmasked scores."""
    _, tq = _batch(B, 3, 100, seed=1)
    _, ts = _batch(C, 3, 100, seed=2)
    before = (K.subbyte_code_scores.launches, K.unpack_query_codes.launches)
    valid = torch.from_numpy(_valid(C, 3))
    got = K.subbyte_scores_fused("dot", tq, ts, D_PAD, valid)
    cd = K.subbyte_code_scores_plain(tq.planes, ts.planes, D_PAD)
    for a, b in zip(got, K.score_epilogue_plain("dot", tq, ts, cd, valid)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(K.subbyte_scores("dot", tq, ts, D_PAD).numpy(),
                                  K.score_epilogue_plain("dot", tq, ts, cd)[0].numpy())
    assert (K.subbyte_code_scores.launches, K.unpack_query_codes.launches) == before == (0, 0)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("res", [1, 2, 3])
def test_kernel_epilogue_arithmetic(res, metric):
    """The CUDA epilogue's arithmetic, modelled in numpy float32 (each
    product, sum and quotient rounded alone): a² and a·b and b²·d_true
    rounded first, then ((a²·cd) + (a·b)·(s_q + s_v)) + b²·d_true, then the
    division where m_q·m_v > 1e-30, else 0. It must equal the plain
    version bit for bit."""
    _, tq = _batch(B, res, 100, seed=20 + res, zero_mags=[0])
    _, ts = _batch(C, res, 100, seed=30 + res, zero_mags=[9])
    cd = K.subbyte_code_scores_plain(tq.planes, ts.planes, D_PAD).numpy().astype(np.float32)
    f = np.float32
    a, b, dt = f(tq.a), f(tq.b), f(tq.dtrue)
    aa, ab, bbd = f(a * a), f(a * b), f(f(b * b) * dt)
    s = (tq.sums.numpy().astype(np.float32)[:, None] + ts.sums.numpy().astype(np.float32)[None, :]).astype(f)
    dot = ((aa * cd).astype(f) + (ab * s).astype(f)).astype(f) + bbd
    if metric == "cosine":
        den = (tq.mags.numpy()[:, None] * ts.mags.numpy()[None, :]).astype(f)
        with np.errstate(divide="ignore", invalid="ignore"):
            dot = np.where(den > f(1e-30), (dot / den).astype(f), f(0.0))
    got = K.score_epilogue_plain(metric, tq, ts, torch.from_numpy(cd.astype(np.int32)))[0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), dot.astype(f).view(np.int32))


def test_kernel_group_maxima_layout():
    """The kernel's group maxima, modelled on its accumulator layout: lane l
    of a warp holds columns 8j + 2(l % 4) + e (j < 16, e < 2) of a 128-row
    block, so a group of 32 rows is j in 4g..4g+3 across the 4 lanes of a
    quad; each lane's 8 values, then xor-shuffles by 1 and 2, give amax."""
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    lanes = np.zeros((8, 4, 4), np.float32)  # (row, quad lane, group) after the lane's own 8 values
    for quad in range(4):
        for g in range(4):
            cols = [8 * j + 2 * quad + e for j in range(4 * g, 4 * g + 4) for e in range(2)]
            lanes[:, quad, g] = x[:, cols].max(axis=1)
    for mask in (1, 2):
        lanes = np.maximum(lanes, lanes[:, [q ^ mask for q in range(4)], :])
    for quad in range(4):  # every lane of the quad holds the group maxima; lane g writes group g
        np.testing.assert_array_equal(lanes[:, quad, :], x.reshape(8, 4, 32).max(axis=2))


# ---------------------------------------------------------------- the scan's shortlist from the group maxima

CHUNK, N_CHUNKS, KF = 512, 4, 40


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda r: f"res{r}")
def scan_case(request):
    """Four chunks of 512 rows: chunk 1 wholly masked, chunk 2 with 10 valid
    rows (fewer than k), 64 copies of one row spread over chunks 0 and 3 and
    a run of 40 copies of another (deliberate ties), tombstones elsewhere."""
    res = request.param
    rng = np.random.default_rng(40 + res)
    cap = CHUNK * N_CHUNKS
    x = rng.uniform(-1.2, 1.2, size=(cap, D_PAD)).astype(np.float32)
    qx = rng.uniform(-1.2, 1.2, size=(B, D_PAD)).astype(np.float32)
    x[rng.choice(np.r_[0:CHUNK, 3 * CHUNK : cap], 64, replace=False)] = qx[0] * 0.9
    x[3 * CHUNK + 100 : 3 * CHUNK + 140] = qx[1]
    valid = rng.random(cap) < 0.9
    valid[CHUNK : 2 * CHUNK] = False
    valid[2 * CHUNK : 3 * CHUNK] = False
    valid[rng.choice(np.arange(2 * CHUNK, 3 * CHUNK), 10, replace=False)] = True
    js, ts = (JQ.quantize_subbyte(jnp.asarray(x), res, 100),) * 2
    jq = JQ.quantize_subbyte(jnp.asarray(qx), res, 100)
    return res, jq, _port(jq), js, _port(ts), valid


def _untied(s, rtol=RTOL):
    """Positions whose score differs from both neighbours (the last column
    may tie with a row outside the top-k, so it never counts)."""
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    prev = np.full(s.shape, np.inf)
    prev[:, 1:] = s[:, :-1] - s[:, 1:]
    nxt = np.zeros(s.shape)
    nxt[:, :-1] = s[:, :-1] - s[:, 1:]
    return (prev > tol) & (nxt > tol)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_group_shortlist_matches_reference_scan(scan_case, metric):
    """(c) flat_scan_topk's shortlist from the group maxima against the
    reference's exact per-chunk scan: scores within rtol, ids on untied
    slots, nothing masked returned, ties present."""
    _, jq, tq, js, ts, valid = scan_case
    j_vals, j_ids = JF.flat_scan_topk(metric, "subbyte", D_PAD, KF, CHUNK, jq, js, jnp.asarray(valid), exact=True)
    t_vals, t_ids = TF.flat_scan_topk(metric, "subbyte", D_PAD, KF, CHUNK, tq, ts, torch.from_numpy(valid))
    j_vals, j_ids = np.asarray(j_vals), np.asarray(j_ids)
    np.testing.assert_allclose(t_vals.numpy(), j_vals, rtol=RTOL, atol=1e-6)
    u = _untied(j_vals)
    np.testing.assert_array_equal(t_ids.numpy()[u], j_ids[u])
    assert u.any() and not u[:2, :5].any(), u.mean()  # the copies tie at the top of queries 0 and 1
    found = t_ids.numpy()[t_ids.numpy() >= 0]
    assert valid[found].all() and not ((found >= CHUNK) & (found < 2 * CHUNK)).any()
    for row in t_ids.numpy():  # no row twice
        assert len(set(row[row >= 0])) == (row >= 0).sum()


def test_group_shortlist_chunks_with_few_valid_rows(scan_case):
    """One chunk wholly masked, one with fewer valid rows than k: the scan
    over those two alone returns exactly the 10 valid rows, then -1, as the
    reference does."""
    _, jq, tq, js, ts, valid = scan_case
    sl = slice(CHUNK, 3 * CHUNK)
    js2 = js._replace(planes=js.planes[:, sl], sums=js.sums[sl], mags=js.mags[sl])
    ts2 = ts._replace(planes=ts.planes[:, sl], sums=ts.sums[sl], mags=ts.mags[sl])
    v2 = valid[sl]
    j_vals, j_ids = JF.flat_scan_topk("cosine", "subbyte", D_PAD, KF, CHUNK, jq, js2, jnp.asarray(v2), exact=True)
    t_vals, t_ids = TF.flat_scan_topk("cosine", "subbyte", D_PAD, KF, CHUNK, tq, ts2, torch.from_numpy(v2))
    assert ((t_ids >= 0).sum(dim=1) == 10).all()
    np.testing.assert_array_equal(np.sort(t_ids.numpy()[:, :10], axis=1), np.sort(np.asarray(j_ids)[:, :10], axis=1))
    assert (t_ids[:, 10:] == -1).all() and (t_vals[:, 10:] == np.float32(NEG_INF)).all()
    np.testing.assert_allclose(t_vals.numpy(), np.asarray(j_vals), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("c", [512, 500])
def test_group_topk_equals_full_topk(c):
    """group_topk against a full torch.topk of the same scores (the scan's
    selection before the fused entry), on scores with many ties, a ragged
    last group and whole groups of NEG_INF: the same scores once sorted,
    the same rows on untied slots, and no row twice."""
    rng = np.random.default_rng(c)
    s = rng.integers(0, 40, size=(6, c)).astype(np.float32) / 8
    s[:, rng.random(c) < 0.3] = np.float32(NEG_INF)
    s[:, 64:128] = np.float32(NEG_INF)
    scores = torch.from_numpy(s)
    gmax = torch.nn.functional.pad(scores, (0, -c % 32), value=NEG_INF).view(6, -1, 32).amax(dim=2)
    for k in (1, 10, 37, 200):
        vals, rows = G.group_topk(scores, gmax, k)  # in no order
        vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
        rows = torch.gather(rows, 1, order)
        want_vals, want_rows = torch.topk(scores, k, dim=1)
        np.testing.assert_array_equal(vals.numpy(), want_vals.numpy())
        np.testing.assert_array_equal(np.take_along_axis(s, rows.numpy(), axis=1), vals.numpy())
        assert (rows < c).all()
        u = _untied(want_vals.numpy())
        np.testing.assert_array_equal(rows.numpy()[u], want_rows.numpy()[u])
        for r in rows.numpy():
            assert len(set(r)) == k


def test_ref_select_keeps_the_reference_tie_order(scan_case):
    """(d) ref_select=True selects with lax_top_k over the fused, masked
    scores: ties fall in index order, as the reference's lax.top_k orders
    them, so the ids equal the reference's on every slot where the two
    packages' scores agree bit for bit down the list."""
    _, jq, tq, js, ts, valid = scan_case
    j_vals, j_ids = JF.flat_scan_topk("cosine", "subbyte", D_PAD, KF, CHUNK, jq, js, jnp.asarray(valid), exact=True)
    t_vals, t_ids = TF.flat_scan_topk("cosine", "subbyte", D_PAD, KF, CHUNK, tq, ts, torch.from_numpy(valid),
                                      ref_select=True)
    j_vals, j_ids = np.asarray(j_vals), np.asarray(j_ids)
    np.testing.assert_allclose(t_vals.numpy(), j_vals, rtol=RTOL, atol=1e-6)
    same = np.cumprod(t_vals.numpy() == j_vals, axis=1).astype(bool)  # equal scores up to this slot
    assert same[:2, :10].all()  # the tied copies at the top of queries 0 and 1
    np.testing.assert_array_equal(t_ids.numpy()[same], j_ids[same])
    # the tied copies come in index order
    top0 = t_ids.numpy()[0][t_vals.numpy()[0] == t_vals.numpy()[0, 0]]
    assert len(top0) > 1 and (np.diff(top0) > 0).all()


def test_scan_metrics_outside_the_fused_entry(scan_case):
    """Only cosine and dot take the fused entry: a euclidean sub-byte scan
    raises the reference's ValueError, and a hamming scan takes the plain
    distances and lax_top_k, so its ids and distances are the reference's
    slot for slot."""
    _, jq, tq, js, ts, valid = scan_case
    with pytest.raises(ValueError, match="euclidean unsupported for sub-byte storage"):
        TF.flat_scan_topk("euclidean", "subbyte", D_PAD, KF, CHUNK, tq, ts, torch.from_numpy(valid))
    with pytest.raises(ValueError, match="takes dot or cosine"):
        K.subbyte_scores_fused("euclidean", tq, ts, D_PAD)
    j_vals, j_ids = JF.flat_scan_topk("hamming", "subbyte", D_PAD, KF, CHUNK, jq, js, jnp.asarray(valid), exact=True)
    t_vals, t_ids = TF.flat_scan_topk("hamming", "subbyte", D_PAD, KF, CHUNK, tq, ts, torch.from_numpy(valid))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))


def _keys(x: np.ndarray) -> np.ndarray:
    """f32 -> uint32 keys in the same order, as the group_topk kernel makes them."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _select(keys: np.ndarray, k: int) -> tuple[int, int, int]:
    """The kernel's select of the k largest keys: a bisection on the keys'
    bits from the highest that differs (all equal: the first k of them),
    each bit counting the keys under the prefix that have it set, stopping
    once the keys under the prefix are exactly those still wanted. Returns
    (prefix, mask, quota): the k largest keys are those whose masked key
    is above prefix and the first quota, in index order, of those equal to
    it."""
    lo, hi = int(np.bitwise_and.reduce(keys)), int(np.bitwise_or.reduce(keys))
    if lo == hi:
        return lo, 0xFFFFFFFF, k
    top = (lo ^ hi).bit_length() - 1
    mask = (0xFFFFFFFF << (top + 1)) & 0xFFFFFFFF
    prefix, remaining, live = lo & mask, k, len(keys)
    for bit in range(top, -1, -1):
        if live == remaining:
            break
        m, want = mask | 1 << bit, prefix | 1 << bit
        ones = int(((keys & np.uint32(m)) == want).sum())
        mask = m
        if ones >= remaining:
            prefix, live = want, ones
        else:
            remaining, live = remaining - ones, live - ones
    return prefix, mask, remaining


def _compact(keys: np.ndarray, ok: np.ndarray, sel: tuple[int, int, int]) -> np.ndarray:
    """Positions the kernel keeps, in index order: masked keys above the
    prefix, then ties in index order up to the quota."""
    prefix, mask, quota = sel
    m = keys & np.uint32(mask)
    tie = ok & (m == prefix)
    return np.flatnonzero((ok & (m > prefix)) | (tie & (np.cumsum(tie) - 1 < quota)))


def _model_merge(scores, gmax, top_s, top_i, start, capacity=None):
    """The group_topk kernel's algorithm for one chunk, row by row, in
    numpy: T, the least running value; the groups whose maximum reaches T,
    or, where more than k do, the k best of them by its select (ties in
    index order) and the floor max(T, that select's prefix); the survivors
    (the running entries, then those groups' rows, at or above the floor,
    in index order) into a buffer of ``capacity`` (the kernel's k + 512,
    rounded up to 4, by default); the k best of the buffer: at most 256
    survivors and at most 32 past k drop their smallest (the later of
    equal keys first), else the select keeps the k best; where the
    survivors overflow the buffer, the select runs over every candidate
    with the floor as the filter (the kernel's route over memory). Returns
    (values, ids, per row (groups reaching T, survivors, overflowed))."""
    b, c = scores.shape
    k, g = top_s.shape[1], gmax.shape[1]
    cap = (k + 512 + 3) // 4 * 4 if capacity is None else capacity
    out_s, out_i = np.empty_like(top_s), np.empty_like(top_i)
    stats = []
    for q in range(b):
        t = int(_keys(top_s[q]).min())
        gk = _keys(gmax[q])
        groups = _compact(gk, np.ones(g, bool), (t, 0xFFFFFFFF, 1 << 31))
        passing, floor = len(groups), t
        if passing > k:
            sel = _select(gk, k)
            groups = _compact(gk, np.ones(g, bool), sel)
            floor = max(t, sel[0])
        rows = (groups[:, None] * 32 + np.arange(32)).reshape(-1)
        vals = np.concatenate([top_s[q], scores[q, np.minimum(rows, c - 1)]])
        ids = np.concatenate([top_i[q], start + rows])
        keys = _keys(vals)
        ok = np.concatenate([np.ones(k, bool), rows < c]) & (keys >= floor)
        n = int(ok.sum())
        if n <= 256 and n - k <= 32:  # a few to drop: the smallest, the later of equal keys first
            buf = np.flatnonzero(ok)
            drop = np.lexsort((-buf, keys[buf]))[: n - k]
            keep = np.delete(buf, drop)
        elif n <= cap:
            buf = np.flatnonzero(ok)
            keep = buf[_compact(keys[buf], np.ones(n, bool), _select(keys[buf], k))]
        else:
            keep = _compact(keys, ok, _select(keys[ok], k))
        assert len(keep) == k
        out_s[q], out_i[q] = vals[keep], ids[keep]
        stats.append((passing, n, n > cap))
    return out_s, out_i, stats


def _maxima(s: np.ndarray) -> np.ndarray:
    """The maxima of every 32 rows, the ragged last group's missing rows NEG_INF."""
    b, c = s.shape
    return np.pad(s, ((0, 0), (0, -c % 32)), constant_values=np.float32(NEG_INF)).reshape(b, -1, 32).max(axis=2)


def _merge_chunks(chunks, k, capacity=None, top=None):
    """Merges the (scores, start) chunks into a running top-k (``top``, or
    the empty one) by the kernel's model and by merge_group_topk_plain,
    holding them equal after every chunk: the same sorted values, the same
    ids on untied slots, no id twice. Returns each chunk's model stats."""
    b = chunks[0][0].shape[0]
    if top is None:
        top = np.full((b, k), np.float32(NEG_INF), np.float32), np.full((b, k), -1, np.int64)
    top_s, top_i = top
    plain_s, plain_i = torch.from_numpy(top_s.copy()), torch.from_numpy(top_i.copy())
    stats = []
    for s, start in chunks:
        gmax = _maxima(s)
        top_s, top_i, st = _model_merge(s, gmax, top_s, top_i, start, capacity)
        plain_s, plain_i = G.merge_group_topk(torch.from_numpy(s), torch.from_numpy(gmax), plain_s, plain_i, start)
        order = np.argsort(-top_s, axis=1, kind="stable")
        ms, mi = np.take_along_axis(top_s, order, 1), np.take_along_axis(top_i, order, 1)
        ps, pos = torch.sort(plain_s, dim=1, descending=True, stable=True)
        pi = torch.gather(plain_i, 1, pos).numpy()
        np.testing.assert_array_equal(ms, ps.numpy())
        live = ms > NEG_INF / 2
        u = _untied(ms) & live
        np.testing.assert_array_equal(mi[u], pi[u])
        for row, lv in zip(mi, live):
            assert len(set(row[lv])) == lv.sum()
        stats.append(st)
    return stats


@pytest.mark.parametrize("c, k", [(2048, 40), (2048, 200), (500, 40), (512, 64), (4096, 7)])
def test_group_topk_kernel_model_equals_plain(c, k):
    """The group_topk kernel's algorithm (T from the running top-k, the
    groups reaching it or the k best of them, the survivors at or above
    the floor, the select over them, ties in index order), modelled in
    numpy, against merge_group_topk_plain over several chunks: the same
    values, the same ids on untied slots, no id twice. Scores tie often
    (eighths) and whole groups are masked; the first chunk merges into the
    empty running top-k."""
    rng = np.random.default_rng(c + k)
    b = 5
    chunks = []
    for n, start in enumerate(range(0, 3 * c, c)):
        s = (rng.integers(-40, 40, size=(b, c)) / 8).astype(np.float32)
        s[:, rng.random(c) < 0.3] = np.float32(NEG_INF)
        s[:, 64:128] = np.float32(NEG_INF)
        if n == 1:
            s[:] = np.float32(NEG_INF)  # a chunk with every row masked
        chunks.append((s, start))
    _merge_chunks(chunks, k)


def _normal(rng, b, c, shift=0.0):
    return (rng.standard_normal((b, c)) + shift).astype(np.float32)


def _branch_warm_few_groups(rng):
    """Six chunks of untied scores: after the first two, T is high and at
    most k groups reach it, so the group select is skipped."""
    k, c = 20, 4096
    chunks = [(_normal(rng, 5, c), n * c) for n in range(6)]

    def check(stats):
        late = [row for st in stats[2:] for row in st]
        assert all(p <= k for p, _, _ in late) and any(p > 0 for p, _, _ in late)
        assert all(n < k + 32 * p + 1 for p, n, _ in late)
    return chunks, k, None, None, check


def _branch_warm_many_groups(rng):
    """A warm running top far below the chunk's scores: every group
    reaches T, more than k, so the group select runs above a finite T."""
    k, c = 20, 4096
    top = (_normal(rng, 5, k, -6.0), rng.permutation(5 * k).reshape(5, k).astype(np.int64) + (1 << 40))
    chunks = [(_normal(rng, 5, c), 0), (_normal(rng, 5, c, 0.5), c)]

    def check(stats):
        assert all(p == c // 32 for p, _, _ in stats[0])
        assert all(p > k for p, _, _ in stats[1])
    return chunks, k, None, top, check


def _branch_all_tied(rng):
    """Every score equal: k tied groups by index, 32k tied survivors, past
    the buffer (k + 512), so every row takes the route over memory; then a
    chunk tied with the running top itself."""
    k, c = 40, 4096
    chunks = [(np.full((5, c), 0.5, np.float32), 0), (np.full((5, c), 0.5, np.float32), c)]

    def check(stats):
        assert all(p == c // 32 and n == 32 * k and over for p, n, over in stats[0])
        assert all(p == c // 32 and n == k + 32 * k and over for p, n, over in stats[1])
    return chunks, k, None, None, check


def _branch_overflow(rng):
    """A buffer of k + 8: rows with many tied survivors overflow it, rows
    of later chunks fit."""
    k, c = 20, 2048
    chunks = [((rng.integers(-40, 40, size=(5, c)) / 8).astype(np.float32), n * c) for n in range(4)]

    def check(stats):
        rows = [row for st in stats for row in st]
        assert any(over for _, _, over in rows) and any(not over for _, _, over in rows)
    return chunks, k, k + 8, None, check


def _branch_k_at_least_g(rng):
    """k = 40 over chunks of 500 rows (16 groups): every group is a
    candidate, no group select, the running entries fill the count."""
    k, c = 40, 500
    chunks = []
    for n in range(3):
        s = _normal(rng, 5, c)
        s[:, rng.random(c) < 0.5] = np.float32(NEG_INF)
        chunks.append((s, n * c))

    def check(stats):
        assert all(p == -(-c // 32) for p, _, _ in stats[0])
        assert all(p <= -(-c // 32) < k for st in stats for p, _, _ in st)
    return chunks, k, None, None, check


def _branch_ragged(rng):
    """C = 2,065: the last group holds 17 rows (its missing 15 are no
    candidates) and the chunk's best row lies in it."""
    k, c = 10, 2065
    chunks = []
    for n in range(3):
        s = _normal(rng, 5, c)
        s[:, c - 1] = 9.0 + n
        chunks.append((s, n * c))

    def check(stats):
        assert all(n >= k for st in stats for _, n, _ in st)
    return chunks, k, None, None, check


@pytest.mark.parametrize("case", [_branch_warm_few_groups, _branch_warm_many_groups, _branch_all_tied,
                                  _branch_overflow, _branch_k_at_least_g, _branch_ragged],
                         ids=lambda f: f.__name__.removeprefix("_branch_"))
def test_group_topk_kernel_model_branches(case):
    """Each branch of the group_topk kernel, in its numpy model, against
    merge_group_topk_plain over several chunks (values, ids on untied
    slots, no id twice), and the branch taken as the case intends."""
    chunks, k, capacity, top, check = case(np.random.default_rng(7))
    check(_merge_chunks(chunks, k, capacity, top))


def test_group_topk_survivors_need_the_kernel():
    """The survivor counts are the kernel's: CPU tensors refuse them."""
    s = torch.zeros((2, 64))
    top_s, top_i = torch.full((2, 4), NEG_INF), torch.full((2, 4), -1, dtype=torch.int64)
    with pytest.raises(ValueError, match="survivors"):
        G.merge_group_topk(s, torch.zeros((2, 2)), top_s, top_i, 0, torch.zeros((2, 2), dtype=torch.int32))


def test_quaternary_scan_merges_visit_the_scans_merges():
    """tools/measure.quaternary_scan_merges runs flat_scan_topk itself: it
    visits each chunk's merge once, in order, with the running top the
    scan holds there (empty before the first), and the last merge gives
    the scan's answer."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, D_PAD)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, D_PAD)).astype(np.float32))
    x, q = x / x.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    seen = []
    measure.quaternary_scan_merges(x, q, 10, lambda *m: seen.append(m), chunk=128)
    assert [m[0] for m in seen] == [0, 1, 2] and [m[5] for m in seen] == [0, 128, 256]
    assert bool((seen[0][3] == NEG_INF).all()) and bool((seen[0][4] == -1).all())
    for before, after in zip(seen, seen[1:]):
        top_s, top_i = G.merge_group_topk(*before[1:])
        assert torch.equal(top_s, after[3]) and torch.equal(top_i, after[4])
    last_s, _ = G.merge_group_topk(*seen[-1][1:])
    store = TQ.quantize_subbyte(torch.nn.functional.pad(x, (0, 0, 0, 84)), 2, D_PAD)
    want_s, _ = TF.flat_scan_topk("cosine", "subbyte", D_PAD, 10, 128, TQ.quantize_subbyte(q, 2, D_PAD), store,
                                  torch.arange(384) < 300)
    assert torch.equal(torch.sort(last_s, dim=1, descending=True).values, want_s)


@pytest.mark.parametrize("name", list(kernel_variants.VARIANTS))
def test_kernel_variants_edit_the_source(name):
    """Each of tools/kernel_variants.py's variants edits its kernel's
    current source: every text it replaces is there (the tool refuses a
    variant whose text is missing, but only on the card)."""
    kernel, edits = kernel_variants.VARIANTS[name]
    texts = {}
    for edit in edits:
        path, old, new = (f"{kernel}.cu", *edit) if len(edit) == 2 else edit
        text = texts.get(path) or (kernel_variants.CSRC / path).read_text()
        assert text.count(old) == 1, old
        texts[path] = text.replace(old, new)


EMULATION = Path(__file__).parent / "cuda_emulation"


def _host_source(cu: str) -> str:
    """group_topk.cu rewritten for warp_emulation.h: no CUDA header, no
    launch, the shared memory the block's, the asynchronous copies plain
    ones."""
    cu, n = re.subn(r"#include <cuda_runtime.h>\n", "", cu)
    assert n == 1
    cu, n = re.subn(r"  group_topk_kernel<<<.*?>>>\(.*?\);\n", "", cu, flags=re.S)
    assert n == 1
    cu, n = re.subn(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                    r"unsigned char* \1 = g_warp->shared;", cu)
    assert n == 1
    cu, n = re.subn(r'asm volatile\("cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], (\d+);" ::"r"\((\w+)\), '
                    r'"l"\((\w+)\)\);', r"emu_copy(\2, \3, \1);", cu)
    assert n == 2
    cu = re.sub(r'asm volatile\("cp\.async\.(wait_all|commit_group|wait_group \d+);" ::: "memory"\);', "", cu)
    assert "asm" not in cu
    return cu


@pytest.fixture(scope="module")
def group_topk_host(tmp_path_factory):
    """The group_topk kernel's CUDA source built for the host by g++ over
    the warp emulation; returns a function running it on numpy inputs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel's host emulation")
    tmp = tmp_path_factory.mktemp("group_topk_host")
    src = Path(G.LIBRARY.source)
    (tmp / "group_topk.inc").write_text(_host_source(src.read_text()))
    exe = tmp / "group_topk_host"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", f"-I{EMULATION}", f"-I{tmp}",
                            '-DGROUP_TOPK_SOURCE="group_topk.inc"', "-o", str(exe),
                            str(EMULATION / "group_topk_host.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr

    def run(s, gmax, top_s, top_i, start, fill):
        b, c = s.shape
        k = top_s.shape[1]
        with open(tmp / "in.bin", "wb") as f:
            np.array([b, c, gmax.shape[1], k, start], np.int64).tofile(f)
            for a, dt in ((s, np.float32), (gmax, np.float32), (top_s, np.float32), (top_i, np.int64)):
                np.ascontiguousarray(a, dt).tofile(f)
        subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin"), str(fill)], check=True, timeout=300)
        raw = (tmp / "out.bin").read_bytes()
        out_s = np.frombuffer(raw, np.float32, b * k).reshape(b, k)
        out_i = np.frombuffer(raw, np.int64, b * k, 4 * b * k).reshape(b, k)
        return out_s, out_i, np.frombuffer(raw, np.int32, 2 * b, 12 * b * k).reshape(b, 2)

    return run


def _eighths(rng, b, c, chunks=3, masked_chunk=1):
    out = []
    for n in range(chunks):
        s = (rng.integers(-40, 40, size=(b, c)) / 8).astype(np.float32)
        s[:, rng.random(c) < 0.3] = np.float32(NEG_INF)
        s[:, 64:128] = np.float32(NEG_INF)
        if n == masked_chunk:
            s[:] = np.float32(NEG_INF)
        out.append((s, n * c))
    return out


def _emulated_eighths(k, c):
    return lambda rng: (_eighths(rng, 3, c), k, None)


def _emulated_branch(case):
    def make(rng):
        chunks, k, _, top, _ = case(rng)
        return [(s[:3], start) for s, start in chunks], k, None if top is None else (top[0][:3], top[1][:3])
    return make


def _emulated_tied_rows(rng):
    s = rng.standard_normal((4, 4096)).astype(np.float32)
    s[::2] = 0.5  # every other row tied throughout: past the buffer
    return [(s, 0)], 200, None


def _emulated_unaligned(rng):
    return [(rng.standard_normal((2, 1001)).astype(np.float32), n * 1001) for n in range(2)], 10, None


def _emulated_maxima_in_memory(rng):
    """G = 2,188 groups: more than the warp holds, read from memory."""
    return [((rng.integers(-40, 40, size=(1, 70000)) / 8).astype(np.float32), 0)], 100, None


def _emulated_overflow_past_groups(rng):
    """More than k groups reach T and the survivors (8 score values) pass
    the buffer: the route over memory reads its candidates in whole chunks,
    past the last listed group."""
    return [(rng.integers(-4, 4, size=(2, 16384)).astype(np.float32), 0)], 400, None


EMULATED_CASES = {
    "eighths_c2048_k40": _emulated_eighths(40, 2048),
    "eighths_c4128_k200": _emulated_eighths(200, 4128),
    "eighths_c4128_k2000": _emulated_eighths(2000, 4128),
    "warm_few_groups": _emulated_branch(_branch_warm_few_groups),
    "warm_many_groups": _emulated_branch(_branch_warm_many_groups),
    "all_tied": _emulated_branch(_branch_all_tied),
    "ragged": _emulated_branch(_branch_ragged),
    "tied_rows": _emulated_tied_rows,
    "unaligned_rows": _emulated_unaligned,
    "maxima_in_memory": _emulated_maxima_in_memory,
    "overflow_past_groups": _emulated_overflow_past_groups,
}


@pytest.mark.parametrize("case", list(EMULATED_CASES))
def test_group_topk_kernel_source_on_the_host(group_topk_host, case):
    """The group_topk kernel's own CUDA source, built for the host over a
    warp emulation (tests/cuda_emulation), against its numpy model after
    every chunk (the same (value, id) set, the same survivor counts) and
    against merge_group_topk_plain (the same sorted values). Shared memory
    starts zeroed in one run and filled with a pattern in the other, so a
    read of memory the kernel never wrote shows."""
    chunks, k, top = EMULATED_CASES[case](np.random.default_rng(11))
    b = chunks[0][0].shape[0]
    if top is None:
        top = np.full((b, k), np.float32(NEG_INF), np.float32), np.full((b, k), -1, np.int64)
    for fill in (0, 0x5A5A5A5A):
        top_s, top_i = top[0].copy(), top[1].copy()
        for s, start in chunks:
            gmax = _maxima(s)
            want_s, want_i, stats = _model_merge(s, gmax, top_s, top_i, start)
            got_s, got_i, surv = group_topk_host(s, gmax, top_s, top_i, start, fill)
            assert surv[:, 0].tolist() == [n for _, n, _ in stats]
            for q in range(b):
                assert sorted(zip(got_s[q].view(np.int32).tolist(), got_i[q].tolist())) == \
                    sorted(zip(want_s[q].view(np.int32).tolist(), want_i[q].tolist()))
            plain_s, _ = G.merge_group_topk(torch.from_numpy(s), torch.from_numpy(gmax), torch.from_numpy(top_s),
                                            torch.from_numpy(top_i), start)
            np.testing.assert_array_equal(np.sort(got_s, 1), np.sort(plain_s.numpy(), 1))
            top_s, top_i = got_s.copy(), got_i.copy()
