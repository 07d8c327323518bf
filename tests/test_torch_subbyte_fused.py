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


def _radix_kth(keys: np.ndarray, k: int) -> tuple[int, int]:
    """The kernel's radix select, pass by pass: 8-bit digits from the top,
    a histogram of the keys that match the prefix so far, the digit where
    the k-th largest falls. Returns (the k-th largest key, how many keys
    are larger)."""
    prefix = mask = 0
    remaining, above = k, 0
    for shift in (24, 16, 8, 0):
        live = keys[(keys & mask) == prefix]
        hist = np.bincount((live >> shift) & 255, minlength=256)
        acc = 0
        for digit in range(255, -1, -1):
            if acc + hist[digit] >= remaining:
                break
            acc += hist[digit]
        remaining -= acc
        above += acc
        prefix |= digit << shift
        mask |= 255 << shift
    return prefix, above


def _compact(keys: np.ndarray, ok: np.ndarray, k: int, kth: int, above: int) -> np.ndarray:
    """Positions the kernel keeps, in index order: keys above the k-th, then
    ties in index order up to k."""
    tie = ok & (keys == kth)
    keep = (ok & (keys > kth)) | (tie & (np.cumsum(tie) - 1 < k - above))
    return np.flatnonzero(keep)


def _model_merge(scores, gmax, top_s, top_i, start):
    """The group_topk kernel's algorithm for one chunk, row by row, in numpy."""
    b, c = scores.shape
    k, g = top_s.shape[1], gmax.shape[1]
    out_s, out_i = np.empty_like(top_s), np.empty_like(top_i)
    for q in range(b):
        gk = _keys(gmax[q])
        if g > k:
            kth, above = _radix_kth(gk, k)
            groups = _compact(gk, np.ones(g, bool), k, kth, above)
            floor = kth
        else:
            groups, floor = np.arange(g), 0
        rows = (groups[:, None] * 32 + np.arange(32)).reshape(-1)
        vals = np.concatenate([top_s[q], scores[q, np.minimum(rows, c - 1)]])
        ids = np.concatenate([top_i[q], start + rows])
        keys = _keys(vals)
        ok = np.concatenate([np.ones(k, bool), rows < c]) & (keys >= floor)
        kth, above = _radix_kth(keys[ok], k)
        keep = _compact(keys, ok, k, kth, above)
        assert len(keep) == k
        out_s[q], out_i[q] = vals[keep], ids[keep]
    return out_s, out_i


@pytest.mark.parametrize("c, k", [(2048, 40), (2048, 200), (500, 40), (512, 64), (4096, 7)])
def test_group_topk_kernel_model_equals_plain(c, k):
    """The group_topk kernel's algorithm (radix select of the k-th best
    group maximum, the floor it sets, the second select over the running
    entries and the kept groups' rows, ties in index order), modelled in
    numpy, against merge_group_topk_plain over several chunks: the same
    values, the same ids on untied slots, no id twice. Scores tie often
    (eighths) and whole groups are masked; the first chunk merges into the
    empty running top-k."""
    rng = np.random.default_rng(c + k)
    b = 5
    top_s = np.full((b, k), np.float32(NEG_INF), np.float32)
    top_i = np.full((b, k), -1, np.int64)
    plain_s, plain_i = torch.from_numpy(top_s), torch.from_numpy(top_i)
    for n, start in enumerate(range(0, 3 * c, c)):
        s = (rng.integers(-40, 40, size=(b, c)) / 8).astype(np.float32)
        s[:, rng.random(c) < 0.3] = np.float32(NEG_INF)
        s[:, 64:128] = np.float32(NEG_INF)
        if n == 1:
            s[:] = np.float32(NEG_INF)  # a chunk with every row masked
        gmax = np.pad(s, ((0, 0), (0, -c % 32)), constant_values=np.float32(NEG_INF)).reshape(b, -1, 32).max(axis=2)
        top_s, top_i = _model_merge(s, gmax, top_s, top_i, start)
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
