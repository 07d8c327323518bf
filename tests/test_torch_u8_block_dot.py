"""Stage 4 of the u8 scan (``ops/kernels/u8_block_dot.py``): its int8
dots' plain version against the blocks gathered and
``distance.diag_code_dot``, an int64 numpy product and the reference's
``storage._diag_dot``; its whole plain version (dots, dequantisation,
metric and mask) against the reference's stage 4 on the CPU; the
inversion of the block ids into each block's list; the kernel's parts
(``csrc/u8_block_dot.cuh``: the walk of a block's list, the copies, the
mma.sync fragments, the epilogue and the scatter) built for the host by g++
over ``tests/cuda_emulation/`` and run as the kernel's launch maps them,
every score bit for bit against the plain version; and
``flat_scan.expand_bins`` through the wrapper against the expansion as it
was before the kernel (blocks gathered and rescored over slices of the
queries), (vals, ids) bit for bit, by cosine, dot and euclidean.

Inputs come from numpy with a seed; the codes reach both ends of the int8
range, including rows and queries of -128 only (the largest sum,
2^14·Dp)."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench_torch.trace import KERNEL_GROUPS, kernel_group
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.ops import distance as TD
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops.kernels import u8_block_dot as K
from cosdata_tpu_torch.ops.kernels.u8_scan import u8_bin_max_from_store
from cosdata_tpu_torch.ops.quantize import quantize_u8
from cosdata_tpu_torch.ops.storage import cos_or_dot
from cosdata_tpu_torch.ops.topk import NEG_INF
from cosdata_tpu_torch.tools.measure import block_dot_bytes

EMULATION = Path(__file__).parent / "cuda_emulation"
DPS = [128, 768, 1024, 2048]
#: (group, blocks in the table, blocks a query): 32-row bins, whose 7 a
#: query leave a ragged last tile (224 of 128-candidate tiles), and single
#: rows (33 a query)
GROUPS = {32: (40, 7), 1: (300, 33)}
B = 5
METRICS = ["cosine", "dot", "euclidean"]
#: the kernel's cases: (group, blocks in the table, queries, blocks a query,
#: Dp, every query choosing the same blocks). "bins": the scan's 32-row
#: bins; "shared": lists of 37 entries (two chunks of 16 and 5, not a
#: multiple of 8) on 5 of 20 blocks; "ragged slice": Dp 640 (slices of 256,
#: 256, 128); "group 1": single rows; "group 48": two row tiles, the second
#: of 16 rows; "wide": Dp 2,048 (8 slices through the ring of 3)
HOST_CASES = {"bins": (32, 40, 9, 7, 768, False), "shared": (32, 20, 37, 5, 256, True),
              "ragged slice": (32, 12, 11, 4, 640, False), "group 1": (1, 300, 5, 33, 128, False),
              "group 48": (48, 6, 10, 3, 384, False), "wide": (32, 6, 20, 2, 2048, False)}


def _case(group: int, dp: int, seed: int):
    """q_codes (B, Dp), codes (rows, Dp) int8 and block_ids (B, K) int64:
    random codes over the whole int8 range, query 0 and the last block of
    -128 only, query 1 and row 0 of +127 only, each query's blocks distinct
    with the last among them."""
    n_blocks, k = GROUPS[group]
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, size=(B, dp), dtype=np.int8)
    codes = rng.integers(-128, 128, size=(n_blocks * group, dp), dtype=np.int8)
    q[0] = -128
    q[1] = 127
    codes[-group:] = -128
    codes[0] = 127
    ids = np.stack([rng.permutation(n_blocks - 1)[: k - 1] for _ in range(B)])
    ids = np.concatenate([ids, np.full((B, 1), n_blocks - 1)], axis=1)
    for b in range(B):
        rng.shuffle(ids[b])
    return q, codes, ids.astype(np.int64)


def _numpy_dots(q, codes, ids, group):
    rows = (ids[:, :, None] * group + np.arange(group)).reshape(ids.shape[0], -1)
    return np.einsum("bd,bpd->bp", q.astype(np.int64), codes[rows].astype(np.int64))


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_plain_equals_gathered_diag_code_dot(group, dp, monkeypatch):
    q, codes, ids = _case(group, dp, seed=dp + group)
    tq, tc, ti = torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(ids)
    got = K.u8_block_dot_plain(tq, tc, ti, group)
    b, k = ids.shape
    gathered = tc.view(-1, group * dp)[ti].view(b, k * group, dp)
    assert got.dtype == torch.int32 and got.shape == (b, k * group)
    np.testing.assert_array_equal(got.numpy(), TD.diag_code_dot(tq, gathered).numpy())
    want = _numpy_dots(q, codes, ids, group)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = JS._diag_dot(jnp.asarray(q), jnp.asarray(gathered.numpy()), int8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the edges were reached: the largest sum, and the table's last block in every query
    assert want.max() == 128 * 128 * dp and (ids == GROUPS[group][0] - 1).any(axis=1).all()
    # over slices of one query each, the same
    monkeypatch.setattr(K, "PLAIN_BYTES", 1)
    np.testing.assert_array_equal(K.u8_block_dot_plain(tq, tc, ti, group).numpy(), want)


def _stage4_case(name: str, seed: int):
    """Stage 4's inputs for case ``name`` of HOST_CASES: (q, store, valid,
    bin_s, ids, group, d_pad). Codes saturate at both ends of the int8 range
    (many tie), query 0 and the last block are -128 only (the largest sum),
    the last row of block 0 is query 1 itself (a euclidean residue that
    clamps), block 1's first row has no magnitude (cosine's zero
    denominator), some rows are invalid and the bins of every third query's
    last two slots sank."""
    group, n_blocks, b, k, dp, shared = HOST_CASES[name]
    rows = n_blocks * group
    d_true = dp - 28
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, dp), np.float32)
    x[:, :d_true] = rng.uniform(-1, 1, (rows, d_true)) * rng.uniform(0.5, 1.5, (rows, 1))
    qx = np.zeros((b, dp), np.float32)
    qx[:, :d_true] = rng.uniform(-1, 1, (b, d_true))
    store = quantize_u8(torch.from_numpy(x), -0.6, 0.7, d_true)
    q = quantize_u8(torch.from_numpy(qx), -0.6, 0.7, d_true)
    store.data[-group:] = -128
    q.data[0] = -128
    last = group - 1
    store.data[last], store.sums[last], store.mags[last] = q.data[1], q.sums[1], q.mags[1]
    store.mags[group % rows] = 0.0
    valid = torch.from_numpy(rng.random(rows) > 0.1)
    if shared:  # every query chooses the same blocks: the last, then every third
        ids = np.tile(np.r_[n_blocks - 1, np.arange(0, 3 * (k - 1), 3)], (b, 1))
    else:  # distinct blocks a query, the last among them
        ids = np.stack([np.r_[n_blocks - 1, rng.permutation(n_blocks - 1)[: k - 1]] for _ in range(b)])
        for row in ids:
            rng.shuffle(row)
    bin_s = np.sort(rng.uniform(-1, 1, (b, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    bin_s[::3, -2:] = NEG_INF
    return q, store, valid, torch.from_numpy(bin_s), torch.from_numpy(ids.astype(np.int64)), group, dp


def test_cpu_wrapper_is_the_plain_version():
    q, store, valid, bin_s, ids, group, dp = _stage4_case("bins", seed=3)
    before = K.u8_block_dot.launches
    got = K.u8_block_dot("cosine", dp, group, q, store, valid, bin_s, ids)
    want = K.block_scores_plain("cosine", dp, group, q, store, valid, bin_s, ids)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    assert K.u8_block_dot.launches == before
    empty = K.u8_block_dot("dot", dp, group, q, store, valid, bin_s[:, :0], ids[:, :0])
    assert empty.shape == (ids.shape[0], 0)


def test_kernel_arguments_are_checked():
    """What the launch would refuse, the wrapper refuses first (checked on
    CPU tensors: the checks read shapes, types and layout only)."""
    q, store, valid, bin_s, ids, group, dp = _stage4_case("bins", seed=4)
    args = ("cosine", dp, group, q, store, valid, bin_s, ids)
    K._check_cuda_args(*args)

    def with_(**kw):
        named = dict(zip(("metric", "d_pad", "group", "q", "store", "valid", "bin_s", "ids"), args))
        named.update(kw)
        return tuple(named.values())

    bad = [
        with_(metric="hamming"),
        with_(group=48),  # does not divide the rows
        with_(d_pad=K.KERNEL_DP_MAX + 1),
        with_(q=q._replace(data=q.data[:, :704].contiguous()), store=store._replace(data=store.data[:, :704].contiguous())),
        with_(q=q._replace(data=q.data.to(torch.int16))),
        with_(q=q._replace(a=q.a[None])),
        with_(store=store._replace(sums=store.sums.to(torch.int64))),
        with_(store=store._replace(data=store.data.t().contiguous().t())),  # not contiguous
        with_(valid=valid.to(torch.uint8)),
        with_(bin_s=bin_s[:, :3]),
        with_(ids=ids.to(torch.int32)),
        with_(ids=ids[:3]),  # ids for another batch
    ]
    for b in bad:
        with pytest.raises(ValueError):
            K._check_cuda_args(*b)
    assert 128 * 128 * K.KERNEL_DP_MAX < 2**31 <= 128 * 128 * (K.KERNEL_DP_MAX + K.KERNEL_DP_MULTIPLE)


@pytest.mark.parametrize("shared", [False, True])
def test_invert_lines_up_each_blocks_entries(shared):
    """The inversion: the ids sorted, each block's entries in the order of
    their flat index; a block nobody chose has none."""
    q, store, valid, bin_s, ids, group, dp = _stage4_case("shared" if shared else "bins", seed=6)
    n_blocks = store.data.shape[0] // group
    keys, order = K.invert(ids)
    flat = ids.numpy().ravel()
    assert keys.dtype == torch.int32 and order.dtype == torch.int64 and keys.shape == order.shape == flat.shape
    np.testing.assert_array_equal(keys.numpy(), np.sort(flat))
    np.testing.assert_array_equal(order.numpy(), np.argsort(flat, kind="stable"))
    assert len(np.unique(flat)) < n_blocks  # blocks nobody chose


def _reference_stage4(metric, d_pad, group, q, store, valid, bin_s, ids):
    """The reference's stage 4 (cosdata_tpu/ops/flat_scan.py:284-304), its
    expressions on jax arrays on the CPU, before its top-k: bins that sank
    carry id -1 (its bin_ids), read at block 0 and masked."""
    j = {name: jnp.asarray(x.numpy()) for name, x in q._asdict().items()}
    b, k = ids.shape
    cap_g = store.data.shape[0] // group
    cw = k * group
    bin_ids = jnp.where(jnp.asarray(bin_s.numpy()) > NEG_INF / 2, jnp.asarray(ids.numpy()), -1)
    safe_b = jnp.maximum(bin_ids, 0)
    data_blk = jnp.asarray(store.data.numpy()).reshape(cap_g, group * d_pad)
    sums_blk = jnp.asarray(store.sums.numpy()).reshape(cap_g, group)
    mags_blk = jnp.asarray(store.mags.numpy()).reshape(cap_g, group)
    valid_blk = jnp.asarray(valid.numpy()).reshape(cap_g, group)
    uq = (j["sums"] + 128 * d_pad).astype(jnp.float32)
    cdata = data_blk[safe_b].reshape(b, cw, d_pad)
    csums = sums_blk[safe_b].reshape(b, cw)
    cmags = mags_blk[safe_b].reshape(b, cw)
    live_c = valid_blk[safe_b].reshape(b, cw) & ((bin_ids[:, :, None] >= 0).repeat(group, 2).reshape(b, cw))
    cc_dot = JS._diag_dot(j["data"], cdata, int8=True)
    code_dot = (cc_dot + 128 * (j["sums"][:, None] + csums) + d_pad * 128 * 128).astype(jnp.float32)
    uc = (csums + 128 * d_pad).astype(jnp.float32)
    dot = j["a"] * j["a"] * code_dot + j["a"] * j["b"] * (uq[:, None] + uc) + j["b"] * j["b"] * j["dtrue"]
    sc = JS._cos_or_dot(metric, dot, j["mags"], cmags)
    return np.asarray(jnp.where(live_c, sc, NEG_INF))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["bins", "group 1"])
def test_plain_scores_equal_the_reference_stage_4(case, metric):
    q, store, valid, bin_s, ids, group, dp = _stage4_case(case, seed=20)
    got = K.block_scores_plain(metric, dp, group, q, store, valid, bin_s, ids).numpy()
    want = _reference_stage4(metric, dp, group, q, store, valid, bin_s, ids)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got == NEG_INF).any() and (got > NEG_INF).sum() > got.size // 2


@pytest.fixture(scope="module")
def kernel_host(tmp_path_factory):
    """The kernel's host-buildable parts (csrc/u8_block_dot.cuh) built for
    the host; returns a function that runs the launch's CTAs over stage 4's
    inputs, the inversion from the wrapper's :func:`invert`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel's parts for the host")
    tmp = tmp_path_factory.mktemp("u8_block_dot_host")
    exe = tmp / "u8_block_dot_host"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-fno-strict-aliasing", "-ffp-contract=off",
                            f"-I{EMULATION}", f"-I{Path(K.LIBRARY.source).parent}", "-o", str(exe),
                            str(EMULATION / "u8_block_dot_host.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr

    def run(metric, d_pad, group, q, store, valid, bin_s, ids, fill: int) -> np.ndarray:
        b, k = ids.shape
        rows = store.data.shape[0]
        keys, order = K.invert(ids)
        path = tmp / f"in-{fill}.bin"
        with open(path, "wb") as f:
            np.array([b, k, group, rows, q.data.shape[1], d_pad, K.METRIC_CODES[metric]], np.int64).tofile(f)
            for x in (q.data, q.sums, q.mags, torch.stack([q.a, q.b, q.dtrue]), store.data, store.sums, store.mags,
                      valid.to(torch.uint8), bin_s, keys, order):
                np.ascontiguousarray(x.numpy()).tofile(f)
        subprocess.run([str(exe), str(path), str(tmp / "out.bin"), str(fill)], check=True, timeout=300)
        return np.fromfile(tmp / "out.bin", np.float32).reshape(b, k * group)

    return run


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_kernel_equals_plain_bit_for_bit(kernel_host, case, metric):
    """The kernel's walk, copies, fragments, products, epilogue and scatter
    run as the launch maps them, every score bit for bit against the plain
    version (stages first filled with a byte pattern, so a read of a byte
    no copy brought would show)."""
    q, store, valid, bin_s, ids, group, dp = _stage4_case(case, seed=10 * len(case) + METRICS.index(metric))
    want = K.block_scores_plain(metric, dp, group, q, store, valid, bin_s, ids).numpy()
    got = kernel_host(metric, dp, group, q, store, valid, bin_s, ids, fill=0x5A if metric == "dot" else -128)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (want == NEG_INF).any() and (want > NEG_INF).any()


def test_host_kernel_reads_nothing_outside_the_table(kernel_host):
    """An id outside [0, rows / group) takes no chunk of its window: no CTA
    reads for it, and its slots stay unwritten; every other slot is scored
    as if it were absent."""
    q, store, valid, bin_s, ids, group, dp = _stage4_case("group 1", seed=5)
    ids[0, 3], ids[2, 0] = -1, store.data.shape[0]
    got = kernel_host("cosine", dp, group, q, store, valid, bin_s, ids, fill=0)
    assert (got[0, 3 * group : 4 * group].view(np.int32) == -1).all()
    assert (got[2, :group].view(np.int32) == -1).all()
    ok = np.ones(ids.shape, bool)
    ok[0, 3] = ok[2, 0] = False
    want = K.block_scores_plain("cosine", dp, group, q, store, valid, bin_s, torch.where(torch.from_numpy(ok), ids, 0))
    keep = np.repeat(ok, group, axis=1)
    np.testing.assert_array_equal(got[keep].view(np.int32), want.numpy()[keep].view(np.int32))


def test_kernel_time_lands_in_products():
    """The benchmark's profiler groups count the kernel (its name keeps
    "dot_kernel") as a product."""
    products = next(label for key, label, _ in KERNEL_GROUPS if key == "products_ms")
    name = "(anonymous namespace)::u8_block_dot_kernel(CUtensorMap_st, u8_block_dot::Args)"
    assert kernel_group(name) == products
    assert "u8_block_dot_kernel" in Path(K.LIBRARY.source).read_text()


def _parent_expand_bins(metric, d_pad, group, k_fetch, q, store, valid, bin_s, bin_ids, expand_bytes):
    """The expansion as it was before the kernel: each slice of the queries
    gathers its blocks, takes their dots by ``diag_code_dot`` and rescores
    them."""
    b, k_bins = bin_ids.shape
    cap_g = store.data.shape[0] // group
    p_total = k_bins * group
    kf = min(k_fetch, p_total)
    live_bin = bin_s > NEG_INF / 2
    data_blk = store.data.view(cap_g, group * d_pad)
    sums_blk = store.sums.view(cap_g, group)
    mags_blk = store.mags.view(cap_g, group)
    valid_blk = valid.view(cap_g, group)
    offs = torch.arange(group)
    q_rows = max(1, expand_bytes // (p_total * d_pad * 4))
    vals = torch.empty((b, kf), dtype=torch.float32)
    ids = torch.empty((b, kf), dtype=torch.int64)
    for s in range(0, b, q_rows):
        e = min(s + q_rows, b)
        sel = bin_ids[s:e]
        cc = TD.diag_code_dot(q.data[s:e], data_blk[sel].view(e - s, p_total, d_pad))
        qs = q._replace(data=q.data[s:e], sums=q.sums[s:e], mags=q.mags[s:e])
        dot = TD.dequant_dot(qs, cc, sums_blk[sel].view(e - s, p_total), d_pad)
        sc = cos_or_dot(metric, dot, qs.mags, mags_blk[sel].view(e - s, p_total))
        live = valid_blk[sel].view(e - s, p_total) & live_bin[s:e].repeat_interleave(group, 1)
        sc = torch.where(live, sc, NEG_INF)
        rows = (sel[:, :, None] * group + offs).view(e - s, p_total)
        v, pos = torch.topk(sc, kf, dim=1)
        vals[s:e], ids[s:e] = v, torch.gather(rows, 1, pos)
    return vals, ids


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_expand_bins_equals_the_gathered_expansion(metric):
    """Stage 4 through the wrapper against the gathered expansion run over
    slices of 3 queries, on bins that K1's plain version selects: tombstones,
    a bin of invalid rows only, bins past the live rows (sunk), duplicated
    rows (tied scores)."""
    rng = np.random.default_rng(11)
    cap, d_true, d_pad, b, group, k_fetch = 4096, 200, 256, 8, 32, 50
    x = np.zeros((cap, d_pad), np.float32)
    x[:3000, :d_true] = rng.uniform(-1, 1, size=(3000, d_true)) * rng.uniform(0.5, 1.5, size=(3000, 1))
    x[100:140] = x[40]  # ties, across two bins
    qx = np.zeros((b, d_pad), np.float32)
    qx[:, :d_true] = rng.uniform(-1, 1, size=(b, d_true))
    valid = np.zeros(cap, bool)
    valid[:3000] = True
    valid[[5, 77, 1500]] = False
    valid[64:96] = False
    store = quantize_u8(torch.from_numpy(x), -1.5, 1.5, d_true)
    q = quantize_u8(torch.from_numpy(qx), -1.5, 1.5, d_true)
    tv = torch.from_numpy(valid)
    bins = u8_bin_max_from_store(metric, group, q, store, tv, d_pad)
    bin_s, bin_ids = torch.topk(bins, 120, dim=1)  # past the 93 live bins: sunk ones too
    assert bool((bin_s <= NEG_INF / 2).any())
    got = TF.expand_bins(metric, d_pad, group, k_fetch, q, store, tv, bin_s, bin_ids)
    bytes_3 = 3 * 120 * group * d_pad * 4
    want = _parent_expand_bins(metric, d_pad, group, k_fetch, q, store, tv, bin_s, bin_ids, bytes_3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    got_c = TF.codes_chunk_topk(metric, d_pad, k_fetch, q, store, tv)
    bin_s, bin_ids = torch.topk(bins, k_fetch, dim=1)
    want_c = _parent_expand_bins(metric, d_pad, group, k_fetch, q, store, tv, bin_s, bin_ids, bytes_3)
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_block_dot_bytes_counts_distinct_blocks():
    """The fused stage's bytes: each distinct block's codes with its rows'
    sums, magnitudes and valid bytes; the query codes, sums and magnitudes;
    each slot's id and bin maximum; the f32 scores written. Beside them, the
    same with each query reading its own blocks."""
    ids = torch.tensor([[0, 3, 5], [3, 5, 7]])
    distinct, per_query = block_dot_bytes(ids, 32, 768)
    fixed = 2 * (768 + 8) + 12 * 6 + 4 * 6 * 32
    assert distinct == 4 * 32 * (768 + 9) + fixed and per_query == 6 * 32 * (768 + 9) + fixed
