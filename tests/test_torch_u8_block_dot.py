"""Stage 4 of the u8 scan (``ops/kernels/u8_block_dot.py``): its plain
version against the blocks gathered and ``distance.diag_code_dot``, an
int64 numpy product and the reference's ``storage._diag_dot``, bit for bit;
the kernel's per-thread dots (``csrc/u8_block_dot.cuh``) built for the host
by g++ over ``tests/cuda_emulation/cuda_int_shims.h`` and run as the
kernel's launch maps them, bit for bit against the plain version; and
``flat_scan.expand_bins`` through the wrapper against the expansion as it
was before the kernel (blocks gathered and rescored over slices of the
queries), (vals, ids) bit for bit, by cosine, dot and euclidean.

Inputs come from numpy with a seed; the codes reach both ends of the int8
range, including rows and queries of -128 only (the largest sum,
2^14·Dp), and every query's blocks include the table's last one."""

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


def test_cpu_wrapper_is_the_plain_version():
    q, codes, ids = _case(32, 768, seed=3)
    before = K.u8_block_dot.launches
    got = K.u8_block_dot(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(ids), 32)
    np.testing.assert_array_equal(got.numpy(), _numpy_dots(q, codes, ids, 32))
    assert K.u8_block_dot.launches == before
    empty = K.u8_block_dot(torch.from_numpy(q), torch.from_numpy(codes), torch.zeros((B, 0), dtype=torch.int64), 32)
    assert empty.shape == (B, 0)


def test_kernel_arguments_are_checked():
    """What the launch would refuse, the wrapper refuses first (checked on
    CPU tensors: the checks read shapes, types and layout only)."""
    q, codes, ids = (torch.from_numpy(x) for x in _case(32, 768, seed=4))
    K._check_cuda_args(q, codes, ids, 32)
    bad = [
        (q, codes, ids, 48),  # group does not divide the rows
        (q[:, :640], codes[:, :640].contiguous(), ids, 32),  # Dp not a multiple of 128
        (q.to(torch.int16), codes, ids, 32),
        (q, codes, ids.to(torch.int32), 32),
        (q, codes.t().contiguous().t(), ids, 32),  # not contiguous
        (q, codes, ids[:3], 32),  # ids for another batch
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K._check_cuda_args(*args)
    assert 128 * 128 * K.KERNEL_DP_MAX < 2**31 <= 128 * 128 * (K.KERNEL_DP_MAX + K.KERNEL_DP_MULTIPLE)


@pytest.fixture(scope="module")
def kernel_host(tmp_path_factory):
    """The kernel's per-thread dots built for the host; returns a function
    running the launch's blocks and threads over numpy inputs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel's dots for the host")
    tmp = tmp_path_factory.mktemp("u8_block_dot_host")
    exe = tmp / "u8_block_dot_host"
    built = subprocess.run([gxx, "-std=c++17", "-O1", "-fno-strict-aliasing", f"-I{EMULATION}",
                            f"-I{Path(K.LIBRARY.source).parent}", "-o", str(exe),
                            str(EMULATION / "u8_block_dot_host.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr

    def run(q: np.ndarray, codes: np.ndarray, ids: np.ndarray, group: int) -> np.ndarray:
        b, k = ids.shape
        with open(tmp / "in.bin", "wb") as f:
            np.array([b, k, group, codes.shape[0], q.shape[1]], np.int64).tofile(f)
            for x in (q, codes, ids):
                np.ascontiguousarray(x).tofile(f)
        subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")], check=True, timeout=300)
        return np.fromfile(tmp / "out.bin", np.int32).reshape(b, k * group)

    return run


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_host_kernel_equals_plain_bit_for_bit(kernel_host, group, dp):
    q, codes, ids = _case(group, dp, seed=10 * dp + group)
    want = K.u8_block_dot_plain(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(ids), group).numpy()
    np.testing.assert_array_equal(kernel_host(q, codes, ids, group), want)


def test_host_kernel_reads_nothing_outside_the_table(kernel_host):
    q, codes, ids = _case(1, 128, seed=5)
    ids[0, 3], ids[2, 0] = -1, codes.shape[0]
    got = kernel_host(q, codes, ids, 1)
    assert got[0, 3] == 0 and got[2, 0] == 0
    ok = np.ones(ids.shape, bool)
    ok[0, 3] = ok[2, 0] = False
    np.testing.assert_array_equal(got[ok], _numpy_dots(q, codes, np.where(ok, ids, 0), 1)[ok])


def test_kernel_time_lands_in_products():
    """The benchmark's profiler groups count the kernel (its name keeps
    "dot_kernel") as a product."""
    products = next(label for key, label, _ in KERNEL_GROUPS if key == "products_ms")
    name = "void (anonymous namespace)::u8_block_dot_kernel(signed char const*, signed char const*, " \
           "long long const*, int*, int, int, long long, int, int, int)"
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
    ids = torch.tensor([[0, 3, 5], [3, 5, 7]])
    distinct, per_query = block_dot_bytes(ids, 32, 768)
    fixed = 2 * 768 + 8 * 6 + 4 * 2 * 3 * 32
    assert distinct == 4 * 32 * 768 + fixed and per_query == 6 * 32 * 768 + fixed
