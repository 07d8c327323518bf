"""K1's euclidean epilogue as the kernel computes it: its source
(``csrc/u8_euclidean.cuh``, which ``u8_bin_max.cu`` includes) built for the
host by g++ over ``tests/cuda_emulation/cuda_float_shims.h`` with
``-ffp-contract=off``, its bins held bit for bit against the plain version,
``u8_bin_max_plain("euclidean", ...)``, on the edges of its terms: code
dots past 2^24 (where their conversion rounds) and at the int32 limit's
widest Dp, ``q_u + v_u`` at its largest, rows whose d2 clamps at 0, an
invalid row in a live bin, a bin of invalid rows only, and tied rows."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cosdata_tpu_torch.ops.kernels import u8_scan as K
from cosdata_tpu_torch.ops.quantize import QuantizedU8

EMULATION = Path(__file__).parent / "cuda_emulation"
B, C, LO, HI = 4, 256, -0.6, 0.7


@pytest.fixture(scope="module")
def epilogue_host(tmp_path_factory):
    """The epilogue built for the host; returns a function running it on a
    EuclideanTerms."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the epilogue for the host")
    tmp = tmp_path_factory.mktemp("u8_euclidean_host")
    exe = tmp / "u8_euclidean_host"
    built = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", f"-I{EMULATION}",
                            f"-I{Path(K.LIBRARY.source).parent}", "-o", str(exe),
                            str(EMULATION / "u8_euclidean_host.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr

    def run(t: K.EuclideanTerms) -> np.ndarray:
        b, dp = t.q_codes.shape
        c = t.codes.shape[0]
        with open(tmp / "in.bin", "wb") as f:
            np.array([b, c, dp], np.int64).tofile(f)
            for x in (t.q_codes, t.q_code, t.q_u, t.q_sq, t.codes, t.v_code, t.v_u, t.v_sq, t.consts):
                x.contiguous().numpy().tofile(f)
        subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")], check=True, timeout=300)
        return np.fromfile(tmp / "out.bin", np.float32).reshape(b, c // 32)

    return run


def _quantized(u: np.ndarray, mags_scale: np.ndarray) -> QuantizedU8:
    """u8 codes ``u`` as quantize_u8 over [LO, HI] would hold them, every
    lane true; the magnitudes scaled by ``mags_scale``."""
    a = np.float32(np.float32(HI) - np.float32(LO)) * np.float32(1.0 / 255.0)
    deq = a * u.astype(np.float32) + np.float32(LO)
    mags = np.sqrt((deq * deq).sum(-1, dtype=np.float32)) * mags_scale.astype(np.float32)
    centered = u.astype(np.int32) - 128
    return QuantizedU8(torch.from_numpy(centered.astype(np.int8)), torch.from_numpy(centered.sum(-1, dtype=np.int32)),
                       torch.from_numpy(mags.astype(np.float32)), torch.tensor(a), torch.tensor(np.float32(LO)),
                       torch.tensor(np.float32(u.shape[1])))


def _edges(dp: int, seed: int):
    """Codes near the top of the range (code dots past 2^24), a query and a
    row of 255s (the largest code dot and q_u + v_u), tied rows, rows equal
    to the queries with their magnitudes cut so d2 < 0, row 5 invalid in
    bin 0 and bin 1 invalid throughout."""
    rng = np.random.default_rng(seed)
    uq = rng.integers(176, 256, size=(B, dp))
    uv = rng.integers(176, 256, size=(C, dp))
    uq[0] = 255
    uv[-1] = 255
    uv[65:80] = uv[64]  # tied inside bin 2
    uv[96:128] = uv[128:160]  # bins 3 and 4 tied row for row
    uv[160 : 160 + B] = uq  # bin 5: each query's own codes
    scale = np.ones(C)
    scale[160 : 160 + B] = 0.7
    valid = np.ones(C, bool)
    valid[5] = False
    valid[32:64] = False
    q = _quantized(uq, np.ones(B))
    store = _quantized(uv, scale)
    return K.bin_max_terms("euclidean", q, store, torch.from_numpy(valid), dp), uq, uv


@pytest.mark.parametrize("dp", [128, 768, 16384])
def test_host_epilogue_equals_plain_bit_for_bit(epilogue_host, dp):
    t, uq, uv = _edges(dp, dp)
    want = K.u8_bin_max_plain("euclidean", 32, t).numpy()
    got = epilogue_host(t)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the edges were reached
    code_dot = uq.astype(np.int64) @ uv.astype(np.int64).T
    assert code_dot.max() == 255 * 255 * dp and (code_dot > 2**24).any() == (dp > 256)
    assert float((t.q_u[:, None] + t.v_u[None, :]).max()) == 2 * 255 * dp
    assert (want[:, 1] == np.float32(K.SINK)).all() and (want[:, 0] > -1e37).all()
    assert (want[:, 5] == 0).all() and not np.signbit(want[:, 5]).any()  # clamped d2: +0
    assert (want[:, 3] == want[:, 4]).all()
    assert K.KERNEL_EUCLIDEAN_DP_MAX >= dp


def test_widest_dp_stays_inside_int32_and_f32():
    """The bounds the header states, at KERNEL_EUCLIDEAN_DP_MAX: the code
    dot below 2^31 and q_u + v_u below 2^24."""
    dp = K.KERNEL_EUCLIDEAN_DP_MAX
    assert 255 * 255 * dp < 2**31 and 2 * 255 * dp < 2**24
