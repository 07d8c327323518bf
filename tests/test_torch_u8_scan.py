"""Port parity: the plain version of the u8_bin_max kernel (K1) against the
reference's Pallas kernel (interpret mode), its jnp scoring route, and its
bins-mode maxima; its euclidean epilogue (which the Pallas kernel lacks)
against the reference's u8 euclidean scores, bit for bit. The CUDA kernel itself is checked against the same plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import distance as JD
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops.pallas.u8_scan import u8_bin_max_from_store as pallas_bin_max
from cosdata_tpu_torch.ops.kernels import u8_scan as K
from cosdata_tpu_torch.ops.quantize import QuantizedU8

torch.set_num_threads(1)

D_PAD, D_TRUE, C, B, GROUP = 128, 100, 2048, 8, 32
LO, HI = -0.5, 0.5


def _to_torch(qj) -> QuantizedU8:
    return QuantizedU8(*(torch.from_numpy(np.array(v)) for v in qj))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    x = rng.uniform(-1, 1, size=(C, D_PAD)).astype(np.float32)
    qx = rng.uniform(-1, 1, size=(B, D_PAD)).astype(np.float32)
    valid = np.ones(C, bool)
    valid[5] = False
    valid[2000:] = False  # ragged tail: bin 62 partly, bin 63 wholly invalid
    store = JQ.quantize_u8(jnp.asarray(x), LO, HI, D_TRUE)
    q = JQ.quantize_u8(jnp.asarray(qx), LO, HI, D_TRUE)
    return store, q, valid


def _port(metric, store, q, valid):
    t = K.bin_max_terms(metric, _to_torch(q), _to_torch(store), torch.from_numpy(valid), D_PAD)
    return K.u8_bin_max(metric, GROUP, t).numpy()


def _assert_bins(got, expect, rtol, atol):
    ok = expect > -1e37
    assert ok.sum() > 0 and (~ok).sum() > 0
    np.testing.assert_allclose(got[ok], expect[ok], rtol=rtol, atol=atol)
    assert (got[~ok] < -1e37).all()


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_plain_matches_pallas_kernel(data, metric):
    """The Pallas kernel's bins are strided row groups within each BC block;
    on a store permuted as X'[S + b + g·nb] = X[S + b·G + g] its strided bin
    b equals the port's contiguous bin b over X."""
    store, q, valid = data
    bc = 1024
    nb = bc // GROUP
    perm = np.empty(C, np.int64)
    for s in range(0, C, bc):
        for b in range(nb):
            for g in range(GROUP):
                perm[s + b + g * nb] = s + b * GROUP + g
    pstore = store._replace(
        data=store.data[perm], sums=store.sums[perm], mags=store.mags[perm]
    )
    got_pallas = np.asarray(pallas_bin_max(
        metric, GROUP, q, pstore, jnp.asarray(valid[perm]), D_PAD,
        qb=B, bc=bc, interpret=True,
    )).T  # (B, C/G)
    _assert_bins(_port(metric, store, q, valid), got_pallas, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_plain_matches_jnp_score_route(data, metric):
    store, q, valid = data
    ref = np.asarray(JD.score(metric, "u8", q, store, D_PAD))
    ref = np.where(valid[None, :], ref, -3.0e38).reshape(B, C // GROUP, GROUP).max(-1)
    _assert_bins(_port(metric, store, q, valid), ref, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_plain_matches_bins_mode_maxima(data, metric):
    """The reference's bins engine casts scores to bf16 before the max
    (flat_scan.py:247): agreement within bf16's rounding, 2^-8."""
    store, q, valid = data
    sc = jnp.where(jnp.asarray(valid)[None, :], JD.score(metric, "u8", q, store, D_PAD), -3.0e38)
    ref = np.asarray(
        sc.astype(jnp.bfloat16).reshape(B, C // GROUP, GROUP).max(axis=2).astype(jnp.float32)
    )
    _assert_bins(_port(metric, store, q, valid), ref, rtol=2.0**-8, atol=1e-6)


def test_cpu_wrapper_takes_plain_version(data):
    store, q, valid = data
    before = K.u8_bin_max.launches
    t = K.bin_max_terms("cosine", _to_torch(q), _to_torch(store), torch.from_numpy(valid), D_PAD)
    got = K.u8_bin_max("cosine", GROUP, t)
    np.testing.assert_array_equal(got.numpy(), K.u8_bin_max_plain("cosine", GROUP, t).numpy())
    assert K.u8_bin_max.launches == before == 0


def test_plain_chunking_is_invisible(data, monkeypatch):
    """Chunking the plain version over store rows changes nothing."""
    store, q, valid = data
    t = K.bin_max_terms("dot", _to_torch(q), _to_torch(store), torch.from_numpy(valid), D_PAD)
    whole = K.u8_bin_max_plain("dot", GROUP, t).numpy()
    monkeypatch.setattr(K, "PLAIN_ROW_CHUNK", 96)
    np.testing.assert_array_equal(K.u8_bin_max_plain("dot", GROUP, t).numpy(), whole)


@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_kernel_metrics(data, metric):
    """Euclidean: the plain version equals the reference's u8 euclidean
    scores maxed over 32-row groups, bit for bit (the Pallas K1 has no
    euclidean). Hamming has no bin kernel and is refused by name."""
    store, q, valid = data
    if metric == "hamming":
        with pytest.raises(ValueError, match="cosine, dot, euclidean"):
            K.bin_max_terms(metric, _to_torch(q), _to_torch(store), torch.from_numpy(valid), D_PAD)
        return
    ref = np.asarray(JD.score(metric, "u8", q, store, D_PAD))
    ref = np.where(valid[None, :], ref, np.float32(K.SINK)).reshape(B, C // GROUP, GROUP).max(-1)
    got = _port(metric, store, q, valid)
    assert (ref < -1e37).any() and (ref > -1e37).any()
    np.testing.assert_array_equal(got, ref)
