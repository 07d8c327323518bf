"""Port parity: cosdata_tpu_torch quantize_u8 against cosdata_tpu quantize_u8.

Codes and sums must be bit-exact; magnitudes agree within rtol 1e-6 (the
two frameworks sum the squares in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu_torch.ops import quantize as TQ

torch.set_num_threads(1)


def _both(x, lo, hi, d_true):
    j = JQ.quantize_u8(jnp.asarray(x), lo, hi, d_true)
    t = TQ.quantize_u8(torch.from_numpy(x), lo, hi, d_true)
    return j, t


def _check(j, t):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.sums.numpy(), np.asarray(j.sums))
    np.testing.assert_allclose(t.mags.numpy(), np.asarray(j.mags), rtol=1e-6)
    for name in ("a", "b", "dtrue"):
        assert float(getattr(t, name)) == float(getattr(j, name)), name
    assert t.data.dtype == torch.int8 and t.sums.dtype == torch.int32


@pytest.mark.parametrize(
    "lo, hi", [(-1.3, 0.7), (-0.1, 0.1), (-0.5, 0.5), (-1.0, 1.0), (-0.025, 0.3)]
)
def test_random_rows_with_padded_lanes(lo, hi):
    rng = np.random.default_rng(0)
    d_pad, d_true = 256, 200
    # values inside and well outside [lo, hi]
    x = rng.uniform(2 * lo, 2 * hi, size=(64, d_pad)).astype(np.float32)
    _check(*_both(x, lo, hi, d_true))


@pytest.mark.parametrize("lo, hi", [(-1.3, 0.7), (-0.3, 0.3)])
def test_bucket_edges(lo, hi):
    """Values exactly on (and one ulp around) every bucket edge: the f32
    subtraction f32(hi) - f32(lo) decides which side each lands on."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    step = (hi32 - lo32) / np.float32(255.0)
    edges = lo32 + step * np.arange(256, dtype=np.float32)
    vals = np.concatenate([
        edges,
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        [lo32, hi32, lo32 - 1, hi32 + 1, 0.0],
    ]).astype(np.float32)
    vals = np.pad(vals, (0, -len(vals) % 128))
    x = vals.reshape(-1, 128)
    _check(*_both(x, lo, hi, 128))


def test_store_and_query_scales():
    """The store's ``a`` is Python's double (hi - lo)/255 cast to f32; a
    query's is f32 arithmetic; both packages keep that split."""
    from cosdata_tpu.ops.storage import VectorStore as JStore
    from cosdata_tpu_torch.ops.storage import VectorStore as TStore

    lo, hi = -1.3, 0.7
    js = JStore(dim=100, kind="u8", range=(lo, hi), keep_raw=False)
    ts = TStore(dim=100, device="cpu", range=(lo, hi), keep_raw=False)
    assert float(ts.arrays.a) == float(js._arrays.a)
    q = np.random.default_rng(1).uniform(-1, 1, size=(4, 100)).astype(np.float32)
    jq = js.ship_query_codes(q)
    tq = ts.ship_query_codes(q)
    _check(jq, tq)
