"""Port parity: sub-byte and float quantization, the plain version of the
sub-byte code-dot kernel (K2) and the sub-byte scores, against the
reference on the same numpy inputs.

Tolerances: bitplanes, code sums, bucket codes and code dots bit-exact
(planes compared as uint32 through ``.view``); magnitudes within rtol 1e-6
and scores within rtol 1e-5 (f32 sums taken in another order). The CUDA
kernel itself is checked against the same plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import distance as JD
from cosdata_tpu.ops import quantize as JQ
from cosdata_tpu.ops.pallas.subbyte_scan import subbyte_code_scores as pallas_code_scores
from cosdata_tpu_torch.ops import distance as TD
from cosdata_tpu_torch.ops import quantize as TQ
from cosdata_tpu_torch.ops.kernels import subbyte_scan as K

torch.set_num_threads(1)

D_PAD, C, B = 128, 256, 8


def _rows(n, seed):
    """Uniform values in and beyond [-1, 1], plus every bucket edge of every
    resolution (and the values one ulp either side) in row 0."""
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, D_PAD)).astype(np.float32)
    edges = np.arange(-1.0, 1.001, 0.25, dtype=np.float32)
    e = np.concatenate([edges, np.nextafter(edges, 2.0), np.nextafter(edges, -2.0)])
    x[0, : len(e)] = e
    return x


def _planes(j):
    """The reference's uint32 planes as the port's int32 words."""
    return torch.from_numpy(np.asarray(j.planes).view(np.int32).copy())


def _port_subbyte(j) -> TQ.QuantizedSubByte:
    return TQ.QuantizedSubByte(_planes(j), *(torch.from_numpy(np.array(v)) for v in j[1:]))


@pytest.mark.parametrize("d_true", [100, D_PAD])
@pytest.mark.parametrize("res", [1, 2, 3])
def test_quantize_subbyte(res, d_true):
    x = _rows(64, seed=res)
    j = JQ.quantize_subbyte(jnp.asarray(x), res, d_true)
    t = TQ.quantize_subbyte(torch.from_numpy(x), res, d_true)
    assert t.planes.dtype == torch.int32 and t.planes.shape == (res, 64, D_PAD // 32)
    np.testing.assert_array_equal(t.planes.numpy().view(np.uint32), np.asarray(j.planes))
    np.testing.assert_array_equal(t.sums.numpy(), np.asarray(j.sums))
    np.testing.assert_allclose(t.mags.numpy(), np.asarray(j.mags), rtol=1e-6)
    for name in ("a", "b", "dtrue"):
        assert float(getattr(t, name)) == float(getattr(j, name)), name
    np.testing.assert_array_equal(
        TQ.subbyte_values(t.planes, D_PAD).numpy(), np.asarray(JQ.subbyte_values(j.planes, D_PAD))
    )
    if d_true == D_PAD:  # bit 31 carries dimensions 124..127: the words wrap
        assert (np.asarray(j.planes) >= 1 << 31).any()
    np.testing.assert_array_equal(
        TQ.unpack_bits_from_u32(t.planes[0], 90).numpy(),
        np.asarray(JQ.unpack_bits_from_u32(j.planes[0], 90)),
    )


@pytest.mark.parametrize("kind", ["f16", "f32"])
def test_quantize_float(kind):
    x = _rows(32, seed=9)
    j = getattr(JQ, f"quantize_{kind}")(jnp.asarray(x))
    t = getattr(TQ, f"quantize_{kind}")(torch.from_numpy(x))
    assert t.data.dtype == (torch.float16 if kind == "f16" else torch.float32)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_allclose(t.mags.numpy(), np.asarray(j.mags), rtol=1e-6)


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda r: f"res{r}")
def pair(request):
    res = request.param
    store = JQ.quantize_subbyte(jnp.asarray(_rows(C, seed=res)), res, 100)
    q = JQ.quantize_subbyte(jnp.asarray(_rows(B, seed=res + 10)), res, 100)
    return res, q, store


def test_plain_matches_pallas_kernel(pair):
    """Bit-exact against the Pallas kernel run as tests/test_pallas.py runs it."""
    _, q, store = pair
    q_codes = JQ.subbyte_values(q.planes, D_PAD)
    want = np.asarray(pallas_code_scores(q_codes, store.planes, D_PAD, block=128, interpret=True))
    got = K.subbyte_code_scores_plain(_planes(q), _planes(store), D_PAD)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_subbyte_scores(pair, metric):
    _, q, store = pair
    want = np.asarray((JD.cosine_subbyte if metric == "cosine" else JD.dot_subbyte)(q, store, D_PAD))
    got = K.subbyte_scores(metric, _port_subbyte(q), _port_subbyte(store), D_PAD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # distance.score routes sub-byte cosine/dot through the same function
    routed = TD.score(metric, "subbyte", _port_subbyte(q), _port_subbyte(store), D_PAD).numpy()
    np.testing.assert_array_equal(routed, got)


def test_cpu_wrapper_takes_plain_version_on_chunk_views(pair):
    """The wrapper on CPU tensors is the plain version (no launch), and a
    row chunk of the store, a strided view of its planes, scores as a copy."""
    res, q, store = pair
    planes = _planes(store)
    before = K.subbyte_code_scores.launches
    view = planes[:, 64:192]
    assert res == 1 or not view.is_contiguous()
    got = K.subbyte_code_scores(_planes(q), view, D_PAD)
    np.testing.assert_array_equal(
        got.numpy(), K.subbyte_code_scores_plain(_planes(q), view.contiguous(), D_PAD).numpy()
    )
    assert K.subbyte_code_scores.launches == before == 0


def test_cpu_query_unpack_is_word_major_and_shared_by_chunks(pair):
    """unpack_query_codes on CPU tensors is word_major_codes (no launch);
    passing its codes to every chunk's wrapper call, as the chunked scan
    does, gives the plain version's dots."""
    res, q, store = pair
    qp, planes = _planes(q), _planes(store)
    launches = (K.unpack_query_codes.launches, K.subbyte_code_scores.launches)
    q_codes = K.unpack_query_codes(qp)
    assert q_codes.dtype == torch.int8 and q_codes.shape == (B, D_PAD)
    np.testing.assert_array_equal(q_codes.numpy(), K.word_major_codes(qp).numpy())
    for rows in (slice(0, 128), slice(128, 256)):
        got = K.subbyte_code_scores(qp, planes[:, rows], D_PAD, q_codes)
        np.testing.assert_array_equal(got.numpy(), K.subbyte_code_scores_plain(qp, planes[:, rows], D_PAD).numpy())
    assert (K.unpack_query_codes.launches, K.subbyte_code_scores.launches) == launches == (0, 0)


@pytest.mark.parametrize("chunk", [False, True], ids=["whole", "chunk"])
@pytest.mark.parametrize("d_pad, d_true", [(128, 100), (768, 768)])
@pytest.mark.parametrize("res", [1, 2, 3])
def test_word_major_codes_give_the_plain_dots(res, d_pad, d_true, chunk):
    """The kernel's unpack order: both sides word-major (position w*32 + i
    holds bit i of word w, dimension i*W + w) give the code dots bit for bit,
    against the plain version and the Pallas kernel in interpret mode, on the
    whole store and on a row chunk of it (a strided view of its planes)."""
    rng = np.random.default_rng(100 * res + d_pad)
    x = rng.uniform(-1.2, 1.2, size=(C, d_pad)).astype(np.float32)
    qx = rng.uniform(-1.2, 1.2, size=(B, d_pad)).astype(np.float32)
    store = JQ.quantize_subbyte(jnp.asarray(x), res, d_true)
    q = JQ.quantize_subbyte(jnp.asarray(qx), res, d_true)
    rows = slice(64, 192) if chunk else slice(None)
    planes = _planes(store)[:, rows]
    assert chunk == (planes.shape[1] < C) and (res == 1 or not chunk or not planes.is_contiguous())
    got = TD.code_matmul(K.word_major_codes(_planes(q)), K.word_major_codes(planes))
    assert got.dtype == torch.int32 and got.shape == (B, planes.shape[1])
    np.testing.assert_array_equal(got.numpy(), K.subbyte_code_scores_plain(_planes(q), planes, d_pad).numpy())
    want = np.asarray(pallas_code_scores(
        JQ.subbyte_values(q.planes, d_pad), store.planes[:, rows], d_pad, block=128, interpret=True
    ))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("res", [1, 2, 3])
def test_kernel_unpack_arithmetic(res):
    """The CUDA unpack's arithmetic, modelled in numpy: each nibble of a
    plane word times 0x00204081, masked with 0x01010101, spreads its bit k
    to byte k; the planes OR in at their weights (plane 0 is the MSB). It
    must give word_major_codes' bytes, bit 31 included."""
    words = np.random.default_rng(res).integers(0, 1 << 32, size=(res, 5, 7), dtype=np.uint64)
    words[:, 0, 0] = 0xFFFFFFFF
    nib = (words[..., None] >> (4 * np.arange(8, dtype=np.uint64))) & 0xF  # (res, n, W, 8)
    spread = (nib * 0x00204081) & 0x01010101
    lanes = np.zeros(spread.shape[1:], np.uint64)
    for p in range(res):
        lanes |= spread[p] << (res - 1 - p)
    got = lanes.astype("<u4").view(np.uint8).reshape(5, 7 * 32)  # little-endian: byte k is code 4g + k
    planes = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(got.astype(np.int8), K.word_major_codes(planes).numpy())


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_float_scores(metric):
    x, qx = _rows(C, seed=4), _rows(B, seed=5)
    for quant in ("quantize_f16", "quantize_f32"):
        j = JD.score(metric, "float", getattr(JQ, quant)(jnp.asarray(qx)), getattr(JQ, quant)(jnp.asarray(x)), D_PAD)
        t = TD.score(
            metric, "float", getattr(TQ, quant)(torch.from_numpy(qx)), getattr(TQ, quant)(torch.from_numpy(x)), D_PAD
        )
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_unsupported_metrics(pair):
    """Euclidean on sub-byte storage raises the reference's ValueError at
    score time; sub-byte hamming and float euclidean equal the reference's
    (hamming bit for bit, float euclidean within rtol 1e-5)."""
    _, q, store = pair
    tq, ts = _port_subbyte(q), _port_subbyte(store)
    with pytest.raises(ValueError, match="euclidean unsupported for sub-byte storage"):
        TD.score("euclidean", "subbyte", tq, ts, D_PAD)
    want = np.asarray(JD.score("hamming", "subbyte", q, store, D_PAD))
    np.testing.assert_array_equal(TD.score("hamming", "subbyte", tq, ts, D_PAD).numpy(), want)
    # distinct rows: a self-distance is the f32 residue of |x|² + |x|² - 2x·x
    xq, xs = _rows(4, seed=1), _rows(32, seed=2)
    want = np.asarray(JD.score("euclidean", "float", JQ.quantize_f32(jnp.asarray(xq)),
                               JQ.quantize_f32(jnp.asarray(xs)), D_PAD))
    got = TD.score("euclidean", "float", TQ.quantize_f32(torch.from_numpy(xq)), TQ.quantize_f32(torch.from_numpy(xs)),
                   D_PAD)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
