"""The port's dense exact-scan slices end to end on the CPU, against the
reference: DenseIndexHandle (sample -> range tune -> u8 store -> add_batch
-> search) and FlatIndex.search(rerank=True) on the same clustered data,
then both entry points over quaternary (2-bit) and f32 stores.

The reference side stays off its graph build (slow to compile on XLA:CPU):
its handle is built with the tuned range as an explicit scalar u8
quantization and set scan-only before the first add (so are both sides'
quaternary and f32 handles; the port's u8 handle builds its graph, which
answers above the serving limits), and its engine is
pinned to the codes engine with bins selection, the port's engine, and
its wire probe pinned fast, so it ships exact f32 queries as the port
does. Tolerances as in test_torch_flat_scan.py."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cosdata_tpu.core import collection as JC
from cosdata_tpu.indexes import flat as JFlat
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.core import collection as TC
from cosdata_tpu_torch.indexes import flat as TFlat
from cosdata_tpu_torch.indexes import hnsw as TH
from cosdata_tpu_torch.ops.kernels import u8_scan
from cosdata_tpu_torch.ops.storage import VectorStore

torch.set_num_threads(1)

DIM, N, NQ, K, BATCH, SCAN = 128, 8000, 16, 10, 2000, 4096
ROOT = Path(__file__).resolve().parents[1]


def gen_clustered(n, d, nq, seed=0):
    """bench.py's gen_clustered formula (copied, without its file cache)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // 100, 16)
    centers = rng.standard_normal(size=(n_clusters, d), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = np.float32(0.5 / np.sqrt(d))
    x = rng.standard_normal(size=(n, d), dtype=np.float32)
    x *= noise
    x += centers[rng.integers(0, n_clusters, n)]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal(size=(nq, d), dtype=np.float32)
    q *= noise
    q += centers[rng.integers(0, n_clusters, nq)]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.fixture(autouse=True)
def small_scan(monkeypatch):
    monkeypatch.setenv("COSDATA_FLAT_ENGINE", "codes")
    monkeypatch.setenv("COSDATA_SCAN_SELECT", "bins")
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)
    for cls in (JH.HNSWIndex, TH.HNSWIndex):
        monkeypatch.setattr(cls, "SCAN_CHUNK", SCAN)
    for cls in (JFlat.FlatIndex, TFlat.FlatIndex):
        monkeypatch.setattr(cls, "SCAN_THRESHOLD", SCAN)
        monkeypatch.setattr(cls, "SCAN_CHUNK", SCAN)


@pytest.fixture(scope="module")
def data():
    x, q = gen_clustered(N, DIM, NQ, seed=3)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :K]
    return x, q, truth


def _recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    prev = np.full(s.shape, np.inf)
    prev[:, 1:] = s[:, :-1] - s[:, 1:]
    nxt = np.full(s.shape, np.inf)
    nxt[:, :-1] = s[:, :-1] - s[:, 1:]
    return (prev > tol) & (nxt > tol)


def _compare(t, j, truth):
    (t_ids, t_vals), (j_ids, j_vals) = t, j
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-5, atol=1e-6)
    u = _untied(j_vals)
    assert u.mean() > 0.5
    np.testing.assert_array_equal(t_ids[u], j_ids[u])
    rt, rj = _recall(t_ids, truth), _recall(j_ids, truth)
    assert rt >= rj and rt >= 0.95, (rt, rj)


def _port_handle(x):
    h = TC.DenseIndexHandle(DIM, "cpu")  # quantization "auto", sample_threshold 100
    for s in range(0, N, BATCH):
        h.add_batch(list(range(s, s + BATCH)), x[s : s + BATCH])
    return h


@pytest.fixture(scope="module")
def handles(data):
    x, _, _ = data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JH.HNSWIndex, "SCAN_CHUNK", SCAN)
        mp.setattr(TH.HNSWIndex, "SCAN_CHUNK", SCAN)
        port = _port_handle(x)
        lo, hi = port.range
        ref = JC.DenseIndexHandle(
            DIM, quantization={"type": "scalar", "data_type": "u8", "range": {"min": lo, "max": hi}}
        )
        ref.index.scan_only = True
        for s in range(0, N, BATCH):
            ref.add_batch(list(range(s, s + BATCH)), x[s : s + BATCH])
    return port, ref


def test_auto_sampling_tunes_the_reference_range(data, handles):
    x, _, _ = data
    port, _ = handles
    assert port.range == JC.tune_dense_range(x[:BATCH]) == TC.tune_dense_range(x[:BATCH])
    assert port.index.n == N and port.index.cap == 8192
    for scale in (0.01, 0.1, 0.3, 2.0):
        v = np.random.default_rng(0).normal(0, scale, 5000).astype(np.float32)
        assert TC.tune_dense_range(v) == JC.tune_dense_range(v)


def test_handle_search_matches_reference(data, handles):
    _, q, truth = data
    port, ref = handles
    _compare(port.search(q, K), ref.search(q, K), truth)


def test_masked_search_matches_reference(data, handles):
    _, q, _ = data
    port, ref = handles
    mask = np.zeros(N, bool)
    mask[::13] = True
    t_ids, t_vals = port.search(q, K, row_mask=mask)
    j_ids, j_vals = ref.search(q, K, row_mask=mask)
    assert mask[t_ids].all() and (t_ids >= 0).all()
    truth = np.flatnonzero(mask)[np.argsort(-(q @ data[0][mask].T), axis=1)[:, :K]]
    _compare((t_ids, t_vals), (j_ids, j_vals), truth)


def test_flat_index_rerank_matches_reference(data):
    x, q, truth = data
    rng = TC.tune_dense_range(x[:1000])
    ref = JFlat.FlatIndex(DIM, kind="u8", range_=rng, raw_dtype="f16")
    port = TFlat.FlatIndex(DIM, "cpu", kind="u8", range_=rng, raw_dtype="f16")
    for s in range(0, N, BATCH):
        ref.add(x[s : s + BATCH])
        port.add(x[s : s + BATCH])
    j = ref.search(q, K, rerank=True)
    _compare(port.search(q, K, rerank=True), j, truth)
    # the reference's store loaded into the port answers the same
    a = ref.store._arrays
    arrays = {
        "data": np.asarray(a.data), "sums": np.asarray(a.sums), "mags": np.asarray(a.mags),
        "a": np.asarray(a.a), "b": np.asarray(a.b), "dtrue": np.asarray(a.dtrue),
        "raw": np.asarray(ref.store._raw), "n": ref.store.n, "capacity": ref.store.capacity,
        "dim": ref.store.dim, "range": ref.store.range,
    }
    loaded = TFlat.FlatIndex.from_store(VectorStore.from_arrays(arrays, metric="cosine", device="cpu"))
    _compare(loaded.search(q, K, rerank=True), j, truth)
    np.testing.assert_array_equal(loaded.store.arrays.data.numpy(), port.store.arrays.data.numpy())


@pytest.fixture(scope="module", params=["quaternary", "f32"])
def kind_handles(request, data):
    """Port and reference handles over one explicit data type."""
    x, _, _ = data
    quant = {"type": "scalar", "data_type": request.param}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)  # the reference ingests exact f32 rows
        mp.setattr(JH.HNSWIndex, "SCAN_CHUNK", SCAN)
        mp.setattr(TH.HNSWIndex, "SCAN_CHUNK", SCAN)
        port = TC.DenseIndexHandle(DIM, "cpu", quantization=quant)
        ref = JC.DenseIndexHandle(DIM, quantization=quant)
        # both scan-only: these handles are held on the scan under the limits
        port.index.scan_only = ref.index.scan_only = True
        for s in range(0, N, BATCH):
            port.add_batch(list(range(s, s + BATCH)), x[s : s + BATCH])
            ref.add_batch(list(range(s, s + BATCH)), x[s : s + BATCH])
    return request.param, port, ref


def test_kind_handle_search_matches_reference(data, kind_handles):
    _, q, truth = data
    dt, port, ref = kind_handles
    store = port.index.store
    assert (store.kind, store.resolution) == (ref.index.store.kind, ref.index.store.resolution)
    assert port.index._rerank_factor() == ref.index._rerank_factor() == (20 if dt == "quaternary" else 5)
    _compare(port.search(q, K), ref.search(q, K), truth)
    mask = np.zeros(N, bool)
    mask[::7] = True
    t_ids, t_vals = port.search(q, K, row_mask=mask)
    assert mask[t_ids].all() and (t_ids >= 0).all()
    masked_truth = np.flatnonzero(mask)[np.argsort(-(q @ data[0][mask].T), axis=1)[:, :K]]
    _compare((t_ids, t_vals), ref.search(q, K, row_mask=mask), masked_truth)


@pytest.mark.parametrize("kind", ["quaternary", "f32"])
def test_flat_index_kind_matches_reference(data, kind):
    x, q, truth = data
    factor = 20 if kind == "quaternary" else 5
    ref = JFlat.FlatIndex(DIM, kind=kind)
    port = TFlat.FlatIndex(DIM, "cpu", kind=kind)
    for s in range(0, N, BATCH):
        ref.add(x[s : s + BATCH])
        port.add(x[s : s + BATCH])
    j = ref.search(q, K, rerank=True, rerank_factor=factor)
    _compare(port.search(q, K, rerank=True, rerank_factor=factor), j, truth)
    # the reference's store loaded into the port answers the same
    arrays = {name: np.asarray(v) for name, v in ref.store._arrays._asdict().items()}
    arrays.update(
        raw=np.asarray(ref.store._raw), n=ref.store.n, capacity=ref.store.capacity, dim=ref.store.dim
    )
    loaded = TFlat.FlatIndex.from_store(VectorStore.from_arrays(arrays, metric="cosine", device="cpu"))
    assert (loaded.store.kind, loaded.store.resolution) == (port.store.kind, port.store.resolution)
    _compare(loaded.search(q, K, rerank=True, rerank_factor=factor), j, truth)
    # the port quantized the rows as the reference did: planes or data bit for bit
    np.testing.assert_array_equal(loaded.store.arrays[0].numpy(), port.store.arrays[0].numpy())
    np.testing.assert_allclose(loaded.store.arrays.mags.numpy(), port.store.arrays.mags.numpy(), rtol=1e-6)


def test_semantics(data):
    x, q, _ = data
    h = _port_handle(x)
    ids, _ = h.search(x[[5, 4321]], K)
    assert ids[:, 0].tolist() == [5, 4321]
    h.delete(5)
    ids, _ = h.search(x[[5]], K)
    assert 5 not in ids and (ids >= 0).all()
    empty = TC.DenseIndexHandle(DIM, "cpu")
    ids, vals = empty.search(q[:3], K)
    assert (ids == -1).all() and np.isneginf(vals).all() and ids.shape == (3, K)
    flat = TFlat.FlatIndex(DIM, "cpu", kind="u8")
    ids, vals = flat.search(q[:2], K, rerank=True)
    assert (ids == -1).all() and np.isneginf(vals).all()
    # the small-store path (capacity below SCAN_THRESHOLD)
    flat.add(x[:500])
    ids, _ = flat.search(x[[7, 300]], K, rerank=True)
    assert ids[:, 0].tolist() == [7, 300]
    flat.delete(7)
    assert 7 not in flat.search(x[[7]], K)[0]
    assert u8_scan.u8_bin_max.launches == 0


def test_routes_not_ported_raise(data, handles):
    """Above the serving limits the handle answers by its graph (built by
    insertion waves as the rows came in); two shards on the CPU serve
    self-queries; euclidean and hamming handles and raw_storage "host" and
    "disk" (the spill tiers) are accepted."""
    x, q, truth = data
    port, _ = handles
    old = port.flat_serve_threshold
    port.flat_serve_threshold = N - 1
    try:
        ids, _ = port.search(q, K)
        assert _recall(ids, truth) >= 0.95
        mask = np.ones(N, bool)
        old_min = port.graph_filter_min
        port.graph_filter_min = N - 1
        ids, _ = port.search(q, K, row_mask=mask)
        assert _recall(ids, truth) >= 0.95
        mask[::2] = False
        ids, _ = port.search(q, K, row_mask=mask)
        assert (ids >= 0).all() and (ids % 2 == 1).all()
        port.graph_filter_min = old_min
    finally:
        port.flat_serve_threshold = old
    # sharding is ported: two shards on the CPU serve a self-query
    h = TC.DenseIndexHandle(DIM, "cpu", shards=2)
    h.add_batch(list(range(300)), x[:300])
    assert h.index.is_sharded and [s.n for s in h.index.shards] == [150, 150]
    assert h.descriptor["shards"] == 2
    ids, _ = h.search(x[[5, 250]], K)
    assert ids[:, 0].tolist() == [5, 250]
    # euclidean and hamming are ported: each handle serves a self-query
    for kwargs in (
        {"distance_metric": "euclidean"},
        {"distance_metric": "hamming"},
        {"distance_metric": "euclidean", "quantization": {"type": "scalar", "data_type": "f32"}},
        {"distance_metric": "hamming", "quantization": {"type": "scalar", "data_type": "binary"}},
    ):
        h = TC.DenseIndexHandle(DIM, "cpu", **kwargs)
        h.add_batch(list(range(300)), x[:300])
        ids, _ = h.search(x[[5, 250]], K)
        assert ids[:, 0].tolist() == [5, 250], kwargs
        assert h.index.scan_only == (h.metric == "hamming")
    # the spill tiers are ported: host and disk raw rows are accepted
    for tier in ("host", "disk"):
        h = TC.DenseIndexHandle(DIM, "cpu", raw_storage=tier, quantization={"type": "scalar", "data_type": "u8"})
        assert h.keep_raw == tier and h.index.store.raw_on_host and h.descriptor["raw_storage"] == tier
        h.index.store.close()
    ids, _ = port.index.search(x[[5, 4321]], K)
    assert ids[:, 0].tolist() == [5, 4321]


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, pkgutil, importlib, cosdata_tpu_torch\n"
        "for name in ('api.server', 'grpc_api.server', 'store.snapshots', '__main__', 'cosql', 'text.native'):\n"
        "    importlib.import_module('cosdata_tpu_torch.' + name)\n"
        "from cosdata_tpu_torch.text.native import LIBRARY\n"
        "LIBRARY.load()  # builds the text library if it is not there yet\n"
        "assert LIBRARY.terms('Runs running ΟΔΟΣ', 40, True)[0] == 3\n"
        "from cosdata_tpu_torch.cosql import parse_statement\n"
        "assert parse_statement('define entity city as name: string;')['kind'] == 'entity_definition'\n"
        "for m in pkgutil.walk_packages(cosdata_tpu_torch.__path__, 'cosdata_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cosdata_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('cosdata_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40
