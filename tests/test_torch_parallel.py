"""The port's sharded dense engines against the reference's, on the CPU.

The reference runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port on ``["cpu"] * n`` (a mesh may repeat a device).

- ``ShardedFlatIndex`` on dp 4 x tp 2 and dp 8 x tp 1, by cosine, dot and
  euclidean (rows scaled by U[0.5, 1.5] so the metrics rank apart): ids
  equal where the reference's scores are untied, values within atol
  1e-5. Waves that span the dp rows' edges (every row is its own nearest),
  -1 for unfilled slots, the capacity guard and ``make_mesh``'s rule.
- ``ShardedHNSWIndex``: the round-robin placement list for list; the scan
  route (u8, f32, quaternary; two shards whose capacity is one 65,536-row
  scan chunk, so K1's and K2's plain versions run), masked and unmasked,
  ids equal on untied slots (scores rtol 1e-5, atol 1e-6); the graph
  route (the serving limit set to 0) within 0.01 of the reference's
  recall against the exact f32 oracle; deletes, ``raw_rows`` and host raw
  rows. The scan-route shards are scan-only on both sides (no graph build).
- The reference's served tests (``TestServedSharded``): a collection with
  ``config.shards: 4`` written through a transaction, searched, filtered,
  streamed a delete, snapshotted and restarted, in each package, with the
  same answers; the same over HTTP; gRPC FindSimilarVectors equal to the
  direct search in both.
- Sharded snapshots both ways: each package opens the other's data dir and
  answers as the writer did.
"""

import asyncio

import grpc
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from cosdata_tpu.api.server import make_app as j_make_app
from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.grpc_api.server import build_server as j_build_server
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu.parallel import sharded as JSh
from cosdata_tpu.parallel.sharded_hnsw import ShardedHNSWIndex as JSharded
from cosdata_tpu_torch.api.server import make_app as t_make_app
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext
from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb
from cosdata_tpu_torch.grpc_api.server import build_server as t_build_server
from cosdata_tpu_torch.indexes import hnsw as TH
from cosdata_tpu_torch.parallel import sharded as TSh
from cosdata_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex as TSharded

torch.set_num_threads(1)
ADMIN = "shard-key"
K = 10
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def reference_engine(monkeypatch):
    """The reference's u8 scan on the codes engine with bins selection (the
    port's engine) and its wire probe pinned fast (exact f32 queries)."""
    monkeypatch.setenv("COSDATA_FLAT_ENGINE", "codes")
    monkeypatch.setenv("COSDATA_SCAN_SELECT", "bins")
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(n, d, nq, seed):
    """bench.py's gen_clustered formula (copied, without its file cache)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal(size=(max(n // 100, 16), d), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = np.float32(0.5 / np.sqrt(d))

    def rows(m):
        x = rng.standard_normal(size=(m, d), dtype=np.float32) * noise
        x += centers[rng.integers(0, len(centers), m)]
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return rows(n), rows(nq)


def _untied(s, rtol=1e-5):
    """Slots whose score is apart from both neighbours in its row."""
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:, :-1] - s[:, 1:]
    inf = np.full((s.shape[0], 1), np.inf)
    return (np.concatenate([inf, gap], 1) > tol) & (np.concatenate([gap, inf], 1) > tol)


def _compare(t, j, atol=1e-6, rtol=1e-5):
    (t_ids, t_vals), (j_ids, j_vals) = t, j
    assert t_ids.shape == j_ids.shape
    np.testing.assert_allclose(t_vals, j_vals, rtol=rtol, atol=atol)
    u = _untied(j_vals) & np.isfinite(j_vals)
    assert u.mean() > 0.5
    np.testing.assert_array_equal(t_ids[u], j_ids[u])


def _recall(ids, truth):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(ids, truth)])


# ------------------------------------------------------------------ the mesh

MESHES = {"dp4_tp2": 2, "dp8_tp1": 1}


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_flat_matches_reference(mesh, metric):
    tp = MESHES[mesh]
    d, n, nq = 64, 700, 16
    x = _unit(n, d, 0) * np.random.default_rng(1).uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    q = _unit(nq, d, 2)
    jm, tm = JSh.make_mesh(8, tp=tp), TSh.make_mesh(tp=tp, devices=CPU8)
    assert tm.shape == dict(jm.shape)
    ref = JSh.ShardedFlatIndex(jm, dim=d, capacity=1000, metric=metric)
    port = TSh.ShardedFlatIndex(tm, dim=d, capacity=1000, metric=metric)
    assert port.capacity == ref.capacity
    for lo, hi in ((0, 300), (300, n)):  # two waves, across the dp rows' edges
        ref.add(x[lo:hi])
        port.add(x[lo:hi])
    _compare(port.search(q, K), ref.search(q, K), atol=1e-5, rtol=0)


def test_flat_waves_span_shard_edges():
    """Every row is its own nearest after waves that cross the dp rows'
    edges (capacity 512 over dp 4: 128 rows each), as in the reference."""
    x = _unit(300, 64, 2)
    tm = TSh.make_mesh(devices=CPU8)
    port = TSh.ShardedFlatIndex(tm, dim=64, capacity=512)
    ref = JSh.ShardedFlatIndex(JSh.make_mesh(8), dim=64, capacity=512)
    for lo, hi in ((0, 100), (100, 250), (250, 300)):
        np.testing.assert_array_equal(port.add(x[lo:hi]), ref.add(x[lo:hi]))
    ids, _ = port.search(x, top_k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(300))
    np.testing.assert_array_equal(ids, ref.search(x, top_k=1)[0])
    dp_only = TSh.ShardedFlatIndex(TSh.make_mesh(tp=1, devices=CPU8), dim=64, capacity=256)
    dp_only.add(x[:128])
    np.testing.assert_array_equal(dp_only.search(x[:4], top_k=1)[0][:, 0], np.arange(4))


def test_flat_pads_unfilled_slots_and_guards_capacity():
    tm = TSh.make_mesh(devices=CPU8)
    port = TSh.ShardedFlatIndex(tm, dim=64, capacity=64)
    port.add(_unit(5, 64, 9))
    ids, vals = port.search(_unit(2, 64, 9), top_k=10)
    assert (ids[:, 5:] == -1).all() and set(ids[0, :5].tolist()) == set(range(5))
    ref = JSh.ShardedFlatIndex(JSh.make_mesh(8), dim=64, capacity=64)
    ref.add(_unit(5, 64, 9))
    j_ids, j_vals = ref.search(_unit(2, 64, 9), top_k=10)
    np.testing.assert_array_equal(ids == -1, j_ids == -1)
    np.testing.assert_allclose(vals[:, :5], j_vals[:, :5], atol=1e-5)
    small = TSh.ShardedFlatIndex(tm, dim=64, capacity=16)
    with pytest.raises(RuntimeError):
        small.add(_unit(100, 64, 3))
    with pytest.raises(ValueError):
        TSh.ShardedFlatIndex(tm, dim=63, capacity=16)


def test_make_mesh_rule():
    """tp = 2 for an even count of at least 4, else 1; dp = count // tp;
    a ValueError when dp < 1; capacity rounds up to a multiple of dp."""
    for n in range(1, 9):
        assert TSh.make_mesh(n, devices=CPU8).shape == dict(JSh.make_mesh(n).shape), n
    assert TSh.make_mesh(devices=["cpu"] * 4, tp=4).shape == {"dp": 1, "tp": 4}
    with pytest.raises(ValueError):
        TSh.make_mesh(2, tp=4, devices=CPU8)
    with pytest.raises(ValueError):
        JSh.make_mesh(2, tp=4)
    assert TSh.ShardedFlatIndex(TSh.make_mesh(6, devices=CPU8), dim=8, capacity=10).capacity == 12
    v, m = TSh.shard_vectors(TSh.make_mesh(devices=CPU8), _unit(16, 8, 1))
    assert len(v) == 4 and len(v[0]) == 2 and tuple(v[0][0].shape) == (4, 4) and tuple(m[3].shape) == (4,)


# --------------------------------------------------------- ShardedHNSWIndex

QUANT = {"u8": {"kind": "u8", "range_": (-0.5, 0.5)}, "f32": {"kind": "f32"}, "quaternary": {"kind": "quaternary"}}


def _pair(kind, n_shards, scan_only, **kw):
    """The reference's and the port's sharded index, alike."""
    dim = kw.pop("dim", 64)
    ref = JSharded(dim=dim, devices=jax.devices()[:n_shards], **QUANT[kind], **kw)
    port = TSharded(dim=dim, devices=["cpu"] * n_shards, **QUANT[kind], **kw)
    if scan_only:
        for shard in ref.shards + port.shards:
            shard.scan_only = True
    return ref, port


def test_round_robin_placement_matches_reference():
    """The placement list for list, and searches between adds (the id maps
    follow the shards as they grow)."""
    x = _unit(400, 16, 4)
    ref, port = _pair("f32", 4, True, dim=16)
    s = 0
    for b in (3, 1, 7, 64, 2, 1, 1, 200, 5):
        np.testing.assert_array_equal(port.add(x[s : s + b]), ref.add(x[s : s + b]))
        s += b
        ids, _ = port.search(x[:s], 1)
        np.testing.assert_array_equal(ids[:, 0], np.arange(s))
    _compare(port.search(x[:40], K), ref.search(x[:40], K))
    assert port._global_of == ref._global_of
    assert port._loc_of == ref._loc_of
    assert port._rr == ref._rr and port.n == ref.n == s
    assert [sh.n for sh in port.shards] == [sh.n for sh in ref.shards]


@pytest.fixture(scope="module")
def scan_pairs():
    """Two shards per kind, capacity one 65,536-row scan chunk each, 3,000
    clustered rows, scan-only on both sides."""
    x, q = _clustered(3000, 64, 16, seed=5)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COSDATA_FLAT_ENGINE", "codes")
        mp.setenv("COSDATA_SCAN_SELECT", "bins")
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        for kind in QUANT:
            ref, port = _pair(kind, 2, True, dim=64, initial_capacity_per_shard=TH.HNSWIndex.SCAN_CHUNK)
            ref.add(x)
            port.add(x)
            out[kind] = (ref, port)
    return x, q, out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", list(QUANT))
def test_scan_route_matches_reference(scan_pairs, kind, masked):
    x, q, pairs = scan_pairs
    ref, port = pairs[kind]
    assert all(sh.cap >= TH.HNSWIndex.SCAN_CHUNK == JH.HNSWIndex.SCAN_CHUNK for sh in port.shards)
    mask = None
    if masked:
        mask = np.zeros(len(x), bool)
        mask[::2] = True
    t = port.search(q, K, row_mask=mask)
    _compare(t, ref.search(q, K, row_mask=mask))
    sims = q @ x.T
    if masked:
        assert (t[0] % 2 == 0).all()
        sims[:, ~mask] = -np.inf
    truth = np.argsort(-sims, axis=1)[:, :K]
    assert _recall(t[0], truth) >= (0.9 if kind == "quaternary" else 0.95)


GRAPH = {  # rows, HNSWParams: the reference's test_parallel.py parameters, one wave shape per shard
    "f32": (1024, dict(num_layers=3, wave_size=256, ef_construction=64, ef_search=96, max_iters=64)),
    "u8": (1024, dict(num_layers=3, wave_size=256, ef_construction=64, ef_search=96, max_iters=64)),
    "quaternary": (1024, dict(num_layers=2, wave_size=128, ef_construction=48, ef_search=96, max_iters=32)),
}


@pytest.mark.parametrize("kind", list(GRAPH))
def test_graph_route_recall_matches_reference(kind):
    n, params = GRAPH[kind]
    x, q = _clustered(n, 64, 16, seed=9)
    ref = JSharded(dim=64, devices=jax.devices()[:4], params=JH.HNSWParams(**params),
                   initial_capacity_per_shard=512, **QUANT[kind])
    port = TSharded(dim=64, devices=["cpu"] * 4, params=TH.HNSWParams(**params),
                    initial_capacity_per_shard=512, **QUANT[kind])
    ref.add(x)
    port.add(x)
    ref.flat_serve_threshold = port.flat_serve_threshold = 0  # every shard takes its graph
    assert all(not sh.scan_only and sh.entry >= 0 for sh in port.shards)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :K]
    rt, rj = _recall(port.search(q, K)[0], truth), _recall(ref.search(q, K)[0], truth)
    assert rt >= rj - 0.01, (rt, rj)
    assert rt >= 0.85


def test_delete_raw_rows_and_host_raw_rows():
    """Deletes route to the owning shard; raw_rows read back by global id;
    shards with host raw rows rerank a 5x shortlist on the host side."""
    x, q = _clustered(1500, 32, 12, seed=11)
    ref, port = _pair("u8", 3, True, dim=32, keep_raw="host")
    ref.add(x[:700])
    port.add(x[:700])
    ref.add(x[700:])
    port.add(x[700:])
    assert port.store.raw_on_host
    _compare(port.search(q, K), ref.search(q, K))
    rows = np.asarray([0, 5, 699, 700, 1499, 7000])
    got = port.raw_rows(rows)
    np.testing.assert_array_equal(got[:5], x[rows[:5]])
    assert (got[5] == 0).all()
    np.testing.assert_array_equal(got, ref.raw_rows(rows))
    for g in (3, 800, 3):
        port.delete(g)
        ref.delete(g)
    assert port.n_deleted == ref.n_deleted == 2
    ids, _ = port.search(x[[3, 800]], K)
    assert 3 not in ids[0] and 800 not in ids[1]
    _compare(port.search(q, K), ref.search(q, K))


def test_no_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSharded(dim=8, n_shards=2)


# ------------------------------------------------------ the served engine

SCHEMA = {"fields": [{"name": "cat", "values": ["a", "b"]}]}
CAT_B = {"Is": {"field_name": "cat", "field_value": "b", "operator": "Equal"}}


def _ctx(pkg, data_dir):
    if pkg == "ref":
        return JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
    return TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")


def _close(ctx):
    if isinstance(ctx, TAppContext):
        ctx.close()
    else:
        ctx.indexing.stop()
        ctx.meta.close()


def _sharded_collection(ctx, x, name="shc", shards=4, raw_storage="device"):
    coll = ctx.create_collection({
        "name": name, "dense_vector": {"enabled": True, "dimension": x.shape[1]},
        "sparse_vector": {"enabled": False}, "tf_idf_options": {"enabled": False},
        "config": {"max_vectors": None, "shards": shards}, "metadata_schema": SCHEMA,
    })
    coll.create_dense_index(
        quantization={"type": "scalar", "data_type": "u8", "range": {"min": -0.5, "max": 0.5}},
        hnsw_params={"num_layers": 2, "wave_size": 64, "max_iters": 32}, raw_storage=raw_storage,
    )
    txn = coll.create_transaction()
    coll.txn_upsert(txn.txn_id, [
        {"id": f"v{i}", "dense_values": x[i].tolist(), "metadata": {"cat": "a" if i % 2 else "b"}}
        for i in range(len(x))
    ], upsert=False)
    ctx.indexing.trigger(coll, coll.commit_transaction(txn.txn_id), txn)
    ctx.indexing.wait_idle()
    return coll


def _answers(coll, q):
    return {
        "plain": coll.search_dense([v.tolist() for v in q], top_k=K),
        "filtered": coll.search_dense([v.tolist() for v in q], top_k=K, filter_dto=CAT_B),
        "vector": coll.get_vector("v9"),
    }


def _same_answers(t, j):
    for key in ("plain", "filtered"):
        for tr, jr in zip(t[key], j[key]):
            ts, js = [r["score"] for r in tr], [r["score"] for r in jr]
            assert len(tr) == len(jr)
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
            u = _untied(np.asarray([js]))[0]
            assert [r["id"] for r, ok in zip(tr, u) if ok] == [r["id"] for r, ok in zip(jr, u) if ok]
    tv, jv = dict(t["vector"]), dict(j["vector"])
    np.testing.assert_allclose(tv.pop("dense_values"), jv.pop("dense_values"), atol=1e-6)
    assert tv == jv


def _lifecycle(pkg, tmp_path):
    """The reference's TestServedSharded lifecycle; returns what it saw."""
    x = _unit(240, 32, 21)
    q = x[[7, 8, 9, 30]]
    ctx = _ctx(pkg, tmp_path / pkg)
    out = {}
    try:
        coll = _sharded_collection(ctx, x)
        idx = coll.dense.index
        out["engine"] = (getattr(idx, "is_sharded", False), len(idx.shards), coll.dense.descriptor.get("shards"))
        out["populated"] = [s.n for s in idx.shards]
        out["before"] = _answers(coll, q)
        coll.stream_delete("v7")
        out["deleted"] = coll.search_dense([x[7].tolist()], top_k=3)[0]
        coll.save_snapshot()
    finally:
        _close(ctx)
    ctx = _ctx(pkg, tmp_path / pkg)
    try:
        c2 = ctx.get_collection("shc")
        out["restart_engine"] = (getattr(c2.dense.index, "is_sharded", False), [s.n for s in c2.dense.index.shards])
        out["after"] = _answers(c2, q[1:])
        out["restart_deleted"] = c2.search_dense([x[7].tolist()], top_k=3)[0]
    finally:
        _close(ctx)
    return out


@pytest.fixture(scope="module")
def lifecycles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lifecycle")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        ref = _lifecycle("ref", tmp)
    return ref, _lifecycle("port", tmp)


@pytest.mark.parametrize("step", ["engine", "answers", "delete", "restart"])
def test_served_lifecycle_matches_reference(lifecycles, step):
    ref, port = lifecycles
    for out in (ref, port):
        if step == "engine":
            assert out["engine"] == (True, 4, 4)
            assert min(out["populated"]) > 0 and sum(out["populated"]) == 240
        elif step == "answers":
            assert out["before"]["plain"][0][0]["id"] == "v7"
            got = [r["id"] for r in out["before"]["filtered"][1]]
            assert got[0] == "v8" and all(int(g[1:]) % 2 == 0 for g in got)
        elif step == "delete":
            assert out["deleted"][0]["id"] != "v7"
        else:
            assert out["restart_engine"] == (True, out["populated"])
            assert out["after"]["plain"][1][0]["id"] == "v9"
            assert "v7" not in [r["id"] for r in out["restart_deleted"]]
    if step == "engine":
        assert port["populated"] == ref["populated"]
    elif step == "answers":
        _same_answers(port["before"], ref["before"])
    elif step == "delete":
        assert [r["id"] for r in port["deleted"]] == [r["id"] for r in ref["deleted"]]
    else:
        _same_answers(port["after"], ref["after"])
        assert [r["id"] for r in port["restart_deleted"]] == [r["id"] for r in ref["restart_deleted"]]


async def _http_script(client, x):
    """The reference's test_http_sharded_collection; returns the search answers."""
    r = await client.post("/auth/create-session", json={"username": "admin", "password": ADMIN})
    hdr = {"Authorization": f"Bearer {(await r.json())['access_token']}"}
    r = await client.post("/vectordb/collections", headers=hdr, json={
        "name": "hsc", "dense_vector": {"enabled": True, "dimension": x.shape[1]},
        "config": {"max_vectors": None, "shards": 4},
    })
    assert r.status == 201, await r.text()
    r = await client.post("/vectordb/collections/hsc/indexes/dense", headers=hdr, json={
        "name": "idx", "distance_metric_type": "cosine",
        "quantization": {"type": "scalar", "properties": {"data_type": "u8"}, "data_type": "u8",
                         "range": {"min": -0.5, "max": 0.5}},
        "hnsw_params": {"num_layers": 2},
    })
    assert r.status == 201, await r.text()
    desc = await r.json()
    r = await client.post("/vectordb/collections/hsc/transactions", json={}, headers=hdr)
    txn_id = (await r.json())["transaction_id"]
    r = await client.post(f"/vectordb/collections/hsc/transactions/{txn_id}/upsert", headers=hdr, json={
        "vectors": [{"id": f"v{i}", "dense_values": x[i].tolist()} for i in range(len(x))]})
    assert r.status == 200, await r.text()
    r = await client.post(f"/vectordb/collections/hsc/transactions/{txn_id}/commit", json={}, headers=hdr)
    assert r.status == 200, await r.text()
    for _ in range(600):
        r = await client.get(f"/vectordb/collections/hsc/transactions/{txn_id}/status", headers=hdr)
        if (await r.json())["status"] == "complete":
            break
        await asyncio.sleep(0.05)
    out = {"desc": desc}
    # the index body's own "shards" reaches the handle, over a collection without the knob
    r = await client.post("/vectordb/collections", headers=hdr, json={
        "name": "hsc2", "dense_vector": {"enabled": True, "dimension": x.shape[1]}})
    assert r.status == 201, await r.text()
    r = await client.post("/vectordb/collections/hsc2/indexes/dense", headers=hdr, json={
        "name": "idx2", "distance_metric_type": "cosine", "shards": 2,
        "quantization": {"type": "scalar", "data_type": "u8", "range": {"min": -0.5, "max": 0.5}}})
    out["desc_body_shards"] = (r.status, await r.json())
    r = await client.post("/vectordb/collections/hsc/search/dense", headers=hdr,
                          json={"query_vector": x[11].tolist(), "top_k": 3})
    out["single"] = (r.status, await r.json())
    r = await client.post("/vectordb/collections/hsc/search/batch-dense", headers=hdr,
                          json={"queries": [{"vector": x[i].tolist()} for i in (1, 50, 199)], "top_k": K})
    out["batch"] = (r.status, await r.json())
    return out


def _http(pkg, tmp, x):
    ctx = _ctx(pkg, tmp / pkg)
    make_app = j_make_app if pkg == "ref" else t_make_app

    async def run():
        client = TestClient(TestServer(make_app(ctx)))
        await client.start_server()
        try:
            out = await _http_script(client, x)
        finally:
            await client.close()
        out["shards"] = [s.n for s in ctx.get_collection("hsc").dense.index.shards]
        out["shards_body"] = len(ctx.get_collection("hsc2").dense.index.shards)
        return out

    try:
        return asyncio.run(run())
    finally:
        _close(ctx)


def test_http_sharded_collection_matches_reference(tmp_path):
    x = _unit(200, 32, 23)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        ref = _http("ref", tmp_path, x)
    port = _http("port", tmp_path, x)
    assert port["desc"] == ref["desc"] and port["desc"].get("shards") == 4
    assert port["desc_body_shards"] == ref["desc_body_shards"] and port["desc_body_shards"][1]["shards"] == 2
    assert port["shards_body"] == ref["shards_body"] == 2
    assert port["shards"] == ref["shards"] and min(port["shards"]) > 0
    for key in ("single", "batch"):
        assert port[key][0] == ref[key][0] == 200
    assert port["single"][1]["results"][0]["id"] == "v11"
    rows = [port["single"][1]["results"]] + [r["results"] for r in port["batch"][1]["responses"]]
    want = [ref["single"][1]["results"]] + [r["results"] for r in ref["batch"][1]["responses"]]
    for tr, jr in zip(rows, want):
        np.testing.assert_allclose([r["score"] for r in tr], [r["score"] for r in jr], rtol=1e-5, atol=1e-6)
        u = _untied(np.asarray([[r["score"] for r in jr]]))[0]
        assert [r["id"] for r, ok in zip(tr, u) if ok] == [r["id"] for r, ok in zip(jr, u) if ok]


def _grpc_find(pkg, ctx, queries):
    build = j_build_server if pkg == "ref" else t_build_server
    server = build(ctx, address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")

    def call(service, method, req, resp_cls, md=()):
        fn = channel.unary_unary(f"/vector_service.{service}/{method}",
                                 request_serializer=lambda m: m.SerializeToString(),
                                 response_deserializer=resp_cls.FromString)
        return fn(req, metadata=list(md), timeout=60)

    try:
        tok = call("AuthService", "CreateSession", pb.CreateSessionRequest(username="admin", password=ADMIN),
                   pb.CreateSessionResponse).access_token
        md = [("authorization", f"Bearer {tok}")]
        return [[(m.id, m.score) for m in call("VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id="shc", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=K)),
            pb.FindSimilarVectorsResponse, md).matches] for v in queries]
    finally:
        channel.close()
        server.stop(0)


def test_grpc_serves_sharded_collection(tmp_path):
    """gRPC FindSimilarVectors on a sharded collection gives the direct
    search's answers, in each package, and the port's equal the reference's."""
    x = _unit(240, 32, 25)
    q = x[[3, 17, 100]]
    got = {}
    for pkg in ("ref", "port"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
            ctx = _ctx(pkg, tmp_path / pkg)
            try:
                coll = _sharded_collection(ctx, x)
                direct = [[(r["id"], r["score"]) for r in res] for res in coll.search_dense(q, top_k=K)]
                found = _grpc_find(pkg, ctx, q)
            finally:
                _close(ctx)
        assert [[i for i, _ in r] for r in found] == [[i for i, _ in r] for r in direct], pkg
        np.testing.assert_allclose([[s for _, s in r] for r in found], [[s for _, s in r] for r in direct], atol=1e-6)
        got[pkg] = found
    assert [r[0][0] for r in got["port"]] == ["v3", "v17", "v100"]
    for tr, jr in zip(got["port"], got["ref"]):
        js = [s for _, s in jr]
        np.testing.assert_allclose([s for _, s in tr], js, rtol=1e-5, atol=1e-6)
        u = _untied(np.asarray([js]))[0]
        assert [i for (i, _), ok in zip(tr, u) if ok] == [i for (i, _), ok in zip(jr, u) if ok]


# ---------------------------------------------------------- snapshots

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sharded_snapshot_opens_in_the_other_package(tmp_path, writer):
    """A sharded collection written by one package (4 shards, a streamed
    delete) answers, in the other, as the writer answered: plain and
    filtered searches, GET, the tombstone, the shards' row counts."""
    reader = "port" if writer == "ref" else "ref"
    x = _unit(240, 32, 27)
    q = x[[5, 8, 31, 77]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        ctx = _ctx(writer, tmp_path)
        try:
            coll = _sharded_collection(ctx, x)
            coll.stream_delete("v31")
            coll.save_snapshot()
            want = _answers(coll, q)
            shards = [s.n for s in coll.dense.index.shards]
            global_of = [list(g) for g in coll.dense.index._global_of]
        finally:
            _close(ctx)
        assert (tmp_path / "collections" / "shc" / "snapshot" / "dense_sharded.msgpack").exists()
        ctx = _ctx(reader, tmp_path)
        try:
            c2 = ctx.get_collection("shc")
            idx = c2.dense.index
            assert getattr(idx, "is_sharded", False) and [s.n for s in idx.shards] == shards
            assert [list(g) for g in idx._global_of] == global_of
            got = _answers(c2, q)
            assert "v31" not in [r["id"] for r in got["plain"][2]]
        finally:
            _close(ctx)
    _same_answers(got, want)


def test_sharded_kept_graph_spill_snapshot_is_scan_only(tmp_path):
    """A shard spilled with its graph kept is written as the port writes
    an unsharded one: scan-only, with its host tombstones; after a
    restart it serves by the scan without the deleted row, and the other
    shards keep their graphs."""
    x = _unit(240, 32, 29)
    ctx = _ctx("port", tmp_path)
    try:
        coll = _sharded_collection(ctx, x, raw_storage="host")
        idx = coll.dense.index
        idx.shards[1].force_spill(keep_graph=True)
        assert idx.shards[1].graph_on_spill
        victim = next(g for g in idx._global_of[1] if g != 0)
        coll.stream_delete(f"v{victim}")
        want = coll.search_dense([x[victim].tolist(), x[0].tolist()], top_k=K)
        coll.save_snapshot()
    finally:
        _close(ctx)
    ctx = _ctx("port", tmp_path)
    try:
        idx = ctx.get_collection("shc").dense.index
        assert [sh.scan_only for sh in idx.shards] == [False, True, False, False]
        got = ctx.get_collection("shc").search_dense([x[victim].tolist(), x[0].tolist()], top_k=K)
    finally:
        _close(ctx)
    assert f"v{victim}" not in [r["id"] for r in got[0]] and got[1][0]["id"] == "v0"
    for tr, jr in zip(got, want):
        assert [r["id"] for r in tr] == [r["id"] for r in jr]
        np.testing.assert_allclose([r["score"] for r in tr], [r["score"] for r in jr], rtol=1e-6)
