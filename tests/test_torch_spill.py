"""The spill tiers of the HNSW index, side by side with the reference: each
of the reference's beyond-HBM tests (tests/test_hnsw.py, TestBeyondHBMSpill)
runs its scenario in both packages on the same numpy rows (3,000-4,000 x
64 random unit rows, the reference's seeds and parameters, its budgets
pinned by COSDATA_HBM_GB) and the port must meet the reference's
assertions and its answers:

- spill on growth (streamed search, a tombstone, a filter mask), the
  mid-add spill that frees the adjacency, the kept-graph spill's
  host-codes graph search (a tombstone mid-traversal, then an add that
  turns it scan-only), the streamed u8 search against the reference's
  plain and codes merges, re-promotion of an HNSW and a flat index, the
  spilled snapshot's restart, device raw rows over the budget, the
  sub-byte spill and its snapshot;
- streamed answers: scores within rtol 1e-5 of the reference's, ids equal
  where its scores are untied; graph answers: recall@5 against brute force
  within 0.01 of the reference's;
- spilled snapshots (u8 and quaternary, host and disk raw rows) written by
  either package load in the other with the codes on the host and answer
  identically to the writer;
- a ``raw_storage: "host"`` collection over REST, spilled by its budget,
  answers as the reference's server, before and after a restart, and its
  gRPC FindSimilarVectors equals its REST search.
"""

import asyncio

import grpc
import msgpack
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from cosdata_tpu.api.server import make_app as j_make_app
from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.indexes.flat import FlatIndex as JFlat
from cosdata_tpu.indexes.hnsw import HNSWIndex as JHNSW
from cosdata_tpu.indexes.hnsw import HNSWParams as JParams
from cosdata_tpu.ops import storage as JS
from cosdata_tpu.store import snapshots as JSnap
from cosdata_tpu_torch.api.auth import SessionManager as TSessions
from cosdata_tpu_torch.api.server import make_app as t_make_app
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext
from cosdata_tpu_torch.core.collection import DenseIndexHandle
from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb
from cosdata_tpu_torch.grpc_api.server import build_server as t_build_server
from cosdata_tpu_torch.indexes.flat import FlatIndex as TFlat
from cosdata_tpu_torch.indexes.hnsw import HNSWIndex as THNSW
from cosdata_tpu_torch.indexes.hnsw import HNSWParams as TParams
from cosdata_tpu_torch.store import snapshots as TSnap

torch.set_num_threads(1)

D = 64
SPILL = dict(num_layers=2, wave_size=256, max_iters=32)
KB = 1 / (1 << 20)  # COSDATA_HBM_GB of one KiB


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(kind="u8", res=2, cap=128, keep_raw="host", range_=(-0.3, 0.3)):
    j = JHNSW(dim=D, kind=kind, resolution=res, range_=range_, keep_raw=keep_raw, initial_capacity=cap,
              params=JParams(**SPILL))
    t = THNSW(D, "cpu", kind=kind, resolution=res, range_=range_, keep_raw=keep_raw, initial_capacity=cap,
              params=TParams(**SPILL))
    return j, t


@pytest.fixture(autouse=True)
def _fast_wire(monkeypatch):
    """The reference ships exact f32 rows and queries, as the port does."""
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)
    monkeypatch.delenv("COSDATA_STREAM_CODES", raising=False)


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-6
    with np.errstate(invalid="ignore"):
        gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [0.0]]) > tol)


def _same(t_out, j_out, rtol=1e-5):
    """Scores within rtol, ids equal where the reference's are untied."""
    (ti, ts), (ji, js) = t_out, j_out
    assert ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=1e-6)
    for t_row, j_row, s_row in zip(ti, ji, js):
        u = _untied(s_row, rtol)
        assert (t_row[u] == j_row[u]).all(), (t_row, j_row)


def _recall(got, x, q, k):
    truth = np.argsort(-(q @ x.T), axis=1)[:, :k]
    return np.mean([len(set(g.tolist()) & set(t.tolist())) / k for g, t in zip(got, truth)])


def test_spill_streamed_search_and_delete(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", str(50 * KB))
    j, t = _pair()
    x = _unit(3000, D, 31)
    assert len(t.add(x)) == len(j.add(x)) == 3000
    assert t.store.codes_on_host and t.scan_only and j.store.codes_on_host
    assert t.store.capacity == j.store.capacity
    got = t.search(x[:5], top_k=5)
    assert (got[0][:, 0] == np.arange(5)).all() and got[1][0, 0] > 0.98
    _same(got, j.search(x[:5], top_k=5))
    for idx in (t, j):
        idx.delete(3)
    got = t.search(x[3], top_k=5)
    assert 3 not in got[0][0]
    _same(got, j.search(x[3], top_k=5))
    mask = np.zeros(3000, bool)
    mask[::2] = True
    got = t.search_brute(x[:4], top_k=5, mask=mask)
    assert got[0][0, 0] == 0 and (got[0][got[0] >= 0] % 2 == 0).all()
    _same(got, j.search_brute(x[:4], top_k=5, mask=mask))
    # no rerank: the streamed u8 scores themselves
    _same(t.search_brute(x[:4], top_k=5, rerank=False), j.search_brute(x[:4], top_k=5, rerank=False), rtol=2e-5)


def test_graph_then_spill_frees_adjacency(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", str(100 * KB))
    j, t = _pair(cap=1024)
    x = _unit(4000, D, 33)
    for idx in (j, t):
        idx.add(x[:1000])  # fits: graph built
        assert not idx.scan_only
        idx.add(x[1000:])  # growth spills mid-add
        assert idx.store.codes_on_host and idx.scan_only
        assert idx.adj0.shape[0] == 1  # adjacency freed
        assert idx.n == 4000
    assert t.up_adj.shape[0] == t.adj0_d.shape[0] == 1 and len(t._alive_host) == t.cap
    got = t.search(x[:8], top_k=3)
    assert (got[0][:, 0] == np.arange(8)).all()
    _same(got, j.search(x[:8], top_k=3))


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_kept_graph_spill_serves_graph_search(tier):
    j, t = _pair(cap=4096, keep_raw=tier)
    x = _unit(4000, D, 41)
    q = x[:16]
    j.add(x)
    t.add(x)
    assert not t.scan_only
    for idx in (j, t):
        idx.force_spill(keep_graph=True)
        assert idx.store.codes_on_host and not idx.scan_only and idx.graph_on_spill
        assert idx.adj0.shape[0] >= 4000
    got, vals = t.search(q, top_k=5, ef=128)
    j_got, j_vals = j.search(q, top_k=5, ef=128)
    self_hit = np.mean([int(i in set(map(int, got[i]))) for i in range(16)])
    assert self_hit >= 0.9 and vals[0, 0] > 0.98
    assert _recall(got, x, q, 5) >= _recall(j_got, x, q, 5) - 0.01
    st = t.last_hostcodes_stats
    assert st["waves"] >= 1 and st["bytes"] == st["rows"] * (t.store.dim_pad + 8)
    # the graph without a rerank: the u8 beam's own order
    got_nr, _ = t.search(q, top_k=5, ef=128, rerank=False)
    assert _recall(got_nr, x, q, 5) >= _recall(j.search(q, top_k=5, ef=128, rerank=False)[0], x, q, 5) - 0.01
    target = int(got[1, 0])
    for idx in (j, t):
        idx.delete(target)
    got2, _ = t.search(x[1], top_k=5, ef=128)
    assert target not in set(map(int, got2[0]))
    # the streamed exact scan serves the same spilled store
    b_ids = t.search_brute(x[4:8], top_k=3)
    assert (b_ids[0][:, 0] == np.arange(4, 8)).all()
    _same(b_ids, j.search_brute(x[4:8], top_k=3))
    extra = _unit(8, D, 42)
    for idx in (j, t):
        idx.add(extra)  # ingest turns the kept-graph spill scan-only
        assert idx.scan_only and not idx.graph_on_spill
    got3 = t.search(x[4:8], top_k=3)
    assert (got3[0][:, 0] == np.arange(4, 8)).all()
    _same(got3, j.search(x[4:8], top_k=3))


def test_streamed_codes_merge_parity(monkeypatch):
    """The port's streamed u8 scan (K1 per chunk, the bins expanded and
    rescored) answers as the reference's plain merge and its codes merge
    (its Pallas K1 in interpret mode)."""
    monkeypatch.setenv("COSDATA_HBM_GB", str(50 * KB))
    j, t = _pair()
    x = _unit(3000, D, 37)
    j.add(x)
    t.add(x)
    assert t.store.codes_on_host
    got = t.search(x[:6], top_k=5)
    assert (got[0][:, 0] == np.arange(6)).all()
    monkeypatch.setenv("COSDATA_STREAM_CODES", "0")
    _same(got, j.search(x[:6], top_k=5))
    monkeypatch.setenv("COSDATA_STREAM_CODES", "interpret")
    _same(got, j.search(x[:6], top_k=5))


def test_repromote_restores_the_device_scan(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", str(50 * KB))
    j, t = _pair()
    x = _unit(3000, D, 35)
    j.add(x)
    t.add(x)
    for idx in (j, t):
        idx.delete(7)  # a tombstone while spilled (host mirror)
        assert not idx.maybe_promote() and idx.store.codes_on_host  # the budget still refuses
    monkeypatch.setenv("COSDATA_HBM_GB", "1.0")
    for idx in (j, t):
        assert idx.maybe_promote()
        assert not idx.store.codes_on_host and getattr(idx, "_alive_host", None) is None
    assert t.alive.shape[0] == t.cap and not bool(t.alive[7])
    got = t.search(x[:5], top_k=5)
    assert (got[0][:, 0] == np.arange(5)).all() and got[1][0, 0] > 0.98
    _same(got, j.search(x[:5], top_k=5))
    got7 = t.search(x[7], top_k=5)
    assert 7 not in got7[0][0]
    _same(got7, j.search(x[7], top_k=5))
    assert not t.maybe_promote() and not j.maybe_promote()  # a second promote is a no-op


def test_flat_repromote(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", str(50 * KB))
    j = JFlat(dim=D, kind="u8", range_=(-0.3, 0.3), keep_raw="host", initial_capacity=128)
    t = TFlat(D, "cpu", kind="u8", range_=(-0.3, 0.3), keep_raw="host", initial_capacity=128)
    x = _unit(2000, D, 36)
    j.add(x)
    t.add(x)
    assert t.store.codes_on_host and j.store.codes_on_host
    for idx in (j, t):
        idx.delete(2)
    spilled = t.search(x[:4], top_k=3, rerank=True)
    _same(spilled, j.search(x[:4], top_k=3, rerank=True))
    _same(t.search(x[:4], top_k=3), j.search(x[:4], top_k=3), rtol=2e-5)  # streamed, no rerank
    monkeypatch.setenv("COSDATA_HBM_GB", "1.0")
    assert t.maybe_promote() and j.maybe_promote()
    assert not t.store.codes_on_host
    got = t.search(x[:4], top_k=3, rerank=True)
    assert (got[0][[0, 1, 3], 0] == [0, 1, 3]).all() and 2 not in got[0]
    _same(got, j.search(x[:4], top_k=3, rerank=True))
    _same(got, spilled)


def test_device_raw_over_budget_raises_clearly(monkeypatch):
    monkeypatch.setenv("COSDATA_HBM_GB", str(50 * KB))
    for idx in _pair(keep_raw=True):
        with pytest.raises(RuntimeError, match="raw_storage"):
            idx.add(_unit(3000, D, 35))
    t = THNSW(D, "cpu", kind="u8", range_=(-0.3, 0.3), keep_raw=True)
    with pytest.raises(RuntimeError, match="store is not spillable"):
        t.force_spill()


def test_subbyte_spill_streamed_search(monkeypatch):
    x = _unit(3000, D, 37)
    ref = JHNSW(dim=D, kind="subbyte", resolution=2, keep_raw="host", initial_capacity=4096, params=JParams(**SPILL))
    ref.add(x)  # the reference's never-spilled index
    assert not ref.store.codes_on_host
    ref_ids, _ = ref.search_brute(x[:16], top_k=5)
    monkeypatch.setenv("COSDATA_HBM_GB", str(30 * KB))
    j, t = _pair("subbyte", 2, range_=(-1.0, 1.0))
    assert len(t.add(x)) == len(j.add(x)) == 3000
    assert t.store.codes_on_host and t.scan_only and t.store.arrays.planes.device.type == "cpu"
    got = t.search(x[:16], top_k=5)
    assert (got[0][:, 0] == np.arange(16)).all() and got[1][0, 0] > 0.98
    _same(got, j.search(x[:16], top_k=5))
    hit = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got[0], ref_ids)])
    assert hit > 0.95
    for idx in (j, t):
        idx.delete(7)
    got = t.search(x[7], top_k=5)
    assert 7 not in got[0][0]
    _same(got, j.search(x[7], top_k=5))


def _save_port(idx, path, rng):
    TSnap._save_dense(idx, path, list(rng))


def _load_port(path, keep_raw, kind):
    quant = {"type": "scalar", "data_type": kind}
    d = DenseIndexHandle(D, "cpu", quantization=quant, raw_storage=keep_raw,
                         hnsw_params=dict(SPILL))
    with open(path / "dense.msgpack", "rb") as f:
        meta = msgpack.unpackb(f.read(), strict_map_key=False)
    TSnap.load_dense(d, path, meta)
    return d.index


def _load_ref(path, keep_raw, kind, res):
    j = JHNSW(dim=D, kind=kind, resolution=res, range_=(-0.3, 0.3), keep_raw=keep_raw, initial_capacity=128,
              params=JParams(**SPILL))
    JSnap._load_one_dense(j, path, keep_raw)
    return j


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("kind", ["u8", "quaternary"])
def test_spilled_snapshots_load_in_both_packages(kind, tier, monkeypatch, tmp_path):
    """A spilled index (a tombstone, codes on the host) written by either
    package loads in the other with its codes on the host, scan-only, and
    answers as the writer did; the port's restart of its own snapshot too."""
    jk, res = ("u8", 2) if kind == "u8" else ("subbyte", 2)
    rng = (-0.3, 0.3) if kind == "u8" else (-1.0, 1.0)
    monkeypatch.setenv("COSDATA_HBM_GB", str(30 * KB))
    j, t = _pair(jk, res, keep_raw=tier, range_=rng)
    x, q = _unit(3000, D, 39), _unit(6, D, 40)
    j.add(x)
    t.add(x)
    for idx in (j, t):
        idx.delete(3)
        assert idx.store.codes_on_host and idx.scan_only
    queries = np.concatenate([x[:5], q])
    want_t, want_j = t.search(queries, top_k=5), j.search(queries, top_k=5)
    _same(want_t, want_j)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    _save_port(t, tmp_path / "t", rng)
    JSnap._save_one_dense(j, tmp_path / "j", list(rng))
    meta = msgpack.unpackb((tmp_path / "t" / "dense.msgpack").read_bytes(), strict_map_key=False)
    assert meta["codes_on_host"] and meta["scan_only"] and meta["capacity"] == t.cap
    assert (tmp_path / "t" / "raw_host.meta.json").exists() and not (tmp_path / "t" / "adj0.meta.json").exists()
    loaded = {
        "port<-port": _load_port(tmp_path / "t", tier, kind),
        "port<-ref": _load_port(tmp_path / "j", tier, kind),
    }
    for name, idx in loaded.items():
        assert idx.store.codes_on_host and idx.scan_only, name
        rows = idx.store.arrays.planes if jk == "subbyte" else idx.store.arrays.data
        assert rows.device.type == "cpu" and idx.store.keep_raw == tier
        if tier == "disk":
            assert isinstance(idx.store._raw_mm, np.memmap)
        got = idx.search(queries, top_k=5)
        np.testing.assert_array_equal(got[0], want_t[0])
        np.testing.assert_array_equal(got[1], want_t[1])
        assert 3 not in idx.search(x[3], top_k=5)[0][0]
    back = _load_ref(tmp_path / "t", tier, jk, res)
    assert back.store.codes_on_host and back.scan_only and isinstance(
        back.store._arrays.planes if jk == "subbyte" else back.store._arrays.data, np.ndarray)
    _same(back.search(queries, top_k=5), want_j)
    if jk == "subbyte":
        np.testing.assert_array_equal(loaded["port<-ref"].store.arrays.planes.numpy().view(np.uint32),
                                      np.asarray(j.store._arrays.planes))
    # the loaded index keeps ingesting into its spilled tier
    idx = loaded["port<-port"]
    idx.add(_unit(10, D, 41))
    assert idx.n == 3010 and idx.store.codes_on_host and idx.search(_unit(10, D, 41)[:1], 1)[0][0, 0] == 3000
    for idx in loaded.values():
        idx.store.close()


def test_kept_graph_spill_snapshot_is_scan_only(tmp_path):
    j, t = _pair(cap=4096)
    x = _unit(3000, D, 43)
    t.add(x)
    t.force_spill(keep_graph=True)
    t.delete(5)
    _save_port(t, tmp_path, (-0.3, 0.3))
    idx = _load_port(tmp_path, "host", "u8")
    assert idx.scan_only and idx.store.codes_on_host and not idx.graph_on_spill
    got, _ = idx.search(x[:8], top_k=3)
    assert got[5, 0] != 5 and (got[[0, 1, 2, 3, 4, 6, 7], 0] == [0, 1, 2, 3, 4, 6, 7]).all()
    back = _load_ref(tmp_path, "host", "u8", 2)
    _same(back.search(x[:8], top_k=3), idx.search(x[:8], top_k=3))


# ---------------------------------------------------------------- servers

ADMIN = "spill-key"
N_REST, DIM_REST = 1500, 48


def _vec(i, x):
    v = {"id": i, "dense_values": [round(float(a), 6) for a in x[i]]}
    if i % 2 == 0:
        v["metadata"] = {"color": "red" if i % 4 == 0 else "blue"}
    return v


SCHEMA = {"fields": [{"name": "color", "values": ["red", "blue"]}], "supported_conditions": []}
RED = {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}}


def _script(make_app, ctx, x, q, create: bool):
    """The REST requests; returns {step: body}."""

    async def run():
        client = TestClient(TestServer(make_app(ctx)))
        await client.start_server()
        try:
            out = {}
            tok = await (await client.post("/auth/create-session",
                                           json={"username": "admin", "password": ADMIN})).json()
            h = {"Authorization": f"Bearer {tok['access_token']}"}
            c = "/vectordb/collections/spill"
            if create:
                out["create"] = await (await client.post("/vectordb/collections", headers=h, json={
                    "name": "spill", "dense_vector": {"enabled": True, "dimension": DIM_REST},
                    "metadata_schema": SCHEMA})).json()
                resp = await client.post(c + "/indexes/dense", headers=h, json={
                    "name": "spill_dense", "distance_metric_type": "cosine", "raw_storage": "host",
                    "quantization": {"type": "scalar", "data_type": "u8", "range": {"min": -0.4, "max": 0.4}}})
                out["index"] = (resp.status, await resp.json())
                txn = (await (await client.post(c + "/transactions", headers=h, json={})).json())["transaction_id"]
                await client.post(f"{c}/transactions/{txn}/upsert", headers=h,
                                  json={"vectors": [_vec(i, x) for i in range(N_REST)]})
                await client.post(f"{c}/transactions/{txn}/commit", headers=h, json={})
                for _ in range(600):
                    st = await (await client.get(f"{c}/transactions/{txn}/status", headers=h)).json()
                    if st["status"] == "complete":
                        break
                    await asyncio.sleep(0.05)
                out["status"] = st["status"]
                out["delete"] = (await client.delete(f"{c}/streaming/vectors/11", headers=h)).status
            out["one"] = (await (await client.post(c + "/search/dense", headers=h, json={
                "query_vector": q[0].tolist(), "top_k": 10})).json())["results"]
            out["batch"] = [r["results"] for r in (await (await client.post(c + "/search/batch-dense", headers=h, json={
                "queries": [{"vector": v.tolist()} for v in q], "top_k": 10})).json())["responses"]]
            out["filtered"] = (await (await client.post(c + "/search/dense", headers=h, json={
                "query_vector": q[1].tolist(), "top_k": 10, "filter": RED})).json())["results"]
            out["self11"] = (await (await client.post(c + "/search/dense", headers=h, json={
                "query_vector": x[11].tolist(), "top_k": 10})).json())["results"]
            out["get"] = await (await client.get(c + "/vectors/4", headers=h)).json()
            return out
        finally:
            await client.close()

    return asyncio.run(run())


def _grpc_ids(ctx, q):
    server = t_build_server(ctx, TSessions(ADMIN), address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        def call(method, req, resp_cls, tok=None):
            fn = channel.unary_unary(f"/vector_service.{method}", request_serializer=lambda m: m.SerializeToString(),
                                     response_deserializer=resp_cls.FromString)
            return fn(req, metadata=[("authorization", f"Bearer {tok}")] if tok else [], timeout=60)

        tok = call("AuthService/CreateSession", pb.CreateSessionRequest(username="admin", password=ADMIN),
                   pb.CreateSessionResponse).access_token
        return [[int(m.id) for m in call("VectorsService/FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id="spill", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
        ), pb.FindSimilarVectorsResponse, tok).matches] for v in q]
    finally:
        channel.close()
        server.stop(0)


def _same_results(t_rows, j_rows):
    assert len(t_rows) == len(j_rows) == 10
    js = [r["score"] for r in j_rows]
    np.testing.assert_allclose([r["score"] for r in t_rows], js, rtol=1e-5, atol=1e-6)
    u = _untied(js)
    assert [r["id"] for r, ok in zip(t_rows, u) if ok] == [r["id"] for r, ok in zip(j_rows, u) if ok]


def test_host_raw_collection_over_rest_and_grpc(tmp_path, monkeypatch):
    """A collection with raw_storage "host" spills its codes under a 60 KB
    budget while the transaction indexes; REST answers as the reference's
    server (search, batch, filter, a streamed delete, GET), a restart with
    the budget still pinned answers identically from the spilled snapshot,
    gRPC FindSimilarVectors gives REST's ids, and a flush with the budget
    lifted promotes the codes, again with the same answers."""
    monkeypatch.setenv("COSDATA_HBM_GB", str(60 * KB))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N_REST, DIM_REST)).astype(np.float32) * 0.2
    q = rng.normal(size=(6, DIM_REST)).astype(np.float32) * 0.2
    jctx = JAppContext(j_load_config(data_path=str(tmp_path / "ref")), admin_key=ADMIN)
    try:
        ref = _script(j_make_app, jctx, x, q, create=True)
    finally:
        jctx.indexing.stop()
        jctx.meta.close()
    tdir = str(tmp_path / "port")
    tctx = TAppContext(t_load_config(data_path=tdir), admin_key=ADMIN, device="cpu")
    try:
        port = _script(t_make_app, tctx, x, q, create=True)
        d = tctx.get_collection("spill").dense
        assert d.index.store.codes_on_host and d.index.scan_only and d.index.store.raw_on_host
    finally:
        tctx.close()
    assert port["index"] == ref["index"] and port["index"][1]["raw_storage"] == "host"
    assert port["status"] == ref["status"] == "complete" and port["delete"] == ref["delete"] == 200
    for step in ("one", "filtered", "self11"):
        _same_results(port[step], ref[step])
    for t_rows, j_rows in zip(port["batch"], ref["batch"]):
        _same_results(t_rows, j_rows)
    assert all(r["id"] % 4 == 0 for r in port["filtered"]) and 11 not in [r["id"] for r in port["self11"]]
    assert port["get"]["dense_values"] == pytest.approx(ref["get"]["dense_values"], abs=1e-6)
    tctx = TAppContext(t_load_config(data_path=tdir), admin_key=ADMIN, device="cpu")
    try:
        again = _script(t_make_app, tctx, x, q, create=False)
        coll = tctx.get_collection("spill")
        assert coll.dense.index.store.codes_on_host
        assert again == {k: v for k, v in port.items() if k in again}
        assert _grpc_ids(tctx, q) == [[r["id"] for r in row] for row in port["batch"]]
        monkeypatch.delenv("COSDATA_HBM_GB")
        coll.flush_indexes()
        assert not coll.dense.index.store.codes_on_host
        promoted = _script(t_make_app, tctx, x, q, create=False)
        for step in ("one", "filtered", "self11"):
            _same_results(promoted[step], port[step])
    finally:
        tctx.close()
