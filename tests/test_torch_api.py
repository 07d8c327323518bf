"""The port's REST server against the reference's: one script of requests
(session; collection with a metadata schema; dense and sparse indexes;
transaction upsert of dense + sparse vectors, commit and status poll;
streaming upsert and delete; dense, batch and filtered search; sparse and
batch-sparse search; hybrid and batch-hybrid search; GET vector;
versions; 400/401/404 errors) runs through each app over aiohttp's
TestClient, and every step must answer the same status and JSON. Scores
agree within rtol 1e-5, atol 1e-6; result ids must agree where the
reference's scores are untied. Timestamps, transaction ids and tokens
differ by nature and are masked.

The reference's indexes are kept off their graph build (scan-only from
construction, as the port's are) and its wire probe is pinned fast, so it
ships exact f32 rows and queries as the port does. A second script over a
collection with dense, sparse and tf-idf indexes drives the sparse, tf-idf
and hybrid (with a ``query_text`` leg) routes through both apps, case by
case; the graph's ``/neighbors`` answers the same plain 501 "not
implemented" in both. Stored collections written by the reference, one with a
sparse index and one with a tf-idf index, are served by the port with the
reference's answers."""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from cosdata_tpu.api.server import make_app as j_make_app
from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.api.server import make_app as t_make_app
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext

ADMIN = "parity-key"
DIM, N, K = 48, 1200, 10
#: values that differ between two runs of the same script
VARYING = {
    "transaction_id", "created_at", "access_token", "expires_at", "txn_id", "epoch_id",
    "processing_time_seconds", "average_throughput", "current_processing_rate",
    "estimated_completion",
}
SCHEMA = {"fields": [{"name": "color", "values": ["red", "blue"]}], "supported_conditions": []}


def _unit(n, seed):
    x = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sparse(i, nnz=12):
    """Doc i's sparse pairs: zipf-ish dims over a 400-dim vocab, seeded by i."""
    rng = np.random.default_rng(1000 + i)
    dims = (rng.pareto(1.2, nnz) * 10).astype(np.int64) % 400
    return [[int(d), round(float(v), 6)] for d, v in zip(dims, rng.gamma(2.0, 0.8, nnz))]


def _terms(i, n=5):
    """Query terms: doc i's n rarest (highest) dims."""
    return sorted(_sparse(i), key=lambda p: p[0])[-n:]


def _vec(i, x):
    v = {"id": f"v{i}", "dense_values": [round(float(a), 6) for a in x[i]], "sparse_values": _sparse(i)}
    if i % 2 == 0:
        v["metadata"] = {"color": "red" if i % 4 == 0 else "blue"}
    return v


async def _script(client) -> list:
    """The request script; returns [(step, status, body)]."""
    out = []

    async def call(step, method, path, **kw):
        resp = await getattr(client, method)(path, **kw)
        body = await resp.json()
        out.append((step, resp.status, body))
        return body

    x = _unit(N + 20, 0)
    q = _unit(8, 1)
    tok = (await call("session", "post", "/auth/create-session",
                      json={"username": "admin", "password": ADMIN}))["access_token"]
    h = {"Authorization": f"Bearer {tok}"}
    c = "/vectordb/collections/par"
    await call("create_collection", "post", "/vectordb/collections", headers=h, json={
        "name": "par", "dense_vector": {"enabled": True, "dimension": DIM},
        "sparse_vector": {"enabled": True}, "metadata_schema": SCHEMA,
    })
    await call("create_index", "post", c + "/indexes/dense", headers=h, json={
        "name": "par_dense", "distance_metric_type": "cosine",
        "quantization": {"type": "auto", "sample_threshold": 100},
    })
    await call("create_sparse_index", "post", c + "/indexes/sparse", headers=h, json={
        "name": "par_sparse", "quantization": 64, "sample_threshold": 200,
    })
    txn = (await call("create_txn", "post", c + "/transactions", headers=h, json={}))["transaction_id"]
    for s in range(0, N, 400):
        await call("txn_upsert", "post", f"{c}/transactions/{txn}/upsert", headers=h,
                   json={"vectors": [_vec(i, x) for i in range(s, s + 400)]})
    await call("txn_delete", "delete", f"{c}/transactions/{txn}/vectors/v3", headers=h)
    await call("commit", "post", f"{c}/transactions/{txn}/commit", headers=h, json={})
    for _ in range(600):
        resp = await client.get(f"{c}/transactions/{txn}/status", headers=h)
        if (await resp.json())["status"] == "complete":
            break
        await asyncio.sleep(0.05)
    await call("txn_status", "get", f"{c}/transactions/{txn}/status", headers=h)
    await call("stream_upsert", "post", c + "/streaming/upsert", headers=h,
               json={"vectors": [_vec(i, x) for i in range(N, N + 20)]})
    await call("stream_delete", "delete", c + "/streaming/vectors/v5", headers=h)
    for name, qv in (("self", x[7]), ("deleted", x[5]), ("query", q[0])):
        await call(f"search_{name}", "post", c + "/search/dense", headers=h,
                   json={"query_vector": qv.tolist(), "top_k": K})
    await call("batch_search", "post", c + "/search/batch-dense", headers=h, json={
        "queries": [{"vector": v.tolist()} for v in q], "top_k": 5,
    })
    await call("filtered_search", "post", c + "/search/dense", headers=h, json={
        "query_vector": q[2].tolist(), "top_k": K,
        "filter": {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}},
    })
    await call("sparse_search", "post", c + "/search/sparse", headers=h,
               json={"query_terms": _terms(7), "top_k": K})
    await call("sparse_deleted", "post", c + "/search/sparse", headers=h,
               json={"query_terms": _terms(5), "top_k": K})
    await call("batch_sparse", "post", c + "/search/batch-sparse", headers=h,
               json={"query_terms_list": [_terms(i) for i in range(20, 28)], "top_k": 5})
    await call("hybrid", "post", c + "/search/hybrid", headers=h,
               json={"query_vector": q[3].tolist(), "query_terms": _terms(9), "top_k": K})
    await call("batch_hybrid", "post", c + "/search/batch-hybrid", headers=h, json={"queries": [
        {"query_vector": x[i].tolist(), "query_terms": _terms(i + 1)} for i in range(30, 34)
    ], "top_k": 5, "fusion_constant_k": 20})
    await call("get_vector", "get", c + "/vectors/v8", headers=h)
    await call("get_streamed_vector", "get", f"{c}/vectors/v{N + 3}", headers=h)
    await call("versions", "get", c + "/versions", headers=h)
    await call("current_version", "get", c + "/versions/current", headers=h)
    await call("indexing_status", "get", c + "/indexing_status", headers=h)
    await call("list_indexes", "get", c + "/indexes", headers=h)
    await call("err_wrong_dim", "post", c + "/streaming/upsert", headers=h,
               json={"vectors": [{"id": "bad", "dense_values": [0.1, 0.2]}]})
    await call("err_missing_field", "post", c + "/search/dense", headers=h, json={"top_k": 3})
    await call("err_no_session", "get", "/vectordb/collections")
    await call("err_bad_password", "post", "/auth/create-session",
               json={"username": "admin", "password": "wrong"})
    await call("err_no_collection", "post", "/vectordb/collections/ghost/search/dense",
               headers=h, json={"query_vector": [0.1] * DIM})
    await call("err_no_vector", "get", c + "/vectors/ghost", headers=h)
    await call("err_no_txn", "post", c + "/transactions/zzz/commit", headers=h, json={})
    return out


def _transcript(ctx, make_app):
    async def run():
        client = TestClient(TestServer(make_app(ctx)))
        await client.start_server()
        try:
            return await _script(client)
        finally:
            await client.close()

    return asyncio.run(run())


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        init = JH.HNSWIndex.__init__

        def scan_only_init(self, *a, **kw):
            init(self, *a, **kw)
            self.scan_only = True

        mp.setattr(JH.HNSWIndex, "__init__", scan_only_init)
        jd = tmp_path_factory.mktemp("ref")
        ref = _transcript(JAppContext(j_load_config(data_path=str(jd)), admin_key=ADMIN), j_make_app)
    td = tmp_path_factory.mktemp("port")
    ctx = TAppContext(t_load_config(data_path=str(td)), admin_key=ADMIN, device="cpu")
    try:
        port = _transcript(ctx, t_make_app)
    finally:
        ctx.close()
    return {step: (status, body) for step, status, body in ref}, {
        step: (status, body) for step, status, body in port
    }


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:-1] - s[1:]
    prev = np.concatenate([[np.inf], gap])
    nxt = np.concatenate([gap, [np.inf]])
    return (prev > tol) & (nxt > tol)


def _compare_results(t, j):
    """Ranked result lists: scores within tolerance, ids where untied."""
    assert len(t) == len(j)
    if not j:
        return
    ts = [r["score"] for r in t]
    js = [r["score"] for r in j]
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    u = _untied(js)
    assert [r["id"] for r, ok in zip(t, u) if ok] == [r["id"] for r, ok in zip(j, u) if ok]
    for a, b, ok in zip(t, j, u):
        if ok:
            assert {k: v for k, v in a.items() if k != "score"} == {k: v for k, v in b.items() if k != "score"}


def _compare(t, j):
    """Equal JSON with masked varying values, floats within tolerance and
    ranked result lists compared by _compare_results."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (t, j)
        for k in j:
            if k in VARYING:
                continue
            if k == "results":
                _compare_results(t[k], j[k])
            else:
                _compare(t[k], j[k])
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (t, j)
        for a, b in zip(t, j):
            _compare(a, b)
    elif isinstance(j, float):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    else:
        assert t == j


STEPS = [
    "session", "create_collection", "create_index", "create_txn", "txn_upsert", "txn_delete",
    "commit", "txn_status", "stream_upsert", "stream_delete", "search_self", "search_deleted",
    "search_query", "batch_search", "filtered_search", "create_sparse_index", "sparse_search",
    "sparse_deleted", "batch_sparse", "hybrid", "batch_hybrid", "get_vector", "get_streamed_vector",
    "versions", "current_version", "indexing_status", "list_indexes", "err_wrong_dim",
    "err_missing_field", "err_no_session", "err_bad_password", "err_no_collection",
    "err_no_vector", "err_no_txn",
]


@pytest.mark.parametrize("step", STEPS)
def test_step_matches_reference(transcripts, step):
    ref, port = transcripts
    (j_status, j_body), (t_status, t_body) = ref[step], port[step]
    assert t_status == j_status, (t_body, j_body)
    _compare(t_body, j_body)


def test_script_semantics(transcripts):
    _, port = transcripts
    assert port["search_self"][1]["results"][0]["id"] == "v7"
    assert "v5" not in [r["id"] for r in port["search_deleted"][1]["results"]]
    reds = {f"v{i}" for i in range(0, N, 4)}
    got = [r["id"] for r in port["filtered_search"][1]["results"]]
    assert len(got) == K and set(got) <= reds
    assert port["get_vector"][1]["metadata"] == {"color": "red"}
    assert port["get_vector"][1]["sparse_values"] == sorted(
        [[d, float(np.float32(v))] for d, v in _sparse(8)], key=lambda p: p[0]
    )
    assert "v7" in [r["id"] for r in port["sparse_search"][1]["results"]]
    assert "v5" not in [r["id"] for r in port["sparse_deleted"][1]["results"]]
    assert [len(r["results"]) for r in port["batch_sparse"][1]["responses"]] == [5] * 8
    assert len(port["hybrid"][1]["results"]) == K
    assert port["txn_status"][1]["records_upserted"] == N
    assert [s for s, (st, _) in port.items() if st >= 400] == [s for s in STEPS if s.startswith("err_")]


def _run_port(tmp_path, script, ctx=None):
    ctx = ctx or TAppContext(t_load_config(data_path=str(tmp_path)), admin_key=ADMIN, device="cpu")

    async def run():
        client = TestClient(TestServer(t_make_app(ctx)))
        await client.start_server()
        try:
            return await script(client)
        finally:
            await client.close()

    try:
        return asyncio.run(run())
    finally:
        ctx.close()


async def _login(client):
    resp = await client.post("/auth/create-session", json={"username": "admin", "password": ADMIN})
    return {"Authorization": f"Bearer {(await resp.json())['access_token']}"}


def _text(i, n=12):
    """Doc i's text: zipf-ish words w0..w199 (bench.py's BM25 corpus shape)."""
    rng = np.random.default_rng(3000 + i)
    return " ".join(f"w{w}" for w in rng.pareto(1.1, n).astype(np.int64) % 200)


def _query_text(i):
    """Doc i's 3 rarest words."""
    return " ".join(sorted(_text(i).split(), key=lambda w: int(w[1:]))[-3:])


ROUTE_CASES = ["sparse_index", "tfidf_index", "sparse_search", "batch_sparse", "tfidf_search", "batch_tfidf",
               "hybrid", "batch_hybrid", "neighbors"]


async def _routes_script(client):
    """Dense, sparse and tf-idf indexes over 60 streamed vectors, then one
    request per route case; returns {case: (status, body)}."""
    h = await _login(client)
    c = "/vectordb/collections/sp"
    await client.post("/vectordb/collections", headers=h, json={
        "name": "sp", "dense_vector": {"enabled": True, "dimension": 4},
        "sparse_vector": {"enabled": True}, "tf_idf_options": {"enabled": True},
    })
    await client.post(c + "/indexes/dense", headers=h, json={
        "name": "sp_dense", "distance_metric_type": "cosine", "quantization": {"type": "scalar", "data_type": "u8"},
    })
    x = np.round(np.random.default_rng(9).normal(size=(60, 4)), 6)
    out = {}
    for name, body in (("sparse_index", {"quantization": 64, "sample_threshold": 20}),
                       ("tfidf_index", {"sample_threshold": 20})):
        resp = await client.post(c + "/indexes/" + ("sparse" if name == "sparse_index" else "tf-idf"),
                                 headers=h, json=body)
        out[name] = (resp.status, await resp.json())
    resp = await client.post(c + "/streaming/upsert", headers=h, json={"vectors": [
        {"id": i, "dense_values": x[i].tolist(), "sparse_values": _sparse(i), "text": _text(i)} for i in range(60)
    ]})
    assert resp.status == 200, await resp.text()
    for name, method, path, body in (
        ("sparse_search", "post", c + "/search/sparse", {"query_terms": _terms(7), "top_k": 5}),
        ("batch_sparse", "post", c + "/search/batch-sparse", {"query_terms_list": [_terms(i) for i in range(3)]}),
        ("tfidf_search", "post", c + "/search/tf-idf", {"query": _query_text(7), "top_k": 5,
                                                        "return_raw_text": True}),
        ("batch_tfidf", "post", c + "/search/batch-tf-idf", {"queries": [_query_text(i) for i in range(4)],
                                                             "top_k": 5}),
        ("hybrid", "post", c + "/search/hybrid", {"query_vector": x[11].tolist(), "query_text": _query_text(11),
                                                  "top_k": 5}),
        ("batch_hybrid", "post", c + "/search/batch-hybrid", {"queries": [
            {"query_vector": x[i].tolist(), "query_text": _query_text(i + 1)} for i in range(3)
        ] + [{"query_terms": _terms(20), "query_text": _query_text(20)}], "top_k": 5}),
        ("neighbors", "get", c + "/vectors/1/neighbors", None),
    ):
        kw = {"json": body} if body is not None else {}
        resp = await getattr(client, method)(path, headers=h, **kw)
        out[name] = (resp.status, await resp.json())
    return out


@pytest.fixture(scope="module")
def route_answers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        init = JH.HNSWIndex.__init__

        def scan_only_init(self, *a, **kw):
            init(self, *a, **kw)
            self.scan_only = True

        mp.setattr(JH.HNSWIndex, "__init__", scan_only_init)
        jctx = JAppContext(j_load_config(data_path=str(tmp_path_factory.mktemp("ref"))), admin_key=ADMIN)

        async def run():
            client = TestClient(TestServer(j_make_app(jctx)))
            await client.start_server()
            try:
                return await _routes_script(client)
            finally:
                await client.close()

        ref = asyncio.run(run())
        jctx.indexing.stop()
        jctx.meta.close()
    return ref, _run_port(tmp_path_factory.mktemp("port"), _routes_script)


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_not_ported_routes_answer_501(route_answers, case):
    """The sparse, tf-idf and hybrid (query_text) routes answer as the
    reference's do; the graph's /neighbors answers the reference's plain
    501 "not implemented" in both."""
    ref, port = route_answers
    (j_status, j_body), (t_status, t_body) = ref[case], port[case]
    assert t_status == j_status, (t_body, j_body)
    if case == "neighbors":
        assert t_status == 501 and t_body == j_body and "not implemented" in t_body["error"]
        assert "ROADMAP" not in t_body["error"]
        return
    _compare(t_body, j_body)
    if case.endswith("search") or case.endswith("hybrid"):
        rows = [t_body["results"]] if "results" in t_body else [r["results"] for r in t_body["responses"]]
        assert all(rows), rows
    if case == "tfidf_search":
        assert t_body["results"][0]["id"] == 7 and t_body["results"][0]["text"] == _text(7)


def test_stored_sparse_collection_answers_501(tmp_path):
    """Collections stored by the reference, one with a sparse index (a
    transaction of 300 sparse vectors with deletes) and one with a tf-idf
    index (300 texts, the same way), are served by the port with the
    reference's answers."""
    ref = JAppContext(j_load_config(data_path=str(tmp_path)), admin_key=ADMIN)
    coll = ref.create_collection({
        "name": "mixed", "dense_vector": {"enabled": True, "dimension": 4},
        "sparse_vector": {"enabled": True},
    })
    coll.create_sparse_index(quantization=64, sample_threshold=100)
    txn = coll.create_transaction()
    coll.txn_upsert(txn.txn_id, [{"id": i, "sparse_values": _sparse(i)} for i in range(300)], True)
    for i in (7, 21):
        coll.txn_delete(txn.txn_id, i)
    coll.index_version(coll.commit_transaction(txn.txn_id), txn)
    queries = [_terms(i) for i in range(5, 25)]
    want = coll.search_sparse([[tuple(p) for p in q] for q in queries], K)
    want_vec = coll.get_vector(9)
    tf = ref.create_collection({"name": "text", "tf_idf_options": {"enabled": True}})
    tf.create_tf_idf_index(sample_threshold=100)
    txn = tf.create_transaction()
    tf.txn_upsert(txn.txn_id, [{"id": i, "text": _text(i)} for i in range(300)], True)
    for i in (7, 21):
        tf.txn_delete(txn.txn_id, i)
    tf.index_version(tf.commit_transaction(txn.txn_id), txn)
    text_queries = [_query_text(i) for i in range(5, 25)]
    want_text = tf.search_tfidf(text_queries, K)
    ref.create_collection({"name": "plain", "dense_vector": {"enabled": True, "dimension": 4}})
    ref.indexing.stop()
    ref.meta.close()

    async def script(client):
        h = await _login(client)
        out = {}
        for name in ("mixed", "text", "plain"):
            resp = await client.get(f"/vectordb/collections/{name}", headers=h)
            out[name] = (resp.status, await resp.json())
        resp = await client.get("/vectordb/collections", headers=h)
        out["list"] = sorted(c["name"] for c in (await resp.json())["collections"])
        resp = await client.post("/vectordb/collections/mixed/search/batch-sparse", headers=h,
                                 json={"query_terms_list": queries, "top_k": K})
        out["search"] = [r["results"] for r in (await resp.json())["responses"]]
        resp = await client.get("/vectordb/collections/mixed/vectors/9", headers=h)
        out["vector"] = await resp.json()
        resp = await client.post("/vectordb/collections/text/search/batch-tf-idf", headers=h,
                                 json={"queries": text_queries, "top_k": K})
        out["text_search"] = [r["results"] for r in (await resp.json())["responses"]]
        return out

    out = _run_port(tmp_path, script)
    assert out["mixed"][0] == 200 and out["plain"][0] == 200 and out["text"][0] == 200
    assert out["list"] == ["mixed", "plain", "text"]
    assert len(out["search"]) == len(want)
    for t_row, j_row in zip(out["search"], want):
        _compare_results(t_row, j_row)
        assert not {7, 21} & {r["id"] for r in t_row}
    assert out["vector"] == want_vec
    assert len(out["text_search"]) == len(want_text)
    for t_row, j_row in zip(out["text_search"], want_text):
        _compare_results(t_row, j_row)
        assert len(t_row) == K and not {7, 21} & {r["id"] for r in t_row}


def test_cli_requires_device(tmp_path):
    """``python -m cosdata_tpu_torch`` runs on the card unless asked for the
    CPU: with no ``--device`` it takes ``cuda`` and refuses when torch sees
    no card (no quiet move to the CPU); an unknown device is refused."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for extra, want in (([], "--device cuda: torch sees no CUDA device"),
                        (["--device", "tpu"], "cuda, cuda:N or cpu")):
        out = subprocess.run(
            [sys.executable, "-m", "cosdata_tpu_torch", "--admin-key", "k",
             "--data-path", str(tmp_path), "--no-grpc", *extra],
            cwd=root, capture_output=True, text=True, timeout=120, env=env,
        )
        assert out.returncode == 2 and want in out.stderr, out.stderr


def test_concurrent_mixed_top_k_searches_match_lone_searches(tmp_path):
    """Searches from many threads coalesce in the MicroBatcher at max(top_k);
    each must get exactly what it gets alone."""
    import sys
    import threading

    ctx = TAppContext(t_load_config(data_path=str(tmp_path)), admin_key=ADMIN, device="cpu")
    try:
        coll = ctx.create_collection({"name": "mb", "dense_vector": {"enabled": True, "dimension": DIM}})
        coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8"})
        x = _unit(500, 3)
        coll.index_embeddings([{"id": i, "dense_values": x[i].tolist()} for i in range(500)])
        q = _unit(32, 4)
        ks = [3, 10, 5, 1] * 8
        alone = [coll.search_dense(q[i : i + 1], ks[i])[0] for i in range(32)]
        got = [None] * 32
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def worker(i):
                got[i] = coll.search_dense(q[i : i + 1], ks[i])[0]

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        # the same ids and lengths; scores to f32 rounding (a batch's
        # product may sum in another order than a lone query's)
        assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in alone]
        assert [len(row) for row in got] == ks
        np.testing.assert_allclose([r["score"] for row in got for r in row],
                                   [r["score"] for row in alone for r in row], rtol=1e-6, atol=1e-7)
    finally:
        ctx.close()


def test_concurrent_tfidf_searches_match_lone_searches(tmp_path):
    """Text searches from many threads coalesce in the tf-idf MicroBatcher
    while hybrid searches run their text leg beside them; each must get
    exactly what it gets alone."""
    import sys
    import threading

    ctx = TAppContext(t_load_config(data_path=str(tmp_path)), admin_key=ADMIN, device="cpu")
    try:
        coll = ctx.create_collection({"name": "tx", "dense_vector": {"enabled": True, "dimension": 4},
                                      "tf_idf_options": {"enabled": True}})
        coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8"})
        coll.create_tf_idf_index(sample_threshold=50)
        x = np.random.default_rng(5).normal(size=(400, 4))
        coll.index_embeddings([{"id": i, "dense_values": x[i].tolist(), "text": _text(i)} for i in range(400)])
        ks = [3, 10, 5, 1] * 8
        jobs = [("text", _query_text(i), ks[i]) if i % 4 else
                ("hybrid", {"query_vector": x[i].tolist(), "query_text": _query_text(i)}, ks[i]) for i in range(32)]

        def run(job):
            kind, q, k = job
            return coll.search_tfidf([q], k)[0] if kind == "text" else coll.hybrid_search(q, k)

        alone = [run(job) for job in jobs]
        got = [None] * 32
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def worker(i):
                got[i] = run(jobs[i])

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert got == alone
        assert all(len(row) > 0 for row in got)
    finally:
        ctx.close()


def test_graph_search_over_rest_equals_direct_calls(tmp_path):
    """Above lowered serving limits (1,500 rows, limits 500) the dense
    search, batch search and a 25% filter take the graph; over REST they
    answer exactly as the direct Collection calls on the same batches."""
    ctx = TAppContext(t_load_config(data_path=str(tmp_path)), admin_key=ADMIN, device="cpu")
    coll = ctx.create_collection({"name": "g", "dense_vector": {"enabled": True, "dimension": DIM},
                                  "metadata_schema": SCHEMA})
    coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8"})
    x, q = _unit(1500, 6), _unit(6, 7)
    coll.index_embeddings([{"id": i, "dense_values": x[i].tolist(),
                            "metadata": {"color": "red" if i % 4 == 0 else "blue"}} for i in range(1500)])
    d = coll.dense
    d.flat_serve_threshold = d.graph_filter_min = 500
    assert not d.index.scan_only and d.index.entry >= 0
    red = {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}}
    want = {
        "one": coll.search_dense(q[:1], K)[0],
        "batch": coll.search_dense(q, 5),
        "filtered": coll.search_dense(q[2:3], K, filter_dto=red)[0],
    }

    async def script(client):
        h = await _login(client)
        c = "/vectordb/collections/g"
        one = await client.post(c + "/search/dense", headers=h, json={"query_vector": q[0].tolist(), "top_k": K})
        batch = await client.post(c + "/search/batch-dense", headers=h,
                                  json={"queries": [{"vector": v.tolist()} for v in q], "top_k": 5})
        filt = await client.post(c + "/search/dense", headers=h,
                                 json={"query_vector": q[2].tolist(), "top_k": K, "filter": red})
        return {"one": (await one.json())["results"],
                "batch": [r["results"] for r in (await batch.json())["responses"]],
                "filtered": (await filt.json())["results"]}

    got = _run_port(tmp_path, script, ctx)
    assert got == want
    assert len(want["one"]) == K and all(r["id"] % 4 == 0 for r in want["filtered"])
    truth = np.argsort(-(q @ x.T), axis=1)[:, :5]
    assert np.mean([len({r["id"] for r in row} & set(t)) / 5 for row, t in zip(want["batch"], truth)]) >= 0.9


# ---------------------------------------------------------------- euclidean and hamming collections

N_M = 1500
METRIC_STEPS = [
    "create_collection", "create_index", "txn_upsert", "txn_delete", "commit", "txn_status", "stream_upsert",
    "stream_delete", "search_self", "search_deleted", "search_query", "batch_search", "filtered_search",
    "get_vector", "restart_search_self", "restart_search_query", "restart_batch_search",
    "restart_filtered_search", "restart_search_deleted",
]


def _metric_rows():
    x = _unit(N_M + 10, 2) * np.random.default_rng(3).uniform(0.5, 1.5, (N_M + 10, 1)).astype(np.float32)
    return x.astype(np.float32), _unit(6, 4)


def _metric_vec(i, x):
    v = {"id": f"v{i}", "dense_values": [round(float(a), 6) for a in x[i]]}
    if i % 2 == 0:
        v["metadata"] = {"color": "red" if i % 4 == 0 else "blue"}
    return v


async def _metric_script(client, metric, restart: bool) -> list:
    """Create, write (transaction and stream), delete and search a collection
    of ``metric``; after a restart, only its searches (step names prefixed
    ``restart_``, one of them 20 deep)."""
    out = []
    x, q = _metric_rows()
    h = await _login(client)
    c = f"/vectordb/collections/m_{metric}"
    pre = "restart_" if restart else ""

    async def call(step, method, path, **kw):
        resp = await getattr(client, method)(path, headers=h, **kw)
        out.append((pre + step, resp.status, await resp.json()))

    if not restart:
        await call("create_collection", "post", "/vectordb/collections", json={
            "name": f"m_{metric}", "dense_vector": {"enabled": True, "dimension": DIM}, "metadata_schema": SCHEMA,
        })
        await call("create_index", "post", c + "/indexes/dense", json={
            "name": f"m_{metric}_dense", "distance_metric_type": metric,
            "quantization": {"type": "auto", "sample_threshold": 100},
        })
        resp = await client.post(c + "/transactions", headers=h, json={})
        txn = (await resp.json())["transaction_id"]
        await call("txn_upsert", "post", f"{c}/transactions/{txn}/upsert",
                   json={"vectors": [_metric_vec(i, x) for i in range(N_M)]})
        await call("txn_delete", "delete", f"{c}/transactions/{txn}/vectors/v3")
        await call("commit", "post", f"{c}/transactions/{txn}/commit", json={})
        for _ in range(600):
            resp = await client.get(f"{c}/transactions/{txn}/status", headers=h)
            if (await resp.json())["status"] == "complete":
                break
            await asyncio.sleep(0.05)
        await call("txn_status", "get", f"{c}/transactions/{txn}/status")
        await call("stream_upsert", "post", c + "/streaming/upsert",
                   json={"vectors": [_metric_vec(i, x) for i in range(N_M, N_M + 10)]})
        await call("stream_delete", "delete", c + "/streaming/vectors/v5")
        await call("get_vector", "get", c + "/vectors/v8")
    for name, qv, k in (("self", x[7], K), ("deleted", x[5], K), ("query", q[0], K), ("deep", q[0], 2 * K)):
        await call(f"search_{name}", "post", c + "/search/dense", json={"query_vector": qv.tolist(), "top_k": k})
    await call("batch_search", "post", c + "/search/batch-dense",
               json={"queries": [{"vector": v.tolist()} for v in q], "top_k": 5})
    await call("filtered_search", "post", c + "/search/dense", json={
        "query_vector": q[2].tolist(), "top_k": K,
        "filter": {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}},
    })
    return out


def _metric_transcript(make_ctx, make_app, metric):
    steps = []
    for restart in (False, True):
        ctx = make_ctx()

        async def run():
            client = TestClient(TestServer(make_app(ctx)))
            await client.start_server()
            try:
                return await _metric_script(client, metric, restart)
            finally:
                await client.close()

        try:
            steps += asyncio.run(run())
        finally:
            if hasattr(ctx, "close"):
                ctx.close()
            else:
                ctx.indexing.stop()
                ctx.meta.close()
    return {step: (status, body) for step, status, body in steps}


@pytest.fixture(scope="module", params=["euclidean", "hamming"])
def metric_transcripts(request, tmp_path_factory):
    """Both servers run the metric script, restart on their data dir and
    search again."""
    metric = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        jd = tmp_path_factory.mktemp(f"ref_{metric}")
        ref = _metric_transcript(lambda: JAppContext(j_load_config(data_path=str(jd)), admin_key=ADMIN),
                                 j_make_app, metric)
    td = tmp_path_factory.mktemp(f"port_{metric}")
    port = _metric_transcript(
        lambda: TAppContext(t_load_config(data_path=str(td)), admin_key=ADMIN, device="cpu"), t_make_app, metric
    )
    return metric, ref, port


@pytest.mark.parametrize("step", METRIC_STEPS)
def test_metric_step_matches_reference(metric_transcripts, step):
    """Every step answers as the reference's server does. A hamming index is
    scan-only in both, and the reference's reload of it drops its
    tombstones (ROADMAP queue 3): after the restart its answers may hold a
    live row fewer or serve one that a dead row pushed out of its
    shortlist, so the restart steps hold its lists, by id, as in-order
    subsets of the port's 20-deep answer where one exists, and the port's
    restart answers equal its own answers before the restart (less the
    "still being indexed" warning, which the restart clears in both)."""
    metric, ref, port = metric_transcripts
    (j_status, j_body), (t_status, t_body) = ref[step], port[step]
    assert t_status == j_status, (t_body, j_body)
    if metric == "hamming" and step.startswith("restart_"):
        b_status, b_body = port[step[len("restart_"):]]
        assert b_status == t_status and {**b_body, "warning": None} == t_body
        if step == "restart_search_query":
            deep = [r["id"] for r in port["search_deep"][1]["results"]]
            got = [r["id"] for r in j_body["results"]]
            assert [i for i in deep if i in got] == got
        return
    _compare(t_body, j_body)


def test_metric_semantics(metric_transcripts):
    metric, _, port = metric_transcripts
    for pre in ("", "restart_"):
        assert port[pre + "search_self"][1]["results"][0]["id"] == "v7"
        assert "v5" not in [r["id"] for r in port[pre + "search_deleted"][1]["results"]]
        assert all(r["score"] <= 0 for r in port[pre + "search_query"][1]["results"])
        got = [r["id"] for r in port[pre + "filtered_search"][1]["results"]]
        assert len(got) == K and all(int(i[1:]) % 4 == 0 for i in got)
