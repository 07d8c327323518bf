"""The port's gRPC server against the reference's: one script of calls
(session; collection; dense and sparse indexes; transaction upsert of
dense + sparse vectors and commit; dense and sparse FindSimilarVectors;
GetVector; reflection; the UNAUTHENTICATED and NOT_FOUND errors) runs
through an in-process server over each package's AppContext, and every
call must answer the same status code and message. Scores agree within
rtol 1e-5, atol 1e-6; match ids must agree where the reference's scores
are untied. The reference's indexes are kept off their graph build and its
wire probe is pinned fast, as in test_torch_api.py. A second script
creates sparse and tf-idf indexes, writes texts through a transaction and
sends tf-idf FindSimilarVectors calls to each package's server: the port
answers as the reference does."""

import re

import grpc
import numpy as np
import pytest
from google.protobuf import empty_pb2
from google.protobuf.json_format import MessageToDict

from cosdata_tpu.api.auth import SessionManager as JSessions
from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.grpc_api.server import build_server as j_build_server
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.api.auth import SessionManager as TSessions
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext
from cosdata_tpu_torch.grpc_api import reflection_v1alpha_pb2 as rpb
from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb
from cosdata_tpu_torch.grpc_api.server import build_server as t_build_server

ADMIN = "grpc-parity"
DIM, N, K = 32, 300, 5


def _call(channel, service, method, req, resp_cls, token=None):
    fn = channel.unary_unary(
        f"/vector_service.{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )
    md = [("authorization", f"Bearer {token}")] if token else []
    return fn(req, metadata=md, timeout=60)


def _sparse(i, nnz=10):
    """Doc i's sparse pairs: zipf-ish dims over a 300-dim vocab, seeded by i."""
    rng = np.random.default_rng(500 + i)
    dims = (rng.pareto(1.2, nnz) * 8).astype(np.int64) % 300
    return list(zip(dims.tolist(), rng.gamma(2.0, 0.8, nnz).astype(np.float32).tolist()))


def _script(ctx, channel) -> dict:
    """Returns {step: ("OK", response dict) or (status code name, details)}."""
    out = {}

    def call(step, service, method, req, resp_cls, token=None):
        try:
            resp = _call(channel, service, method, req, resp_cls, token)
        except grpc.RpcError as e:
            out[step] = (e.code().name, e.details())
            return None
        out[step] = ("OK", MessageToDict(resp, preserving_proto_field_name=True))
        return resp

    x = np.random.default_rng(0).normal(size=(N, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    call("bad_password", "AuthService", "CreateSession",
         pb.CreateSessionRequest(username="admin", password="no"), pb.CreateSessionResponse)
    tok = call("session", "AuthService", "CreateSession",
               pb.CreateSessionRequest(username="admin", password=ADMIN), pb.CreateSessionResponse).access_token
    call("no_session", "CollectionsService", "GetCollections",
         pb.GetCollectionsRequest(), pb.GetCollectionsResponse)
    call("create_collection", "CollectionsService", "CreateCollection", pb.CreateCollectionRequest(
        name="g", dense_vector=pb.DenseVectorOptions(enabled=True, dimension=DIM),
        sparse_vector=pb.SparseVectorOptions(enabled=True),
    ), pb.CreateCollectionResponse, tok)
    call("get_collection", "CollectionsService", "GetCollection",
         pb.GetCollectionRequest(collection_id="g"), pb.Collection, tok)
    call("get_collections", "CollectionsService", "GetCollections",
         pb.GetCollectionsRequest(), pb.GetCollectionsResponse, tok)
    call("no_collection", "CollectionsService", "GetCollection",
         pb.GetCollectionRequest(collection_id="ghost"), pb.Collection, tok)
    call("create_index", "IndexesService", "CreateDenseIndex", pb.CreateDenseIndexRequest(
        collection_id="g", distance_metric_type="cosine",
        auto=pb.AutoQuantization(sample_threshold=64),
    ), empty_pb2.Empty, tok)
    call("create_sparse_index", "IndexesService", "CreateSparseIndex", pb.CreateSparseIndexRequest(
        collection_id="g", quantization=32, sample_threshold=50,
    ), empty_pb2.Empty, tok)
    txn = call("create_txn", "TransactionsService", "CreateTransaction",
               pb.CreateTransactionRequest(collection_id="g"), pb.CreateTransactionResponse, tok).transaction_id
    req = pb.UpsertVectorsRequest(collection_id="g", transaction_id=txn)
    for i in range(N):
        v = req.vectors.add(id=f"v{i}", dense_values=x[i].tolist())
        for d, val in _sparse(i):
            v.sparse_values.add(index=d, value=val)
    call("upsert", "TransactionsService", "UpsertVectors", req, empty_pb2.Empty, tok)
    call("txn_delete", "TransactionsService", "DeleteVectorInTransaction",
         pb.DeleteVectorInTransactionRequest(collection_id="g", transaction_id=txn, vector_id="v4"),
         empty_pb2.Empty, tok)
    call("commit", "TransactionsService", "CommitTransaction",
         pb.CommitTransactionRequest(collection_id="g", transaction_id=txn), empty_pb2.Empty, tok)
    call("commit_again", "TransactionsService", "CommitTransaction",
         pb.CommitTransactionRequest(collection_id="g", transaction_id=txn), empty_pb2.Empty, tok)
    ctx.indexing.wait_idle()
    for name, v in (("self", x[9]), ("deleted", x[4]), ("query", -x[11] + x[12])):
        call(f"find_{name}", "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id="g", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=K),
        ), pb.FindSimilarVectorsResponse, tok)
    for name, i in (("sparse_self", 9), ("sparse_deleted", 4), ("sparse_query", 20)):
        terms = sorted(_sparse(i))[-5:]
        call(f"find_{name}", "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id="g", sparse=pb.FindSimilarSparseVectorsQuery(
                values=[pb.SparsePair(index=d, value=v) for d, v in terms], top_k=K),
        ), pb.FindSimilarVectorsResponse, tok)
    call("get_vector", "VectorsService", "GetVector",
         pb.GetVectorRequest(collection_id="g", vector_id="v9"), pb.VectorResponse, tok)
    call("no_vector", "VectorsService", "GetVector",
         pb.GetVectorRequest(collection_id="g", vector_id="ghost"), pb.VectorResponse, tok)
    return out


def _transcript(ctx, build_server, sessions):
    server = build_server(ctx, sessions, address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        out = _script(ctx, channel)
        fn = channel.stream_stream(
            "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=rpb.ServerReflectionResponse.FromString,
        )
        resp = list(fn(iter([rpb.ServerReflectionRequest(host="", list_services="*")]), timeout=30))
        out["reflection"] = ("OK", sorted(s.name for s in resp[0].list_services_response.service))
        return out
    finally:
        channel.close()
        server.stop(0)


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        init = JH.HNSWIndex.__init__

        def scan_only_init(self, *a, **kw):
            init(self, *a, **kw)
            self.scan_only = True

        mp.setattr(JH.HNSWIndex, "__init__", scan_only_init)
        jctx = JAppContext(j_load_config(data_path=str(tmp_path_factory.mktemp("ref"))), admin_key=ADMIN)
        ref = _transcript(jctx, j_build_server, JSessions(ADMIN))
    tctx = TAppContext(t_load_config(data_path=str(tmp_path_factory.mktemp("port"))), admin_key=ADMIN, device="cpu")
    try:
        port = _transcript(tctx, t_build_server, TSessions(ADMIN))
    finally:
        tctx.close()
    return ref, port


STEPS = [
    "bad_password", "session", "no_session", "create_collection", "get_collection",
    "get_collections", "no_collection", "create_index", "create_sparse_index", "create_txn", "upsert",
    "txn_delete", "commit", "commit_again", "find_self", "find_deleted", "find_query", "find_sparse_self",
    "find_sparse_deleted", "find_sparse_query", "get_vector",
    "no_vector", "reflection",
]
VARYING = {"access_token", "created_at", "expires_at", "transaction_id"}


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [np.inf]]) > tol)


@pytest.mark.parametrize("step", STEPS)
def test_call_matches_reference(transcripts, step):
    ref, port = transcripts
    (j_code, j_body), (t_code, t_body) = ref[step], port[step]
    assert t_code == j_code, (t_body, j_body)
    if isinstance(j_body, dict):
        j_body = {k: v for k, v in j_body.items() if k not in VARYING}
        t_body = {k: v for k, v in t_body.items() if k not in VARYING}
        if "matches" in j_body:
            jm, tm = j_body.pop("matches"), t_body.pop("matches")
            assert len(tm) == len(jm) == K
            js = [m["score"] for m in jm]
            np.testing.assert_allclose([m["score"] for m in tm], js, rtol=1e-5, atol=1e-6)
            u = _untied(js)
            assert [m["id"] for m, ok in zip(tm, u) if ok] == [m["id"] for m, ok in zip(jm, u) if ok]
    elif isinstance(j_body, str):  # an error's details may name the transaction id
        j_body, t_body = (re.sub(r"\b[0-9a-f]{16}\b", "<txn>", s) for s in (j_body, t_body))
    assert t_body == j_body


def test_port_semantics(transcripts):
    _, port = transcripts
    assert port["find_self"][1]["matches"][0]["id"] == "v9"
    assert "v4" not in [m["id"] for m in port["find_deleted"][1]["matches"]]
    assert len(port["get_vector"][1]["vector"]["dense_values"]) == DIM
    got = sorted((p["index"], np.float32(p["value"])) for p in port["get_vector"][1]["vector"]["sparse_values"])
    assert got == sorted((d, np.float32(v)) for d, v in _sparse(9))
    assert "v9" in [m["id"] for m in port["find_sparse_self"][1]["matches"]]
    assert "v4" not in [m["id"] for m in port["find_sparse_deleted"][1]["matches"]]
    assert port["no_session"][0] == "UNAUTHENTICATED" and port["no_vector"][0] == "NOT_FOUND"


def _text(i):
    rng = np.random.default_rng(4000 + i)
    return " ".join(f"w{w}" for w in rng.pareto(1.1, 12).astype(np.int64) % 150)


def _tfidf_calls(ctx, build_server, sessions) -> dict:
    """Sparse and tf-idf indexes, 80 texts through a transaction, then
    sparse and tf-idf FindSimilarVectors; returns {step: (code, matches)}."""
    server = build_server(ctx, sessions, address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    out = {}
    try:
        tok = _call(ch, "AuthService", "CreateSession",
                    pb.CreateSessionRequest(username="admin", password=ADMIN), pb.CreateSessionResponse).access_token
        _call(ch, "CollectionsService", "CreateCollection", pb.CreateCollectionRequest(
            name="s", dense_vector=pb.DenseVectorOptions(enabled=True, dimension=4),
            sparse_vector=pb.SparseVectorOptions(enabled=True), tf_idf_options=pb.TFIDFOptions(enabled=True),
        ), pb.CreateCollectionResponse, tok)
        _call(ch, "IndexesService", "CreateSparseIndex", pb.CreateSparseIndexRequest(collection_id="s"),
              empty_pb2.Empty, tok)
        resp = _call(ch, "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id="s", sparse=pb.FindSimilarSparseVectorsQuery(top_k=3),
        ), pb.FindSimilarVectorsResponse, tok)
        out["empty_sparse"] = ("OK", list(resp.matches))
        _call(ch, "IndexesService", "CreateTFIDFIndex",
              pb.CreateTFIDFIndexRequest(collection_id="s", k1=1.2, b=0.75, sample_threshold=20), empty_pb2.Empty, tok)
        txn = _call(ch, "TransactionsService", "CreateTransaction", pb.CreateTransactionRequest(collection_id="s"),
                    pb.CreateTransactionResponse, tok).transaction_id
        req = pb.UpsertVectorsRequest(collection_id="s", transaction_id=txn)
        for i in range(80):
            req.vectors.add(id=f"t{i}", text=_text(i))
        _call(ch, "TransactionsService", "UpsertVectors", req, empty_pb2.Empty, tok)
        _call(ch, "TransactionsService", "DeleteVectorInTransaction", pb.DeleteVectorInTransactionRequest(
            collection_id="s", transaction_id=txn, vector_id="t3"), empty_pb2.Empty, tok)
        _call(ch, "TransactionsService", "CommitTransaction",
              pb.CommitTransactionRequest(collection_id="s", transaction_id=txn), empty_pb2.Empty, tok)
        ctx.indexing.wait_idle()
        for name, i in (("tfidf_self", 9), ("tfidf_deleted", 3), ("tfidf_query", 40)):
            query = " ".join(sorted(_text(i).split(), key=lambda w: int(w[1:]))[-3:])
            try:
                resp = _call(ch, "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
                    collection_id="s", tf_idf=pb.FindSimilarTFIDFDocumentQuery(query=query, top_k=K),
                ), pb.FindSimilarVectorsResponse, tok)
            except grpc.RpcError as e:
                out[name] = (e.code().name, e.details())
                continue
            out[name] = ("OK", [MessageToDict(m, preserving_proto_field_name=True) for m in resp.matches])
        return out
    finally:
        ch.close()
        server.stop(0)


def test_sparse_answers_unimplemented(tmp_path):
    """Sparse and tf-idf indexes and searches are served: a tf-idf
    FindSimilarVectors answers as the reference's (scores rtol 1e-5, ids
    where untied), and a deleted text never comes back."""
    jctx = JAppContext(j_load_config(data_path=str(tmp_path / "ref")), admin_key=ADMIN)
    try:
        ref = _tfidf_calls(jctx, j_build_server, JSessions(ADMIN))
    finally:
        jctx.indexing.stop()
        jctx.meta.close()
    tctx = TAppContext(t_load_config(data_path=str(tmp_path / "port")), admin_key=ADMIN, device="cpu")
    try:
        port = _tfidf_calls(tctx, t_build_server, TSessions(ADMIN))
    finally:
        tctx.close()
    assert port["empty_sparse"] == ref["empty_sparse"] == ("OK", [])
    for name in ("tfidf_self", "tfidf_deleted", "tfidf_query"):
        (j_code, jm), (t_code, tm) = ref[name], port[name]
        assert t_code == j_code == "OK", (tm, jm)
        assert len(tm) == len(jm) > 0
        js = [m["score"] for m in jm]
        np.testing.assert_allclose([m["score"] for m in tm], js, rtol=1e-5, atol=1e-6)
        u = _untied(js)
        assert [m["id"] for m, ok in zip(tm, u) if ok] == [m["id"] for m, ok in zip(jm, u) if ok]
    assert "t9" in [m["id"] for m in port["tfidf_self"][1]]
    assert "t3" not in [m["id"] for m in port["tfidf_deleted"][1]]


def test_graph_search_over_grpc_equals_direct_calls(tmp_path):
    """Above lowered serving limits (1,000 rows, limit 300) a dense
    FindSimilarVectors takes the graph and answers as the direct
    Collection call (scores to the protocol's f32)."""
    tctx = TAppContext(t_load_config(data_path=str(tmp_path)), admin_key=ADMIN, device="cpu")
    try:
        coll = tctx.create_collection({"name": "g", "dense_vector": {"enabled": True, "dimension": DIM}})
        coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8"})
        x = np.random.default_rng(8).normal(size=(1000, DIM)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        coll.index_embeddings([{"id": i, "dense_values": x[i].tolist()} for i in range(1000)])
        coll.dense.flat_serve_threshold = 300
        assert not coll.dense.index.scan_only
        server = t_build_server(tctx, TSessions(ADMIN), address="127.0.0.1:0")
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            tok = _call(channel, "AuthService", "CreateSession",
                        pb.CreateSessionRequest(username="admin", password=ADMIN), pb.CreateSessionResponse).access_token
            for i in (3, 400, 999):
                want = coll.search_dense(x[i : i + 1], K)[0]
                resp = _call(channel, "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
                    collection_id="g", dense=pb.FindSimilarDenseVectorsQuery(vector=x[i].tolist(), top_k=K),
                ), pb.FindSimilarVectorsResponse, tok)
                assert [m.id for m in resp.matches] == [str(r["id"]) for r in want]
                assert want[0]["id"] == i
                np.testing.assert_allclose([m.score for m in resp.matches], [r["score"] for r in want], rtol=1e-6)
        finally:
            channel.close()
            server.stop(0)
    finally:
        tctx.close()


# ---------------------------------------------------------------- euclidean and hamming collections

METRIC_STEPS = ["create_collection", "create_index", "upsert", "txn_delete", "commit", "find_self", "find_deleted",
                "find_query", "get_vector"]


def _metric_script(ctx, channel, metric) -> dict:
    out = {}

    def call(step, service, method, req, resp_cls, token=None):
        try:
            resp = _call(channel, service, method, req, resp_cls, token)
        except grpc.RpcError as e:
            out[step] = (e.code().name, e.details())
            return None
        out[step] = ("OK", MessageToDict(resp, preserving_proto_field_name=True))
        return resp

    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    x *= (rng.uniform(0.5, 1.5, N) / np.linalg.norm(x, axis=1))[:, None].astype(np.float32)
    tok = _call(channel, "AuthService", "CreateSession",
                pb.CreateSessionRequest(username="admin", password=ADMIN), pb.CreateSessionResponse).access_token
    name = f"m_{metric}"
    call("create_collection", "CollectionsService", "CreateCollection", pb.CreateCollectionRequest(
        name=name, dense_vector=pb.DenseVectorOptions(enabled=True, dimension=DIM),
    ), pb.CreateCollectionResponse, tok)
    call("create_index", "IndexesService", "CreateDenseIndex", pb.CreateDenseIndexRequest(
        collection_id=name, distance_metric_type=metric, auto=pb.AutoQuantization(sample_threshold=64),
    ), empty_pb2.Empty, tok)
    txn = _call(channel, "TransactionsService", "CreateTransaction",
                pb.CreateTransactionRequest(collection_id=name), pb.CreateTransactionResponse, tok).transaction_id
    req = pb.UpsertVectorsRequest(collection_id=name, transaction_id=txn)
    for i in range(N):
        req.vectors.add(id=f"v{i}", dense_values=x[i].tolist())
    call("upsert", "TransactionsService", "UpsertVectors", req, empty_pb2.Empty, tok)
    call("txn_delete", "TransactionsService", "DeleteVectorInTransaction",
         pb.DeleteVectorInTransactionRequest(collection_id=name, transaction_id=txn, vector_id="v4"),
         empty_pb2.Empty, tok)
    call("commit", "TransactionsService", "CommitTransaction",
         pb.CommitTransactionRequest(collection_id=name, transaction_id=txn), empty_pb2.Empty, tok)
    ctx.indexing.wait_idle()
    for step, v in (("self", x[9]), ("deleted", x[4]), ("query", -x[11] + x[12])):
        call(f"find_{step}", "VectorsService", "FindSimilarVectors", pb.FindSimilarVectorsRequest(
            collection_id=name, dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=K),
        ), pb.FindSimilarVectorsResponse, tok)
    call("get_vector", "VectorsService", "GetVector",
         pb.GetVectorRequest(collection_id=name, vector_id="v9"), pb.VectorResponse, tok)
    return out


def _metric_transcript(ctx, build_server, sessions, metric):
    server = build_server(ctx, sessions, address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        return _metric_script(ctx, channel, metric)
    finally:
        channel.close()
        server.stop(0)


@pytest.fixture(scope="module", params=["euclidean", "hamming"])
def metric_transcripts(request, tmp_path_factory):
    metric = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        jctx = JAppContext(j_load_config(data_path=str(tmp_path_factory.mktemp(f"ref_{metric}"))), admin_key=ADMIN)
        ref = _metric_transcript(jctx, j_build_server, JSessions(ADMIN), metric)
    tctx = TAppContext(t_load_config(data_path=str(tmp_path_factory.mktemp(f"port_{metric}"))), admin_key=ADMIN,
                       device="cpu")
    try:
        port = _metric_transcript(tctx, t_build_server, TSessions(ADMIN), metric)
    finally:
        tctx.close()
    return metric, ref, port


@pytest.mark.parametrize("step", METRIC_STEPS)
def test_metric_call_matches_reference(metric_transcripts, step):
    """A euclidean and a hamming collection over gRPC answer as the
    reference's: negated distances within rtol 1e-5, ids where untied,
    the deleted vector absent."""
    metric, ref, port = metric_transcripts
    (j_code, j_body), (t_code, t_body) = ref[step], port[step]
    assert t_code == j_code, (t_body, j_body)
    if isinstance(j_body, dict) and "matches" in j_body:
        jm, tm = j_body["matches"], t_body["matches"]
        assert len(tm) == len(jm) == K
        js = [m["score"] for m in jm]
        np.testing.assert_allclose([m["score"] for m in tm], js, rtol=1e-5, atol=1e-6)
        u = _untied(js)
        assert [m["id"] for m, ok in zip(tm, u) if ok] == [m["id"] for m, ok in zip(jm, u) if ok]
        assert all(m["score"] <= 0 for m in tm) and "v4" not in [m["id"] for m in tm]
    else:
        assert t_body == j_body
    if step == "find_self":
        assert t_body["matches"][0]["id"] == "v9"
