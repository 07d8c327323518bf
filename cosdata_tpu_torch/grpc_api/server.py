"""gRPC server: Auth/Collections/Indexes/Transactions/Vectors services.

Mirrors upstream src/grpc/server.rs:24-44 (spawned next to the HTTP
server, same AppContext) and src/grpc/{collections,vectors}.rs semantics.
Like the reference's dense gRPC search, metadata filters are not exposed
over gRPC (explicit TODO at grpc/vectors/mod.rs:110-113).

Port of ``cosdata_tpu/grpc_api/server.py``.
"""

from __future__ import annotations

import logging
from concurrent import futures

import grpc
from google.protobuf import empty_pb2

from cosdata_tpu_torch.api.auth import SessionManager
from cosdata_tpu_torch.core.app_context import AppContext
from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

log = logging.getLogger(__name__)

# Server reflection (grpc/server.rs:24-44 parity): grpcio-reflection is not
# in this image, so the v1alpha protocol is hand-implemented over the
# generated descriptor pool — see cosdata_tpu_torch/grpc_api/reflection.py.

_PKG = "vector_service"


def _abort(context, code, msg):
    context.abort(code, msg)


class _Services:
    def __init__(self, ctx: AppContext, sessions: SessionManager):
        self.ctx = ctx
        self.sessions = sessions

    # -- helpers ---------------------------------------------------------

    def _auth(self, context):
        for k, v in context.invocation_metadata():
            if k == "authorization":
                token = v.removeprefix("Bearer ").strip()
                if self.sessions.check(token):
                    return
        _abort(context, grpc.StatusCode.UNAUTHENTICATED, "invalid or missing session")

    def _coll(self, context, collection_id: str):
        coll = self.ctx.get_collection(collection_id)
        if coll is None:
            _abort(
                context,
                grpc.StatusCode.NOT_FOUND,
                f"collection '{collection_id}' not found",
            )
        return coll

    @staticmethod
    def _vector_to_dict(v: pb.Vector) -> dict:
        out: dict = {"id": v.id}
        if v.HasField("document_id"):
            out["document_id"] = v.document_id
        if v.dense_values:
            out["dense_values"] = list(v.dense_values)
        if v.sparse_values:
            out["sparse_values"] = [[p.index, p.value] for p in v.sparse_values]
        if v.HasField("text"):
            out["text"] = v.text
        if v.metadata:
            out["metadata"] = {
                k: (fv.string_value if fv.WhichOneof("value") == "string_value"
                    else fv.int_value)
                for k, fv in v.metadata.items()
            }
        return out

    @staticmethod
    def _dict_to_vector(d: dict) -> pb.Vector:
        v = pb.Vector(id=str(d["id"]))
        if d.get("document_id") is not None:
            v.document_id = str(d["document_id"])
        if d.get("dense_values"):
            v.dense_values.extend(d["dense_values"])
        for pair in d.get("sparse_values") or []:
            v.sparse_values.add(index=int(pair[0]), value=float(pair[1]))
        if d.get("text") is not None:
            v.text = d["text"]
        for k, val in (d.get("metadata") or {}).items():
            if isinstance(val, str):
                v.metadata[k].string_value = val
            else:
                v.metadata[k].int_value = int(val)
        return v

    # -- auth --------------------------------------------------------------

    def CreateSession(self, request, context):
        try:
            s = self.sessions.create_session(request.username, request.password)
        except PermissionError as e:
            _abort(context, grpc.StatusCode.UNAUTHENTICATED, str(e))
        return pb.CreateSessionResponse(
            access_token=s["access_token"],
            created_at=s["created_at"],
            expires_at=s["expires_at"],
        )

    # -- collections ---------------------------------------------------------

    def CreateCollection(self, request, context):
        self._auth(context)
        cfg = {
            "name": request.name,
            "description": request.description if request.HasField("description") else None,
            "dense_vector": {
                "enabled": request.dense_vector.enabled,
                "dimension": request.dense_vector.dimension,
            },
            "sparse_vector": {"enabled": request.sparse_vector.enabled},
            "tf_idf_options": {"enabled": request.tf_idf_options.enabled},
            "store_raw_text": request.store_raw_text,
        }
        try:
            self.ctx.create_collection(cfg)
        except ValueError as e:
            _abort(context, grpc.StatusCode.ALREADY_EXISTS, str(e))
        return pb.CreateCollectionResponse(name=request.name)

    def GetCollections(self, request, context):
        self._auth(context)
        resp = pb.GetCollectionsResponse()
        for c in self.ctx.snapshot_collections():
            resp.collections.add(
                name=c.name,
                dense_vector=pb.DenseVectorOptions(
                    enabled=bool(c.dense_vector.get("enabled")),
                    dimension=int(c.dense_vector.get("dimension") or 0),
                ),
                sparse_vector=pb.SparseVectorOptions(
                    enabled=bool(c.sparse_vector.get("enabled"))
                ),
                tf_idf_options=pb.TFIDFOptions(
                    enabled=bool(c.tf_idf_options.get("enabled"))
                ),
            )
        return resp

    def GetCollection(self, request, context):
        self._auth(context)
        c = self._coll(context, request.collection_id)
        return pb.Collection(
            name=c.name,
            dense_vector=pb.DenseVectorOptions(
                enabled=bool(c.dense_vector.get("enabled")),
                dimension=int(c.dense_vector.get("dimension") or 0),
            ),
            sparse_vector=pb.SparseVectorOptions(
                enabled=bool(c.sparse_vector.get("enabled"))
            ),
            tf_idf_options=pb.TFIDFOptions(
                enabled=bool(c.tf_idf_options.get("enabled"))
            ),
        )

    def DeleteCollection(self, request, context):
        self._auth(context)
        # delete_collection raises KeyError for unknown names itself; going
        # through _coll() would lazily LOAD an unloaded collection (WAL
        # replay + index rebuild) just to throw it away
        try:
            self.ctx.delete_collection(request.collection_id)
        except KeyError:
            _abort(
                context,
                grpc.StatusCode.NOT_FOUND,
                f"collection '{request.collection_id}' not found",
            )
        return empty_pb2.Empty()

    # -- indexes --------------------------------------------------------------

    def CreateDenseIndex(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        which = request.WhichOneof("quantization")
        if which == "scalar":
            quant = {
                "type": "scalar",
                "data_type": request.scalar.data_type,
                "range": {"min": request.scalar.range.min, "max": request.scalar.range.max},
            }
        else:
            quant = {
                "type": "auto",
                "sample_threshold": request.auto.sample_threshold or 100,
            }
        hp = request.hnsw_params
        params = {}
        for proto_name, name in [
            ("num_layers", "num_layers"),
            ("num_neighbors", "neighbors_count"),
            ("level_0_neighbors_count", "level_0_neighbors_count"),
            ("ef_construction", "ef_construction"),
            ("ef_search", "ef_search"),
        ]:
            if hp.HasField(proto_name):
                params[name] = getattr(hp, proto_name)
        try:
            coll.create_dense_index(
                request.distance_metric_type or "cosine", quant, params
            )
            self.ctx._persist_index_descriptors(coll)
        except ValueError as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    def CreateSparseIndex(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.create_sparse_index(
                request.quantization
                if request.HasField("quantization")
                else 64,
                request.sample_threshold
                if request.HasField("sample_threshold")
                else 1000,
            )
            self.ctx._persist_index_descriptors(coll)
        except ValueError as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    def CreateTFIDFIndex(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.create_tf_idf_index(
                request.k1 if request.HasField("k1") else 1.2,
                request.b if request.HasField("b") else 0.75,
                request.sample_threshold
                if request.HasField("sample_threshold")
                else 1000,
            )
            self.ctx._persist_index_descriptors(coll)
        except ValueError as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    # -- transactions -----------------------------------------------------------

    def CreateTransaction(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            txn = coll.create_transaction()
        except RuntimeError as e:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return pb.CreateTransactionResponse(
            transaction_id=txn.txn_id, created_at=int(txn.created_at)
        )

    def CommitTransaction(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            txn = coll.get_transaction(request.transaction_id)
            version = coll.commit_transaction(request.transaction_id)
        except KeyError as e:
            _abort(context, grpc.StatusCode.NOT_FOUND, str(e))
        except RuntimeError as e:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION, str(e))
        self.ctx.indexing.trigger(coll, version, txn)
        return empty_pb2.Empty()

    def AbortTransaction(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.abort_transaction(request.transaction_id)
        except (KeyError, RuntimeError) as e:
            _abort(context, grpc.StatusCode.NOT_FOUND, str(e))
        return empty_pb2.Empty()

    def CreateVectorInTransaction(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.txn_upsert(
                request.transaction_id,
                [self._vector_to_dict(request.vector)],
                upsert=False,
            )
        except (KeyError, RuntimeError, ValueError) as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    def DeleteVectorInTransaction(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.txn_delete(request.transaction_id, request.vector_id)
        except (KeyError, RuntimeError) as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    def UpsertVectors(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        try:
            coll.txn_upsert(
                request.transaction_id,
                [self._vector_to_dict(v) for v in request.vectors],
                upsert=True,
            )
        except (KeyError, RuntimeError, ValueError) as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return empty_pb2.Empty()

    # -- vectors -------------------------------------------------------------------

    def GetVector(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        rec = coll.get_vector(request.vector_id)
        if rec is None:
            rec = coll.get_vector(_maybe_int(request.vector_id))
        if rec is None:
            _abort(
                context,
                grpc.StatusCode.NOT_FOUND,
                f"vector '{request.vector_id}' not found",
            )
        return pb.VectorResponse(vector=self._dict_to_vector(rec))

    def FindSimilarVectors(self, request, context):
        self._auth(context)
        coll = self._coll(context, request.collection_id)
        which = request.WhichOneof("query")
        try:
            if which == "dense":
                q = request.dense
                results = coll.search_dense(
                    [list(q.vector)], int(q.top_k or 10)
                )[0]
            elif which == "sparse":
                q = request.sparse
                results = coll.search_sparse(
                    [[(p.index, p.value) for p in q.values]],
                    int(q.top_k or 10),
                    q.early_terminate_threshold
                    if q.HasField("early_terminate_threshold")
                    else None,
                )[0]
            elif which == "tf_idf":
                q = request.tf_idf
                results = coll.search_tfidf([q.query], int(q.top_k or 10))[0]
            else:
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT, "missing query")
        except AttributeError:
            _abort(
                context,
                grpc.StatusCode.FAILED_PRECONDITION,
                "required index does not exist",
            )
        resp = pb.FindSimilarVectorsResponse()
        for r in results:
            m = resp.matches.add(id=str(r["id"]), score=r["score"])
            if r.get("document_id") is not None:
                m.document_id = str(r["document_id"])
        return resp


def _maybe_int(s):
    try:
        return int(s)
    except (TypeError, ValueError):
        return s


_SERVICE_METHODS = {
    "AuthService": {
        "CreateSession": (pb.CreateSessionRequest, pb.CreateSessionResponse),
    },
    "CollectionsService": {
        "CreateCollection": (pb.CreateCollectionRequest, pb.CreateCollectionResponse),
        "GetCollections": (pb.GetCollectionsRequest, pb.GetCollectionsResponse),
        "GetCollection": (pb.GetCollectionRequest, pb.Collection),
        "DeleteCollection": (pb.DeleteCollectionRequest, empty_pb2.Empty),
    },
    "IndexesService": {
        "CreateDenseIndex": (pb.CreateDenseIndexRequest, empty_pb2.Empty),
        "CreateSparseIndex": (pb.CreateSparseIndexRequest, empty_pb2.Empty),
        "CreateTFIDFIndex": (pb.CreateTFIDFIndexRequest, empty_pb2.Empty),
    },
    "TransactionsService": {
        "CreateTransaction": (pb.CreateTransactionRequest, pb.CreateTransactionResponse),
        "CommitTransaction": (pb.CommitTransactionRequest, empty_pb2.Empty),
        "AbortTransaction": (pb.AbortTransactionRequest, empty_pb2.Empty),
        "CreateVectorInTransaction": (
            pb.CreateVectorInTransactionRequest, empty_pb2.Empty,
        ),
        "DeleteVectorInTransaction": (
            pb.DeleteVectorInTransactionRequest, empty_pb2.Empty,
        ),
        "UpsertVectors": (pb.UpsertVectorsRequest, empty_pb2.Empty),
    },
    "VectorsService": {
        "GetVector": (pb.GetVectorRequest, pb.VectorResponse),
        "FindSimilarVectors": (
            pb.FindSimilarVectorsRequest, pb.FindSimilarVectorsResponse,
        ),
    },
}


def build_server(
    ctx: AppContext,
    sessions: SessionManager | None = None,
    address: str | None = None,
    max_workers: int = 8,
) -> grpc.Server:
    sessions = sessions or SessionManager(ctx.admin_key)
    impl = _Services(ctx, sessions)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    handlers = []
    for service, methods in _SERVICE_METHODS.items():
        rpc = {}
        for method, (req_cls, resp_cls) in methods.items():
            rpc[method] = grpc.unary_unary_rpc_method_handler(
                getattr(impl, method),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        handlers.append(
            grpc.method_handlers_generic_handler(f"{_PKG}.{service}", rpc)
        )
    # server reflection (grpc/server.rs:24-44 parity) — hand-implemented
    # v1alpha protocol over the generated descriptor pool (reflection.py)
    from cosdata_tpu_torch.grpc_api.reflection import reflection_handler

    handlers.append(
        reflection_handler(
            [f"{_PKG}.{service}" for service in _SERVICE_METHODS]
        )
    )
    server.add_generic_rpc_handlers(tuple(handlers))
    if address is None:
        address = f"{ctx.config.grpc.host}:{ctx.config.grpc.port}"
    server.add_insecure_port(address)
    return server
