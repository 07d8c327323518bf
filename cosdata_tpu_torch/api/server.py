"""REST server reproducing the reference's route surface
(upstream src/web_server.rs:26-90 + src/api/vectordb/*/mod.rs):

  POST /auth/create-session
  /vectordb/collections               POST, GET, GET /loaded,
                                      GET|DELETE /{id}, GET /{id}/indexing_status,
                                      POST /{id}/load, POST /{id}/unload
  .../indexes                         GET, POST /dense|/sparse|/tf-idf,
                                      DELETE /{index_type}
  .../search                          POST /dense|/batch-dense|/sparse|
                                      /batch-sparse|/tf-idf|/batch-tf-idf|
                                      /hybrid|/batch-hybrid
  .../vectors                         GET ?document_id=, GET|HEAD /{id},
                                      GET /{id}/neighbors (unimplemented, like
                                      vectors/repo.rs:101-107)
  .../transactions                    POST, POST /{t}/commit, GET /{t}/status,
                                      POST /{t}/vectors, POST /{t}/upsert,
                                      DELETE /{t}/vectors/{vid}, POST /{t}/abort
  .../streaming                       POST /upsert, DELETE /vectors/{vid}
  .../versions                        GET, GET /current
  GET /api-docs/openapi.json

aiohttp replaces actix; compute-heavy work runs in a worker executor so the
event loop stays responsive (the reference's actix worker threads play the
same role, web_server.rs:48).

Port of ``cosdata_tpu/api/server.py``. Dense searches take the exact
scan or the HNSW graph as the reference's do, sharded collections
included; ``/neighbors`` answers the reference's plain 501 "not
implemented".
"""

from __future__ import annotations

import asyncio
import json
import logging
from functools import partial

from aiohttp import web

from cosdata_tpu_torch.api.auth import SessionManager
from cosdata_tpu_torch.core.app_context import AppContext

log = logging.getLogger(__name__)

JSON_LIMIT = 8 * 1024 * 1024  # actix 8 MB JSON limit (web_server.rs)


def _err(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


async def _run(request, fn, *args, **kwargs):
    """Run blocking service work in the executor."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, partial(fn, *args, **kwargs))


class Server:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self.sessions = SessionManager(ctx.admin_key)
        self.app = web.Application(
            client_max_size=JSON_LIMIT,
            middlewares=[self._cors_middleware, self._auth_middleware],
        )
        self._routes()

    # -------------------------------------------------------------- plumbing

    _CORS_HEADERS = {
        # permissive CORS, matching the reference (web_server.rs:51
        # Cors::permissive())
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, HEAD, OPTIONS",
        "Access-Control-Allow-Headers": "*",
        "Access-Control-Max-Age": "3600",
    }

    @web.middleware
    async def _cors_middleware(self, request, handler):
        if request.method == "OPTIONS":
            return web.Response(status=204, headers=self._CORS_HEADERS)
        resp = await handler(request)
        for k, v in self._CORS_HEADERS.items():
            resp.headers.setdefault(k, v)
        return resp

    @web.middleware
    async def _auth_middleware(self, request, handler):
        if request.path.startswith("/vectordb"):
            auth = request.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip() if auth else None
            if not self.sessions.check(token):
                return _err(401, "invalid or expired session")
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except KeyError as e:
            # service-layer "X not found" KeyErrors are 404; a KeyError from
            # a missing request-body field is a client error
            if "not found" in str(e):
                return _err(404, str(e))
            return _err(400, f"missing required field: {e}")
        except PermissionError as e:
            return _err(401, str(e))
        except ValueError as e:
            return _err(400, str(e))
        except RuntimeError as e:
            return _err(409, str(e))
        except Exception as e:  # pragma: no cover
            log.exception("internal error")
            return _err(500, f"internal error: {e}")

    async def _coll(self, request):
        cid = request.match_info["collection_id"]
        if cid in self.ctx.collections:
            coll = self.ctx.get_collection(cid)  # loaded: LRU touch only
        else:
            # unloaded: lazy reload = snapshot load + WAL replay + device
            # index rebuild (documented minutes at scale) — NEVER on the
            # event loop, or every other request stalls behind it
            coll = await _run(request, self.ctx.get_collection, cid)
        if coll is None:
            raise KeyError(f"collection '{cid}' not found")
        return coll

    def _warning(self, coll) -> str | None:
        """'is indexing' warning attached to search responses
        (search/repo.rs:29-32)."""
        st = coll.indexing_status()
        if st["status_counts"]["in_progress"] > 0 or (
            coll.vcs.background_version < coll.vcs.current_version
        ):
            return (
                "Some transactions are still being indexed; results may be "
                "incomplete"
            )
        return None

    def _routes(self):
        r = self.app.router
        r.add_post("/auth/create-session", self.create_session)

        c = "/vectordb/collections"
        r.add_post(c, self.create_collection)
        r.add_get(c, self.list_collections)
        r.add_get(c + "/loaded", self.loaded_collections)
        r.add_get(c + "/{collection_id}", self.get_collection)
        r.add_delete(c + "/{collection_id}", self.delete_collection)
        r.add_get(c + "/{collection_id}/indexing_status", self.indexing_status)
        r.add_post(c + "/{collection_id}/load", self.load_collection)
        r.add_post(c + "/{collection_id}/unload", self.unload_collection)

        i = c + "/{collection_id}/indexes"
        r.add_get(i, self.list_indexes)
        r.add_post(i + "/dense", self.create_dense_index)
        r.add_post(i + "/sparse", self.create_sparse_index)
        r.add_post(i + "/tf-idf", self.create_tf_idf_index)
        r.add_delete(i + "/{index_type}", self.delete_index)

        s = c + "/{collection_id}/search"
        r.add_post(s + "/dense", self.search_dense)
        r.add_post(s + "/batch-dense", self.search_batch_dense)
        r.add_post(s + "/sparse", self.search_sparse)
        r.add_post(s + "/batch-sparse", self.search_batch_sparse)
        r.add_post(s + "/tf-idf", self.search_tfidf)
        r.add_post(s + "/batch-tf-idf", self.search_batch_tfidf)
        r.add_post(s + "/hybrid", self.search_hybrid)
        r.add_post(s + "/batch-hybrid", self.search_batch_hybrid)

        v = c + "/{collection_id}/vectors"
        r.add_get(v, self.vectors_by_document)
        r.add_get(v + "/{vector_id}", self.get_vector, allow_head=True)
        r.add_get(v + "/{vector_id}/neighbors", self.get_neighbors)

        t = c + "/{collection_id}/transactions"
        r.add_post(t, self.create_transaction)
        r.add_post(t + "/{txn_id}/commit", self.commit_transaction)
        r.add_get(t + "/{txn_id}/status", self.transaction_status)
        r.add_post(t + "/{txn_id}/vectors", self.txn_vectors)
        r.add_post(t + "/{txn_id}/upsert", self.txn_upsert)
        r.add_delete(t + "/{txn_id}/vectors/{vector_id}", self.txn_delete_vector)
        r.add_post(t + "/{txn_id}/abort", self.abort_transaction)

        st = c + "/{collection_id}/streaming"
        r.add_post(st + "/upsert", self.stream_upsert)
        r.add_delete(st + "/vectors/{vector_id}", self.stream_delete)

        ver = c + "/{collection_id}/versions"
        r.add_get(ver, self.list_versions)
        r.add_get(ver + "/current", self.current_version)

        r.add_get("/api-docs/openapi.json", self.openapi)
        # per-module scoped docs, mirroring upstream src/api/docs.rs:8-30
        r.add_get("/api-docs/{module}/openapi.json", self.openapi_module)
        r.add_get("/metrics", self.metrics)

    # ---------------------------------------------------------------- auth

    async def create_session(self, request):
        body = await request.json()
        details = self.sessions.create_session(
            body.get("username", ""), body.get("password", "")
        )
        return web.json_response(details)

    # ---------------------------------------------------------- collections

    async def create_collection(self, request):
        body = await request.json()
        coll = await _run(request, self.ctx.create_collection, body)
        return web.json_response(coll.to_dict(), status=201)

    async def list_collections(self, request):
        return web.json_response({"collections": self.ctx.list_collections()})

    async def loaded_collections(self, request):
        return web.json_response(
            {"collections": [c.name for c in self.ctx.collections.values()]}
        )

    async def get_collection(self, request):
        return web.json_response((await self._coll(request)).to_dict())

    async def delete_collection(self, request):
        # do NOT resolve through _coll(): that lazily LOADS an unloaded
        # collection (WAL replay + device index rebuild) only to delete it
        name = request.match_info["collection_id"]
        info = await _run(request, self.ctx.delete_collection, name)
        return web.json_response(info)

    async def indexing_status(self, request):
        return web.json_response((await self._coll(request)).indexing_status())

    async def load_collection(self, request):
        name = request.match_info["collection_id"]
        await _run(request, self.ctx.load_collection, name)
        return web.json_response({"status": "loaded"})

    async def unload_collection(self, request):
        name = request.match_info["collection_id"]
        await _run(request, self.ctx.unload_collection, name)
        return web.json_response({"status": "unloaded"})

    # -------------------------------------------------------------- indexes

    async def list_indexes(self, request):
        coll = await self._coll(request)
        return web.json_response({"indexes": coll.list_indexes()})

    async def create_dense_index(self, request):
        body = await request.json()
        coll = await self._coll(request)
        hnsw_params = body.get("hnsw_params") or {}
        params = {
            # the reference DTO field is 'neighbors_count' (dtos.rs:166);
            # 'num_neighbors' kept as a lenient alias
            "neighbors_count": hnsw_params.get(
                "neighbors_count", hnsw_params.get("num_neighbors")
            ),
            "level_0_neighbors_count": hnsw_params.get("level_0_neighbors_count"),
            "ef_construction": hnsw_params.get("ef_construction"),
            "ef_search": hnsw_params.get("ef_search"),
            "num_layers": hnsw_params.get("num_layers"),
        }
        params = {k: v for k, v in params.items() if v is not None}
        desc = await _run(
            request,
            coll.create_dense_index,
            body.get("distance_metric_type", body.get("distance_metric", "cosine")),
            body.get("quantization"),
            params,
            body.get("raw_storage", "device"),
            # multi-chip sharded engine (extension knob; defaults to the
            # collection config's `shards`)
            body.get("shards"),
        )
        self.ctx._persist_index_descriptors(coll)
        return web.json_response(desc, status=201)

    async def create_sparse_index(self, request):
        body = await request.json()
        coll = await self._coll(request)
        desc = await _run(
            request,
            coll.create_sparse_index,
            body.get("quantization", 64),
            body.get("sample_threshold", 1000),
            body.get("early_terminate_threshold", 0.0),
            # extension knobs: pin posting-scan budgets per collection
            # (both equal -> deterministic quality under any batch size)
            body.get("scan_budget"),
            body.get("scan_budget_total"),
        )
        self.ctx._persist_index_descriptors(coll)
        return web.json_response(desc, status=201)

    async def create_tf_idf_index(self, request):
        body = await request.json()
        coll = await self._coll(request)
        desc = await _run(
            request,
            coll.create_tf_idf_index,
            body.get("k1", 1.2),
            body.get("b", 0.75),
            body.get("sample_threshold", 1000),
            body.get("scan_budget"),
            body.get("scan_budget_total"),
        )
        self.ctx._persist_index_descriptors(coll)
        return web.json_response(desc, status=201)

    async def delete_index(self, request):
        coll = await self._coll(request)
        coll.delete_index(request.match_info["index_type"])
        self.ctx._persist_index_descriptors(coll)
        return web.json_response({"status": "deleted"})

    # --------------------------------------------------------------- search

    async def _coll_at_version(self, request, body):
        """Resolve the collection, honoring an optional historical
        ``version`` (version-context querying; requires
        enable_context_history snapshots)."""
        coll = await self._coll(request)
        v = body.get("version")
        if v is not None:
            # checkout loads a full snapshot on a cache miss: executor
            coll = await _run(request, coll.checkout_version, int(v))
        return coll

    async def search_dense(self, request):
        body = await request.json()
        coll = await self._coll_at_version(request, body)
        if coll.dense is None:
            raise KeyError("dense index not found")
        results = await _run(
            request,
            coll.search_dense,
            [body["query_vector"]],
            int(body.get("top_k") or 10),
            bool(body.get("return_raw_text", False)),
            body.get("filter"),
        )
        return web.json_response(
            {"results": results[0], "warning": self._warning(coll)}
        )

    async def search_batch_dense(self, request):
        body = await request.json()
        coll = await self._coll(request)
        if coll.dense is None:
            raise KeyError("dense index not found")
        top_k = int(body.get("top_k") or 10)
        rrt = bool(body.get("return_raw_text", False))
        qs = body["queries"]
        # group queries by per-query filter so each group runs as one
        # batched device call (BatchDenseSearchRequestQueryDto carries an
        # optional filter per query — previously silently ignored)
        groups: dict[str, list[int]] = {}
        for i, q in enumerate(qs):
            key = json.dumps(q.get("filter"), sort_keys=True)
            groups.setdefault(key, []).append(i)
        results = [None] * len(qs)
        for idxs in groups.values():
            part = await _run(
                request,
                coll.search_dense,
                [qs[i]["vector"] for i in idxs],
                top_k,
                rrt,
                qs[idxs[0]].get("filter"),
            )
            for i, r in zip(idxs, part):
                results[i] = r
        return web.json_response(
            {
                "responses": [{"results": r} for r in results],
                "warning": self._warning(coll),
            }
        )

    async def search_sparse(self, request):
        body = await request.json()
        coll = await self._coll_at_version(request, body)
        if coll.sparse is None:
            raise KeyError("sparse index not found")
        results = await _run(
            request,
            coll.search_sparse,
            [[tuple(p) for p in body["query_terms"]]],
            int(body.get("top_k") or 10),
            body.get("early_terminate_threshold"),
            bool(body.get("return_raw_text", False)),
        )
        return web.json_response(
            {"results": results[0], "warning": self._warning(coll)}
        )

    async def search_batch_sparse(self, request):
        body = await request.json()
        coll = await self._coll(request)
        if coll.sparse is None:
            raise KeyError("sparse index not found")
        queries = [[tuple(p) for p in q] for q in body["query_terms_list"]]
        results = await _run(
            request,
            coll.search_sparse,
            queries,
            int(body.get("top_k") or 10),
            body.get("early_terminate_threshold"),
            bool(body.get("return_raw_text", False)),
        )
        return web.json_response(
            {
                "responses": [{"results": r} for r in results],
                "warning": self._warning(coll),
            }
        )

    async def search_tfidf(self, request):
        body = await request.json()
        coll = await self._coll_at_version(request, body)
        if coll.tfidf is None:
            raise KeyError("tf-idf index not found")
        results = await _run(
            request,
            coll.search_tfidf,
            [body["query"]],
            int(body.get("top_k") or 10),
            bool(body.get("return_raw_text", False)),
        )
        return web.json_response(
            {"results": results[0], "warning": self._warning(coll)}
        )

    async def search_batch_tfidf(self, request):
        body = await request.json()
        coll = await self._coll(request)
        if coll.tfidf is None:
            raise KeyError("tf-idf index not found")
        queries = body["queries"]
        # DTO parity: queries is Vec<String> (search/dtos.rs:136-141) —
        # serde would reject non-strings with 400, not surface a 500
        if not isinstance(queries, list) or not all(
            isinstance(q, str) for q in queries
        ):
            raise ValueError("queries must be a list of strings")
        results = await _run(
            request,
            coll.search_tfidf,
            queries,
            int(body.get("top_k") or 10),
            bool(body.get("return_raw_text", False)),
        )
        return web.json_response(
            {
                "responses": [{"results": r} for r in results],
                "warning": self._warning(coll),
            }
        )

    async def search_hybrid(self, request):
        body = await request.json()
        coll = await self._coll(request)
        query = {
            k: body[k]
            for k in (
                "query_vector",
                "query_terms",
                "query_text",
                "sparse_early_terminate_threshold",
            )
            if k in body
        }
        results = await _run(
            request,
            coll.hybrid_search,
            query,
            int(body.get("top_k") or 10),
            float(body.get("fusion_constant_k") or 60.0),
            bool(body.get("return_raw_text", False)),
        )
        return web.json_response({"results": results, "warning": self._warning(coll)})

    async def search_batch_hybrid(self, request):
        body = await request.json()
        coll = await self._coll(request)
        # ONE batched call: legs are regrouped across queries inside
        # Collection.hybrid_search_batch (the reference regroups legs and
        # joins them, search/repo.rs:343-555) — not a per-query fan-out
        queries = [
            {
                k: q[k]
                for k in (
                    "query_vector",
                    "query_terms",
                    "query_text",
                    "sparse_early_terminate_threshold",
                )
                if k in q
            }
            for q in body["queries"]
        ]
        results = await _run(
            request,
            coll.hybrid_search_batch,
            queries,
            int(body.get("top_k") or 10),
            float(body.get("fusion_constant_k") or 60.0),
            bool(body.get("return_raw_text", False)),
        )
        out = [{"results": r} for r in results]
        return web.json_response(
            {"responses": out, "warning": self._warning(coll)}
        )

    # -------------------------------------------------------------- vectors

    async def vectors_by_document(self, request):
        coll = await self._coll(request)
        doc = request.query.get("document_id")
        if doc is None:
            raise ValueError("document_id query parameter required")
        return web.json_response(
            {"vectors": coll.vectors_by_document(_maybe_int(doc))}
        )

    async def get_vector(self, request):
        coll = await self._coll(request)
        vid = _maybe_int(request.match_info["vector_id"])
        rec = coll.get_vector(vid)
        if rec is None:
            raise KeyError(f"vector '{vid}' not found")
        if request.method == "HEAD":
            return web.Response(status=200)
        return web.json_response(rec)

    async def get_neighbors(self, request):
        # explicitly unimplemented, as in the reference (vectors/repo.rs:101-107)
        return _err(501, "not implemented")

    # --------------------------------------------------------- transactions

    async def create_transaction(self, request):
        coll = await self._coll(request)
        txn = coll.create_transaction()
        return web.json_response(txn.to_dict())

    async def commit_transaction(self, request):
        coll = await self._coll(request)
        txn_id = request.match_info["txn_id"]
        txn = coll.get_transaction(txn_id)
        version = await _run(request, coll.commit_transaction, txn_id)
        self.ctx.indexing.trigger(coll, version, txn)
        return web.json_response({"version": version}, status=200)

    async def transaction_status(self, request):
        coll = await self._coll(request)
        txn = coll.get_transaction(request.match_info["txn_id"])
        return web.json_response(txn.status.to_dict())

    async def txn_vectors(self, request):
        body = await request.json()
        coll = await self._coll(request)
        vectors = body if isinstance(body, list) else [body]
        await _run(
            request, coll.txn_upsert, request.match_info["txn_id"], vectors, False
        )
        return web.json_response({"inserted": len(vectors)})

    async def txn_upsert(self, request):
        body = await request.json()
        coll = await self._coll(request)
        vectors = body.get("vectors") if isinstance(body, dict) else body
        if not isinstance(vectors, list):
            raise ValueError("request body must contain a 'vectors' list")
        await _run(
            request, coll.txn_upsert, request.match_info["txn_id"], vectors, True
        )
        return web.json_response({"upserted": len(vectors)})

    async def txn_delete_vector(self, request):
        coll = await self._coll(request)
        coll.txn_delete(
            request.match_info["txn_id"], _maybe_int(request.match_info["vector_id"])
        )
        return web.json_response({"status": "queued"})

    async def abort_transaction(self, request):
        coll = await self._coll(request)
        coll.abort_transaction(request.match_info["txn_id"])
        return web.json_response({"status": "aborted"})

    # ------------------------------------------------------------ streaming

    async def stream_upsert(self, request):
        body = await request.json()
        coll = await self._coll(request)
        vectors = body.get("vectors") if isinstance(body, dict) else body
        if not isinstance(vectors, list):
            raise ValueError("request body must contain a 'vectors' list")
        await _run(request, coll.stream_upsert, vectors)
        return web.json_response({"upserted": len(vectors)})

    async def stream_delete(self, request):
        coll = await self._coll(request)
        await _run(
            request, coll.stream_delete, _maybe_int(request.match_info["vector_id"])
        )
        return web.json_response({"status": "deleted"})

    # ------------------------------------------------------------- versions

    async def list_versions(self, request):
        coll = await self._coll(request)
        return web.json_response({"versions": coll.vcs.list_versions()})

    async def current_version(self, request):
        coll = await self._coll(request)
        v = coll.vcs.current_version
        return web.json_response(
            {"version": v, **(coll.vcs.version_info(v) or {})}
        )

    # ----------------------------------------------------------------- docs

    async def metrics(self, request):
        from cosdata_tpu_torch.utils.profiling import profiler

        return web.json_response({"timers": profiler.snapshot()})

    async def openapi(self, request):
        from cosdata_tpu_torch.api.openapi import build_openapi

        return web.json_response(build_openapi(self.app))

    async def openapi_module(self, request):
        from cosdata_tpu_torch.api.openapi import DOC_MODULES, build_openapi

        module = request.match_info["module"]
        if module not in DOC_MODULES:
            raise web.HTTPNotFound(
                text=json.dumps({"error": f"unknown docs module {module!r}"}),
                content_type="application/json",
            )
        return web.json_response(build_openapi(self.app, module))


def _maybe_int(s: str):
    try:
        return int(s)
    except (TypeError, ValueError):
        return s


def make_app(ctx: AppContext) -> web.Application:
    return Server(ctx).app


def run_server(ctx: AppContext):
    app = make_app(ctx)
    ssl_ctx = None
    if ctx.config.server.mode == "https":
        # rustls-equivalent TLS termination (web_server.rs:92-126)
        import ssl

        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(
            ctx.config.server.ssl.cert_file, ctx.config.server.ssl.key_file
        )
    web.run_app(
        app,
        host=ctx.config.server.host,
        port=ctx.config.server.port,
        ssl_context=ssl_ctx,
    )
