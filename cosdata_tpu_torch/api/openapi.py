"""OpenAPI document generation with full request/response schemas.

The reference serves utoipa-generated JSON per module at /api-docs/...
(upstream src/api/docs.rs:8-30, api/openapi.rs). This module
re-authors that contract: the component schemas mirror the DTO surface of
the reference's api/vectordb/*/dtos.rs modules, wired to each route.

Port of ``cosdata_tpu/api/openapi.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

from cosdata_tpu_torch import __version__


def _ref(name: str) -> dict:
    return {"$ref": f"#/components/schemas/{name}"}


def _arr(items) -> dict:
    return {"type": "array", "items": items}


_F32 = {"type": "number", "format": "float"}
_STR = {"type": "string"}
_INT = {"type": "integer"}
_BOOL = {"type": "boolean"}
#: vector ids may be strings or integers (models/types.rs VectorId)
_VECTOR_ID = {"oneOf": [{"type": "string"}, {"type": "integer"}]}
#: sparse pair [dimension, value] (indexes/inverted/types.rs SparsePair)
_SPARSE_PAIR = {
    # OpenAPI 3.0 has no prefixItems (that's 3.1): a fixed [dim, value]
    # pair is expressed as a 2-item array whose items are number-typed
    # (ints are valid JSON-Schema numbers)
    "type": "array",
    "items": {"type": "number"},
    "minItems": 2,
    "maxItems": 2,
    "description": "[dimension (int), value (float)] pair",
}

#: metadata filter (metadata/query_filtering.rs:7-110: Is / And / Or over
#: field predicates)
_FILTER = {
    "type": "object",
    "description": "Metadata filter: {field: value} equality predicates, "
    "or {op: 'and'|'or', predicates: [...]}, with {field, value, ne: true} "
    "for inequality",
    "additionalProperties": True,
}


def _schemas() -> dict:
    """Component schemas, mirroring api/vectordb/*/dtos.rs."""
    return {
        # ---- auth (api/auth/dtos.rs) ----
        "CreateSessionDto": {
            "type": "object",
            "required": ["username", "password"],
            "properties": {"username": _STR, "password": _STR},
        },
        "SessionResponse": {
            "type": "object",
            "properties": {
                "access_token": _STR,
                "created_at": _INT,
                "expires_at": _INT,
            },
        },
        # ---- collections (collections/dtos.rs:76-80+) ----
        "DenseVectorOptions": {
            "type": "object",
            "properties": {"enabled": _BOOL, "dimension": _INT},
        },
        "SparseVectorOptions": {
            "type": "object",
            "properties": {"enabled": _BOOL},
        },
        "TfIdfOptions": {
            "type": "object",
            "properties": {"enabled": _BOOL},
        },
        "MetadataField": {
            "type": "object",
            "required": ["name", "values"],
            "properties": {"name": _STR, "values": _arr({})},
        },
        "MetadataSchemaDto": {
            "type": "object",
            "properties": {
                "fields": _arr(_ref("MetadataField")),
                "supported_conditions": _arr(
                    {
                        "type": "object",
                        "properties": {"op": _STR, "field_names": _arr(_STR)},
                    }
                ),
            },
        },
        "CollectionConfig": {
            "type": "object",
            "properties": {
                "max_vectors": {**_INT, "nullable": True},
                "replication_factor": {**_INT, "nullable": True},
            },
        },
        "CreateCollectionDto": {
            "type": "object",
            "required": ["name"],
            "properties": {
                "name": _STR,
                "description": {**_STR, "nullable": True},
                "dense_vector": _ref("DenseVectorOptions"),
                "sparse_vector": _ref("SparseVectorOptions"),
                "tf_idf_options": _ref("TfIdfOptions"),
                "metadata_schema": {
                    "nullable": True,
                    "allOf": [_ref("MetadataSchemaDto")],
                },
                "config": _ref("CollectionConfig"),
                "store_raw_text": _BOOL,
            },
        },
        "CollectionResponse": {
            "type": "object",
            "properties": {
                "name": _STR,
                "description": {**_STR, "nullable": True},
                "dense_vector": _ref("DenseVectorOptions"),
                "sparse_vector": _ref("SparseVectorOptions"),
                "tf_idf_options": _ref("TfIdfOptions"),
                "metadata_schema": {
                    "nullable": True,
                    "allOf": [_ref("MetadataSchemaDto")],
                },
                "config": _ref("CollectionConfig"),
                "store_raw_text": _BOOL,
            },
        },
        "IndexingStatusResponse": {
            "type": "object",
            "properties": {
                "collection_name": _STR,
                "status_counts": {
                    "type": "object",
                    "properties": {
                        "not_started": _INT,
                        "in_progress": _INT,
                        "complete": _INT,
                    },
                },
                "total_records_upserted": _INT,
                "current_version": _INT,
                "background_version": _INT,
            },
        },
        # ---- indexes (indexes/dtos.rs:98-228) ----
        "ValuesRange": {
            "type": "object",
            "required": ["min", "max"],
            "properties": {"min": _F32, "max": _F32},
        },
        "DenseIndexQuantization": {
            "oneOf": [
                {
                    "type": "object",
                    "properties": {
                        "type": {"type": "string", "enum": ["auto"]},
                        "sample_threshold": _INT,
                    },
                },
                {
                    "type": "object",
                    "properties": {
                        "type": {"type": "string", "enum": ["scalar"]},
                        "data_type": {
                            "type": "string",
                            # incl. the reference's "quaternay" typo
                            # (indexes/dtos.rs:132-140)
                            "enum": [
                                "binary", "quaternay", "quaternary",
                                "octal", "u8", "f16", "f32",
                            ],
                        },
                        "range": _ref("ValuesRange"),
                    },
                },
            ]
        },
        "HnswParams": {
            "type": "object",
            "properties": {
                "num_layers": _INT,
                "neighbors_count": _INT,
                "level_0_neighbors_count": _INT,
                "ef_construction": _INT,
                "ef_search": _INT,
            },
        },
        "CreateDenseIndexDto": {
            "type": "object",
            "properties": {
                "name": {**_STR, "nullable": True},
                "distance_metric_type": {
                    "type": "string",
                    "enum": ["cosine", "dotproduct", "euclidean", "hamming"],
                },
                "quantization": _ref("DenseIndexQuantization"),
                "index": {
                    "type": "object",
                    "properties": {
                        "type": {"type": "string", "enum": ["hnsw"]},
                        "params": _ref("HnswParams"),
                    },
                },
                "hnsw_params": _ref("HnswParams"),
                "raw_storage": {
                    "type": "string",
                    "enum": ["device", "host", "disk", "none"],
                    "default": "device",
                    "description": "where exact (raw f32) rows live: device"
                    " memory (fused rerank), host RAM, disk memmap, or"
                    " nowhere; this port serves device and none",
                },
            },
        },
        "CreateSparseIndexDto": {
            "type": "object",
            "properties": {
                "name": {**_STR, "nullable": True},
                "quantization": {
                    "type": "integer",
                    "enum": [16, 32, 64, 128, 256],
                },
                "sample_threshold": _INT,
                "early_terminate_threshold": _F32,
            },
        },
        "CreateTfIdfIndexDto": {
            "type": "object",
            "properties": {
                "name": {**_STR, "nullable": True},
                "k1": _F32,
                "b": _F32,
                "sample_threshold": _INT,
            },
        },
        "IndexDetailsDto": {
            "type": "object",
            "properties": {"indexes": _arr({"type": "object"})},
        },
        # ---- vectors (vectors/dtos.rs:21-34) ----
        "VectorDto": {
            "type": "object",
            "required": ["id"],
            "properties": {
                "id": _VECTOR_ID,
                "document_id": {"nullable": True, **_VECTOR_ID},
                "dense_values": {**_arr(_F32), "nullable": True},
                "metadata": {"type": "object", "nullable": True},
                "sparse_values": {**_arr(_SPARSE_PAIR), "nullable": True},
                "text": {**_STR, "nullable": True},
            },
        },
        # ---- search (search/dtos.rs) ----
        "SearchResultItem": {
            "type": "object",
            "properties": {
                "id": _VECTOR_ID,
                "document_id": {"nullable": True, **_VECTOR_ID},
                "score": _F32,
                "text": {**_STR, "nullable": True},
            },
        },
        "SearchResponse": {
            "type": "object",
            "properties": {
                "results": _arr(_ref("SearchResultItem")),
                "warning": {**_STR, "nullable": True},
            },
        },
        "BatchSearchResponse": {
            "type": "object",
            "properties": {
                "responses": _arr(_ref("SearchResponse")),
                "warning": {**_STR, "nullable": True},
            },
        },
        "DenseSearchRequest": {
            "type": "object",
            "required": ["query_vector"],
            "properties": {
                "query_vector": _arr(_F32),
                "top_k": _INT,
                "filter": {**_FILTER, "nullable": True},
                "return_raw_text": _BOOL,
            },
        },
        "BatchDenseSearchRequest": {
            "type": "object",
            "required": ["queries"],
            "properties": {
                "queries": _arr(
                    {
                        "type": "object",
                        "required": ["vector"],
                        "properties": {
                            "vector": _arr(_F32),
                            "filter": {**_FILTER, "nullable": True},
                        },
                    }
                ),
                "top_k": _INT,
                "return_raw_text": _BOOL,
            },
        },
        "SparseSearchRequest": {
            "type": "object",
            "required": ["query_terms"],
            "properties": {
                "query_terms": _arr(_SPARSE_PAIR),
                "top_k": _INT,
                "early_terminate_threshold": _F32,
                "return_raw_text": _BOOL,
            },
        },
        "BatchSparseSearchRequest": {
            "type": "object",
            "required": ["query_terms_list"],
            "properties": {
                "query_terms_list": _arr(_arr(_SPARSE_PAIR)),
                "top_k": _INT,
                "early_terminate_threshold": _F32,
                "return_raw_text": _BOOL,
            },
        },
        "TfIdfSearchRequest": {
            "type": "object",
            "required": ["query"],
            "properties": {
                "query": _STR,
                "top_k": _INT,
                "return_raw_text": _BOOL,
            },
        },
        "BatchTfIdfSearchRequest": {
            "type": "object",
            "required": ["queries"],
            "properties": {
                "queries": _arr(_STR),
                "top_k": _INT,
                "return_raw_text": _BOOL,
            },
        },
        "HybridSearchQuery": {
            "description": "Two of query_vector / query_terms / query_text "
            "(search/dtos.rs HybridSearchQuery untagged enum)",
            "type": "object",
            "properties": {
                "query_vector": {**_arr(_F32), "nullable": True},
                "query_terms": {**_arr(_SPARSE_PAIR), "nullable": True},
                "query_text": {**_STR, "nullable": True},
                "sparse_early_terminate_threshold": {**_F32, "nullable": True},
            },
        },
        "HybridSearchRequest": {
            "allOf": [
                _ref("HybridSearchQuery"),
                {
                    "type": "object",
                    "properties": {
                        "top_k": _INT,
                        "fusion_constant_k": _F32,
                        "return_raw_text": _BOOL,
                    },
                },
            ]
        },
        "BatchHybridSearchRequest": {
            "type": "object",
            "required": ["queries"],
            "properties": {
                "queries": _arr(_ref("HybridSearchQuery")),
                "top_k": _INT,
                "fusion_constant_k": _F32,
                "return_raw_text": _BOOL,
            },
        },
        # ---- transactions (transactions/dtos.rs) ----
        "CreateTransactionResponse": {
            "type": "object",
            "properties": {"transaction_id": _STR, "created_at": _INT},
        },
        "UpsertDto": {
            "type": "object",
            "required": ["vectors"],
            "properties": {"vectors": _arr(_ref("VectorDto"))},
        },
        "VectorListDto": _arr(_ref("VectorDto")),
        "TransactionStatusResponse": {
            "type": "object",
            "properties": {
                "status": {
                    "type": "string",
                    "enum": ["not_started", "in_progress", "complete"],
                },
                "records_upserted": _INT,
                "records_deleted": _INT,
                "total_operations": _INT,
                "percentage_complete": _F32,
                "processing_time_seconds": {**_F32, "nullable": True},
                "average_throughput": {**_F32, "nullable": True},
                "current_processing_rate": {**_F32, "nullable": True},
                "estimated_completion": {**_STR, "nullable": True},
                "version_created": {**_INT, "nullable": True},
            },
        },
        # ---- versions (versions/dtos.rs) ----
        "VersionMetadata": {
            "type": "object",
            "properties": {
                "version": _INT,
                "source": {"type": "object"},
                "created_at": _F32,
                "records_upserted": _INT,
                "records_deleted": _INT,
                "total_operations": _INT,
            },
        },
        "VersionListResponse": {
            "type": "object",
            "properties": {
                "versions": _arr(_ref("VersionMetadata")),
                "current": _INT,
            },
        },
        "CurrentVersionResponse": _ref("VersionMetadata"),
    }


#: request/response schema per (method, path-suffix) — matched against the
#: route table so new routes degrade to the generic stub instead of failing
_ROUTE_SCHEMAS: list[tuple[str, str, str | None, str | None]] = [
    ("post", "/auth/create-session", "CreateSessionDto", "SessionResponse"),
    ("post", "/vectordb/collections", "CreateCollectionDto", "CollectionResponse"),
    ("get", "/vectordb/collections", None, None),
    ("get", "/vectordb/collections/loaded", None, None),
    ("get", "/vectordb/collections/{collection_id}", None, "CollectionResponse"),
    ("delete", "/vectordb/collections/{collection_id}", None, "CollectionResponse"),
    ("get", "/vectordb/collections/{collection_id}/indexing_status", None,
     "IndexingStatusResponse"),
    ("post", "/vectordb/collections/{collection_id}/indexes/dense",
     "CreateDenseIndexDto", None),
    ("post", "/vectordb/collections/{collection_id}/indexes/sparse",
     "CreateSparseIndexDto", None),
    ("post", "/vectordb/collections/{collection_id}/indexes/tf-idf",
     "CreateTfIdfIndexDto", None),
    ("get", "/vectordb/collections/{collection_id}/indexes", None,
     "IndexDetailsDto"),
    ("post", "/vectordb/collections/{collection_id}/search/dense",
     "DenseSearchRequest", "SearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/batch-dense",
     "BatchDenseSearchRequest", "BatchSearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/sparse",
     "SparseSearchRequest", "SearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/batch-sparse",
     "BatchSparseSearchRequest", "BatchSearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/tf-idf",
     "TfIdfSearchRequest", "SearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/batch-tf-idf",
     "BatchTfIdfSearchRequest", "BatchSearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/hybrid",
     "HybridSearchRequest", "SearchResponse"),
    ("post", "/vectordb/collections/{collection_id}/search/batch-hybrid",
     "BatchHybridSearchRequest", "BatchSearchResponse"),
    ("get", "/vectordb/collections/{collection_id}/vectors/{vector_id}",
     None, "VectorDto"),
    ("get", "/vectordb/collections/{collection_id}/vectors", None, None),
    ("post", "/vectordb/collections/{collection_id}/transactions", None,
     "CreateTransactionResponse"),
    # /vectors takes a BARE vector array (or single object), not the
    # UpsertDto envelope (server.txn_vectors wraps non-list bodies)
    ("post",
     "/vectordb/collections/{collection_id}/transactions/{txn_id}/vectors",
     "VectorListDto", None),
    ("post",
     "/vectordb/collections/{collection_id}/transactions/{txn_id}/upsert",
     "UpsertDto", None),
    ("get",
     "/vectordb/collections/{collection_id}/transactions/{txn_id}/status",
     None, "TransactionStatusResponse"),
    ("post", "/vectordb/collections/{collection_id}/streaming/upsert",
     "UpsertDto", None),
    ("get", "/vectordb/collections/{collection_id}/versions", None,
     "VersionListResponse"),
    ("get", "/vectordb/collections/{collection_id}/versions/current", None,
     "CurrentVersionResponse"),
]


#: scoped doc modules, mirroring the reference's per-module utoipa docs
#: (upstream src/api/docs.rs:8-30): each name maps to a predicate
#: over the route path.
DOC_MODULES = {
    "auth": lambda p: p.startswith("/auth"),
    "collections": lambda p: p.startswith("/vectordb/collections")
    and not any(
        s in p
        for s in ("/indexes", "/search", "/vectors", "/transactions",
                  "/streaming", "/versions")
    ),
    "indexes": lambda p: "/indexes" in p,
    "search": lambda p: "/search" in p,
    "transactions": lambda p: "/transactions" in p,
    "vectors": lambda p: "/vectors" in p and "/transactions" not in p
    and "/streaming" not in p,
    "versions": lambda p: "/versions" in p,
    "streaming": lambda p: "/streaming" in p,
}


def build_openapi(app, module: str | None = None) -> dict:
    by_key = {(m, p): (req, resp) for m, p, req, resp in _ROUTE_SCHEMAS}
    keep = DOC_MODULES.get(module) if module else None
    paths: dict[str, dict] = {}
    for route in app.router.routes():
        info = route.resource.get_info() if route.resource else {}
        path = info.get("path") or info.get("formatter")
        if not path or route.method in ("HEAD", "OPTIONS", "*"):
            continue
        if keep is not None and not keep(path):
            continue
        entry = paths.setdefault(path, {})
        method = route.method.lower()
        op = {
            "operationId": f"{method}_{path.strip('/').replace('/', '_').replace('{', '').replace('}', '')}",
            "responses": {"200": {"description": "OK"}},
        }
        req, resp = by_key.get((method, path), (None, None))
        if req:
            op["requestBody"] = {
                "required": True,
                "content": {"application/json": {"schema": _ref(req)}},
            }
        if resp:
            op["responses"]["200"] = {
                "description": "OK",
                "content": {"application/json": {"schema": _ref(resp)}},
            }
        if path.startswith("/vectordb"):
            op["security"] = [{"bearerAuth": []}]
        entry[method] = op
    return {
        "openapi": "3.0.3",
        "info": {
            "title": f"cosdata_tpu_torch — {module}" if module else "cosdata_tpu_torch",
            "version": __version__,
            "description": "vector database on a CUDA GPU — REST API",
        },
        "components": {
            "schemas": _schemas(),
            "securitySchemes": {
                "bearerAuth": {
                    "type": "http",
                    "scheme": "bearer",
                    "description": "Session token from /auth/create-session "
                    "(1 h lifetime, crypto.rs:34-137)",
                }
            },
        },
        "paths": paths,
    }
