"""PyTorch/CUDA port of cosdata_tpu: dense search (u8, sub-byte, f16, f32)
by the exact scan and the HNSW graph, sparse (SPLADE-style) inverted-index
search, BM25 full-text search, hybrid search by reciprocal-rank fusion, and
the serving stack above them
(collections, transactions, WAL, versions, snapshots, the REST and gRPC
servers; ``python -m cosdata_tpu_torch --device cuda --admin-key KEY``).

Module names mirror ``cosdata_tpu`` so each counterpart is easy to find.
The package imports torch and numpy only, never jax and never
``cosdata_tpu`` (whose ``__init__`` imports jax). Every index and store
takes an explicit ``device``: CPU tensors take each kernel's plain PyTorch
version, CUDA tensors take the hand-written kernel or raise.
"""

__version__ = "0.1.0"
