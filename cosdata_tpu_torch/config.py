"""Configuration system (TOML), mirroring upstream src/config_loader.rs
and the defaults in upstream config.toml.

Port of ``cosdata_tpu/config.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class SslConfig:
    cert_file: str = ""
    key_file: str = ""


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8443
    mode: str = "http"  # "http" or "https" (config.toml:14)
    ssl: SslConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.ssl is None:
            self.ssl = SslConfig()


@dataclass
class HnswConfig:
    # config.toml:19-26
    default_neighbors_count: int = 32
    default_level_0_neighbors_count: int = 64
    default_ef_construction: int = 128
    default_ef_search: int = 256
    default_num_layer: int = 9
    default_max_cache_size: int = 1000


@dataclass
class SearchConfig:
    shortlist_size: int = 64
    early_terminate_threshold: float = 0.0


@dataclass
class IndexingConfig:
    clamp_margin_percent: float = 1.0
    mode: str = "batch"
    batch_size: int = 8


@dataclass
class CacheConfig:
    # collection residency cap + probabilistic-eviction knobs
    # (config_loader.rs:201-225: max 10 collections, prob 0.03125)
    max_collections: int = 10
    eviction_probability: float = 0.03125


@dataclass
class GrpcConfig:
    host: str = "127.0.0.1"
    port: int = 50051


@dataclass
class Config:
    upload_threshold: int = 100
    upload_process_batch_size: int = 1000
    rerank_sparse_with_raw_values: bool = False
    sparse_raw_values_reranking_factor: int = 5
    epoch_length: int = 3600
    # retain a per-version snapshot directory (the reference's
    # enable_context_history keeps versioned latest-link region files,
    # cache_loader.rs:98-112). Off by default here: array snapshots are
    # full copies, so history costs O(index size) per version.
    enable_context_history: bool = False
    data_path: str = "./data"
    server: ServerConfig = field(default_factory=ServerConfig)
    hnsw: HnswConfig = field(default_factory=HnswConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    grpc: GrpcConfig = field(default_factory=GrpcConfig)


def _merge(dc, d: dict):
    for k, v in d.items():
        if hasattr(dc, k):
            cur = getattr(dc, k)
            if hasattr(cur, "__dataclass_fields__") and isinstance(v, dict):
                _merge(cur, v)
            else:
                setattr(dc, k, v)
    return dc


def load_config(path: str | Path | None = None, **overrides) -> Config:
    """Load TOML config; ``path=None`` = pure defaults. An explicitly
    named file that doesn't exist is an ERROR — silently falling back to
    defaults would start the server against the wrong data directory."""
    cfg = Config()
    if path is not None:
        if not Path(path).exists():
            raise FileNotFoundError(f"config file not found: {path}")
        with open(path, "rb") as f:
            _merge(cfg, tomllib.load(f))
    _merge(cfg, overrides)
    return cfg
