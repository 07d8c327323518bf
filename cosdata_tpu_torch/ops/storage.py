"""Device-resident u8 vector store (port of cosdata_tpu/ops/storage.py, u8).

The store is a handful of preallocated tensors on one device: centered
int8 codes, int32 code sums, f32 magnitudes, and the raw rows (f32 or f16)
for the exact rerank. Rows are written in place into the preallocated
tensors (the reference rebuilds its arrays functionally with
``dynamic_update_slice``), so an ingest holds no second copy of the store;
only growth allocates, by doubling.

Not ported: the wire-bandwidth probe and the wire formats it picks, the
host quantizer, the HBM budget and the spill tiers (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cosdata_tpu_torch.ops import distance as D
from cosdata_tpu_torch.ops import quantize as Q

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def as_rows(x, device) -> torch.Tensor:
    """A (B, D) f32 tensor on ``device`` from a numpy array, list or tensor."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x[None] if x.ndim == 1 else x


@dataclass
class VectorStore:
    """Growing store of u8-quantized vectors plus raw rows on ``device``."""

    dim: int
    device: str | torch.device
    kind: str = "u8"
    metric: str = "cosine"
    range: tuple[float, float] = (-1.0, 1.0)
    #: True = raw rows on the device (exact rerank); False = codes only
    keep_raw: bool = True
    #: dtype of the raw rows: "f16" halves their memory at ~1e-3 relative
    #: value error, which the exact rerank does not see; "f32" is exact
    raw_dtype: str = "f32"
    initial_capacity: int = 1024

    n: int = field(default=0, init=False)
    capacity: int = field(default=0, init=False)
    dim_pad: int = field(default=0, init=False)
    arrays: Q.QuantizedU8 = field(default=None, init=False)
    raw: torch.Tensor | None = field(default=None, init=False)

    def __post_init__(self):
        if self.kind != "u8":
            raise NotImplementedError(
                f"{self.kind!r} storage is not ported yet "
                "(ROADMAP queue 1: sub-byte with K2, then f16 and f32)"
            )
        if self.keep_raw not in (True, False):
            raise NotImplementedError(
                f"keep_raw={self.keep_raw!r}: host and disk raw tiers are not ported yet "
                "(ROADMAP queue 1: spill tiers)"
            )
        self.device = torch.device(self.device)
        self.dim_pad = _round_up(self.dim, _LANE)
        self.capacity = max(_round_up(self.initial_capacity, _LANE), _LANE)
        self.arrays = self._empty(self.capacity)
        if self.keep_raw:
            self.raw = torch.zeros(
                (self.capacity, self.dim_pad), dtype=self._raw_torch_dtype(), device=self.device
            )

    def _raw_torch_dtype(self) -> torch.dtype:
        return torch.float16 if self.raw_dtype == "f16" else torch.float32

    def device_nbytes(self) -> int:
        """Bytes of device-resident store state."""
        total = sum(t.numel() * t.element_size() for t in self.arrays)
        if self.raw is not None:
            total += self.raw.numel() * self.raw.element_size()
        return total

    def _empty(self, cap: int) -> Q.QuantizedU8:
        d = self.dim_pad
        lo, hi = self.range
        dev = self.device
        return Q.QuantizedU8(
            torch.zeros((cap, d), dtype=torch.int8, device=dev),
            torch.full((cap,), -d * 128, dtype=torch.int32, device=dev),  # all-zero-code rows
            torch.zeros((cap,), dtype=torch.float32, device=dev),
            # the store's scale is Python's double (hi - lo)/255 cast to f32;
            # a query's comes from quantize_u8 in f32 (reference parity)
            torch.tensor((hi - lo) / 255.0, dtype=torch.float32, device=dev),
            torch.tensor(lo, dtype=torch.float32, device=dev),
            torch.tensor(float(self.dim), dtype=torch.float32, device=dev),
        )

    def grow_to(self, cap: int) -> None:
        """Reallocate to ``cap`` rows (rounded to 128), keeping the rows."""
        cap = _round_up(cap, _LANE)
        old, n_old = self.arrays, self.capacity
        new = self._empty(cap)
        new.data[:n_old] = old.data
        new.sums[:n_old] = old.sums
        new.mags[:n_old] = old.mags
        self.arrays = new
        if self.raw is not None:
            raw = torch.zeros((cap, self.dim_pad), dtype=self.raw.dtype, device=self.device)
            raw[:n_old] = self.raw
            self.raw = raw
        self.capacity = cap

    # -- ingestion ----------------------------------------------------------

    def pad_dims(self, x, ship_f16: bool = False) -> torch.Tensor:
        """(B, dim) rows -> (B, dim_pad) f32 on the device; ``ship_f16`` rounds
        them through f16 first, as the reference's f16 query wire does."""
        x = as_rows(x, self.device)
        if x.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {x.shape[1]}")
        if self.dim_pad != self.dim:
            # quantize_u8 zeroes padded-lane codes and excludes them from
            # sums/magnitudes, so the pad value is irrelevant
            x = torch.nn.functional.pad(x, (0, self.dim_pad - self.dim))
        if ship_f16:
            x = x.to(torch.float16).to(torch.float32)
        return x

    def quantize(self, x: torch.Tensor) -> Q.QuantizedU8:
        return Q.quantize_u8(x, self.range[0], self.range[1], self.dim)

    #: rows quantized per step: bounds the f32 temporaries of an ingest
    ADD_CHUNK = 131072

    def add(self, x) -> np.ndarray:
        """Append rows; returns the assigned internal row ids."""
        x = as_rows(x, self.device)
        b = x.shape[0]
        if self.n + b > self.capacity:
            self.grow_to(max(self.capacity * 2, self.n + b))
        start = self.n
        for s in range(0, b, self.ADD_CHUNK):
            piece = self.pad_dims(x[s : s + self.ADD_CHUNK])
            qb = self.quantize(piece)
            rows = slice(self.n, self.n + piece.shape[0])
            self.arrays.data[rows] = qb.data
            self.arrays.sums[rows] = qb.sums
            self.arrays.mags[rows] = qb.mags
            if self.raw is not None:
                self.raw[rows] = piece.to(self.raw.dtype)
            self.n += piece.shape[0]
        return np.arange(start, self.n, dtype=np.int64)

    # -- queries ------------------------------------------------------------

    def quantize_queries(self, q) -> Q.QuantizedU8:
        return self.quantize(self.pad_dims(q))

    def ship_query_codes(self, x) -> Q.QuantizedU8:
        """Query codes quantized from the exact f32 queries, carrying the
        STORE's scale ``a`` (reference parity: ship_query_codes quantizes on
        the host and takes ``a`` from the store, mags from the f32 scale)."""
        return self.quantize_queries(x)._replace(a=self.arrays.a)

    def scores_all(self, q_quant: Q.QuantizedU8) -> torch.Tensor:
        """(Q, capacity) similarity scores; rows >= n are garbage (mask them)."""
        return D.score(self.metric, self.kind, q_quant, self.arrays, self.dim_pad)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n

    def rerank_scores(self, q_raw, ids: torch.Tensor) -> torch.Tensor:
        """Exact f32 scores of candidate ids (Q, K) vs raw queries (Q, D)."""
        if self.raw is None:
            raise RuntimeError("raw store disabled")
        return rerank(self.metric, self.pad_dims(q_raw), self.raw, ids)

    @classmethod
    def from_arrays(cls, arrays: dict, *, metric: str, device) -> VectorStore:
        """A store holding the reference store's state, given as numpy arrays
        (``data``, ``sums``, ``mags``, ``a``, ``b``, ``dtrue``, ``raw``, ``n``,
        ``capacity``, ``dim``, ``range``): the database's "weights"."""
        raw = arrays.get("raw")
        store = cls(
            dim=int(arrays["dim"]), device=device, metric=metric,
            range=tuple(float(v) for v in arrays["range"]),
            keep_raw=raw is not None,
            raw_dtype="f16" if raw is not None and raw.dtype == np.float16 else "f32",
            initial_capacity=int(arrays["capacity"]),
        )
        if store.capacity != int(arrays["capacity"]):
            raise ValueError(f"capacity {arrays['capacity']} is not a multiple of {_LANE}")

        def t(name, dtype):  # a copy: the store writes into its tensors in place
            return torch.tensor(np.array(arrays[name]), dtype=dtype, device=store.device)

        store.arrays = Q.QuantizedU8(
            t("data", torch.int8), t("sums", torch.int32), t("mags", torch.float32),
            t("a", torch.float32), t("b", torch.float32), t("dtrue", torch.float32),
        )
        if raw is not None:
            store.raw = t("raw", store.raw.dtype)
        store.n = int(arrays["n"])
        return store


def cos_or_dot(metric: str, dot, qmags, cmags):
    if metric == "dot":
        return dot
    if metric == "cosine":
        return D.safe_div(dot, qmags[:, None] * cmags)
    if metric == "euclidean":
        d2 = qmags[:, None] ** 2 + cmags**2 - 2.0 * dot
        return -torch.sqrt(torch.clamp_min(d2, 0.0))
    raise ValueError(metric)


def scores_gathered(metric: str, d: int, q: Q.QuantizedU8, store: Q.QuantizedU8, ids):
    """Per-query u8 candidate scores: ids (Q, K) -> (Q, K); negative ids
    are clamped to row 0 (callers mask them out)."""
    safe = torch.clamp_min(ids, 0)
    cc = D.diag_code_dot(q.data, store.data[safe])
    return cos_or_dot(metric, D.dequant_dot(q, cc, store.sums[safe], d), q.mags, store.mags[safe])


def exact_scores(metric: str, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of candidates ``cand`` (Q, K, D) against ``q`` (Q, D)."""
    dot = D.diag_dot(q, cand)
    qm = torch.linalg.vector_norm(q, dim=-1)
    cm = torch.linalg.vector_norm(cand, dim=-1)
    return cos_or_dot("euclidean" if metric == "hamming" else metric, dot, qm, cm)


def rerank(metric: str, q_raw: torch.Tensor, raw: torch.Tensor, ids: torch.Tensor):
    """Exact f32 scores of raw rows ``ids`` (Q, K) against ``q_raw`` (Q, D)."""
    # raw may be f16
    return exact_scores(metric, q_raw, raw[torch.clamp_min(ids, 0)].to(torch.float32))
