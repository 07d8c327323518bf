"""Device-resident vector store (port of cosdata_tpu/ops/storage.py).

Four storage kinds, as in the reference:

- ``u8``      — centered int8 codes + row code sums + dequant scale/offset
- ``subbyte`` — packed bitplanes (resolution 1/2/3; aliases ``binary``,
  ``quaternary``/``quaternay``, ``octal``) + code sums
- ``f16``     — float16 rows + f32 magnitudes
- ``f32``     — float32 rows + f32 magnitudes

The store is a handful of preallocated tensors on one device, plus the raw
rows (f32 or f16) for the exact rerank. Rows are written in place into
the preallocated tensors (the reference rebuilds its arrays functionally with
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
from cosdata_tpu_torch.ops.kernels.subbyte_scan import word_major_codes
from cosdata_tpu_torch.store.chunked import DirtyTracker

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def as_rows(x, device) -> torch.Tensor:
    """A (B, D) f32 tensor on ``device`` from a numpy array, list or tensor."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x[None] if x.ndim == 1 else x


#: the REST vocabulary's sub-byte data types (with its "quaternay" spelling)
SUBBYTE_ALIAS = {"binary": 1, "quaternary": 2, "quaternay": 2, "octal": 3}


def quantize_batch(x: torch.Tensor, lo, hi, kind: str, resolution: int, d_true: int):
    """Quantize lane-padded f32 rows for a store of ``kind``."""
    if kind == "u8":
        return Q.quantize_u8(x, lo, hi, d_true)
    if kind == "subbyte":
        return Q.quantize_subbyte(x, resolution, d_true)
    if kind == "f16":
        return Q.quantize_f16(x)
    return Q.quantize_f32(x)


def _write_rows(store, batch, offset: int) -> None:
    """Write a quantized batch into the store's tensors at row ``offset``,
    in place (the reference's functional ``_write_rows``)."""
    n = batch.mags.shape[0]
    if isinstance(store, Q.QuantizedSubByte):
        store.planes[:, offset : offset + n] = batch.planes
    else:
        store.data[offset : offset + n] = batch.data
    if not isinstance(store, Q.QuantizedFloat):
        store.sums[offset : offset + n] = batch.sums
    store.mags[offset : offset + n] = batch.mags


@dataclass
class VectorStore:
    """Growing store of quantized vectors plus raw rows on ``device``."""

    dim: int
    device: str | torch.device
    kind: str = "u8"  # u8 | subbyte | f16 | f32 (or a sub-byte alias)
    metric: str = "cosine"
    resolution: int = 2  # for subbyte
    range: tuple[float, float] = (-1.0, 1.0)  # for u8
    #: True = raw rows on the device (exact rerank); False = codes only
    keep_raw: bool = True
    #: dtype of the raw rows: "f16" halves their memory at ~1e-3 relative
    #: value error, which the exact rerank does not see; "f32" is exact
    raw_dtype: str = "f32"
    initial_capacity: int = 1024

    n: int = field(default=0, init=False)
    capacity: int = field(default=0, init=False)
    dim_pad: int = field(default=0, init=False)
    arrays: Q.QuantizedU8 | Q.QuantizedSubByte | Q.QuantizedFloat = field(default=None, init=False)
    raw: torch.Tensor | None = field(default=None, init=False)
    #: row-chunk dirty epochs (one row space for all store arrays), so a
    #: snapshot rewrites only the chunks that ``add`` touched
    tracker: DirtyTracker = field(default_factory=DirtyTracker, init=False)

    def __post_init__(self):
        if self.kind in SUBBYTE_ALIAS:
            self.resolution = SUBBYTE_ALIAS[self.kind]
            self.kind = "subbyte"
        if self.kind not in ("u8", "subbyte", "f16", "f32"):
            raise ValueError(f"unknown storage kind {self.kind!r}")
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

    @property
    def score_kind(self) -> str:
        """The kind ``distance.score`` dispatches on: f16/f32 are "float"."""
        return "float" if self.kind in ("f16", "f32") else self.kind

    def _raw_torch_dtype(self) -> torch.dtype:
        return torch.float16 if self.raw_dtype == "f16" else torch.float32

    def device_nbytes(self) -> int:
        """Bytes of device-resident store state."""
        total = sum(t.numel() * t.element_size() for t in self.arrays)
        if self.raw is not None:
            total += self.raw.numel() * self.raw.element_size()
        return total

    def _empty(self, cap: int):
        d = self.dim_pad
        dev = self.device
        if self.kind == "subbyte":
            step = 2.0 / (1 << self.resolution)
            return Q.QuantizedSubByte(
                torch.zeros((self.resolution, cap, d // 32), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.float32, device=dev),
                torch.tensor(step, dtype=torch.float32, device=dev),
                torch.tensor(step / 2.0 - 1.0, dtype=torch.float32, device=dev),
                torch.tensor(float(self.dim), dtype=torch.float32, device=dev),
            )
        if self.kind in ("f16", "f32"):
            dt = torch.float16 if self.kind == "f16" else torch.float32
            return Q.QuantizedFloat(
                torch.zeros((cap, d), dtype=dt, device=dev),
                torch.zeros((cap,), dtype=torch.float32, device=dev),
            )
        lo, hi = self.range
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
        _write_rows(new, old, 0)
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
            # padded lanes are zeros: the quantizers give them code 0 and
            # leave them out of sums/magnitudes, and float rows stay exact
            x = torch.nn.functional.pad(x, (0, self.dim_pad - self.dim))
        if ship_f16:
            x = x.to(torch.float16).to(torch.float32)
        return x

    def quantize(self, x: torch.Tensor):
        return quantize_batch(x, self.range[0], self.range[1], self.kind, self.resolution, self.dim)

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
            _write_rows(self.arrays, self.quantize(piece), self.n)
            if self.raw is not None:
                self.raw[self.n : self.n + piece.shape[0]] = piece.to(self.raw.dtype)
            self.n += piece.shape[0]
        self.tracker.bump()
        self.tracker.mark_range("rows", start, self.n)
        return np.arange(start, self.n, dtype=np.int64)

    # -- queries ------------------------------------------------------------

    def quantize_queries(self, q):
        return self.quantize(self.pad_dims(q))

    def ship_queries(self, x) -> torch.Tensor:
        """The exact f32 query rows, padded (the reference's choice on a fast
        link; the port has no wire)."""
        return self.pad_dims(x)

    def ship_query_codes(self, x) -> Q.QuantizedU8:
        """Query codes quantized from the exact f32 queries, carrying the
        STORE's scale ``a`` (reference parity: ship_query_codes quantizes on
        the host and takes ``a`` from the store, mags from the f32 scale)."""
        return self.quantize_queries(x)._replace(a=self.arrays.a)

    def gather_as_queries(self, ids: torch.Tensor):
        """Stored rows ``ids`` as a quantized query batch (wave self-joins)."""
        return gather_queries(self.kind, self.arrays, ids)

    def scores_all(self, q_quant) -> torch.Tensor:
        """(Q, capacity) similarity scores; rows >= n are garbage (mask them)."""
        return D.score(self.metric, self.score_kind, q_quant, self.arrays, self.dim_pad)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n

    def raw_rows(self, rows) -> torch.Tensor:
        """The raw rows ``rows`` (f32, unpadded) as a tensor on the store's
        device (the reference returns host arrays)."""
        if self.raw is None:
            raise RuntimeError("raw store disabled")
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self.raw[rows, : self.dim].to(torch.float32)

    def rerank_scores(self, q_raw, ids: torch.Tensor) -> torch.Tensor:
        """Exact f32 scores of candidate ids (Q, K) vs raw queries (Q, D)."""
        if self.raw is None:
            raise RuntimeError("raw store disabled")
        return rerank(self.metric, self.pad_dims(q_raw), self.raw, ids)

    @classmethod
    def from_arrays(cls, arrays: dict, *, metric: str, device) -> VectorStore:
        """A store holding the reference store's state, given as numpy arrays:
        the database's "weights". Keys: ``n``, ``capacity``, ``dim``, ``raw``
        (optional), ``range`` (u8), and the quantized arrays of one kind: u8
        ``data`` (int8) / ``sums`` / ``mags`` / ``a`` / ``b`` / ``dtrue``;
        sub-byte ``planes`` (uint32) / ``sums`` / ``mags`` / ``a`` / ``b`` /
        ``dtrue``; float ``data`` (f16 or f32) / ``mags``."""
        raw = arrays.get("raw")
        if "planes" in arrays:
            kind, resolution = "subbyte", int(arrays["planes"].shape[0])
        else:
            kind = {np.dtype(np.float16): "f16", np.dtype(np.float32): "f32"}.get(
                np.asarray(arrays["data"]).dtype, "u8"
            )
            resolution = 2
        store = cls(
            dim=int(arrays["dim"]), device=device, kind=kind, metric=metric, resolution=resolution,
            range=tuple(float(v) for v in arrays.get("range", (-1.0, 1.0))),
            keep_raw=raw is not None,
            raw_dtype="f16" if raw is not None and raw.dtype == np.float16 else "f32",
            initial_capacity=int(arrays["capacity"]),
        )
        if store.capacity != int(arrays["capacity"]):
            raise ValueError(f"capacity {arrays['capacity']} is not a multiple of {_LANE}")

        def t(name, dtype):  # a copy: the store writes into its tensors in place
            return torch.tensor(np.array(arrays[name]), dtype=dtype, device=store.device)

        f32 = torch.float32
        if kind == "subbyte":
            # int32 tensors holding the uint32 words' bits
            planes = np.array(arrays["planes"], dtype=np.uint32).view(np.int32)
            store.arrays = Q.QuantizedSubByte(
                torch.from_numpy(planes).to(store.device), t("sums", torch.int32),
                t("mags", f32), t("a", f32), t("b", f32), t("dtrue", f32),
            )
        elif kind == "u8":
            store.arrays = Q.QuantizedU8(
                t("data", torch.int8), t("sums", torch.int32), t("mags", f32),
                t("a", f32), t("b", f32), t("dtrue", f32),
            )
        else:
            store.arrays = Q.QuantizedFloat(t("data", store.arrays.data.dtype), t("mags", f32))
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


def gather_queries(kind: str, store, ids: torch.Tensor):
    """Rows ``ids`` of a quantized store as a query batch of the same type
    (``kind`` is the store's; f16/f32 rows stay in their dtype)."""
    if kind == "subbyte":
        return store._replace(planes=store.planes[:, ids], sums=store.sums[ids], mags=store.mags[ids])
    if kind == "u8":
        return store._replace(data=store.data[ids], sums=store.sums[ids], mags=store.mags[ids])
    return store._replace(data=store.data[ids], mags=store.mags[ids])


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids (any shape, >= 0) by one ``index_select``,
    which the CPU runs an order of magnitude faster than advanced indexing
    for short rows."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, *table.shape[1:])


def word_major_rows(planes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bucket codes of the rows ``ids`` (any shape, >= 0) of (res, N, W)
    planes as (*ids.shape, 32·W) int8 in the WORD-MAJOR order of
    ``subbyte_scan.word_major_codes``. A code dot of two sides unpacked
    this way equals the one in dimension order (the padding lanes are 0 on
    both), and the unpack needs no transposing copy."""
    rows = torch.index_select(planes, 1, ids.reshape(-1))
    return word_major_codes(rows).reshape(*ids.shape, 32 * planes.shape[2])


def scores_gathered(metric: str, kind: str, d: int, q, store, ids: torch.Tensor):
    """Per-query candidate scores: ids (Q, K) -> (Q, K), ``kind`` in
    {"u8", "subbyte", "float"}; negative ids are clamped to row 0 (callers
    mask them out). The code products are exact (``distance.diag_code_dot``;
    sub-byte codes on both sides in :func:`word_major_rows`' order)."""
    safe = torch.clamp_min(ids, 0)
    cmags = take_rows(store.mags, safe)
    if kind == "u8":
        cc = D.diag_code_dot(q.data, take_rows(store.data, safe))
        return cos_or_dot(metric, D.dequant_dot(q, cc, take_rows(store.sums, safe), d), q.mags, cmags)
    if kind == "subbyte":
        qvals = word_major_codes(q.planes)
        code_dot = D.diag_code_dot(qvals, word_major_rows(store.planes, safe)).to(torch.float32)
        csums = take_rows(store.sums, safe).to(torch.float32)
        dot = (
            q.a * q.a * code_dot
            + q.a * q.b * (q.sums.to(torch.float32)[:, None] + csums)
            + q.b * q.b * q.dtrue
        )
        return cos_or_dot(metric, dot, q.mags, cmags)
    dot = D.diag_dot(q.data.to(torch.float32), take_rows(store.data, safe).to(torch.float32))
    return cos_or_dot(metric, dot, q.mags, cmags)


def score_table(metric: str, kind: str, d: int, q, store) -> torch.Tensor:
    """(Q, capacity) scores of the queries against every stored row; rows
    past ``n`` are garbage. u8 and sub-byte code products are exact, so
    they equal :func:`scores_gathered`'s; f16/f32 products may differ from
    them in the f32 summation order."""
    if kind == "u8":
        cc = D.code_matmul(q.data, store.data)
        return cos_or_dot(metric, D.dequant_dot(q, cc, store.sums[None, :], d), q.mags, store.mags[None, :])
    if kind == "subbyte":
        code_dot = D.code_matmul(word_major_codes(q.planes), word_major_codes(store.planes))
        dot = (
            q.a * q.a * code_dot.to(torch.float32)
            + q.a * q.b * (q.sums.to(torch.float32)[:, None] + store.sums.to(torch.float32)[None, :])
            + q.b * q.b * q.dtrue
        )
        return cos_or_dot(metric, dot, q.mags, store.mags[None, :])
    if q.data.device.type == "cuda":
        D._no_tf32()
    dot = torch.mm(q.data.to(torch.float32), store.data.to(torch.float32).T)
    return cos_or_dot(metric, dot, q.mags, store.mags[None, :])


def exact_scores(metric: str, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of candidates ``cand`` (Q, K, D) against ``q`` (Q, D)."""
    dot = D.diag_dot(q, cand)
    qm = torch.linalg.vector_norm(q, dim=-1)
    cm = torch.linalg.vector_norm(cand, dim=-1)
    return cos_or_dot("euclidean" if metric == "hamming" else metric, dot, qm, cm)


def rerank(metric: str, q_raw: torch.Tensor, raw: torch.Tensor, ids: torch.Tensor):
    """Exact f32 scores of raw rows ``ids`` (Q, K) against ``q_raw`` (Q, D)."""
    # raw may be f16
    return exact_scores(metric, q_raw, take_rows(raw, torch.clamp_min(ids, 0)).to(torch.float32))
