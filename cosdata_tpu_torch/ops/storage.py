"""Device-resident vector store (port of cosdata_tpu/ops/storage.py).

Four storage kinds, as in the reference:

- ``u8``      — centered int8 codes + row code sums + dequant scale/offset
- ``subbyte`` — packed bitplanes (resolution 1/2/3; aliases ``binary``,
  ``quaternary``/``quaternay``, ``octal``) + code sums
- ``f16``     — float16 rows + f32 magnitudes
- ``f32``     — float32 rows + f32 magnitudes

The store is a handful of preallocated tensors on one device, plus the raw
rows for the exact rerank. Rows are written in place into the preallocated
tensors (the reference rebuilds its arrays functionally with
``dynamic_update_slice``), so an ingest holds no second copy of the store;
only growth allocates, by doubling.

Tiers, as in the reference:

- raw rows (``keep_raw``): ``True`` on the device (f32 or f16), ``"host"``
  in a CPU tensor (pinned when the store's device is CUDA), ``"disk"`` in
  an ``np.memmap`` over a temporary ``cosdata_raw_*.f32`` file, ``False``
  none. Host and disk rows are reranked by gathering only the candidate
  rows and scoring them on the device (:meth:`VectorStore.rerank_scores_host`).
- codes: on the device, or spilled to host tensors (``codes_on_host``)
  when growth would pass the device budget (:func:`device_budget_bytes`)
  and the raw rows are not on the device; searches then stream them
  through the scan (``flat_scan.streamed_flat_topk``), and
  :meth:`VectorStore.maybe_promote_codes` moves them back once they fit.
  Rows added to a spilled store are quantized on the device and their
  codes copied to the host tier; their magnitudes are computed on the host
  as the reference's host tier computes them, so both packages hold the
  same bits.

Not ported: the wire-bandwidth probe and the wire formats it picks, and
the host quantizer (spilled rows are quantized on the card).
"""

from __future__ import annotations

import os
import tempfile
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


def device_budget_bytes(device) -> int | None:
    """Device-memory budget for store growth: ``COSDATA_HBM_GB`` pins it
    (the reference's operator setting, read under the same name), else a
    CUDA device's total memory; None (unenforced) on the CPU."""
    env = os.environ.get("COSDATA_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return None


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
    """Growing store of quantized vectors plus raw rows, on ``device`` or
    in the host tiers (module doc)."""

    dim: int
    device: str | torch.device
    kind: str = "u8"  # u8 | subbyte | f16 | f32 (or a sub-byte alias)
    metric: str = "cosine"
    resolution: int = 2  # for subbyte
    range: tuple[float, float] = (-1.0, 1.0)  # for u8
    #: where the raw rows for the exact rerank live: True = the device,
    #: "host" = a CPU tensor, "disk" = a memory-mapped temporary file,
    #: False = nowhere (codes only)
    keep_raw: bool | str = True
    #: dtype of device raw rows: "f16" halves their memory at ~1e-3 relative
    #: value error, which the exact rerank does not see; "f32" is exact.
    #: Host and disk rows are always f32, as in the reference
    raw_dtype: str = "f32"
    initial_capacity: int = 1024

    n: int = field(default=0, init=False)
    capacity: int = field(default=0, init=False)
    dim_pad: int = field(default=0, init=False)
    arrays: Q.QuantizedU8 | Q.QuantizedSubByte | Q.QuantizedFloat = field(default=None, init=False)
    raw: torch.Tensor | None = field(default=None, init=False)
    #: host or disk raw rows (capacity, dim_pad) f32 on the CPU; for "disk"
    #: a view of the memmap ``_raw_mm`` over the file ``_raw_path``
    raw_host: torch.Tensor | None = field(default=None, init=False)
    _raw_mm: np.memmap | None = field(default=None, init=False, repr=False)
    _raw_path: str | None = field(default=None, init=False, repr=False)
    #: the quantized codes, sums and magnitudes live in host tensors (the
    #: spill tier); the dequantization scalars stay on the device
    codes_on_host: bool = field(default=False, init=False)
    #: pinned staging buffer of :meth:`upload_rows` and the event of its
    #: last copy to the device
    _staging: torch.Tensor | None = field(default=None, init=False, repr=False)
    _staging_done: object = field(default=None, init=False, repr=False)
    #: row-chunk dirty epochs (one row space for all store arrays), so a
    #: snapshot rewrites only the chunks that ``add`` touched
    tracker: DirtyTracker = field(default_factory=DirtyTracker, init=False)

    def __post_init__(self):
        if self.kind in SUBBYTE_ALIAS:
            self.resolution = SUBBYTE_ALIAS[self.kind]
            self.kind = "subbyte"
        if self.kind not in ("u8", "subbyte", "f16", "f32"):
            raise ValueError(f"unknown storage kind {self.kind!r}")
        if self.keep_raw not in (True, False, "host", "disk"):
            raise ValueError(f"keep_raw must be True, False, 'host' or 'disk', not {self.keep_raw!r}")
        self.device = torch.device(self.device)
        self.dim_pad = _round_up(self.dim, _LANE)
        self.capacity = max(_round_up(self.initial_capacity, _LANE), _LANE)
        self.arrays = self._empty(self.capacity)
        if self.keep_raw is True:
            self.raw = torch.zeros(
                (self.capacity, self.dim_pad), dtype=self._raw_torch_dtype(), device=self.device
            )
        elif self.raw_on_host:
            self._new_raw_host(self.capacity)

    @property
    def score_kind(self) -> str:
        """The kind ``distance.score`` dispatches on: f16/f32 are "float"."""
        return "float" if self.kind in ("f16", "f32") else self.kind

    @property
    def raw_on_host(self) -> bool:
        """Raw rows live on the host (RAM or a disk-backed memmap)."""
        return self.keep_raw in ("host", "disk")

    @property
    def _pin(self) -> bool:
        """Host tensors are pinned for a CUDA store (the CPU cannot pin)."""
        return self.device.type == "cuda"

    def _raw_torch_dtype(self) -> torch.dtype:
        return torch.float16 if self.raw_dtype == "f16" else torch.float32

    # -- device-memory accounting ------------------------------------------

    def device_nbytes(self, cap: int | None = None) -> int:
        """Bytes of device-resident store state at capacity ``cap`` (the
        reference's count: codes, sums and magnitudes, device raw rows)."""
        cap = self.capacity if cap is None else cap
        d = self.dim_pad
        if self.codes_on_host:
            total = 0
        elif self.kind == "u8":
            total = cap * d + 8 * cap
        elif self.kind == "subbyte":
            total = self.resolution * cap * (d // 32) * 4 + 8 * cap
        elif self.kind == "f16":
            total = cap * d * 2 + 4 * cap
        else:
            total = cap * d * 4 + 4 * cap
        if self.keep_raw is True and not self.codes_on_host:
            total += cap * d * (2 if self.raw_dtype == "f16" else 4)
        return total

    # -- allocation ---------------------------------------------------------

    def _empty(self, cap: int, host: bool = False):
        """Empty quantized arrays of ``cap`` rows: on the device, or with
        ``host`` in (pinned) host tensors; the scalars stay on the device."""
        d = self.dim_pad
        dev = self.device
        rows = {"device": torch.device("cpu"), "pin_memory": self._pin} if host else {"device": dev}
        if self.kind == "subbyte":
            step = 2.0 / (1 << self.resolution)
            return Q.QuantizedSubByte(
                torch.zeros((self.resolution, cap, d // 32), dtype=torch.int32, **rows),
                torch.zeros((cap,), dtype=torch.int32, **rows),
                torch.zeros((cap,), dtype=torch.float32, **rows),
                torch.tensor(step, dtype=torch.float32, device=dev),
                torch.tensor(step / 2.0 - 1.0, dtype=torch.float32, device=dev),
                torch.tensor(float(self.dim), dtype=torch.float32, device=dev),
            )
        if self.kind in ("f16", "f32"):
            dt = torch.float16 if self.kind == "f16" else torch.float32
            return Q.QuantizedFloat(
                torch.zeros((cap, d), dtype=dt, **rows),
                torch.zeros((cap,), dtype=torch.float32, **rows),
            )
        lo, hi = self.range
        return Q.QuantizedU8(
            torch.zeros((cap, d), dtype=torch.int8, **rows),
            torch.full((cap,), -d * 128, dtype=torch.int32, **rows),  # all-zero-code rows
            torch.zeros((cap,), dtype=torch.float32, **rows),
            # the store's scale is Python's double (hi - lo)/255 cast to f32;
            # a query's comes from quantize_u8 in f32 (reference parity)
            torch.tensor((hi - lo) / 255.0, dtype=torch.float32, device=dev),
            torch.tensor(lo, dtype=torch.float32, device=dev),
            torch.tensor(float(self.dim), dtype=torch.float32, device=dev),
        )

    def _new_raw_host(self, cap: int) -> None:
        """Allocate empty host or disk raw rows of ``cap`` rows. A disk tier
        gets a fresh ``cosdata_raw_*.f32`` memmap in the temporary directory."""
        shape = (cap, self.dim_pad)
        if self.keep_raw == "disk":
            with tempfile.NamedTemporaryFile(prefix="cosdata_raw_", suffix=".f32", delete=False) as f:
                self._raw_path = f.name
            self._raw_mm = np.memmap(self._raw_path, dtype=np.float32, mode="w+", shape=shape)
            self.raw_host = torch.from_numpy(self._raw_mm)
        else:
            self.raw_host = torch.zeros(shape, dtype=torch.float32, pin_memory=self._pin)

    def close(self) -> None:
        """Delete a disk tier's file (the store is not used after)."""
        if self._raw_path is not None:
            self.raw_host = self._raw_mm = None
            os.unlink(self._raw_path)
            self._raw_path = None

    def _spillable(self) -> bool:
        """Codes can move to the host tier: u8 codes or sub-byte planes whose
        raw rows are NOT on the device (device raw rows must stay resident
        anyway, so growth past the budget fails loudly instead)."""
        return self.kind in ("u8", "subbyte") and self.keep_raw is not True

    def _move_codes(self, host: bool) -> None:
        """Copy the codes, sums and magnitudes into fresh host (pinned) or
        device tensors: ``host=True`` spills them (searches stream them
        through the scan; graph engines turn scan-only, or keep their
        level-0 adjacency with ``HNSWIndex.force_spill(keep_graph=True)``),
        ``host=False`` promotes them."""
        new = self._empty(self.capacity, host=host)
        _write_rows(new, self.arrays, 0)
        self.arrays = new
        self.codes_on_host = host

    def maybe_promote_codes(self) -> bool:
        """Move spilled codes back to the device once the budget fits again
        (compaction shrank the store, or ``COSDATA_HBM_GB`` was raised or
        unset). Returns True when they moved."""
        if not self.codes_on_host:
            return False
        budget = device_budget_bytes(self.device)
        # device_nbytes counts the codes only while they are on the device
        self.codes_on_host = False
        fits = budget is None or self.device_nbytes() <= budget
        self.codes_on_host = True
        if fits:
            self._move_codes(host=False)
        return fits

    def grow_to(self, cap: int) -> None:
        """Reallocate to ``cap`` rows (rounded to 128), keeping the rows.
        Growth past the device budget spills the codes to the host tier
        when the store is spillable, and raises otherwise."""
        cap = _round_up(cap, _LANE)
        budget = device_budget_bytes(self.device)
        if budget is not None and not self.codes_on_host and self.device_nbytes(cap) > budget:
            if not self._spillable():
                raise RuntimeError(
                    f"growing the store to {cap} rows needs ~{self.device_nbytes(cap) / (1 << 30):.1f} GiB "
                    f"of device memory (budget {budget / (1 << 30):.1f} GiB; COSDATA_HBM_GB overrides). "
                    "Use raw_storage='host' or 'disk' (frees the raw f32 rows and lets u8 and sub-byte "
                    "codes spill to the host-streamed tier)."
                )
            self._move_codes(host=True)
        n_old = self.capacity
        new = self._empty(cap, host=self.codes_on_host)
        _write_rows(new, self.arrays, 0)
        self.arrays = new
        if self.raw is not None:
            raw = torch.zeros((cap, self.dim_pad), dtype=self.raw.dtype, device=self.device)
            raw[:n_old] = self.raw
            self.raw = raw
        elif self.raw_on_host:
            old_raw, old_path = self.raw_host, self._raw_path
            self._new_raw_host(cap)
            self.raw_host[:n_old] = old_raw
            del old_raw
            if self.keep_raw == "disk":
                self._raw_mm.flush()
                os.unlink(old_path)
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

    def _host_mags(self, codes: np.ndarray) -> np.ndarray:
        """Magnitudes of quantized rows (u8 centered int8 codes, or sub-byte
        bucket codes in dimension order), computed in numpy exactly as the
        reference's host tier computes them."""
        if self.kind == "u8":
            lo, hi = self.range
            aa = (np.float32(hi) - np.float32(lo)) / np.float32(255.0)
            deq = aa * (codes.astype(np.float32) + 128.0) + np.float32(lo)
        else:
            step = np.float32(2.0 / (1 << self.resolution))
            deq = step * codes.astype(np.float32) + np.float32(step / 2.0 - 1.0)
        deq[:, self.dim :] = 0.0
        return np.sqrt((deq * deq).sum(axis=1))

    def _to_host_tier(self, batch):
        """A batch quantized on the device, as host-tier rows: the codes and
        sums copied, the magnitudes recomputed by :meth:`_host_mags`."""
        if self.kind == "u8":
            data = batch.data.cpu()
            return batch._replace(data=data, sums=batch.sums.cpu(),
                                  mags=torch.from_numpy(self._host_mags(data.numpy())))
        codes = Q.subbyte_values(batch.planes, self.dim_pad).cpu().numpy()
        return batch._replace(planes=batch.planes.cpu(), sums=batch.sums.cpu(),
                              mags=torch.from_numpy(self._host_mags(codes)))

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
            batch = self.quantize(piece)
            if self.codes_on_host:
                batch = self._to_host_tier(batch)
            _write_rows(self.arrays, batch, self.n)
            rows = slice(self.n, self.n + piece.shape[0])
            if self.raw is not None:
                self.raw[rows] = piece.to(self.raw.dtype)
            elif self.raw_host is not None:
                self.raw_host[rows] = piece.cpu()
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

    def upload_rows(self, tables: list[torch.Tensor], ids: torch.Tensor) -> list[torch.Tensor]:
        """``table[ids]`` of each host table (ids a 1-D CPU int64 tensor) as
        tensors on the device. A CUDA store gathers the rows into one pinned
        staging buffer and copies them without blocking; the buffer is
        rewritten only after that copy has finished, so a later call can
        never overwrite rows still in flight."""
        if not self._pin:
            return [torch.index_select(t, 0, ids).to(self.device) for t in tables]
        n = ids.numel()
        sizes = [n * t[0].numel() * t.element_size() for t in tables]
        offs = np.cumsum([0] + [_round_up(sz, 256) for sz in sizes])
        if self._staging_done is not None:
            self._staging_done.synchronize()
        if self._staging is None or self._staging.numel() < offs[-1]:
            self._staging = torch.empty(max(int(offs[-1]), 1 << 20) * 2, dtype=torch.uint8, pin_memory=True)
            self._staging_done = torch.cuda.Event()
        out = []
        for t, off, sz in zip(tables, offs, sizes):
            stage = self._staging[off : off + sz].view(t.dtype).view(n, *t.shape[1:])
            torch.index_select(t, 0, ids, out=stage)
            out.append(stage.to(self.device, non_blocking=True))
        # the copies ran on the store's device's stream, whichever device is current
        self._staging_done.record(torch.cuda.current_stream(self.device))
        return out

    def raw_rows(self, rows) -> torch.Tensor:
        """The raw rows ``rows`` (f32, unpadded) as a tensor on the store's
        device (the reference returns host arrays)."""
        rows = torch.as_tensor(np.asarray(rows, np.int64))
        if self.raw_host is not None:
            return self.upload_rows([self.raw_host], rows)[0][:, : self.dim]
        if self.raw is None:
            raise RuntimeError("raw store disabled")
        return self.raw[rows.to(self.device), : self.dim].to(torch.float32)

    def rerank_scores(self, q_raw, ids: torch.Tensor) -> torch.Tensor:
        """Exact f32 scores of candidate ids (Q, K) vs raw queries (Q, D)."""
        if self.raw is None:
            raise RuntimeError("raw store disabled")
        return rerank(self.metric, self.pad_dims(q_raw), self.raw, ids)

    def rerank_scores_host(self, q_raw, ids: np.ndarray) -> np.ndarray:
        """Exact f32 scores (Q, K) of host or disk raw rows ``ids`` (negative
        ids score row 0; callers mask them) against raw queries (Q, D): the
        candidate rows alone are gathered on the host (a memmap reads only
        those), uploaded and scored on the device."""
        if self.raw_host is None:
            raise RuntimeError("host raw store disabled")
        ids = np.asarray(ids, np.int64)
        safe = torch.from_numpy(np.maximum(ids, 0).reshape(-1))
        (cand,) = self.upload_rows([self.raw_host], safe)
        q = self.pad_dims(q_raw)
        return exact_scores(self.metric, q, cand.view(*ids.shape, self.dim_pad)).cpu().numpy()

    def rerank_host_topk(self, q_raw, ids: np.ndarray, top_k: int) -> tuple[np.ndarray, np.ndarray]:
        """Rerank a (Q, K) shortlist of ids (-1 padded) against the host raw
        rows and keep the top_k, in the reference's stable order."""
        re = np.where(ids >= 0, self.rerank_scores_host(q_raw, ids), -np.inf)
        order = np.argsort(-re, axis=1, kind="stable")[:, :top_k]
        return (np.take_along_axis(ids, order, axis=1),
                np.take_along_axis(re, order, axis=1).astype(np.float32))

    @classmethod
    def from_arrays(cls, arrays: dict, *, metric: str, device) -> VectorStore:
        """A store holding the reference store's state, given as numpy arrays:
        the database's "weights". Keys: ``n``, ``capacity``, ``dim``, ``raw``
        (optional; or ``raw_host`` with ``keep_raw`` "host" (the default) or
        "disk"), ``codes_on_host`` (optional), ``range`` (u8), and the
        quantized arrays of one kind: u8 ``data`` (int8) / ``sums`` / ``mags``
        / ``a`` / ``b`` / ``dtrue``; sub-byte ``planes`` (uint32) / ``sums`` /
        ``mags`` / ``a`` / ``b`` / ``dtrue``; float ``data`` (f16 or f32) /
        ``mags``."""
        raw = arrays.get("raw")
        if "planes" in arrays:
            kind, resolution = "subbyte", int(arrays["planes"].shape[0])
        else:
            kind = {np.dtype(np.float16): "f16", np.dtype(np.float32): "f32"}.get(
                np.asarray(arrays["data"]).dtype, "u8"
            )
            resolution = 2
        if raw is not None:
            keep_raw = True
        elif arrays.get("raw_host") is not None:
            keep_raw = arrays.get("keep_raw", "host")
        else:
            keep_raw = False
        store = cls(
            dim=int(arrays["dim"]), device=device, kind=kind, metric=metric, resolution=resolution,
            range=tuple(float(v) for v in arrays.get("range", (-1.0, 1.0))),
            keep_raw=keep_raw,
            raw_dtype="f16" if raw is not None and raw.dtype == np.float16 else "f32",
            initial_capacity=int(arrays["capacity"]),
        )
        if store.capacity != int(arrays["capacity"]):
            raise ValueError(f"capacity {arrays['capacity']} is not a multiple of {_LANE}")
        host = bool(arrays.get("codes_on_host", False))

        def t(name, dtype, rows=False):  # a copy: the store writes into its tensors in place
            if name == "planes":  # int32 tensors holding the uint32 words' bits
                out = torch.from_numpy(np.array(arrays[name], dtype=np.uint32).view(np.int32))
            else:
                out = torch.tensor(np.array(arrays[name]), dtype=dtype)
            if rows and host:
                return out.pin_memory() if store._pin else out
            return out.to(store.device)

        f32 = torch.float32
        if kind == "subbyte":
            store.arrays = Q.QuantizedSubByte(
                t("planes", torch.int32, True), t("sums", torch.int32, True), t("mags", f32, True),
                t("a", f32), t("b", f32), t("dtrue", f32),
            )
        elif kind == "u8":
            store.arrays = Q.QuantizedU8(
                t("data", torch.int8, True), t("sums", torch.int32, True), t("mags", f32, True),
                t("a", f32), t("b", f32), t("dtrue", f32),
            )
        else:
            store.arrays = Q.QuantizedFloat(t("data", store.arrays.data.dtype), t("mags", f32))
        store.codes_on_host = host
        if raw is not None:
            store.raw = t("raw", store.raw.dtype)
        elif store.raw_host is not None:
            store.raw_host[:] = torch.from_numpy(np.asarray(arrays["raw_host"], np.float32))
        store.n = int(arrays["n"])
        return store


def cos_or_dot(metric: str, dot, qmags, cmags):
    if metric == "dot":
        return dot
    if metric == "cosine":
        return D.safe_div(dot, qmags[:, None] * cmags)
    if metric == "euclidean":
        d2 = qmags[:, None] ** 2 + cmags**2 - 2.0 * dot
        return -D.sqrt_rn(torch.clamp_min(d2, 0.0))
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
