"""u8 scan with fused dequantization epilogue and per-bin max (kernel K1).

Port of cosdata_tpu/ops/pallas/u8_scan.py. The CUDA kernel lives in
``cosdata_tpu_torch/csrc/u8_bin_max.cu``; it is compiled by ``nvcc`` for
``sm_90a`` at first use into ``cosdata_tpu_torch/build/`` and loaded with
ctypes (ops/kernels/nvcc.py). Beside it sits the plain PyTorch version of
the same function.
:func:`u8_bin_max` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises.

Bins are CONTIGUOUS: bin j of query i is the max over store rows
j*group .. j*group+group-1, and the output is (B, C/group) f32.

Math (ops/distance.dot_u8): with centered codes cc = Σ q_i v_i,
  dot = a²·cc + k1·(sq + sv) + k0,
  k1 = 128a² + ab,  k0 = a²·D_pad·128² + 2ab·128·D_pad + b²·d_true
folded into a per-query additive term (k1·sq + k0) and a per-row additive
term (k1·sv); cosine multiplies by reciprocal magnitudes; invalid rows get
reciprocal 0 plus a -3e38 sink.

Euclidean keeps the reference's own op order (``distance.euclidean_u8``),
so its bins are the reference's scores maxed, bit for bit: the integer
code dot ``cc + 128·(sq + sv) + D_pad·128²``, then
``dot = a²·code_dot + ab·(uq + uv) + b²·d_true`` with ``u = s + 128·D_pad``,
``d2 = (|q|² + |v|²) − 2·dot`` and ``−sqrt(max(d2, 0))``. Its terms
(:class:`EuclideanTerms`) come in the types its epilogue needs: the code
dot's query part ``128·sq + D_pad·128²`` and row part ``128·sv`` in
int32, ``uq``, ``uv`` and the squared magnitudes in f32, ``+inf`` for an
invalid row's, so a score costs the kernel one int → float conversion
(``csrc/u8_euclidean.cuh`` states why each is exact). Hamming has no bin
kernel: its XOR popcount is not this product's epilogue.

The kernel computes a tile's two 128-row halves into accumulators of
their own, so that each half's epilogue runs while the next half's codes
load (the header of ``csrc/u8_bin_max.cu``). On an NVIDIA H100 80GB HBM3
at 700 W, back to back at B=1024, C=1,048,576, Dp=768: cosine 1.37-1.38
ms, euclidean 1.54 (it took 2.22-2.27 with its earlier terms and
schedule), 0.29 at B=128 (``PERF.md``, section 6).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cosdata_tpu_torch.ops.distance import code_bmm, sqrt_rn
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.quantize import QuantizedU8

LIBRARY = CudaLibrary(
    "u8_bin_max",
    {"launch": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_void_p]},
)
#: the kernel's bin width (one warp) and its Dp granularity
KERNEL_GROUP = 32
KERNEL_DP_MULTIPLE = 128
_METRIC_CODE = {"cosine": 0, "dot": 1, "euclidean": 2}
#: the sink of an invalid row (the kernel's kSink)
SINK = -3.0e38


class BinMaxTerms(NamedTuple):
    """Cosine's and dot's kernel inputs: query and row terms folded from
    QuantizedU8."""

    q_codes: torch.Tensor  # (B, Dp) int8
    q_add: torch.Tensor  # (B,) f32: k1*sq + k0
    q_inv: torch.Tensor  # (B,) f32: 1/max(qmag, eps) (cosine) or 1
    codes: torch.Tensor  # (C, Dp) int8
    v_add: torch.Tensor  # (C,) f32: k1*sv
    v_inv: torch.Tensor  # (C,) f32: valid/max(vmag, eps) (cosine) or valid
    v_sink: torch.Tensor  # (C,) f32: 0 on valid rows, SINK on invalid
    consts: torch.Tensor  # (3,) f32: a², a·b, b²·d_true

    def kernel_terms(self) -> tuple[tuple, tuple]:
        """The query's and the row's three terms in the kernel's order."""
        return (self.q_add, self.q_inv, None), (self.v_add, self.v_inv, self.v_sink)


class EuclideanTerms(NamedTuple):
    """Euclidean's kernel inputs, in the types its epilogue needs
    (``csrc/u8_euclidean.cuh``): sq, sv are the code sums."""

    q_codes: torch.Tensor  # (B, Dp) int8
    q_code: torch.Tensor  # (B,) int32: 128·sq + Dp·128², the code dot's query part
    q_u: torch.Tensor  # (B,) f32: sq + 128·Dp
    q_sq: torch.Tensor  # (B,) f32: qmag²
    codes: torch.Tensor  # (C, Dp) int8
    v_code: torch.Tensor  # (C,) int32: 128·sv
    v_u: torch.Tensor  # (C,) f32: sv + 128·Dp
    v_sq: torch.Tensor  # (C,) f32: vmag², +inf on invalid rows
    consts: torch.Tensor  # (3,) f32: a², a·b, b²·d_true

    def kernel_terms(self) -> tuple[tuple, tuple]:
        return (self.q_code, self.q_u, self.q_sq), (self.v_code, self.v_u, self.v_sq)


def bin_max_terms(metric: str, q: QuantizedU8, store: QuantizedU8, valid: torch.Tensor,
                  d_pad: int) -> BinMaxTerms | EuclideanTerms:
    """Fold the dequantization and cosine terms (u8_scan.py:129-159 order);
    euclidean's are the code sums' parts and the squared magnitudes."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"u8_bin_max computes {', '.join(_METRIC_CODE)}, not {metric!r}")
    consts = torch.stack([q.a * q.a, q.a * q.b, q.b * q.b * q.dtrue])
    if metric == "euclidean":
        u0 = 128 * q.data.shape[1]
        sq, sv = q.sums.to(torch.int32) + u0, store.sums.to(torch.int32)
        return EuclideanTerms(q.data, 128 * sq, sq.to(torch.float32), q.mags ** 2, store.data, 128 * sv,
                              (sv + u0).to(torch.float32), torch.where(valid, store.mags ** 2, torch.inf), consts)
    v_sink = torch.where(valid, 0.0, SINK)
    a = q.a
    b_ = q.b
    k1 = 128.0 * a * a + a * b_
    k0 = (
        a * a * d_pad * 128.0 * 128.0
        + 2.0 * a * b_ * 128.0 * d_pad
        + b_ * b_ * q.dtrue
    )
    eps = 1e-30
    q_add = k1 * q.sums.to(torch.float32) + k0
    if metric == "cosine":
        q_inv = 1.0 / torch.clamp_min(q.mags, eps)
        v_inv = torch.where(valid, 1.0 / torch.clamp_min(store.mags, eps), 0.0)
    else:
        q_inv = torch.ones_like(q.mags)
        v_inv = torch.where(valid, 1.0, 0.0)
    v_add = k1 * store.sums.to(torch.float32)
    return BinMaxTerms(q.data, q_add, q_inv, store.data, v_add, v_inv, v_sink, consts)


#: store rows per step of the plain version (bounds its (B, rows) scores)
PLAIN_ROW_CHUNK = 1 << 16


def _euclidean_scores(t: EuclideanTerms, cc: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """Negated euclidean distances of rows s..e in distance.euclidean_u8's
    op order (its dequant_dot on the code sums); -inf on invalid rows."""
    code_dot = (cc + t.q_code[:, None] + t.v_code[None, s:e]).to(torch.float32)
    dot = t.consts[0] * code_dot + t.consts[1] * (t.q_u[:, None] + t.v_u[None, s:e]) + t.consts[2]
    d2 = t.q_sq[:, None] + t.v_sq[None, s:e] - 2.0 * dot
    return -sqrt_rn(torch.clamp_min(d2, 0.0))


def u8_bin_max_plain(metric: str, group: int, t: BinMaxTerms | EuclideanTerms) -> torch.Tensor:
    """Plain PyTorch version: exact int8 product, the kernel's f32 epilogue
    in the same op order, then the group max (euclidean: a bin of invalid
    rows only is SINK). Chunked over store rows so the (B, chunk) scores
    stay bounded; the kernel writes no scores at all."""
    b = t.q_codes.shape[0]
    c = t.codes.shape[0]
    out = torch.empty((b, c // group), dtype=torch.float32, device=t.codes.device)
    step = max(PLAIN_ROW_CHUNK // group, 1) * group
    for s in range(0, c, step):
        e = min(s + step, c)
        cc = code_bmm(t.q_codes, t.codes[s:e])
        if metric == "euclidean":
            m = _euclidean_scores(t, cc, s, e).view(b, (e - s) // group, group).amax(-1)
            out[:, s // group : e // group] = torch.where(m == -torch.inf, SINK, m + 0.0)
            continue
        dot = t.consts[0] * cc.to(torch.float32)
        dot = dot + t.v_add[None, s:e] + t.q_add[:, None]
        sc = dot * t.v_inv[None, s:e]
        if metric == "cosine":
            sc = sc * t.q_inv[:, None]
        sc = sc + t.v_sink[None, s:e]
        out[:, s // group : e // group] = sc.view(b, (e - s) // group, group).amax(-1)
    return out


#: widest Dp of the euclidean epilogue: its integer code dot stays in int32
#: and ``uq + uv`` (at most 2·255·Dp) exact in f32
KERNEL_EUCLIDEAN_DP_MAX = 16384


def _check_cuda_args(metric: str, group: int, t: BinMaxTerms | EuclideanTerms) -> None:
    if metric not in _METRIC_CODE:
        raise ValueError(f"u8_bin_max kernel takes {', '.join(_METRIC_CODE)}, not {metric!r}")
    if isinstance(t, EuclideanTerms) != (metric == "euclidean"):
        raise ValueError(f"{metric} takes {'EuclideanTerms' if metric == 'euclidean' else 'BinMaxTerms'}")
    if group != KERNEL_GROUP:
        raise ValueError(f"u8_bin_max kernel takes group={KERNEL_GROUP}, not {group}")
    dev = t.codes.device
    b, dp = t.q_codes.shape
    c = t.codes.shape[0]
    if t.codes.shape != (c, dp) or c % group or dp % KERNEL_DP_MULTIPLE:
        raise ValueError(f"bad shapes: q_codes {tuple(t.q_codes.shape)}, codes {tuple(t.codes.shape)}")
    if metric == "euclidean" and dp > KERNEL_EUCLIDEAN_DP_MAX:
        raise ValueError(f"the euclidean epilogue takes Dp <= {KERNEL_EUCLIDEAN_DP_MAX}, not {dp}")
    for name in t._fields:
        x = getattr(t, name)
        if name in ("q_codes", "codes"):
            shape, dtype = (b if name == "q_codes" else c, dp), torch.int8
        elif name == "consts":
            shape, dtype = (3,), torch.float32
        else:
            shape, dtype = (b if name.startswith("q_") else c,), torch.int32 if name.endswith("_code") else torch.float32
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: want {dtype} {shape} contiguous on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    for x in (t.q_codes, t.codes, *t.kernel_terms()[1]):  # TMA and bulk-copy sources
        if x.data_ptr() % 16:
            raise ValueError("the codes and the row terms must be 16-byte aligned")


def u8_bin_max(metric: str, group: int, t: BinMaxTerms | EuclideanTerms) -> torch.Tensor:
    """(B, C/group) f32 contiguous bin maxima.

    CPU tensors take :func:`u8_bin_max_plain`; CUDA tensors launch the
    kernel (counted in ``u8_bin_max.launches``) or raise."""
    if t.codes.device.type == "cpu":
        return u8_bin_max_plain(metric, group, t)
    _check_cuda_args(metric, group, t)
    b, dp = t.q_codes.shape
    c = t.codes.shape[0]
    out = torch.empty((b, c // group), dtype=torch.float32, device=t.codes.device)
    if out.numel() == 0:
        return out
    q_terms, v_terms = t.kernel_terms()
    with torch.cuda.device(t.codes.device):
        LIBRARY.launch(
            _METRIC_CODE[metric], t.q_codes.data_ptr(), *(0 if x is None else x.data_ptr() for x in q_terms),
            t.codes.data_ptr(), *(x.data_ptr() for x in v_terms), t.consts.data_ptr(), out.data_ptr(),
            b, c, dp, torch.cuda.current_stream().cuda_stream,
        )
    u8_bin_max.launches += 1
    return out


u8_bin_max.launches = 0


def u8_bin_max_from_store(metric: str, group: int, q: QuantizedU8, store: QuantizedU8,
                          valid: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Fold the terms and run K1: (B, C/group) contiguous bin maxima."""
    return u8_bin_max(metric, group, bin_max_terms(metric, q, store, valid, d_pad))
