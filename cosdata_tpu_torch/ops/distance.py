"""Batched scores (port of cosdata_tpu/ops/distance.py): (Q, D) queries x
(N, D) stored -> (Q, N), higher is better.

Quantized kinds score in dequantized space:

    x̂·ŷ = a²·Σ(u_q·u_v) + a·b·(Σu_q + Σu_v) + b²·d_true

Sub-byte code dots come from kernel K2 (ops/kernels/subbyte_scan.py) at
every size; float kinds are one full-f32 product.

The int8 code contraction is exact on both devices. It runs as an f32
product of the int8 values (CUDA has no integer ``mm``, an int8 ``torch.mm``
on the CPU returns int8 and wraps, and the CPU's int32 product has no BLAS
behind it), which is exact while every partial sum stays below 2^24 —
true for slices of at most 1024 lanes at full code range
(128·128·1024 = 2^24), so wider rows are split and the partials summed as
int32. TF32 is switched off for these products.

The u8 products here serve stores below the scan threshold; the
large-store u8 scan goes through the u8_bin_max kernel
(ops/kernels/u8_scan.py).
"""

from __future__ import annotations

import torch

from cosdata_tpu_torch.ops.quantize import QuantizedFloat, QuantizedSubByte, QuantizedU8

_EPS = 1e-30
#: widest lane slice whose int8 f32 product is exact (128·128·1024 = 2^24)
EXACT_F32_LANES = 1024


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def code_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (..., A, D) x int8 (..., B, D)^T -> exact int32 (..., A, B)."""
    if a.device.type == "cuda":
        _no_tf32()
    out = None
    for s in range(0, a.shape[-1], EXACT_F32_LANES):
        e = s + EXACT_F32_LANES
        part = torch.matmul(a[..., s:e].to(torch.float32), b[..., s:e].to(torch.float32).transpose(-1, -2))
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def code_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, D) x int8 (N, D)^T -> exact int32 (M, N)."""
    return code_bmm(a, b)


def diag_code_dot(qrows: torch.Tensor, crows: torch.Tensor) -> torch.Tensor:
    """int8 qrows (B, D) . int8 per-query candidates crows (B, K, D) -> int32 (B, K).

    A plain batched product: the reference's grouping into block GEMMs
    (storage._diag_dot) exists only to reach the TPU's matrix unit."""
    return code_bmm(qrows[:, None, :], crows)[:, 0, :]


def diag_dot(qrows: torch.Tensor, crows: torch.Tensor) -> torch.Tensor:
    """f32 qrows (B, D) . f32 crows (B, K, D) -> (B, K), full f32 (no TF32)."""
    if qrows.device.type == "cuda":
        _no_tf32()
    return torch.bmm(crows, qrows[:, :, None])[:, :, 0]


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """A zero cosine denominator maps to similarity 0."""
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


def dequant_dot(q: QuantizedU8, cc: torch.Tensor, vsums: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Dequantized x̂·ŷ from int32 code dots ``cc`` (Q, N) and the rows' code
    sums ``vsums`` (broadcastable to (Q, N))."""
    code_dot = (cc + 128 * (q.sums[:, None] + vsums) + d_pad * 128 * 128).to(torch.float32)
    uq = (q.sums + 128 * d_pad).to(torch.float32)
    uv = (vsums + 128 * d_pad).to(torch.float32)
    return q.a * q.a * code_dot + q.a * q.b * (uq[:, None] + uv) + q.b * q.b * q.dtrue


def dot_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    """Dequantized dot product x̂·ŷ, (Q, N)."""
    return dequant_dot(q, code_matmul(q.data, v.data), v.sums[None, :], q.data.shape[-1])


def cosine_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    return safe_div(dot_u8(q, v), q.mags[:, None] * v.mags[None, :])


def euclidean_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    d2 = q.mags[:, None] ** 2 + v.mags[None, :] ** 2 - 2.0 * dot_u8(q, v)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _subbyte_scores(metric: str, q: QuantizedSubByte, v: QuantizedSubByte, d: int,
                    q_codes: torch.Tensor | None = None) -> torch.Tensor:
    # imported here: the kernel module builds on this module's exact products
    from cosdata_tpu_torch.ops.kernels.subbyte_scan import subbyte_scores

    return subbyte_scores(metric, q, v, d, q_codes)


def dot_subbyte(q: QuantizedSubByte, v: QuantizedSubByte, d: int) -> torch.Tensor:
    """Dequantized (bucket-centre) dot product, (Q, N), through K2."""
    return _subbyte_scores("dot", q, v, d)


def cosine_subbyte(q: QuantizedSubByte, v: QuantizedSubByte, d: int) -> torch.Tensor:
    return _subbyte_scores("cosine", q, v, d)


def dot_float(q: QuantizedFloat, v: QuantizedFloat) -> torch.Tensor:
    """Full-f32 product (f16 upcast), TF32 off: the exact tier."""
    if q.data.device.type == "cuda":
        _no_tf32()
    return torch.mm(q.data.to(torch.float32), v.data.to(torch.float32).T)


def cosine_float(q: QuantizedFloat, v: QuantizedFloat) -> torch.Tensor:
    return safe_div(dot_float(q, v), q.mags[:, None] * v.mags[None, :])


def score(metric: str, kind: str, q, v, d: int, q_codes: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform (Q, N) similarity scores, higher is better (euclidean negated).

    ``kind`` in {"u8", "subbyte", "float"}; ``q_codes``, for sub-byte
    storage only, is the queries' unpacked codes
    (``kernels.subbyte_scan.unpack_query_codes``) shared by the chunks of
    one scan.
    """
    if metric in ("cosine", "dot"):
        if kind == "u8":
            return cosine_u8(q, v) if metric == "cosine" else dot_u8(q, v)
        if kind == "subbyte":
            return _subbyte_scores(metric, q, v, d, q_codes)
        if kind == "float":
            return cosine_float(q, v) if metric == "cosine" else dot_float(q, v)
        raise ValueError(f"unknown storage kind {kind!r}")
    if metric == "euclidean":
        if kind == "u8":
            return -euclidean_u8(q, v)
        if kind == "subbyte":
            raise ValueError("euclidean unsupported for sub-byte storage")
        raise NotImplementedError(
            f"euclidean scoring of {kind!r} storage is not ported yet "
            "(ROADMAP queue 1: euclidean and hamming stage 1)"
        )
    if metric == "hamming":
        raise NotImplementedError(
            "hamming scoring is not ported yet (ROADMAP queue 1: euclidean and hamming stage 1)"
        )
    raise ValueError(f"unknown metric {metric!r}")
