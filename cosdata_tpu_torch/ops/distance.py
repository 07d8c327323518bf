"""Batched u8 scores (port of the u8 branch of cosdata_tpu/ops/distance.py).

Quantized kinds score in dequantized space:

    x̂·ŷ = a²·Σ(u_q·u_v) + a·b·(Σu_q + Σu_v) + b²·d_true

The int8 code contraction is exact on both devices: on the CPU it runs as
an int32 product (an int8 ``torch.mm`` returns int8 and wraps); on CUDA,
which has no integer ``mm``, it runs as an f32 product of the int8 values,
which is exact while every partial sum stays below 2^24 — true for slices
of at most 1024 lanes at full code range (128·128·1024 = 2^24), so wider
rows are split and the partials summed as int32. TF32 is switched off for
these products.

This path serves stores below the scan threshold; the large-store scan
goes through the u8_bin_max kernel (ops/kernels/u8_scan.py).
"""

from __future__ import annotations

import torch

from cosdata_tpu_torch.ops.quantize import QuantizedU8

_EPS = 1e-30
#: widest lane slice whose int8 f32 product is exact (128·128·1024 = 2^24)
EXACT_F32_LANES = 1024


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def code_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, D) x int8 (N, D)^T -> exact int32 (M, N)."""
    if a.device.type == "cpu":
        return torch.mm(a.to(torch.int32), b.to(torch.int32).T)
    _no_tf32()
    out = None
    for s in range(0, a.shape[1], EXACT_F32_LANES):
        e = s + EXACT_F32_LANES
        part = torch.mm(a[:, s:e].to(torch.float32), b[:, s:e].to(torch.float32).T)
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def diag_code_dot(qrows: torch.Tensor, crows: torch.Tensor) -> torch.Tensor:
    """int8 qrows (B, D) . int8 per-query candidates crows (B, K, D) -> int32 (B, K).

    A plain batched product: the reference's grouping into block GEMMs
    (storage._diag_dot) exists only to reach the TPU's matrix unit."""
    if qrows.device.type == "cpu":
        return torch.bmm(crows.to(torch.int32), qrows.to(torch.int32)[:, :, None])[:, :, 0]
    _no_tf32()
    out = None
    for s in range(0, qrows.shape[1], EXACT_F32_LANES):
        e = s + EXACT_F32_LANES
        part = torch.bmm(
            crows[:, :, s:e].to(torch.float32), qrows[:, s:e].to(torch.float32)[:, :, None]
        )[:, :, 0].to(torch.int32)
        out = part if out is None else out + part
    return out


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


def score(metric: str, kind: str, q: QuantizedU8, v: QuantizedU8, d: int) -> torch.Tensor:
    """Uniform (Q, N) similarity scores, higher is better (euclidean negated).

    Only u8 storage is ported; sub-byte and float kinds wait for their slice.
    """
    if kind != "u8":
        raise NotImplementedError(
            f"{kind!r} storage is not ported yet (ROADMAP queue 1: sub-byte, f16 and f32 kinds)"
        )
    if metric == "cosine":
        return cosine_u8(q, v)
    if metric == "dot":
        return dot_u8(q, v)
    if metric == "euclidean":
        return -euclidean_u8(q, v)
    if metric == "hamming":
        raise NotImplementedError("hamming scoring is not ported yet (ROADMAP queue 1)")
    raise ValueError(f"unknown metric {metric!r}")
