"""Scalar u8 quantization (port of cosdata_tpu/ops/quantize.py, u8 only).

Every stored code ``u`` represents ``x̂ = a*u + b``; codes are kept centered
as int8 (``u - 128``) with per-row code sums, so u8 x u8 contractions run as
int8 products: ``Σ u_q u_v = cc + 128*(s_q + s_v) + D*128²``. Padded lanes
carry code 0 and are excluded from magnitudes and the constant terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedU8(NamedTuple):
    """u8-quantized batch. x̂ = a*u + b on the first `dtrue` lanes."""

    data: torch.Tensor  # (N, D) int8 == u8 code - 128  (0 code on padded lanes)
    sums: torch.Tensor  # (N,)  int32 sum of centered codes (all lanes)
    mags: torch.Tensor  # (N,)  f32 ||x̂|| over true lanes
    a: torch.Tensor  # () f32 scale  (hi-lo)/255
    b: torch.Tensor  # () f32 offset lo
    dtrue: torch.Tensor  # () f32 number of true lanes


def quantize_u8(
    x: torch.Tensor, lo, hi, d_true: int | None = None
) -> QuantizedU8:
    """Affine u8 bucket assignment over [lo, hi], in the reference's op order.

    ``lo``/``hi`` become 0-d f32 tensors, so ``hi - lo`` is the f32
    subtraction f32(hi) - f32(lo), as in the jitted reference, not Python's
    double subtraction rounded to f32 (the two differ by one ulp for ranges
    like (-1.3, 0.7), which flips codes at bucket edges).
    """
    x = x.to(torch.float32)
    d_pad = x.shape[-1]
    d_true = d_pad if d_true is None else d_true
    lo = torch.as_tensor(lo, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=x.device)
    scaled = (torch.clamp(x, lo, hi) - lo) / (hi - lo) * 255.0
    u8 = torch.clamp(torch.floor(scaled).to(torch.int32), 0, 255)
    lanes = torch.arange(d_pad, device=x.device) < d_true
    u8 = u8 * lanes[None, :]
    # XLA rewrites the reference's `(hi - lo) / 255.0` into a multiply by
    # the f32 constant 1/255; this is that exact arithmetic (one ulp apart
    # from a true division for ranges like (-0.025, 0.3))
    a = (hi - lo) * (1.0 / 255.0)
    deq = a * u8.to(torch.float32) + lo
    mags = torch.sqrt(torch.sum(torch.where(lanes[None, :], deq * deq, 0.0), dim=-1))
    centered = u8 - 128
    return QuantizedU8(
        centered.to(torch.int8),
        torch.sum(centered, dim=-1, dtype=torch.int32),
        mags,
        a,
        lo,
        torch.tensor(float(d_true), dtype=torch.float32, device=x.device),
    )
