"""Quantization (port of cosdata_tpu/ops/quantize.py): scalar u8, sub-byte
bitplanes, f16/f32 pass-through.

Every stored code ``u`` represents ``x̂ = a*u + b``:

- **u8**: codes kept centered as int8 (``u - 128``) with per-row code
  sums, so u8 x u8 contractions run as int8 products:
  ``Σ u_q u_v = cc + 128*(s_q + s_v) + D*128²``.
- **sub-byte (1/2/3-bit)**: values bucketed over the fixed [-1, 1] with
  ``step = 2/2^bits``; plane p holds bit ``res-1-p`` of each bucket code
  (plane 0 = MSB), packed **strided** into 32-bit words (bit i of word w is
  dimension i*W + w). torch's ``uint32`` lacks shifts, so the words live in
  ``int32`` tensors holding the same bits; unpacking reads them as bytes
  through a bit table, which never shifts a word.
- **f16/f32**: stored as-is with f32 magnitudes.

Padded lanes carry code 0 and are excluded from magnitudes and the
constant terms.
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


class QuantizedSubByte(NamedTuple):
    """Sub-byte batch: packed bitplanes (MSB plane first), x̂ = a*n + b."""

    planes: torch.Tensor  # (res, N, ceil(D/32)) int32 holding the uint32 words
    sums: torch.Tensor  # (N,) int32 sum of bucket codes (all lanes; padded = 0)
    mags: torch.Tensor  # (N,) f32 ||x̂|| over true lanes
    a: torch.Tensor  # () f32 = step
    b: torch.Tensor  # () f32 = step/2 - 1
    dtrue: torch.Tensor  # () f32


class QuantizedFloat(NamedTuple):
    """f16/f32 storage with precomputed magnitudes."""

    data: torch.Tensor  # (N, D) f16 or f32
    mags: torch.Tensor  # (N,) f32


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


def _pack_bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (N, D) tensor of 0/1 into (N, ceil(D/32)) 32-bit words, as
    int32 holding the uint32 bits.

    **Strided layout**: bit ``i`` of word ``w`` holds dimension ``i*W + w``
    (W = word count). The words are summed in int64, where bit 31 fits,
    then wrapped into int32's range."""
    n, d = bits.shape
    w = -(-d // 32)
    if w * 32 != d:
        bits = torch.nn.functional.pad(bits, (0, w * 32 - d))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)[None, :, None]
    words = torch.sum(bits.reshape(n, 32, w).to(torch.int64) << shifts, dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_bits_from_u32(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits_to_u32`: (N, W) words -> (N, d) int8 of 0/1.

    The words are read as little-endian bytes (byte b holds bits 8b..8b+7),
    laid out byte-major, and each byte is shifted by 0..7 into an output
    already in dimension order, so the unpack moves bytes, not 32 shifted
    int32 copies of every word, and needs no transposing copy after."""
    n, w = packed.shape
    byte = packed.contiguous().view(torch.uint8).reshape(n, w, 4).transpose(1, 2).contiguous()
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)[:, None]
    bits = (byte[:, :, None, :] >> shifts) & 1  # (N, 4 bytes, 8 bits, W): bit 8b+j of word w
    return bits.view(torch.int8).reshape(n, 32 * w)[:, :d]


def quantize_subbyte(
    x: torch.Tensor, resolution: int, d_true: int | None = None
) -> QuantizedSubByte:
    """Sub-byte bitplane bucket assignment over [-1, 1] into
    ``2^resolution`` buckets (``resolution`` in {1, 2, 3}); out-of-range
    values clamp to the extreme buckets."""
    x = x.to(torch.float32)
    d_pad = x.shape[-1]
    d_true = d_pad if d_true is None else d_true
    parts = 1 << resolution
    step = 2.0 / parts
    n_bucket = torch.clamp(torch.floor((x + 1.0) / step).to(torch.int32), 0, parts - 1)
    lanes = torch.arange(d_pad, device=x.device) < d_true
    n_bucket = n_bucket * lanes[None, :]
    planes = [_pack_bits_to_u32((n_bucket >> (resolution - 1 - p)) & 1) for p in range(resolution)]
    deq = step * n_bucket.to(torch.float32) + (step / 2.0 - 1.0)
    mags = torch.sqrt(torch.sum(torch.where(lanes[None, :], deq * deq, 0.0), dim=-1))
    return QuantizedSubByte(
        torch.stack(planes, dim=0),
        torch.sum(n_bucket, dim=-1, dtype=torch.int32),
        mags,
        torch.tensor(step, dtype=torch.float32, device=x.device),
        torch.tensor(step / 2.0 - 1.0, dtype=torch.float32, device=x.device),
        torch.tensor(float(d_true), dtype=torch.float32, device=x.device),
    )


def subbyte_values(planes: torch.Tensor, d: int) -> torch.Tensor:
    """Reconstruct bucket codes 0..2^res-1 as (N, d) int8 from packed planes."""
    res = planes.shape[0]
    acc = None
    for p in range(res):
        contrib = unpack_bits_from_u32(planes[p], d) << (res - 1 - p)
        acc = contrib if acc is None else acc + contrib
    return acc


def quantize_f32(x: torch.Tensor) -> QuantizedFloat:
    x = x.to(torch.float32)
    return QuantizedFloat(x, torch.sqrt(torch.sum(x * x, dim=-1)))


def quantize_f16(x: torch.Tensor) -> QuantizedFloat:
    x32 = x.to(torch.float32)
    return QuantizedFloat(x32.to(torch.float16), torch.sqrt(torch.sum(x32 * x32, dim=-1)))
