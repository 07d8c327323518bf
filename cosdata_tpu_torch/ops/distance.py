"""Batched scores (port of cosdata_tpu/ops/distance.py): (Q, D) queries x
(N, D) stored -> (Q, N), higher is better.

Quantized kinds score in dequantized space:

    x̂·ŷ = a²·Σ(u_q·u_v) + a·b·(Σu_q + Σu_v) + b²·d_true

Sub-byte code dots come from kernel K2 (ops/kernels/subbyte_scan.py) at
every size; float kinds are one full-f32 product. Euclidean is
``|q|² + |v|² − 2·x̂·ŷ`` over the same products; hamming is the XOR
popcount of the stored bit patterns, ``pc(x) + pc(y) − 2·Σ(x_bits·y_bits)``
as one exact product of 0/1 bits (:func:`bit_matmul`).

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

from cosdata_tpu_torch.ops.quantize import QuantizedFloat, QuantizedSubByte, QuantizedU8, unpack_bits_from_u32

_EPS = 1e-30
#: widest lane slice whose int8 f32 product is exact (128·128·1024 = 2^24)
EXACT_F32_LANES = 1024


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def code_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (..., A, D) x int8 (..., B, D)^T -> exact int32 (..., A, B); two
    (M, D), (N, D) matrices give their (M, N) product."""
    if a.device.type == "cuda":
        _no_tf32()
    out = None
    for s in range(0, a.shape[-1], EXACT_F32_LANES):
        e = s + EXACT_F32_LANES
        part = torch.matmul(a[..., s:e].to(torch.float32), b[..., s:e].to(torch.float32).transpose(-1, -2))
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


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


def exact_diag_dot(qrows: torch.Tensor, crows: torch.Tensor) -> torch.Tensor:
    """:func:`diag_dot` for the exact rerank. On the CPU the sum is taken in
    f64 and rounded once: the CPU's f32 ``bmm`` can land an ulp off the
    rounded sum where XLA's product does not (a row's product with itself,
    whose euclidean residue |x|² + |x|² − 2x·x the root turns into ~5e-4);
    the card keeps the f32 product."""
    if qrows.device.type == "cuda":
        return diag_dot(qrows, crows)
    return diag_dot(qrows.to(torch.float64), crows.to(torch.float64)).to(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded to nearest, as XLA's and CUDA's ``sqrtf``:
    the CPU's f32 ``torch.sqrt`` is up to an ulp off, so the root is taken
    in f64 and rounded once to f32."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """A zero cosine denominator maps to similarity 0."""
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids (any shape, >= 0) by one ``index_select``,
    which the CPU runs an order of magnitude faster than advanced indexing
    for short rows."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, *table.shape[1:])


def cos_or_dot(metric: str, dot, qmags, cmags):
    """Candidate scores from their dequantized dots ``dot`` (Q, ...), the
    queries' magnitudes (Q,) and the candidates' ``cmags`` (shaped as
    ``dot``): the dot itself, cosine, or the negated euclidean distance."""
    if metric == "dot":
        return dot
    if metric == "cosine":
        return safe_div(dot, qmags[:, None] * cmags)
    if metric == "euclidean":
        d2 = qmags[:, None] ** 2 + cmags**2 - 2.0 * dot
        return -sqrt_rn(torch.clamp_min(d2, 0.0))
    raise ValueError(metric)


def dequant_dot(q: QuantizedU8, cc: torch.Tensor, vsums: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Dequantized x̂·ŷ from int32 code dots ``cc`` (Q, N) and the rows' code
    sums ``vsums`` (broadcastable to (Q, N))."""
    code_dot = (cc + 128 * (q.sums[:, None] + vsums) + d_pad * 128 * 128).to(torch.float32)
    uq = (q.sums + 128 * d_pad).to(torch.float32)
    uv = (vsums + 128 * d_pad).to(torch.float32)
    return q.a * q.a * code_dot + q.a * q.b * (uq[:, None] + uv) + q.b * q.b * q.dtrue


def dot_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    """Dequantized dot product x̂·ŷ, (Q, N)."""
    return dequant_dot(q, code_bmm(q.data, v.data), v.sums[None, :], q.data.shape[-1])


def cosine_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    return safe_div(dot_u8(q, v), q.mags[:, None] * v.mags[None, :])


def euclidean_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    d2 = q.mags[:, None] ** 2 + v.mags[None, :] ** 2 - 2.0 * dot_u8(q, v)
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def euclidean_float(q: QuantizedFloat, v: QuantizedFloat) -> torch.Tensor:
    d2 = q.mags[:, None] ** 2 + v.mags[None, :] ** 2 - 2.0 * dot_float(q, v)
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def bit_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0/1 int8 bits (M, K) x (N, K)^T -> exact int32 (M, N).

    Every partial sum is an integer of at most K < 2^24, so one f32
    product (TF32 off) is exact at any width. On CUDA, shapes that
    ``torch._int_mm`` takes (M > 16, K and N multiples of 8) run it on the
    int8 tensor cores instead; both give the same integers."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type == "cuda":
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            return torch._int_mm(a.contiguous(), b.contiguous().t())
        _no_tf32()
    return torch.mm(a.to(torch.float32), b.to(torch.float32).T).to(torch.int32)


def hamming_from_bits(q_bits: torch.Tensor, v_bits: torch.Tensor) -> torch.Tensor:
    """popcount(x XOR y) = pc(x) + pc(y) - 2·Σ(x_bits·y_bits), as f32 (Q, N)."""
    qc = torch.sum(q_bits, dim=-1, dtype=torch.int32)
    vc = torch.sum(v_bits, dim=-1, dtype=torch.int32)
    return (qc[:, None] + vc[None, :] - 2 * bit_matmul(q_bits, v_bits)).to(torch.float32)


def _expand_bits(words: torch.Tensor, width: int) -> torch.Tensor:
    """(N, D) integer words -> (N, D·width) int8 bits, bit j of lane i at
    i·width + j. Shifts stay in the words' dtype (an arithmetic shift of a
    signed word still leaves bit j in place 0)."""
    shifts = torch.arange(width, dtype=words.dtype, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).to(torch.int8).reshape(words.shape[0], -1)


def hamming_u8(q: QuantizedU8, v: QuantizedU8) -> torch.Tensor:
    """Per-byte XOR popcount of the u8 codes (the code u = centered + 128 is
    the centered byte with its top bit flipped)."""
    return hamming_from_bits(_expand_bits(q.data.view(torch.uint8) ^ 0x80, 8),
                             _expand_bits(v.data.view(torch.uint8) ^ 0x80, 8))


def hamming_subbyte(q: QuantizedSubByte, v: QuantizedSubByte, d: int) -> torch.Tensor:
    """XOR popcount over the bucket codes' bit planes, summed over planes."""
    out = None
    for p in range(q.planes.shape[0]):
        h = hamming_from_bits(unpack_bits_from_u32(q.planes[p], d), unpack_bits_from_u32(v.planes[p], d))
        out = h if out is None else out + h
    return out


def hamming_f16(q: QuantizedFloat, v: QuantizedFloat) -> torch.Tensor:
    """XOR popcount of the f16 bit patterns (f32 storage is rounded to f16
    first, as in the reference)."""

    def bits(s: QuantizedFloat) -> torch.Tensor:
        return _expand_bits(s.data.to(torch.float16).view(torch.int16), 16)

    return hamming_from_bits(bits(q), bits(v))


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
    """Uniform (Q, N) similarity scores, higher is better (euclidean and
    hamming negated).

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
        if kind == "float":
            return -euclidean_float(q, v)
        raise ValueError("euclidean unsupported for sub-byte storage")
    if metric == "hamming":
        if kind == "u8":
            return -hamming_u8(q, v)
        if kind == "subbyte":
            return -hamming_subbyte(q, v, d)
        return -hamming_f16(q, v)
    raise ValueError(f"unknown metric {metric!r}")
