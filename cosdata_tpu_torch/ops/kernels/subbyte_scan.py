"""Sub-byte code dots on the int8 tensor cores (kernel K2) and the sub-byte
scores built on them.

Port of cosdata_tpu/ops/pallas/subbyte_scan.py. The CUDA kernel lives in
``cosdata_tpu_torch/csrc/subbyte_code_scores.cu``, built by ``nvcc`` for
``sm_90a`` at first use (ops/kernels/nvcc.py). It takes the query's packed
planes, not its unpacked codes as the Pallas kernel does, and unpacks both
sides on the card into the word-major order of :func:`word_major_codes`,
then contracts them on the int8 tensor cores. The query side is unpacked
by its own small kernel (:func:`unpack_query_codes`), once per batch when
the caller scans several row chunks. Two entries share the product:
:func:`subbyte_code_scores` writes the raw int32 code dots, and
:func:`subbyte_scores_fused` the f32 scores, masked, with the maxima of
every ``GROUP`` rows, which every score of the port goes through. Each
wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops.distance import code_bmm, safe_div
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.quantize import QuantizedSubByte, subbyte_values
from cosdata_tpu_torch.ops.topk import NEG_INF

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("subbyte_code_scores", {
    "unpack_queries": [_I, _P, _L, _P, _I, _I, _P],
    "launch": [_P, _P, _L, _P, _I, _I, _L, _I, _P],
    "launch_fused": [_P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P],
})
#: rows per group maximum of :func:`subbyte_scores_fused`
GROUP = 32
#: the fused kernel's metric codes
_METRIC_CODES = {"dot": 1, "cosine": 2}


def word_major_codes(planes: torch.Tensor) -> torch.Tensor:
    """(res, N, W) planes -> (N, 32·W) int8 bucket codes in WORD-MAJOR
    order: position ``w*32 + i`` holds bit ``i`` of word ``w`` (dimension
    ``i*W + w`` of the strided pack). Both sides of a code dot unpacked
    this way give the same sum as in dimension order; the kernel unpacks
    the query and store planes into this order, one word into 32
    consecutive bytes. Here each little-endian byte of a word looks up its
    8 bits in a (256, 8) table, which lays them out in this order with no
    transposing copy (the graph's beam unpacks its gathered rows so)."""
    res, n, w = planes.shape
    lut = ((torch.arange(256, dtype=torch.int32, device=planes.device)[:, None]
            >> torch.arange(8, dtype=torch.int32, device=planes.device)) & 1).to(torch.int8)
    acc = None
    for p in range(res):
        byte = planes[p].contiguous().view(torch.uint8).reshape(-1).to(torch.int32)
        contrib = torch.index_select(lut, 0, byte) << (res - 1 - p)
        acc = contrib if acc is None else acc + contrib
    return acc.reshape(n, 32 * w)


def subbyte_code_scores_plain(q_planes: torch.Tensor, planes: torch.Tensor, d: int) -> torch.Tensor:
    """Plain PyTorch version: unpack both sides to codes, then the exact
    code product (int32 on the CPU; on CUDA an f32 product with TF32 off,
    exact because every partial sum is at most 49·d < 2^24)."""
    return code_bmm(subbyte_values(q_planes, d), subbyte_values(planes, d))


def _check_planes(name: str, x: torch.Tensor, w: int, device: torch.device) -> None:
    if x.device != device or x.dtype != torch.int32:
        raise ValueError(f"{name}: want int32 on {device}, got {x.dtype} on {x.device}")
    # rows contiguous within a plane; the plane stride is passed through
    if x.stride(2) != 1 or x.stride(1) != w or x.data_ptr() % 4:
        raise ValueError(f"{name}: rows must be contiguous 4-byte-aligned words, strides {x.stride()}")


def _check_cuda_args(q_planes: torch.Tensor, planes: torch.Tensor, d: int) -> None:
    res, c, w = planes.shape
    if res not in (1, 2, 3):
        raise ValueError(f"subbyte_code_scores takes 1, 2 or 3 planes, not {res}")
    if q_planes.ndim != 3 or q_planes.shape[0] != res or q_planes.shape[2] != w:
        raise ValueError(f"bad shapes: q_planes {tuple(q_planes.shape)}, planes {tuple(planes.shape)}")
    if d != 32 * w:
        raise ValueError(f"d={d} must be 32 x the word count {w}")
    for name, x in (("q_planes", q_planes), ("planes", planes)):
        _check_planes(name, x, w, planes.device)


def unpack_query_codes(q_planes: torch.Tensor) -> torch.Tensor:
    """(res, B, W) query planes -> (B, 32·W) int8 codes in the word-major
    order of :func:`word_major_codes`: the product's query operand. A scan
    over several row chunks unpacks once and passes the result to each
    chunk's :func:`subbyte_code_scores`.

    CPU tensors take :func:`word_major_codes`; CUDA tensors launch the
    unpack kernel (counted in ``unpack_query_codes.launches``) or raise."""
    if q_planes.device.type == "cpu":
        return word_major_codes(q_planes)
    res, b, w = q_planes.shape
    if res not in (1, 2, 3):
        raise ValueError(f"unpack_query_codes takes 1, 2 or 3 planes, not {res}")
    _check_planes("q_planes", q_planes, w, q_planes.device)
    q_codes = torch.empty((b, 32 * w), dtype=torch.int8, device=q_planes.device)
    if q_codes.numel() == 0:
        return q_codes
    with torch.cuda.device(q_planes.device):
        LIBRARY.launch(res, q_planes.data_ptr(), q_planes.stride(0), q_codes.data_ptr(), b, w,
                       torch.cuda.current_stream().cuda_stream, entry="unpack_queries")
    unpack_query_codes.launches += 1
    return q_codes


unpack_query_codes.launches = 0


def _check_q_codes(q_codes: torch.Tensor, b: int, w: int, device: torch.device) -> None:
    if (q_codes.shape != (b, 32 * w) or q_codes.dtype != torch.int8 or q_codes.device != device
            or not q_codes.is_contiguous() or q_codes.data_ptr() % 16):
        raise ValueError(f"q_codes: want contiguous 16-byte-aligned int8 ({b}, {32 * w}) on {device}, "
                         f"got {q_codes.dtype} {tuple(q_codes.shape)} on {q_codes.device}")


def subbyte_code_scores(q_planes: torch.Tensor, planes: torch.Tensor, d: int,
                        q_codes: torch.Tensor | None = None) -> torch.Tensor:
    """(B, C) int32 code dots Σ qcode·vcode from q_planes (res, B, W) and
    planes (res, C, W), both int32 words of the strided pack. ``q_codes``
    is :func:`unpack_query_codes` of ``q_planes`` where the caller has it;
    the wrapper unpacks the queries itself when it is None.

    CPU tensors take :func:`subbyte_code_scores_plain`; CUDA tensors launch
    the kernel (counted in ``subbyte_code_scores.launches``) or raise."""
    if planes.device.type == "cpu":
        return subbyte_code_scores_plain(q_planes, planes, d)
    _check_cuda_args(q_planes, planes, d)
    res, c, w = planes.shape
    b = q_planes.shape[1]
    out = torch.empty((b, c), dtype=torch.int32, device=planes.device)
    if out.numel() == 0:
        return out
    if q_codes is None:
        q_codes = unpack_query_codes(q_planes)
    else:
        _check_q_codes(q_codes, b, w, planes.device)
    with torch.cuda.device(planes.device):
        LIBRARY.launch(
            q_codes.data_ptr(), planes.data_ptr(), planes.stride(0), out.data_ptr(), res, b, c, w,
            torch.cuda.current_stream().cuda_stream,
        )
    subbyte_code_scores.launches += 1
    return out


subbyte_code_scores.launches = 0


def score_epilogue_plain(metric: str, q: QuantizedSubByte, store: QuantizedSubByte, code_dot: torch.Tensor,
                         valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused kernel's output side, on the (B, C)
    int32 code dots: the dequantized (bucket-centre) similarity in the
    reference's op order, ``a²·code_dot + a·b·(s_q + s_v) + b²·d_true``,
    then the cosine division for ``metric="cosine"``; NEG_INF where
    ``valid`` (C,) is False (None: every row); and the maxima of every
    ``GROUP`` consecutive rows (a ragged last group over the rows it has).
    Returns (scores (B, C), group maxima (B, ceil(C / GROUP)))."""
    code_dot = code_dot.to(torch.float32)
    dot = (
        q.a * q.a * code_dot
        + q.a * q.b * (q.sums.to(torch.float32)[:, None] + store.sums.to(torch.float32)[None, :])
        + q.b * q.b * q.dtrue
    )
    scores = dot if metric == "dot" else safe_div(dot, q.mags[:, None] * store.mags[None, :])
    if valid is not None:
        scores = torch.where(valid[None, :], scores, NEG_INF)
    b, c = scores.shape
    padded = torch.nn.functional.pad(scores, (0, -c % GROUP), value=NEG_INF)
    return scores, padded.view(b, -1, GROUP).amax(dim=2)


def subbyte_scores_fused_plain(metric: str, q: QuantizedSubByte, store: QuantizedSubByte, d: int,
                               valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`subbyte_scores_fused`: the plain code product,
    then :func:`score_epilogue_plain`."""
    return score_epilogue_plain(metric, q, store, subbyte_code_scores_plain(q.planes, store.planes, d), valid)


def _check_vector(name: str, x: torch.Tensor, n: int, dtype: torch.dtype, device: torch.device) -> None:
    if x.shape != (n,) or x.dtype != dtype or x.device != device or x.stride(0) != 1:
        raise ValueError(f"{name}: want contiguous {dtype} ({n},) on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} stride {x.stride()} on {x.device}")


def subbyte_scores_fused(metric: str, q: QuantizedSubByte, store: QuantizedSubByte, d: int,
                         valid: torch.Tensor | None = None,
                         q_codes: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) f32 scores of the query batch ``q`` against the store rows
    ``store`` (``metric`` "dot" or "cosine"), NEG_INF where ``valid`` (C,)
    bool is False (None: every row), and the (B, ceil(C / GROUP)) maxima of
    every ``GROUP`` consecutive rows; ``q_codes`` as for
    :func:`subbyte_code_scores`.

    CPU tensors take :func:`subbyte_scores_fused_plain`; CUDA tensors
    launch the fused kernel, whose scores equal the plain version's bit for
    bit (counted in ``subbyte_code_scores.launches``), or raise."""
    if metric not in _METRIC_CODES:
        raise ValueError(f"subbyte_scores_fused takes dot or cosine, not {metric!r}")
    if store.planes.device.type == "cpu":
        return subbyte_scores_fused_plain(metric, q, store, d, valid)
    _check_cuda_args(q.planes, store.planes, d)
    res, c, w = store.planes.shape
    b = q.planes.shape[1]
    dev = store.planes.device
    scores = torch.empty((b, c), dtype=torch.float32, device=dev)
    gmax = torch.empty((b, -(-c // GROUP)), dtype=torch.float32, device=dev)
    if scores.numel() == 0:
        return scores, gmax
    for name, x, n, dtype in (("q.sums", q.sums, b, torch.int32), ("q.mags", q.mags, b, torch.float32),
                              ("store.sums", store.sums, c, torch.int32),
                              ("store.mags", store.mags, c, torch.float32)):
        _check_vector(name, x, n, dtype, dev)
    if valid is not None:
        _check_vector("valid", valid, c, torch.bool, dev)
    for name, x in (("a", q.a), ("b", q.b), ("dtrue", q.dtrue)):
        if x.shape != () or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"q.{name}: want a 0-d float32 tensor on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if q_codes is None:
        q_codes = unpack_query_codes(q.planes)
    else:
        _check_q_codes(q_codes, b, w, dev)
    with torch.cuda.device(dev):
        LIBRARY.launch(
            q_codes.data_ptr(), store.planes.data_ptr(), store.planes.stride(0), scores.data_ptr(),
            gmax.data_ptr(), q.sums.data_ptr(), q.mags.data_ptr(), store.sums.data_ptr(),
            store.mags.data_ptr(), None if valid is None else valid.data_ptr(), q.a.data_ptr(),
            q.b.data_ptr(), q.dtrue.data_ptr(), _METRIC_CODES[metric], res, b, c, w,
            torch.cuda.current_stream().cuda_stream, entry="launch_fused",
        )
    subbyte_code_scores.launches += 1
    return scores, gmax


def subbyte_scores(metric: str, q: QuantizedSubByte, store: QuantizedSubByte, d: int,
                   q_codes: torch.Tensor | None = None) -> torch.Tensor:
    """(B, C) dequantized (bucket-centre) similarity, in the reference's op
    order (:func:`score_epilogue_plain`), by :func:`subbyte_scores_fused`
    over every row; ``q_codes`` as for :func:`subbyte_code_scores`."""
    return subbyte_scores_fused(metric, q, store, d, None, q_codes)[0]
