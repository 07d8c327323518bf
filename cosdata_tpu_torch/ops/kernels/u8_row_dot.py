"""The graph beam's candidate scoring on u8 codes: each query's candidate
rows read by id from the code table, from the exact int8 dots to the f32
scores the beam merges (kernel ``u8_row_dot``).

The CUDA kernel lives in ``cosdata_tpu_torch/csrc/u8_row_dot.cu`` (the
thread's share of the work in ``u8_row_dot.cuh``, the epilogue in
``u8_epilogue.cuh``), built by ``nvcc`` for ``sm_90a`` at first use
(ops/kernels/nvcc.py). It replaces no Pallas kernel: on the TPU the step is
XLA's gather of the rows and its grouped int8 einsum
(``cosdata_tpu/ops/storage.py:_scores_gathered``). The kernel is
query-major: a CTA holds one query's codes and reads each of its live
candidates' rows straight from the table. The plain version beside it
(:func:`row_scores_plain`) gathers the rows, takes their dots
(``distance.diag_code_dot``) and rescores them. The wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA tensors, or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops import distance as D
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.quantize import QuantizedU8
from cosdata_tpu_torch.ops.topk import NEG_INF

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("u8_row_dot", {"launch": [_I, *[_P] * 9, _L, *[_P] * 3, *[_I] * 4, _P]})
#: the kernel's Dp granularity and its widest Dp (every int32 sum exact:
#: 2^14 Dp < 2^31)
KERNEL_DP_MULTIPLE = 128
KERNEL_DP_MAX = (1 << 17) - KERNEL_DP_MULTIPLE
#: the metrics of the launch (cos_or_dot's: hamming never reaches it)
METRIC_CODES = {"cosine": 0, "dot": 1, "euclidean": 2}


def row_scores_plain(metric: str, d_pad: int, q: QuantizedU8, store: QuantizedU8, ids: torch.Tensor,
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the rows ``ids`` (negative ids
    clamped to row 0) gathered, their int32 dots
    (:func:`distance.diag_code_dot`), :func:`distance.dequant_dot`,
    :func:`distance.cos_or_dot`, then NEG_INF where ``live`` is False."""
    safe = torch.clamp_min(ids, 0)
    cmags = D.take_rows(store.mags, safe)
    cc = D.diag_code_dot(q.data, D.take_rows(store.data, safe))
    sc = D.cos_or_dot(metric, D.dequant_dot(q, cc, D.take_rows(store.sums, safe), d_pad), q.mags, cmags)
    return sc if live is None else torch.where(live, sc, NEG_INF)


def _check_cuda_args(metric: str, d_pad: int, q: QuantizedU8, store: QuantizedU8, ids: torch.Tensor,
                     live: torch.Tensor | None) -> None:
    dev = store.data.device
    b, dp = q.data.shape
    rows = store.data.shape[0]
    k = ids.shape[-1]
    if metric not in METRIC_CODES:
        raise ValueError(f"u8_row_dot scores by {', '.join(METRIC_CODES)}, not {metric!r}")
    if dp % KERNEL_DP_MULTIPLE or dp > KERNEL_DP_MAX or not 0 <= d_pad <= KERNEL_DP_MAX:
        raise ValueError(f"the kernel takes Dp a multiple of {KERNEL_DP_MULTIPLE} up to {KERNEL_DP_MAX}, not "
                         f"{dp} (d_pad {d_pad})")
    f32, i32 = torch.float32, torch.int32
    args = [
        ("q.data", q.data, (b, dp), torch.int8), ("q.sums", q.sums, (b,), i32), ("q.mags", q.mags, (b,), f32),
        ("q.a", q.a, (), f32), ("q.b", q.b, (), f32), ("q.dtrue", q.dtrue, (), f32),
        ("store.data", store.data, (rows, dp), torch.int8), ("store.sums", store.sums, (rows,), i32),
        ("store.mags", store.mags, (rows,), f32), ("ids", ids, (b, k), torch.int64),
    ]
    if live is not None:
        args.append(("live", live, (b, k), torch.bool))
    for name, x, shape, dtype in args:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if q.data.data_ptr() % 16 or store.data.data_ptr() % 16:
        raise ValueError("the query codes and the code table must be 16-byte aligned")


def u8_row_dot(metric: str, d_pad: int, q: QuantizedU8, store: QuantizedU8, ids: torch.Tensor,
               live: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K) f32: entry [b, p] is the ``metric`` score of query b (``q``)
    with row ``ids[b, p]`` (int64, row 0 where negative) of the u8
    ``store``, NEG_INF where ``live`` (bool (B, K), None for all) is False.

    CPU tensors take :func:`row_scores_plain`; CUDA tensors launch the
    kernel (counted in ``u8_row_dot.launches``) or raise. The kernel reads
    no row for an entry that is not live, nor its id. A live entry's id at
    or past the store's rows stops the launch (the kernel traps, and the
    CUDA error shows at the next synchronisation), as the plain version's
    gather stops on it."""
    if store.data.device.type == "cpu":
        return row_scores_plain(metric, d_pad, q, store, ids, live)
    _check_cuda_args(metric, d_pad, q, store, ids, live)
    b, k = ids.shape
    out = torch.empty((b, k), dtype=torch.float32, device=store.data.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(store.data.device):
        LIBRARY.launch(METRIC_CODES[metric], *(x.data_ptr() for x in (q.data, q.sums, q.mags, q.a, q.b, q.dtrue,
                                                                      store.data, store.sums, store.mags)),
                       store.data.shape[0], ids.data_ptr(), None if live is None else live.data_ptr(),
                       out.data_ptr(), b, k, q.data.shape[1], d_pad, torch.cuda.current_stream().cuda_stream)
    u8_row_dot.launches += 1
    return out


u8_row_dot.launches = 0
