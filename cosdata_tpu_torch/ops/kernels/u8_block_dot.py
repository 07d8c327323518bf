"""Stage 4 of the u8 scan: each query's winning blocks of the code table
rescored, from the exact int8 dots of its codes with their rows to the f32
scores that the stage's top-k reads (kernel ``u8_block_dot``).

The CUDA kernel lives in ``cosdata_tpu_torch/csrc/u8_block_dot.cu`` (the
fragments, the walk of a block's entries and the epilogue in
``u8_block_dot.cuh``), built by ``nvcc`` for ``sm_90a`` at first use
(ops/kernels/nvcc.py). It replaces no TPU kernel: on the TPU the step is
XLA's gather of the blocks, its grouped int8 einsum and the elementwise
rescore (``cosdata_tpu/ops/flat_scan.py``, ``exp_body``). The kernel is
block-major: each table block that some query chose is read once and
scored for every query that chose it, so the wrapper first sorts the
(B, K) block ids, which lines up each block's entries (:func:`invert`). The
plain version beside it (:func:`block_scores_plain`) gathers each query's
blocks, takes their dots (:func:`u8_block_dot_plain`) and rescores them.
The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors, or raises.

Block k of query b is ``group`` contiguous rows of the (rows, Dp) table,
starting at row ``block_ids[b, k] * group``: the scan's 32-row bins, or
single rows with ``group`` 1.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops import distance as D
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.quantize import QuantizedU8
from cosdata_tpu_torch.ops.storage import cos_or_dot
from cosdata_tpu_torch.ops.topk import NEG_INF

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("u8_block_dot", {"launch": [_I, *[_P] * 10, _L, *[_P] * 4, *[_I] * 5, _P]})
#: the kernel's Dp granularity and its widest Dp (every int32 sum exact:
#: 2^14 Dp < 2^31)
KERNEL_DP_MULTIPLE = 128
KERNEL_DP_MAX = (1 << 17) - KERNEL_DP_MULTIPLE
#: the metrics of the launch (stage 4 never sees hamming)
METRIC_CODES = {"cosine": 0, "dot": 1, "euclidean": 2}
#: bytes of the f32 copy of the gathered blocks that the plain version may
#: hold at once (it runs over slices of the queries)
PLAIN_BYTES = 1 << 30


def u8_block_dot_plain(q_codes: torch.Tensor, codes: torch.Tensor, block_ids: torch.Tensor,
                       group: int) -> torch.Tensor:
    """(B, K·group) int32: entry [b, k·group + j] is the exact dot of
    ``q_codes[b]`` with row ``block_ids[b, k]·group + j`` of ``codes``:
    the blocks gathered, then :func:`distance.diag_code_dot`, over slices
    of the queries."""
    b, k = block_ids.shape
    dp = q_codes.shape[1]
    out = torch.empty((b, k * group), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    blocks = codes.view(-1, group * dp)
    step = max(1, PLAIN_BYTES // (k * group * dp * 4))
    for s in range(0, b, step):
        e = min(s + step, b)
        out[s:e] = D.diag_code_dot(q_codes[s:e], blocks[block_ids[s:e]].view(e - s, k * group, dp))
    return out


def block_scores_plain(metric: str, d_pad: int, group: int, q: QuantizedU8, store: QuantizedU8,
                       valid: torch.Tensor, bin_s: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the int32 dots
    (:func:`u8_block_dot_plain`), :func:`distance.dequant_dot`,
    :func:`storage.cos_or_dot`, then NEG_INF where the row is invalid or
    its bin sank (``bin_s <= NEG_INF / 2``)."""
    b, k = block_ids.shape
    cap_g = store.data.shape[0] // group
    p_total = k * group
    cc = u8_block_dot_plain(q.data, store.data, block_ids, group)
    dot = D.dequant_dot(q, cc, store.sums.view(cap_g, group)[block_ids].view(b, p_total), d_pad)
    sc = cos_or_dot(metric, dot, q.mags, store.mags.view(cap_g, group)[block_ids].view(b, p_total))
    live = valid.view(cap_g, group)[block_ids].view(b, p_total) & (bin_s > NEG_INF / 2).repeat_interleave(group, 1)
    return torch.where(live, sc, NEG_INF)


def invert(block_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, K) block ids as one list of entries a table block: ``keys``
    (B·K,) int32, the ids sorted, and ``order`` (B·K,) int64, the flat
    index b·K + k of each, stably (a block's entries in the order of their
    flat index). Fixed sizes: no host sync."""
    return torch.sort(block_ids.view(-1).to(torch.int32), stable=True)


def _check_cuda_args(metric: str, d_pad: int, group: int, q: QuantizedU8, store: QuantizedU8, valid: torch.Tensor,
                     bin_s: torch.Tensor, block_ids: torch.Tensor) -> None:
    dev = store.data.device
    b, dp = q.data.shape
    rows = store.data.shape[0]
    k = block_ids.shape[-1]
    if metric not in METRIC_CODES:
        raise ValueError(f"u8_block_dot scores by {', '.join(METRIC_CODES)}, not {metric!r}")
    if group < 1 or rows % group:
        raise ValueError(f"group {group} must divide the table's {rows} rows")
    if dp % KERNEL_DP_MULTIPLE or dp > KERNEL_DP_MAX or not 0 <= d_pad <= KERNEL_DP_MAX:
        raise ValueError(f"the kernel takes Dp a multiple of {KERNEL_DP_MULTIPLE} up to {KERNEL_DP_MAX}, not "
                         f"{dp} (d_pad {d_pad})")
    f32, i32 = torch.float32, torch.int32
    for name, x, shape, dtype in (
        ("q.data", q.data, (b, dp), torch.int8), ("q.sums", q.sums, (b,), i32), ("q.mags", q.mags, (b,), f32),
        ("q.a", q.a, (), f32), ("q.b", q.b, (), f32), ("q.dtrue", q.dtrue, (), f32),
        ("store.data", store.data, (rows, dp), torch.int8), ("store.sums", store.sums, (rows,), i32),
        ("store.mags", store.mags, (rows,), f32), ("valid", valid, (rows,), torch.bool),
        ("bin_s", bin_s, (b, k), f32), ("block_ids", block_ids, (b, k), torch.int64),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if q.data.data_ptr() % 16 or store.data.data_ptr() % 16:
        raise ValueError("the query codes and the code table must be 16-byte aligned")


def u8_block_dot(metric: str, d_pad: int, group: int, q: QuantizedU8, store: QuantizedU8, valid: torch.Tensor,
                 bin_s: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """(B, K·group) f32: entry [b, k·group + j] is the ``metric`` score of
    query b (``q``) with row ``block_ids[b, k]·group + j`` of the u8
    ``store``, NEG_INF where that row is not ``valid`` or ``bin_s[b, k]``
    sank; ``block_ids`` int64 (B, K), each in [0, rows / group).

    CPU tensors take :func:`block_scores_plain`; CUDA tensors launch the
    kernel (counted in ``u8_block_dot.launches``) or raise."""
    if store.data.device.type == "cpu":
        return block_scores_plain(metric, d_pad, group, q, store, valid, bin_s, block_ids)
    _check_cuda_args(metric, d_pad, group, q, store, valid, bin_s, block_ids)
    b, k = block_ids.shape
    rows = store.data.shape[0]
    out = torch.empty((b, k * group), dtype=torch.float32, device=store.data.device)
    if out.numel() == 0:
        return out
    keys, order = invert(block_ids)
    with torch.cuda.device(store.data.device):
        LIBRARY.launch(METRIC_CODES[metric], *(x.data_ptr() for x in (q.data, q.sums, q.mags, q.a, q.b, q.dtrue,
                                                                      store.data, store.sums, store.mags, valid)),
                       rows, bin_s.data_ptr(), keys.data_ptr(), order.data_ptr(), out.data_ptr(), b, k, group,
                       q.data.shape[1], d_pad, torch.cuda.current_stream().cuda_stream)
    u8_block_dot.launches += 1
    return out


u8_block_dot.launches = 0
