"""Stage 4 of the u8 scan: exact int8 dots of each query's codes with the
rows of its winning blocks, read in place from the code table (kernel
``u8_block_dot``).

The CUDA kernel lives in ``cosdata_tpu_torch/csrc/u8_block_dot.cu`` (each
thread's share of the dots in ``u8_block_dot.cuh``), built by ``nvcc`` for
``sm_90a`` at first use (ops/kernels/nvcc.py). It replaces no TPU kernel:
on the TPU the step is XLA's gather of the blocks and grouped int8 einsum
(``cosdata_tpu/ops/flat_scan.py``, ``exp_body``). The plain version beside
it gathers the blocks and takes ``distance.diag_code_dot`` of them. The
wrapper takes the plain version for CPU tensors and launches the kernel for
CUDA tensors, or raises.

Block k of query b is ``group`` contiguous rows of the (rows, Dp) table,
starting at row ``block_ids[b, k] * group``: the scan's 32-row bins, or
single rows with ``group`` 1.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops.distance import diag_code_dot
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("u8_block_dot", {"launch": [_P, _P, _L, _P, _P, _I, _I, _I, _I, _P]})
#: the kernel's Dp granularity (8 lanes of 16 bytes) and its widest Dp
#: (every int32 sum exact: 2^14 Dp < 2^31)
KERNEL_DP_MULTIPLE = 128
KERNEL_DP_MAX = (1 << 17) - KERNEL_DP_MULTIPLE
#: bytes of the f32 copy of the gathered blocks that the plain version may
#: hold at once (it runs over slices of the queries)
PLAIN_BYTES = 1 << 30


def u8_block_dot_plain(q_codes: torch.Tensor, codes: torch.Tensor, block_ids: torch.Tensor,
                       group: int) -> torch.Tensor:
    """Plain PyTorch version: the blocks gathered, then
    :func:`distance.diag_code_dot`, over slices of the queries."""
    b, k = block_ids.shape
    dp = q_codes.shape[1]
    out = torch.empty((b, k * group), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    blocks = codes.view(-1, group * dp)
    step = max(1, PLAIN_BYTES // (k * group * dp * 4))
    for s in range(0, b, step):
        e = min(s + step, b)
        out[s:e] = diag_code_dot(q_codes[s:e], blocks[block_ids[s:e]].view(e - s, k * group, dp))
    return out


def _check_cuda_args(q_codes: torch.Tensor, codes: torch.Tensor, block_ids: torch.Tensor, group: int) -> None:
    dev = codes.device
    b, dp = q_codes.shape
    rows = codes.shape[0]
    if group < 1 or rows % group:
        raise ValueError(f"group {group} must divide the table's {rows} rows")
    if dp % KERNEL_DP_MULTIPLE or dp > KERNEL_DP_MAX:
        raise ValueError(f"the kernel takes Dp a multiple of {KERNEL_DP_MULTIPLE} up to {KERNEL_DP_MAX}, not {dp}")
    for name, x, shape, dtype in (("q_codes", q_codes, (b, dp), torch.int8), ("codes", codes, (rows, dp), torch.int8),
                                  ("block_ids", block_ids, (b, block_ids.shape[-1]), torch.int64)):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if q_codes.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("the query codes and the code table must be 16-byte aligned")


def u8_block_dot(q_codes: torch.Tensor, codes: torch.Tensor, block_ids: torch.Tensor, group: int) -> torch.Tensor:
    """(B, K·group) int32: entry [b, k·group + j] is the exact dot of
    ``q_codes[b]`` (int8 (B, Dp)) with row ``block_ids[b, k]·group + j`` of
    ``codes`` (int8 (rows, Dp)); ``block_ids`` int64 (B, K), each in
    [0, rows / group) (the kernel reads nothing for an id outside and
    writes 0).

    CPU tensors take :func:`u8_block_dot_plain`; CUDA tensors launch the
    kernel (counted in ``u8_block_dot.launches``) or raise."""
    if codes.device.type == "cpu":
        return u8_block_dot_plain(q_codes, codes, block_ids, group)
    _check_cuda_args(q_codes, codes, block_ids, group)
    b, k = block_ids.shape
    out = torch.empty((b, k * group), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(codes.device):
        LIBRARY.launch(q_codes.data_ptr(), codes.data_ptr(), codes.shape[0], block_ids.data_ptr(), out.data_ptr(),
                       b, k, group, q_codes.shape[1], torch.cuda.current_stream().cuda_stream)
    u8_block_dot.launches += 1
    return out


u8_block_dot.launches = 0
