"""Sub-byte code dots by bitplane popcounts (kernel K2) and the sub-byte
scores built on them.

Port of cosdata_tpu/ops/pallas/subbyte_scan.py. The CUDA kernel lives in
``cosdata_tpu_torch/csrc/subbyte_code_scores.cu``, built by ``nvcc`` for
``sm_90a`` at first use (ops/kernels/nvcc.py). It takes the query's packed
planes, not its unpacked codes as the Pallas kernel does, so query and
store share one layout. :func:`subbyte_code_scores` takes the plain version
for CPU tensors and launches the kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops.distance import code_matmul, safe_div
from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.quantize import QuantizedSubByte, subbyte_values

LIBRARY = CudaLibrary(
    "subbyte_code_scores",
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
)


def subbyte_code_scores_plain(q_planes: torch.Tensor, planes: torch.Tensor, d: int) -> torch.Tensor:
    """Plain PyTorch version: unpack both sides to codes, then the exact
    code product (int32 on the CPU; on CUDA an f32 product with TF32 off,
    exact because every partial sum is at most 49·d < 2^24)."""
    return code_matmul(subbyte_values(q_planes, d), subbyte_values(planes, d))


def _check_cuda_args(q_planes: torch.Tensor, planes: torch.Tensor, d: int) -> None:
    res, c, w = planes.shape
    if res not in (1, 2, 3):
        raise ValueError(f"subbyte_code_scores takes 1, 2 or 3 planes, not {res}")
    if q_planes.ndim != 3 or q_planes.shape[0] != res or q_planes.shape[2] != w:
        raise ValueError(f"bad shapes: q_planes {tuple(q_planes.shape)}, planes {tuple(planes.shape)}")
    if d != 32 * w:
        raise ValueError(f"d={d} must be 32 x the word count {w}")
    for name, x in (("q_planes", q_planes), ("planes", planes)):
        if x.device != planes.device or x.dtype != torch.int32:
            raise ValueError(f"{name}: want int32 on {planes.device}, got {x.dtype} on {x.device}")
        # rows contiguous within a plane; the plane stride is passed through
        if x.stride(2) != 1 or x.stride(1) != w or x.data_ptr() % 4:
            raise ValueError(f"{name}: rows must be contiguous 4-byte-aligned words, strides {x.stride()}")


def subbyte_code_scores(q_planes: torch.Tensor, planes: torch.Tensor, d: int) -> torch.Tensor:
    """(B, C) int32 code dots Σ qcode·vcode from q_planes (res, B, W) and
    planes (res, C, W), both int32 words of the strided pack.

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
    with torch.cuda.device(planes.device):
        LIBRARY.launch(
            res, q_planes.data_ptr(), q_planes.stride(0), planes.data_ptr(), planes.stride(0),
            out.data_ptr(), b, c, w, torch.cuda.current_stream().cuda_stream,
        )
    subbyte_code_scores.launches += 1
    return out


subbyte_code_scores.launches = 0


def subbyte_scores(metric: str, q: QuantizedSubByte, store: QuantizedSubByte, d: int) -> torch.Tensor:
    """(B, C) dequantized (bucket-centre) similarity, in the reference's op
    order: ``a²·code_dot + a·b·(s_q + s_v) + b²·d_true``, then the cosine
    division for ``metric="cosine"``."""
    code_dot = subbyte_code_scores(q.planes, store.planes, d).to(torch.float32)
    dot = (
        q.a * q.a * code_dot
        + q.a * q.b * (q.sums.to(torch.float32)[:, None] + store.sums.to(torch.float32)[None, :])
        + q.b * q.b * q.dtrue
    )
    if metric == "dot":
        return dot
    return safe_div(dot, q.mags[:, None] * store.mags[None, :])
