"""One chunk's step of the sub-byte scan's running top-k, from K2's fused
output (kernel ``group_topk``).

The CUDA kernel lives in ``cosdata_tpu_torch/csrc/group_topk.cu``, built by
``nvcc`` for ``sm_90a`` at first use (ops/kernels/nvcc.py). It replaces no
TPU kernel: on the TPU the step is XLA's per-chunk selection and merge in
``cosdata_tpu/ops/flat_scan.py:flat_scan_topk``. The wrapper takes the
plain version for CPU tensors and launches the kernel for CUDA tensors, or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from cosdata_tpu_torch.ops.kernels.nvcc import CudaLibrary
from cosdata_tpu_torch.ops.kernels.subbyte_scan import GROUP
from cosdata_tpu_torch.ops.topk import NEG_INF

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("group_topk", {"launch": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P, _P]})


def group_topk(scores: torch.Tensor, gmax: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k (scores, rows) of (B, C) ``scores``, in no order, from
    their (B, ceil(C / GROUP)) group maxima ``gmax``: the k best groups'
    rows are gathered and cut to their top k (k <= C). Exact up to ties: a
    row of the top k lying outside the k best groups would be outscored by
    k distinct rows, one in each of those groups."""
    b, c = scores.shape
    _, g_ids = torch.topk(gmax, min(k, gmax.shape[1]), dim=1, sorted=False)
    rows = (g_ids[:, :, None] * GROUP + torch.arange(GROUP, device=scores.device)).view(b, -1)
    if c % GROUP:  # the ragged last group's missing rows score NEG_INF
        cand = torch.where(rows < c, torch.gather(scores, 1, rows.clamp_max(c - 1)), NEG_INF)
    else:
        cand = torch.gather(scores, 1, rows)
    vals, pos = torch.topk(cand, k, dim=1, sorted=False)
    return vals, torch.gather(rows, 1, pos)


def merge_group_topk_plain(scores: torch.Tensor, gmax: torch.Tensor, top_s: torch.Tensor, top_i: torch.Tensor,
                           start: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`merge_group_topk`: the chunk's top-k by
    :func:`group_topk`, then the top k of it and the running entries."""
    k = top_s.shape[1]
    c_s, c_i = group_topk(scores, gmax, min(k, scores.shape[1]))
    vals, pos = torch.topk(torch.cat([top_s, c_s], dim=1), k, dim=1, sorted=False)
    return vals, torch.gather(torch.cat([top_i, c_i + start], dim=1), 1, pos)


def merge_group_topk(scores: torch.Tensor, gmax: torch.Tensor, top_s: torch.Tensor, top_i: torch.Tensor,
                     start: int, survivors: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of the running top-k (``top_s`` (B, k) f32 values,
    ``top_i`` (B, k) int64 ids) and a chunk's rows, taken from its k best
    32-row groups: ``scores`` (B, C) and ``gmax`` (B, ceil(C / GROUP)) as
    :func:`subbyte_scan.subbyte_scores_fused` writes them, the chunk's row r
    having id ``start + r``. Returns the new (values, ids), in no order;
    exact up to ties.

    CPU tensors take :func:`merge_group_topk_plain`; CUDA tensors launch the
    kernel (counted in ``merge_group_topk.launches``) or raise. The kernel
    writes each row's survivors (the candidates at or above its floor) and
    its buffer's capacity into ``survivors`` (B, 2) int32, where one is
    given: a row with more survivors than that took its route over memory.
    The plain version has no survivors; CPU tensors refuse the argument."""
    if scores.device.type == "cpu":
        if survivors is not None:
            raise ValueError("survivors: the plain version has none")
        return merge_group_topk_plain(scores, gmax, top_s, top_i, start)
    b, c = scores.shape
    k = top_s.shape[1]
    dev = scores.device
    args = [("scores", scores, (b, c), torch.float32), ("gmax", gmax, (b, -(-c // GROUP)), torch.float32),
            ("top_s", top_s, (b, k), torch.float32), ("top_i", top_i, (b, k), torch.int64)]
    if survivors is not None:
        args.append(("survivors", survivors, (b, 2), torch.int32))
    for name, x, shape, dtype in args:
        if x.shape != shape or x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    out_s = torch.empty_like(top_s)
    out_i = torch.empty_like(top_i)
    if b == 0 or k == 0:
        return out_s, out_i
    with torch.cuda.device(dev):
        LIBRARY.launch(scores.data_ptr(), gmax.data_ptr(), top_s.data_ptr(), top_i.data_ptr(), out_s.data_ptr(),
                       out_i.data_ptr(), b, c, gmax.shape[1], k, start,
                       None if survivors is None else survivors.data_ptr(), torch.cuda.current_stream().cuda_stream)
    merge_group_topk.launches += 1
    return out_s, out_i


merge_group_topk.launches = 0
