"""Measuring on the card: its name and power limit, kernel times by CUDA
events, the least time the card could take for a piece of work, and the
clustered corpus the smoke and the profiles search. Used by
``chip_smoke.py`` and the tools beside this module; nothing here touches
the card at import."""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls run back
    to back (CUDA events). A spin kernel queued first keeps the card busy
    while the host enqueues the calls, so host time between calls is not
    counted; a warm-up call comes first."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: published H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor-core
#: operations per second, float32 operations per second outside the tensor
#: cores and device-memory bytes per second
INT8_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S = 1979e12, 67e12, 3.35e12
#: int8 operations per second by ``__dp4a`` outside the tensor cores, which
#: no data sheet gives: taken as 64 a clock on each of the 132 SMs (an SM's
#: 64 INT32 lanes), each 4 multiply-adds (8 operations), at the 1,980 MHz
#: boost clock
DP4A_OPS_PER_S = 132 * 64 * 8 * 1.98e9


def bound(ops: float, nbytes: float, f32_ops: float = 0.0, dp4a_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take for ``ops`` int8 tensor-core
    operations, ``f32_ops`` float32 and ``dp4a_ops`` int8 ``__dp4a``
    operations moving ``nbytes``: the largest of the times, and whether
    operations or bytes set it."""
    t_ops = max(ops / INT8_OPS_PER_S, f32_ops / F32_OPS_PER_S, dp4a_ops / DP4A_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_dot_bytes(block_ids: torch.Tensor, group: int, dp: int) -> tuple[int, int]:
    """The bytes stage 4 (``kernels/u8_block_dot.py``: the int8 dots, the
    dequantisation, the metric and the mask in one kernel) must move for
    (B, K) ``block_ids`` of ``group`` rows of ``dp`` bytes: each distinct
    block read once, its rows' codes with their int32 sums, f32 magnitudes
    and valid bytes; the query codes with their sums and magnitudes; each
    slot's int64 id and f32 bin maximum (its live flag); the (B, K·group)
    f32 scores written. Then the same with each query reading its own
    blocks, what a design without reuse across queries reads."""
    b, k = block_ids.shape
    fixed = b * (dp + 8) + 12 * b * k + 4 * b * k * group
    block = group * (dp + 9)
    distinct = int(torch.unique(block_ids).numel())
    return distinct * block + fixed, b * k * block + fixed


def clustered(n: int, nq: int, d: int, gen: torch.Generator, dev, *more: int):
    """bench.py's gen_clustered formula: n//100 unit centres, noise 0.5/sqrt(d), unit rows:
    n corpus rows, nq queries, then one more batch of queries per entry of ``more``."""
    n_clusters = max(n // 100, 16)
    centers = torch.randn((n_clusters, d), generator=gen, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    noise = float(np.float32(0.5 / np.sqrt(d)))

    def rows(m):
        x = torch.randn((m, d), generator=gen, device=dev) * noise
        x += centers[torch.randint(0, n_clusters, (m,), generator=gen, device=dev)]
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    return (rows(n), rows(nq), *(rows(m) for m in more))


def quaternary_scan_merges(x: torch.Tensor, q: torch.Tensor, k: int, visit, chunk: int = 1 << 16) -> None:
    """Runs ``ops/flat_scan.py:flat_scan_topk`` itself, as a quaternary
    cosine scan of the rows ``x`` (n, d) for the queries ``q`` (both
    quantized as ``storage.quantize_batch`` quantizes them; a capacity of
    whole chunks, the rows past n masked), and calls ``visit(chunk index,
    scores, gmax, top_s, top_i, start)`` with each group_topk merge's inputs
    before the merge runs: K2's fused scores and maxima and the running
    top-k, empty before the first. Imports the package when called, so that
    a tool may take it from another checkout."""
    from cosdata_tpu_torch.ops import flat_scan, storage
    from cosdata_tpu_torch.ops.kernels import group_topk

    n, d = x.shape
    capacity = -(-n // chunk) * chunk
    store = storage.quantize_batch(torch.nn.functional.pad(x, (0, 0, 0, capacity - n)), None, None, "subbyte", 2, d)
    qs = storage.quantize_batch(q, None, None, "subbyte", 2, d)
    valid = torch.arange(capacity, device=x.device) < n

    def merge(scores, gmax, top_s, top_i, start):
        visit(start // chunk, scores, gmax, top_s, top_i, start)
        return group_topk.merge_group_topk(scores, gmax, top_s, top_i, start)

    flat_scan.flat_scan_topk("cosine", "subbyte", d, k, chunk, qs, store, valid, merge=merge)


def group_topk_bytes(gmax: torch.Tensor, out_s: torch.Tensor) -> int:
    """The bytes one group_topk merge must move: the group maxima and the
    running top (f32 values, int64 ids) read, the new top written, and the
    32 scores of every group whose maximum reaches its row's new k-th value
    (no other group holds a row of the result)."""
    b, g = gmax.shape
    kth = out_s.min(dim=1, keepdim=True).values
    return 4 * b * g + 2 * 12 * out_s.numel() + 4 * 32 * int((gmax >= kth).sum())
