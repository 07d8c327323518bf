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


def bound(ops: float, nbytes: float, f32_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take for ``ops`` int8 operations
    and ``f32_ops`` float32 operations moving ``nbytes``: the largest of the
    three times, and whether operations or bytes set it."""
    t_ops = max(ops / INT8_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
