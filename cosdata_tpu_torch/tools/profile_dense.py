"""Where a dense b1024 batch of the PyTorch/CUDA port spends its device time.

Builds chip_smoke.py's 1,000,000 x 768 clustered corpus (seed 0) on the
card, mounts it in a u8 and a quaternary DenseIndexHandle, and runs
torch.profiler over a few b1024 searches of each. Prints, per handle, the
wall time per search, the device time per search (the sum of the
kernels' own times), the busy share, and the kernels that take the most
device time. Needs one CUDA card; run from the repository root:

    python3 -m cosdata_tpu_torch.tools.profile_dense [searches] [--shards S]

``--shards S`` profiles chip_smoke.py phase 21a's engine in their place: a
u8 handle of S shards over the card's devices (range tuned on the first
1,000 rows), filled with all but 4,096 rows in one call and then 4,096
more, and adds the median wall time of 5 unprofiled searches and of 3
searches under a 50% row mask. To time another checkout's package with
this file, run it as a script with that checkout on the path:
``PYTHONPATH=CHECKOUT python3 cosdata_tpu_torch/tools/profile_dense.py
--shards 4`` (the first line printed names the package's directory).
"""

from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import cosdata_tpu_torch
from cosdata_tpu_torch.core.collection import DenseIndexHandle, tune_dense_range
from cosdata_tpu_torch.tools.measure import card_line, clustered

N, DIM, NQ, SEED, ADD_BATCH = 1_000_000, 768, 1024, 0, 131_072
#: rows the sharded handle takes after its bulk build (one wave per shard)
WAVE_ROWS = 4096
TOP = 12


def device_us(evt) -> float:
    """An event's own device time in microseconds (torch renamed the field)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_handle(name: str, handle: DenseIndexHandle, q: torch.Tensor, reps: int, card: str) -> None:
    handle.search(q, 10)  # warm-up: kernel builds, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            handle.search(q, 10)  # returns host arrays, so each search ends synchronized
        wall = (time.perf_counter() - t0) / reps
    # kernels only: their own device time, not the CPU-side ops that launched them
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels) / reps / 1e3
    print(f"{name} b{len(q)}: wall {wall * 1e3:.2f} ms/search (under the profiler), device {total:.2f} ms/search, "
          f"busy {total / (wall * 1e3):.1%} [{card}]")
    for e in sorted(kernels, key=device_us, reverse=True)[:TOP]:
        ms = device_us(e) / reps / 1e3
        print(f"  {ms:8.3f} ms  {ms / total:6.1%}  x{e.count // reps:<4d} {e.key[:110]}")


def median_ms(fn, reps: int) -> float:
    """Median wall ms of ``fn`` (a search that returns host arrays) after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_sharded(shards: int, x: torch.Tensor, q: torch.Tensor, reps: int, card: str) -> None:
    lo, hi = tune_dense_range(x[:1000].cpu().numpy())
    handle = DenseIndexHandle(DIM, x.device, shards=shards,
                              quantization={"type": "scalar", "data_type": "u8", "range": {"min": lo, "max": hi}})
    t0 = time.perf_counter()
    handle.add_batch(list(range(N - WAVE_ROWS)), x[:-WAVE_ROWS])  # a bulk build per shard
    handle.add_batch(list(range(N - WAVE_ROWS, N)), x[-WAVE_ROWS:])  # one insertion wave per shard
    for d in set(handle.index.devices):
        torch.cuda.synchronize(d)
    mask = np.zeros(N, bool)
    mask[::2] = True
    print(f"sharded u8 handle, {shards} shards on {[str(d) for d in handle.index.devices]}: built in "
          f"{time.perf_counter() - t0:.2f} s; b{len(q)} wall {median_ms(lambda: handle.search(q, 10), 5):.2f} "
          f"ms/search (median of 5), 50% masked {median_ms(lambda: handle.search(q, 10, row_mask=mask), 3):.2f} "
          f"[{card}]")
    profile_handle(f"sharded u8 DenseIndexHandle {N} rows", handle, q, reps, card)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("searches", nargs="?", type=int, default=3, help="profiled searches per handle")
    parser.add_argument("--shards", type=int, default=0, help="profile a u8 handle of this many shards instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: this profile needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(f"package: {Path(cosdata_tpu_torch.__file__).parent}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, q = clustered(N, NQ, DIM, gen, dev)
    if args.shards:
        profile_sharded(args.shards, x, q, args.searches, card)
        return
    for label, quant in (("u8", None), ("quaternary", {"type": "scalar", "data_type": "quaternary"})):
        handle = DenseIndexHandle(DIM, dev, quantization=quant)  # None: "auto", which picks u8 here
        for s in range(0, N, ADD_BATCH):
            e = min(s + ADD_BATCH, N)
            handle.add_batch(list(range(s, e)), x[s:e])
        profile_handle(f"{label} DenseIndexHandle {N} rows", handle, q, args.searches, card)
        del handle
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
