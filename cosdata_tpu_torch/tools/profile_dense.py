"""Where a dense b1024 batch of the PyTorch/CUDA port spends its device time.

Builds chip_smoke.py's 1,000,000 x 768 clustered corpus (seed 0) on the
card, mounts it in a u8 and a quaternary DenseIndexHandle, and runs
torch.profiler over a few b1024 searches of each. Prints, per handle, the
wall time per search, the device time per search (the sum of the
kernels' own times), the busy share, and the kernels that take the most
device time. Needs one CUDA card; run from the repository root:

    python3 -m cosdata_tpu_torch.tools.profile_dense [searches]
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from cosdata_tpu_torch.core.collection import DenseIndexHandle
from cosdata_tpu_torch.tools.measure import card_line, clustered

N, DIM, NQ, SEED, ADD_BATCH = 1_000_000, 768, 1024, 0, 131_072
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: this profile needs a CUDA card")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda")
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, q = clustered(N, NQ, DIM, gen, dev)
    for label, quant in (("u8", None), ("quaternary", {"type": "scalar", "data_type": "quaternary"})):
        handle = DenseIndexHandle(DIM, dev, quantization=quant)  # None: "auto", which picks u8 here
        for s in range(0, N, ADD_BATCH):
            e = min(s + ADD_BATCH, N)
            handle.add_batch(list(range(s, e)), x[s:e])
        profile_handle(f"{label} DenseIndexHandle {N} rows", handle, q, reps, card)
        del handle
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
