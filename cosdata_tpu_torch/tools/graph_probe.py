"""Where the HNSW graph's time goes: the bulk build's stages, the
insertion waves, and batched graph searches, on one index of clustered
rows (1M x 768 u8 by default, the reference's bench row).

Run from the repository root on a machine with one CUDA card:

    python3 -m cosdata_tpu_torch.tools.graph_probe [--n N] [--dim D] [--kind u8]

It ingests ``n - 16384`` rows in one ``add`` (the bulk build), searches
once (the scan's capacity step), ingests the last 16,384 rows (16
insertion waves of 1,024), then searches ``q[:1024]`` at ef 128, 256 and
512 (recall@10 against the exact f32 oracle; median of 5 runs) and 8
single queries at ef 128, and profiles one ef-128 batch. Each build stage
is timed with the card synchronised around it. ``--device cpu`` rehearses
the control flow at a small size; its times are not the card's.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from cosdata_tpu_torch.core.collection import tune_dense_range
from cosdata_tpu_torch.indexes import hnsw as H
from cosdata_tpu_torch.ops import hnsw_kernels as HK
from cosdata_tpu_torch.tools.measure import clustered

WAVE_ROWS = 16384


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_timers(dev) -> dict:
    """Wrap the build's stages so each call is timed with the card
    synchronised around it; returns {stage: [seconds, calls]}."""
    spent: dict = {}

    def wrap(owner, name):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            rec = spent.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - t0
            rec[1] += 1
            return out

        setattr(owner, name, timed)

    for owner, name in (
        (H.HNSWIndex, "_rp_order"), (HK, "leaf_knn_gather"), (H, "_prune_candidates"), (HK, "finalize_level0"),
        (HK, "upper_level_exact"), (HK, "upper_level_apply"), (H.HNSWIndex, "_search_levels"),
        (HK, "wave_scores"), (HK, "pairwise_scores"), (HK, "select_diverse"), (H.HNSWIndex, "_apply_back_edges"),
    ):
        wrap(owner, name)
    return spent


def recall10(ids, truth: torch.Tensor) -> float:
    ids = torch.as_tensor(ids, device=truth.device)
    return (ids[:, :, None] == truth[:, None, :]).any(-1).sum().item() / truth.numel()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--kind", default="u8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA card")
    if dev.type == "cuda":
        from cosdata_tpu_torch.tools.measure import card_line

        card = card_line()
    else:
        card = "CPU rehearsal, not a device measurement"
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, q = clustered(args.n, 1024, args.dim, gen, dev)
    q = q[:1024]
    torch.backends.cuda.matmul.allow_tf32 = False
    truth = torch.cat([torch.topk(q[s : s + 256] @ x.T, 10, dim=1).indices for s in range(0, len(q), 256)])
    # the range an "auto" handle tunes on the rows
    idx = H.HNSWIndex(args.dim, dev, kind=args.kind, range_=tune_dense_range(x[:10000].cpu().numpy()))
    spent = stage_timers(dev)
    n_bulk = args.n - WAVE_ROWS
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx.add(x[:n_bulk])
    _sync(dev)
    t_bulk = time.perf_counter() - t0
    print(f"bulk build of {n_bulk} rows: {t_bulk:.2f} s ({idx.last_build_stats}); levels {idx.level_counts.tolist()}"
          f" [{card}]", flush=True)
    for name, (s, c) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {s:.3f} s in {c} calls", flush=True)
    spent.clear()
    idx.search_brute(q[:8], 10)  # the scan's capacity step, as a first search makes it
    t0 = time.perf_counter()
    idx.add(x[n_bulk:])
    _sync(dev)
    t_waves = time.perf_counter() - t0
    print(f"16 waves of 1024: {t_waves:.2f} s = {t_waves / 16 * 1e3:.1f} ms per wave [{card}]", flush=True)
    for name, (s, c) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {s:.3f} s in {c} calls", flush=True)
    adj = sum(t.numel() * t.element_size() for t in (idx.adj0, idx.adj0_d, idx.up_adj, idx.up_d))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    print(f"adjacency bytes {adj}; store bytes {idx.store.device_nbytes()}; capacity {idx.cap}; "
          f"peak allocated {peak} B [{card}]", flush=True)
    for ef in (128, 256, 512):
        idx.search(q, 10, ef=ef)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            ids, _ = idx.search(q, 10, ef=ef)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        print(f"search ef={ef} b1024: recall@10 {recall10(ids, truth):.4f}, {t * 1e3:.1f} ms/batch, "
              f"{1024 / t:.0f} qps [{card}]", flush=True)
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        idx.search(q[i : i + 1], 10, ef=128)
        lat.append(time.perf_counter() - t0)
    print(f"8 single queries at ef=128: median {statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms "
          f"[{card}]", flush=True)
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        from cosdata_tpu_torch.tools.profile_dense import device_us

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            idx.search(q, 10, ef=128)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(device_us(e) for e in kernels) / 1e3
        print(f"profile ef=128 b1024: wall {wall:.1f} ms, device {busy:.1f} ms, busy {busy / wall:.1%} [{card}]")
        for e in sorted(kernels, key=device_us, reverse=True)[:12]:
            print(f"  {device_us(e) / 1e3:8.2f} ms x{e.count:<5d} {e.key[:110]}")


if __name__ == "__main__":
    main()
