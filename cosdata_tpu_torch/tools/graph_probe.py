"""Where the HNSW graph's time goes: the bulk build's stages, the
insertion waves, and batched graph searches, on one index of clustered
rows (1M x 768 u8 by default, the reference's bench row).

Run from the repository root on a machine with one CUDA card:

    python3 -m cosdata_tpu_torch.tools.graph_probe [--n N] [--dim D] [--kind u8]
        [--metric cosine|euclidean] [--scale] [--keep-raw device|host] [--no-profile]
        [--set NAME=VALUE ...] [--param NAME=VALUE ...] [--range LO,HI] [--hostcodes]

It ingests ``n - 16384`` rows in one ``add`` (the bulk build), searches
once (the scan's capacity step) and at ef 128, ingests the last 16,384
rows (16 insertion waves of 1,024), then searches ``q[:1024]`` at ef 128,
256 and 512 (recall@10 against the exact f32 oracle of the metric; median
of 5 runs; beside it the recall of the unreranked 50-row shortlist the
rerank takes, queries by hits, and the exact scan's recall), the level-0
in-degrees and the rows a walk from the entry reaches, 8 single queries at
ef 128, and profiles one ef-128 batch. ``--scale`` multiplies each row by
a seeded factor in [0.5, 1.5], so that euclidean ranks unlike cosine;
``--set`` overrides an integer build setting of ``HNSWIndex``
(``RP_TREES``, ``EUCLIDEAN_RP_TREES``, ``EUCLIDEAN_REPRUNE``,
``NN_DESCENT_ROUNDS``, ``RP_THRESHOLD``, ...) and ``--param`` a field of
``HNSWParams`` (``max_iters``, ``ef_upper``, ...) for this run; ``--range``
replaces the u8 range an "auto" handle would tune on the rows;
``--hostcodes`` (with ``--keep-raw host``) ends by searching level 0 alone
from the entry and 31, 255 and 2,047 random seeds. Each build stage
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


def reached(idx) -> torch.Tensor:
    """Rows a breadth-first walk over the level-0 edges reaches from the entry."""
    adj = idx.adj0[: idx.n].long()
    seen = torch.zeros(idx.n, dtype=torch.bool, device=adj.device)
    frontier = torch.tensor([idx.entry], device=adj.device)
    seen[frontier] = True
    while frontier.numel():
        nb = adj[frontier].reshape(-1)
        nb = torch.unique(nb[nb >= 0])
        frontier = nb[~seen[nb]]
        seen[frontier] = True
    return seen


def recall10(ids, truth: torch.Tensor) -> float:
    ids = torch.as_tensor(ids, device=truth.device)
    return (ids[:, :, None] == truth[:, None, :]).any(-1).sum().item() / truth.numel()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--kind", default="u8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metric", default="cosine")
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--keep-raw", default="device")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--param", action="append", default=[])
    ap.add_argument("--range", default=None)
    ap.add_argument("--hostcodes", action="store_true")
    args = ap.parse_args()
    params = H.HNSWParams()
    for item in args.param:
        name, value = item.split("=")
        setattr(params, name, type(getattr(params, name))(value))
    for item in args.set:
        name, value = item.split("=")
        if not isinstance(getattr(H.HNSWIndex, name), int):
            raise SystemExit(f"FAIL: HNSWIndex.{name} is not an integer setting")
        setattr(H.HNSWIndex, name, int(value))
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
    if args.scale:
        x = x * (torch.rand((args.n, 1), generator=gen, device=dev) + 0.5)
    torch.backends.cuda.matmul.allow_tf32 = False

    def oracle(rows):
        """The exact f32 top-10 of ``rows`` by the metric (euclidean: the
        least distance, the largest 2 q·x - |x|²)."""
        if args.metric == "euclidean":
            sc = lambda qq: 2.0 * (qq @ rows.T) - (rows * rows).sum(1)  # noqa: E731
        else:
            unit = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)
            sc = lambda qq: qq @ unit.T  # noqa: E731
        return torch.cat([torch.topk(sc(q[s : s + 256]), 10, dim=1).indices for s in range(0, len(q), 256)])

    truth = oracle(x)
    # the range an "auto" handle tunes on the rows
    keep_raw = True if args.keep_raw == "device" else args.keep_raw
    rng = tuple(map(float, args.range.split(","))) if args.range else tune_dense_range(x[:10000].cpu().numpy())
    idx = H.HNSWIndex(args.dim, dev, metric=args.metric, kind=args.kind, keep_raw=keep_raw, params=params,
                      range_=rng)
    print(f"metric {args.metric}, rows scaled {args.scale}, raw rows {args.keep_raw}, range {idx.store.range}, "
          f"settings {args.set}, params {args.param}", flush=True)
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
    ids, _ = idx.search(q, 10, ef=128)
    print(f"the bulk-built graph alone, ef=128 b1024: recall@10 {recall10(ids, oracle(x[:n_bulk])):.4f} "
          f"[{card}]", flush=True)
    t0 = time.perf_counter()
    idx.add(x[n_bulk:])
    _sync(dev)
    t_waves = time.perf_counter() - t0
    print(f"16 waves of 1024: {t_waves:.2f} s = {t_waves / 16 * 1e3:.1f} ms per wave [{card}]", flush=True)
    for name, (s, c) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {s:.3f} s in {c} calls", flush=True)
    print(f"level-0 walk from the entry reaches {int(reached(idx).sum())} of {idx.n} rows [{card}]", flush=True)
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
        short, _ = idx.search(q, 50, ef=ef, rerank=False)
        hits = (torch.as_tensor(ids, device=dev)[:, :, None] == truth[:, None, :]).any(1)  # (B, 10) found
        per_q = hits.sum(1)
        norms = torch.linalg.vector_norm(x[truth], dim=-1)
        print(f"search ef={ef} b1024: recall@10 {recall10(ids, truth):.4f}, {t * 1e3:.1f} ms/batch, "
              f"{1024 / t:.0f} qps; the truth in the unreranked 50-row shortlist {recall10(short, truth):.4f}; "
              f"queries with 10 / 5-9 / 0-4 hits {int((per_q == 10).sum())} / "
              f"{int(((per_q >= 5) & (per_q < 10)).sum())} / {int((per_q < 5).sum())}; mean norm of the missed "
              f"truth rows {float(norms[~hits].mean()) if (~hits).any() else 0.0:.3f}, of all "
              f"{float(norms.mean()):.3f} [{card}]", flush=True)
    ids, _ = idx.search_brute(q, 10)
    print(f"the exact scan b1024: recall@10 {recall10(ids, truth):.4f} [{card}]", flush=True)
    # level-0 in-degrees: a row no list points to is reached only as an entry
    adj = idx.adj0[: idx.n].long()
    indeg = torch.bincount(adj[adj >= 0], minlength=idx.n)
    ids, _ = idx.search(q, 10, ef=256)
    hits = (torch.as_tensor(ids, device=dev)[:, :, None] == truth[:, None, :]).any(1)
    miss = truth[~hits]
    print(f"level-0 in-degree: rows with none {int((indeg == 0).sum())} of {idx.n}, median "
          f"{float(indeg.float().median()):.0f}, max {int(indeg.max())}; the rows ef=256 missed: {miss.numel()}, "
          f"with no in-edge {int((indeg[miss] == 0).sum())}, median in-degree "
          f"{float(indeg[miss].float().median()) if miss.numel() else 0.0:.0f}; out-degree median "
          f"{float((adj >= 0).sum(1).float().median()):.0f} [{card}]", flush=True)
    if args.hostcodes:
        # level 0 alone, from the entry and random seeds (the host-codes beam)
        idx.force_spill(keep_graph=True)
        for seeds in (32, 256, 2048):
            idx.HOSTCODES_SEEDS = seeds
            for ef in (128, 256):
                ids, _ = idx.search(q[:256], 10, ef=ef, rerank=False)
                print(f"level 0 from the entry and {seeds - 1} random seeds, ef={ef} b256 (u8 order, no rerank): "
                      f"recall@10 {recall10(ids, truth[:256]):.4f} [{card}]", flush=True)
        return
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        idx.search(q[i : i + 1], 10, ef=128)
        lat.append(time.perf_counter() - t0)
    print(f"8 single queries at ef=128: median {statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms "
          f"[{card}]", flush=True)
    if dev.type == "cuda" and not args.no_profile:
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
