"""Chip smoke of the PyTorch/CUDA port: dense exact-scan search at 1M x 768,
u8 and sub-byte.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases: 0 environment; 1 build both kernels (u8_bin_max, K1;
subbyte_code_scores, K2) from the checkout's sources, in parallel; 2 K1
against its plain PyTorch version at the u8 path's shapes; 3 the u8 path at
1M x 768 through DenseIndexHandle.search and FlatIndex.search, recall@10
against an exact f32 oracle and K1's launch count; 4 u8 search semantics;
5 K2 against its plain version, bit for bit; 6 the sub-byte path on the
same corpus through a quaternary DenseIndexHandle at 1M rows, recall@10 and
K2's launch count; 7 quaternary search semantics; 8 a quaternary FlatIndex
at 262,144 rows (the reference's bench row) at b1024 and b4096, then
binary, octal and f16 at b1024. Any failure exits non-zero. The last line
is one JSON object naming the device.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from cosdata_tpu_torch.core.collection import DenseIndexHandle, tune_dense_range
from cosdata_tpu_torch.indexes.flat import FlatIndex
from cosdata_tpu_torch.ops.kernels import subbyte_scan, u8_scan
from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8

SEED = 0
N, DIM, NQ = 1_000_000, 768, 4096
#: the reference's quaternary bench row (BENCH_r05.json, bench.py:777-805)
N_SUB = 262_144
ADD_BATCH = 131072
RTOL, ATOL = 2e-5, 1e-5
MIN_RECALL = 0.99


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
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


def clustered(n: int, nq: int, d: int, gen: torch.Generator, dev):
    """bench.py's gen_clustered formula: n//100 unit centres, noise 0.5/sqrt(d), unit rows."""
    n_clusters = max(n // 100, 16)
    centers = torch.randn((n_clusters, d), generator=gen, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    noise = float(np.float32(0.5 / np.sqrt(d)))

    def rows(m):
        x = torch.randn((m, d), generator=gen, device=dev) * noise
        x += centers[torch.randint(0, n_clusters, (m,), generator=gen, device=dev)]
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    return rows(n), rows(nq)


def exact_top10(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cat([torch.topk(q[s : s + 512] @ x.T, 10, dim=1).indices for s in range(0, len(q), 512)])


def recall10(ids, truth: torch.Tensor) -> float:
    ids = torch.as_tensor(ids, device=truth.device)
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    return hits / truth.numel()


def timed_search(fn, reps: int = 5) -> tuple[float, object]:
    """Median host seconds of a search that returns host arrays (so it syncs)."""
    out = fn()  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def kernel_check(gen, dev) -> tuple[float, float, float]:
    """Kernel vs plain at the listed shapes; returns (max_abs_err, ms, plain_ms)."""
    max_err = 0.0
    ms = plain_ms = None
    for c in (65_536, 1_048_576):
        for dp in (128, 768):
            d_true = dp - 28 if dp == 128 else dp
            x = torch.rand((c, dp), generator=gen, device=dev) * 2 - 1
            store = quantize_u8(x, -0.6, 0.7, d_true)
            del x
            valid = torch.ones(c, dtype=torch.bool, device=dev)
            valid[5] = False
            valid[c - 1000 :] = False  # ragged valid tail
            valid[c // 2 : c // 2 + 64] = False  # two whole invalid bins
            for b in (8, 1024, 4096):
                q = quantize_u8(torch.rand((b, dp), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, d_true)
                for metric in ("cosine", "dot"):
                    t = u8_scan.bin_max_terms(metric, q, store, valid, dp)
                    got = u8_scan.u8_bin_max(metric, 32, t)
                    want = u8_scan.u8_bin_max_plain(metric, 32, t)
                    torch.cuda.synchronize()
                    live = want > -1e37
                    if not bool((got[~live] < -1e37).all()):
                        fail(f"invalid bins not sunk at B={b} C={c} Dp={dp} {metric}")
                    err = (got[live] - want[live]).abs()
                    bad = err > ATOL + RTOL * want[live].abs()
                    e = float(err.max()) if err.numel() else 0.0
                    print(f"  B={b:5d} C={c:8d} Dp={dp:4d} {metric:6s} max_abs_err={e:.3g}", flush=True)
                    if bool(bad.any()):
                        fail(f"kernel disagrees with plain at B={b} C={c} Dp={dp} {metric}: {e}")
                    max_err = max(max_err, e)
                    if (b, c, dp, metric) == (1024, 1_048_576, 768, "cosine"):
                        # plain, kernel, kernel, plain in turns
                        p1 = cuda_ms(lambda: u8_scan.u8_bin_max_plain(metric, 32, t), 3)
                        k1 = cuda_ms(lambda: u8_scan.u8_bin_max(metric, 32, t), 5)
                        k2 = cuda_ms(lambda: u8_scan.u8_bin_max(metric, 32, t), 5)
                        p2 = cuda_ms(lambda: u8_scan.u8_bin_max_plain(metric, 32, t), 3)
                        ms, plain_ms = min(k1, k2), min(p1, p2)
                        print(f"  time at B=1024 C=1048576 Dp=768: kernel {k1:.3f}/{k2:.3f} ms, "
                              f"plain {p1:.3f}/{p2:.3f} ms", flush=True)
                    del t, got, want
            del store
            torch.cuda.empty_cache()
    return max_err, ms, plain_ms


def check_results(name: str, ids, truth: torch.Tensor, t: float, card: str, gate: bool) -> None:
    b = truth.shape[0]
    if ids.shape != (b, 10) or (ids < 0).any():
        fail(f"{name}: bad result shape {ids.shape} or missing ids")
    r = recall10(ids, truth)
    print(f"{name}: recall@10 {r:.4f}, {t * 1e3:.2f} ms/batch, {b / t:.1f} qps [{card}]", flush=True)
    if gate and r < MIN_RECALL:
        fail(f"{name}: recall@10 {r:.4f} < {MIN_RECALL}")


def reset_counts() -> None:
    u8_scan.u8_bin_max.launches = 0
    subbyte_scan.subbyte_code_scores.launches = 0


def main_path(x, q, truth, dev, card: str) -> int:
    """Phases 3 and 4; returns K1's launches during the u8 path."""
    t0 = time.perf_counter()
    handle = DenseIndexHandle(DIM, dev)  # quantization "auto"
    for s in range(0, N, ADD_BATCH):
        e = min(s + ADD_BATCH, N)
        handle.add_batch(list(range(s, e)), x[s:e])
    flat = FlatIndex(DIM, dev, kind="u8", range_=tune_dense_range(x[:1000].cpu().numpy()), raw_dtype="f16")
    for s in range(0, N, ADD_BATCH):
        flat.add(x[s : s + ADD_BATCH])
    torch.cuda.synchronize()
    print(f"ingest (both indexes) {time.perf_counter() - t0:.1f} s; handle range {handle.range}, "
          f"flat range {flat.store.range}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_h, (h_ids, _) = timed_search(lambda: handle.search(q[:1024], 10))
    t_f1, (f1_ids, _) = timed_search(lambda: flat.search(q[:1024], 10, rerank=True))
    t_f4, (f4_ids, _) = timed_search(lambda: flat.search(q, 10, rerank=True))
    launches = u8_scan.u8_bin_max.launches
    for name, ids, t, b in (
        ("DenseIndexHandle.search b1024", h_ids, t_h, 1024),
        ("FlatIndex.search(rerank) b1024", f1_ids, t_f1, 1024),
        ("FlatIndex.search(rerank) b4096", f4_ids, t_f4, 4096),
    ):
        check_results(name, ids, truth[:b], t, card, True)
    print(f"store bytes: handle {handle.index.store.device_nbytes()}, flat {flat.store.device_nbytes()}; "
          f"peak allocated during search {torch.cuda.max_memory_allocated()} B; "
          f"u8_bin_max launches {launches} [{card}]")
    if launches == 0:
        fail("the main path never launched u8_bin_max")

    phase("4 semantics")
    probe = [7, N // 3]
    ids, _ = handle.search(x[probe], 10)
    if ids[:, 0].tolist() != probe:
        fail(f"self-query returned {ids[:, 0].tolist()}, want {probe}")
    handle.delete(7)
    ids, _ = handle.search(x[probe], 10)
    if 7 in ids:
        fail("a deleted id came back")
    mask = np.zeros(handle.index.n, bool)
    mask[::20] = True
    ids, _ = handle.search(q[:64], 10, row_mask=mask)
    rows = np.asarray([handle.row_of[i] for i in ids[ids >= 0]])
    if (ids < 0).any() or not mask[rows].all():
        fail("masked search returned rows outside the mask")
    handle.flat_serve_threshold = handle.index.n - 1
    try:
        handle.search(q[:8], 10)
    except NotImplementedError as err:
        print(f"above flat_serve_threshold: NotImplementedError ({err})")
    else:
        fail("a search above flat_serve_threshold did not raise NotImplementedError")
    print("self-query, delete, mask: ok")
    return launches


def k2_check(gen, dev) -> tuple[int, float, float]:
    """K2 against its plain version, bit for bit, at the listed shapes;
    returns (max_abs_err, ms, plain_ms)."""
    max_err = 0
    ms = plain_ms = None
    for res in (1, 2, 3):
        for dp in (128, 768):
            d_true = dp - 28 if dp == 128 else dp
            x = torch.rand((65_536, dp), generator=gen, device=dev) * 2 - 1
            whole = quantize_subbyte(x, res, d_true)
            del x
            # the ragged C is a row chunk of the store: a strided view of its planes
            for planes in (whole.planes, whole.planes[:, 96:]):
                c = planes.shape[1]
                for b in (8, 1024, 4096):
                    q = quantize_subbyte(torch.rand((b, dp), generator=gen, device=dev) * 2 - 1, res, d_true)
                    got = subbyte_scan.subbyte_code_scores(q.planes, planes, dp)
                    want = subbyte_scan.subbyte_code_scores_plain(q.planes, planes, dp)
                    torch.cuda.synchronize()
                    e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                    print(f"  res={res} B={b:5d} C={c:6d} Dp={dp:4d} d_true={d_true:4d} max_abs_err={e}", flush=True)
                    if e != 0 or got.shape != (b, c):
                        fail(f"K2 disagrees with plain at res={res} B={b} C={c} Dp={dp}: {e}")
                    max_err = max(max_err, e)
                    if (res, b, c, dp) == (2, 1024, 65_536, 768):
                        # plain, kernel, kernel, plain in turns
                        p1 = cuda_ms(lambda: subbyte_scan.subbyte_code_scores_plain(q.planes, planes, dp), 5)
                        k1 = cuda_ms(lambda: subbyte_scan.subbyte_code_scores(q.planes, planes, dp), 5)
                        k2 = cuda_ms(lambda: subbyte_scan.subbyte_code_scores(q.planes, planes, dp), 5)
                        p2 = cuda_ms(lambda: subbyte_scan.subbyte_code_scores_plain(q.planes, planes, dp), 5)
                        ms, plain_ms = min(k1, k2), min(p1, p2)
                        print(f"  time at res=2 B=1024 C=65536 Dp=768: kernel {k1:.3f}/{k2:.3f} ms, "
                              f"plain {p1:.3f}/{p2:.3f} ms", flush=True)
                    del got, want, q
            del whole, planes
            torch.cuda.empty_cache()
    return max_err, ms, plain_ms


def flat_index(kind: str, x, dev) -> FlatIndex:
    flat = FlatIndex(DIM, dev, kind=kind, initial_capacity=len(x))
    for s in range(0, len(x), ADD_BATCH):
        flat.add(x[s : s + ADD_BATCH])
    return flat


def subbyte_path(x, q, truth, dev, card: str) -> int:
    """Phases 6 to 8; returns K2's launches during the quaternary runs."""
    k2 = subbyte_scan.subbyte_code_scores
    t0 = time.perf_counter()
    handle = DenseIndexHandle(DIM, dev, quantization={"type": "scalar", "data_type": "quaternary"})
    for s in range(0, N, ADD_BATCH):
        e = min(s + ADD_BATCH, N)
        handle.add_batch(list(range(s, e)), x[s:e])
    torch.cuda.synchronize()
    print(f"quaternary handle ingest {time.perf_counter() - t0:.1f} s, rerank factor {handle.index._rerank_factor()}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_h, (h_ids, _) = timed_search(lambda: handle.search(q[:1024], 10))
    launches_h = k2.launches
    check_results(f"quaternary DenseIndexHandle.search {N} rows b1024", h_ids, truth[:1024], t_h, card, True)
    print(f"store bytes {handle.index.store.device_nbytes()}; peak allocated during search "
          f"{torch.cuda.max_memory_allocated()} B; K2 launches {launches_h} [{card}]")
    if launches_h == 0:
        fail("the quaternary DenseIndexHandle path never launched K2")

    phase("7 quaternary semantics")
    probe = [7, N // 3]
    ids, _ = handle.search(x[probe], 10)
    if ids[:, 0].tolist() != probe:
        fail(f"self-query returned {ids[:, 0].tolist()}, want {probe}")
    handle.delete(7)
    ids, _ = handle.search(x[probe], 10)
    if 7 in ids:
        fail("a deleted id came back")
    mask = np.zeros(handle.index.n, bool)
    mask[::20] = True
    ids, _ = handle.search(q[:64], 10, row_mask=mask)
    rows = np.asarray([handle.row_of[i] for i in ids[ids >= 0]])
    if (ids < 0).any() or not mask[rows].all():
        fail("masked search returned rows outside the mask")
    print("self-query, delete, mask: ok")
    del handle
    torch.cuda.empty_cache()

    phase(f"8 sub-byte and f16 FlatIndex at {N_SUB} x {DIM}")
    xs = x[:N_SUB]
    truth_s = exact_top10(q, xs)
    flat = flat_index("quaternary", xs, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_f1, (f1_ids, _) = timed_search(lambda: flat.search(q[:1024], 10, rerank=True, rerank_factor=20))
    t_f4, (f4_ids, _) = timed_search(lambda: flat.search(q, 10, rerank=True, rerank_factor=20))
    launches_f = k2.launches
    check_results("quaternary FlatIndex.search(rerank x20) b1024", f1_ids, truth_s[:1024], t_f1, card, True)
    check_results("quaternary FlatIndex.search(rerank x20) b4096", f4_ids, truth_s, t_f4, card, True)
    print(f"store bytes {flat.store.device_nbytes()}; peak allocated during search "
          f"{torch.cuda.max_memory_allocated()} B; K2 launches {launches_f} [{card}]")
    if launches_f == 0:
        fail("the quaternary FlatIndex path never launched K2")
    del flat
    torch.cuda.empty_cache()
    # octal at the handle's 5x ladder step and at 20x
    for kind, factors in (("binary", (20,)), ("octal", (5, 20)), ("f16", (5,))):
        flat = flat_index(kind, xs, dev)
        for factor in factors:
            reset_counts()
            t, (ids, _) = timed_search(lambda: flat.search(q[:1024], 10, rerank=True, rerank_factor=factor), reps=1)
            check_results(f"{kind} FlatIndex.search(rerank x{factor}) b1024", ids, truth_s[:1024], t, card, False)
            print(f"  store bytes {flat.store.device_nbytes()}; K2 launches {k2.launches}")
        del flat
        torch.cuda.empty_cache()
    return launches_h + launches_f


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase("0 environment")
    card = card_line()
    print(f"card: {card}")
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True, text=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    for mod in ("aiohttp", "msgpack", "grpc"):
        print(f"package {mod}: {'present' if importlib.util.find_spec(mod) else 'absent'}")

    phase("1 build u8_bin_max and subbyte_code_scores")
    t0 = time.perf_counter()
    libs = (u8_scan.LIBRARY, subbyte_scan.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, together
        logs = list(ex.map(lambda lib: lib.build(), libs))
    print(f"built {', '.join(lib.library.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib, log in zip(libs, logs):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {lib.name}: {line.strip()}")

    phase("2 kernel against plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err, ms, plain_ms = kernel_check(gen, dev)
    print(f"kernel vs plain: max_abs_err {max_err:.3g} (rtol {RTOL}, atol {ATOL}); "
          f"B=1024 C=1048576 Dp=768: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")

    phase(f"3 main path at {N} x {DIM}")
    t0 = time.perf_counter()
    x, q = clustered(N, NQ, DIM, gen, dev)
    truth = exact_top10(q, x)
    torch.cuda.synchronize()
    print(f"corpus + oracle in {time.perf_counter() - t0:.1f} s")
    launches = main_path(x, q, truth, dev, card)
    torch.cuda.empty_cache()

    phase("5 K2 against plain")
    k2_err, k2_ms, k2_plain_ms = k2_check(gen, dev)
    print(f"K2 vs plain: max_abs_err {k2_err} (bit-exact required); res=2 B=1024 C=65536 Dp=768: "
          f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms [{card}]")

    phase(f"6 quaternary DenseIndexHandle at {N} x {DIM}")
    k2_launches = subbyte_path(x, q, truth, dev, card)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "u8_bin_max",
        "route": "cuda",
        "source": "cosdata_tpu_torch/csrc/u8_bin_max.cu",
        "replaces": "cosdata_tpu/ops/pallas/u8_scan.py:69",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "subbyte_code_scores",
        "route": "cuda",
        "source": "cosdata_tpu_torch/csrc/subbyte_code_scores.cu",
        "replaces": "cosdata_tpu/ops/pallas/subbyte_scan.py:55",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
