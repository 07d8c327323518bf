"""Chip smoke of the PyTorch/CUDA port: dense exact-scan search at 1M x 768,
u8 and sub-byte, then the serving stack (REST, restart, gRPC) over it.

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
binary, octal and f16 at b1024; 9 the REST server (``AppContext`` on the
card, aiohttp on a local port): a 65,536 x 768 collection written through
one explicit transaction, searched in batches (recall@10 against an exact
oracle), filtered, read back by id and streamed a delete; 10 a restart of
the context on the same data dir (snapshot + WAL replay) answering the same
queries identically; 11 served throughput: the phase-3 u8 and the phase-6
quaternary 1M handles mounted into collections and searched over HTTP in
128-query requests from 8 threads; 12 the gRPC server over the u8
collection, whose FindSimilarVectors must return REST's ids. K1 and K2
launch counts are read around each path. Any failure exits non-zero. The
last line is one JSON object naming the device.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http.client
import importlib.util
import json
import socket
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from cosdata_tpu_torch.config import load_config
from cosdata_tpu_torch.core.app_context import AppContext
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
#: the REST phases: collection rows (one scan chunk, so the capacity takes
#: the K1 engine), rows per upsert request, queries and queries per request
N_REST, UPSERT_ROWS, NQ_REST, QUERY_ROWS, WORKERS = 65_536, 512, 1024, 128, 8
ADMIN_KEY = "chip-smoke"


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


def main_path(x, q, truth, dev, card: str) -> tuple[int, DenseIndexHandle]:
    """Phases 3 and 4; returns K1's launches during the u8 path and the
    handle, which phase 11 serves."""
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
    serve_threshold, handle.flat_serve_threshold = handle.flat_serve_threshold, handle.index.n - 1
    try:
        handle.search(q[:8], 10)
    except NotImplementedError as err:
        print(f"above flat_serve_threshold: NotImplementedError ({err})")
    else:
        fail("a search above flat_serve_threshold did not raise NotImplementedError")
    handle.flat_serve_threshold = serve_threshold
    print("self-query, delete, mask: ok")
    return launches, handle


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


def subbyte_path(x, q, truth, dev, card: str) -> tuple[int, DenseIndexHandle]:
    """Phases 6 to 8; returns K2's launches during the quaternary runs and
    the quaternary handle, which phase 11 serves."""
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
    return launches_h + launches_f, handle


class RestServer:
    """The port's aiohttp app on a free local port, served from a thread's
    event loop (as bench.py:899-918 serves the reference's)."""

    def __init__(self, ctx: AppContext):
        from aiohttp import web

        from cosdata_tpu_torch.api.server import make_app

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(make_app(ctx))
        started = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            self.loop.run_until_complete(web.TCPSite(self.runner, "127.0.0.1", self.port).start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        if not started.wait(60):
            fail("the REST server did not start")

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


class RestClient:
    """JSON over http.client, one keep-alive connection per thread."""

    def __init__(self, port: int):
        self.port = port
        self.headers = {"Content-Type": "application/json"}
        self._local = threading.local()
        self._conns: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def call(self, method: str, path: str, body=None) -> tuple[int, object]:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=900)
            with self._lock:
                self._conns.append(conn)
        conn.request(method, path, body=None if body is None else json.dumps(body), headers=self.headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")

    def ok(self, method: str, path: str, body=None):
        status, out = self.call(method, path, body)
        if status not in (200, 201):
            fail(f"{method} {path}: HTTP {status}: {out}")
        return out

    def login(self) -> None:
        out = self.ok("POST", "/auth/create-session", {"username": "admin", "password": ADMIN_KEY})
        self.headers["Authorization"] = f"Bearer {out['access_token']}"

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                conn.close()


def rows_of(responses: list, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """(ids, scores) arrays from REST result lists, -1 / -inf padded."""
    ids = np.full((len(responses), k), -1, np.int64)
    scores = np.full((len(responses), k), -np.inf, np.float64)
    for i, res in enumerate(responses):
        for j, r in enumerate(res[:k]):
            ids[i, j], scores[i, j] = r["id"], r["score"]
    return ids, scores


def batch_search(client: RestClient, coll: str, qr: np.ndarray, workers: int) -> tuple:
    """/search/batch-dense over ``qr`` in QUERY_ROWS-query requests from
    ``workers`` threads; returns (ids, scores, seconds, request latencies)."""
    path = f"/vectordb/collections/{coll}/search/batch-dense"
    lat = []

    def one(bq):
        t0 = time.perf_counter()
        out = client.ok("POST", path, {"queries": [{"vector": v} for v in bq.tolist()], "top_k": 10})
        lat.append(time.perf_counter() - t0)
        return [r["results"] for r in out["responses"]]

    batches = [qr[s : s + QUERY_ROWS] for s in range(0, len(qr), QUERY_ROWS)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        responses = [r for part in ex.map(one, batches) for r in part]
    dt = time.perf_counter() - t0
    ids, scores = rows_of(responses)
    return ids, scores, dt, lat


def served_line(name: str, ids: np.ndarray, truth: np.ndarray, dt: float, lat: list, card: str) -> float:
    if ids.shape != (truth.shape[0], 10) or (ids < 0).any():
        fail(f"{name}: bad result shape {ids.shape} or missing ids")
    r = float((ids[:, :, None] == truth[:, None, :]).any(-1).sum()) / truth.size
    print(f"{name}: recall@10 {r:.4f}; {truth.shape[0]} queries in {len(lat)} requests of {QUERY_ROWS} "
          f"in {dt:.3f} s = {truth.shape[0] / dt:.1f} qps, {len(lat) / dt:.2f} requests/s; request latency "
          f"median {statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms [{card}]", flush=True)
    if r < MIN_RECALL:
        fail(f"{name}: recall@10 {r:.4f} < {MIN_RECALL}")
    return r


def rest_phase(data_dir: str, x_rest: np.ndarray, q_rest: np.ndarray, truth, dev, card: str) -> dict:
    """Phase 9: ingest, search, filter, read back and delete over HTTP;
    returns the sequential answers phase 10 must repeat and K1's launches."""
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    c = "/vectordb/collections/rest"
    client.ok("POST", "/vectordb/collections", {
        "name": "rest", "dense_vector": {"enabled": True, "dimension": DIM},
        "metadata_schema": {"fields": [{"name": "half", "values": ["a", "b"]}], "supported_conditions": []},
    })
    client.ok("POST", c + "/indexes/dense", {"name": "rest_dense", "distance_metric_type": "cosine",
                                             "quantization": {"type": "auto"}})
    t0 = time.perf_counter()
    txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
    rows = x_rest.tolist()
    for s in range(0, N_REST, UPSERT_ROWS):
        vectors = []
        for i in range(s, s + UPSERT_ROWS):
            v = {"id": i, "dense_values": rows[i]}
            if i % 2 == 0:  # half the rows carry the field
                v["metadata"] = {"half": "a" if i % 4 == 0 else "b"}
            vectors.append(v)
        client.ok("POST", f"{c}/transactions/{txn}/upsert", {"vectors": vectors})
    t_upload = time.perf_counter() - t0
    client.ok("POST", f"{c}/transactions/{txn}/commit", {})
    while True:
        st = client.ok("GET", f"{c}/transactions/{txn}/status")
        if st["status"] == "complete":
            break
        if time.perf_counter() - t0 > 600:
            fail(f"the transaction did not complete: {st}")
        time.sleep(0.2)
    t_ingest = time.perf_counter() - t0
    if st["records_upserted"] != N_REST:
        fail(f"transaction status {st}")
    coll = ctx.get_collection("rest")
    print(f"REST ingest of {N_REST} x {DIM} in {N_REST // UPSERT_ROWS} requests: upload {t_upload:.1f} s, "
          f"commit to complete {t_ingest - t_upload:.1f} s, total {t_ingest:.1f} s; range {coll.dense.range}, "
          f"capacity {coll.dense.index.cap} [{card}]", flush=True)

    reset_counts()
    batch_search(client, "rest", q_rest[:QUERY_ROWS], WORKERS)  # first search of the collection
    ids, _, dt, lat = batch_search(client, "rest", q_rest, WORKERS)
    served_line(f"REST /search/batch-dense {N_REST} rows", ids, truth, dt, lat, card)

    flt = {"Is": {"field_name": "half", "field_value": "a", "operator": "Equal"}}
    res = client.ok("POST", c + "/search/dense", {"query_vector": q_rest[0].tolist(), "top_k": 10,
                                                  "filter": flt})["results"]
    if len(res) != 10 or any(r["id"] % 4 for r in res):
        fail(f"filtered search returned ids without the filter value: {[r['id'] for r in res]}")
    probe = N_REST // 2 + 2  # an even row of the field's value "b"
    rec = client.ok("GET", f"{c}/vectors/{probe}")
    err = float(np.abs(np.asarray(rec["dense_values"], np.float64) - x_rest[probe]).max())
    if rec["metadata"] != {"half": "b"} or err > 1e-6:
        fail(f"GET /vectors/{probe}: metadata {rec['metadata']}, max value error {err}")
    victim = int(ids[0, 0])
    client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
    res = client.ok("POST", c + "/search/dense", {"query_vector": x_rest[victim].tolist(), "top_k": 10})["results"]
    if victim in [r["id"] for r in res] or len(res) != 10:
        fail(f"streamed delete of {victim}: it came back as the query for itself")
    print(f"filtered search: ok; GET /vectors/{probe}: max value error {err:.3g}; "
          f"streamed delete of {victim}: ok", flush=True)
    seq = batch_search(client, "rest", q_rest, 1)
    launches = u8_scan.u8_bin_max.launches
    print(f"u8_bin_max launches in phase 9: {launches}", flush=True)
    client.close()
    server.close()
    ctx.close()
    return {"launches": launches, "ids": seq[0], "scores": seq[1], "victim": victim}


def restart_phase(data_dir: str, q_rest: np.ndarray, before: dict, dev, card: str) -> int:
    """Phase 10: a new context on the same data dir answers as before."""
    t0 = time.perf_counter()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    print(f"restart: snapshot load + WAL replay in {time.perf_counter() - t0:.1f} s", flush=True)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    reset_counts()
    ids, scores, dt, lat = batch_search(client, "rest", q_rest, 1)
    launches = u8_scan.u8_bin_max.launches
    same_ids = bool((ids == before["ids"]).all())
    same_scores = bool((scores == before["scores"]).all())
    status, _ = client.call("GET", f"/vectordb/collections/rest/vectors/{before['victim']}")
    print(f"after restart: ids identical {same_ids}, scores identical {same_scores}; deleted "
          f"{before['victim']} answers HTTP {status}; {dt:.3f} s; u8_bin_max launches {launches} [{card}]",
          flush=True)
    client.close()
    server.close()
    ctx.close()
    if not (same_ids and same_scores):
        fail("the restarted context answered differently")
    if status != 404:
        fail(f"the deleted vector came back after the restart (HTTP {status})")
    return launches


def mount(ctx: AppContext, name: str, handle: DenseIndexHandle) -> None:
    """Serve a built 1M handle from a new collection (bench.py:892-897)."""
    coll = ctx.create_collection({"name": name, "dense_vector": {"enabled": True, "dimension": DIM}})
    coll.dense = handle
    coll.raw = {i: {"id": i} for i in handle.row_of}


def served_phase(ctx: AppContext, client: RestClient, u8_handle, q4_handle, q, truth, card: str) -> dict:
    """Phase 11: 1M-row u8 and quaternary handles served over HTTP."""
    mount(ctx, "served_u8", u8_handle)
    mount(ctx, "served_q4", q4_handle)
    qr = np.round(q.cpu().numpy().astype(np.float64), 6)
    reset_counts()
    batch_search(client, "served_u8", qr[:QUERY_ROWS], WORKERS)  # first search of the collection
    ids, _, dt, lat = batch_search(client, "served_u8", qr, WORKERS)
    k1 = u8_scan.u8_bin_max.launches
    served_line(f"served u8 {N} rows, {WORKERS} workers", ids, truth.cpu().numpy(), dt, lat, card)
    print(f"u8_bin_max launches in phase 11: {k1}", flush=True)
    reset_counts()
    sub = qr[: 8 * QUERY_ROWS]
    ids4, _, dt4, lat4 = batch_search(client, "served_q4", sub, WORKERS)
    k2 = subbyte_scan.subbyte_code_scores.launches
    served_line(f"served quaternary {N} rows, {WORKERS} workers", ids4, truth[: len(sub)].cpu().numpy(),
                dt4, lat4, card)
    print(f"subbyte_code_scores launches in phase 11: {k2}", flush=True)
    return {"k1": k1, "k2": k2, "ids": ids, "qr": qr}


def grpc_phase(ctx: AppContext, served: dict, card: str) -> int:
    """Phase 12: FindSimilarVectors on the u8 collection returns REST's ids."""
    import grpc

    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb
    from cosdata_tpu_torch.grpc_api.server import build_server

    server = build_server(ctx, address="127.0.0.1:0")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        def call(method, service, req, resp_cls, md=()):
            fn = channel.unary_unary(f"/vector_service.{service}/{method}",
                                     request_serializer=lambda m: m.SerializeToString(),
                                     response_deserializer=resp_cls.FromString)
            return fn(req, metadata=list(md), timeout=300)

        tok = call("CreateSession", "AuthService",
                   pb.CreateSessionRequest(username="admin", password=ADMIN_KEY), pb.CreateSessionResponse).access_token
        md = [("authorization", f"Bearer {tok}")]
        reset_counts()
        t0 = time.perf_counter()
        got = []
        for v in served["qr"][:8]:
            resp = call("FindSimilarVectors", "VectorsService", pb.FindSimilarVectorsRequest(
                collection_id="served_u8", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
            ), pb.FindSimilarVectorsResponse, md)
            got.append([int(m.id) for m in resp.matches])
        dt = time.perf_counter() - t0
        launches = u8_scan.u8_bin_max.launches
    finally:
        channel.close()
        server.stop(0)
    want = served["ids"][:8].tolist()
    print(f"gRPC FindSimilarVectors x8: ids equal REST's {got == want}; {dt:.3f} s; "
          f"u8_bin_max launches {launches} [{card}]", flush=True)
    if got != want:
        fail(f"gRPC ids differ from REST's: {got} vs {want}")
    return launches


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
    launches, u8_handle = main_path(x, q, truth, dev, card)
    torch.cuda.empty_cache()

    phase("5 K2 against plain")
    k2_err, k2_ms, k2_plain_ms = k2_check(gen, dev)
    print(f"K2 vs plain: max_abs_err {k2_err} (bit-exact required); res=2 B=1024 C=65536 Dp=768: "
          f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms [{card}]")

    phase(f"6 quaternary DenseIndexHandle at {N} x {DIM}")
    k2_launches, q4_handle = subbyte_path(x, q, truth, dev, card)

    phase(f"9 REST ingest and search at {N_REST} x {DIM}")
    x_rest = np.round(x[:N_REST].cpu().numpy().astype(np.float64), 6)
    q_rest = np.round(q[:NQ_REST].cpu().numpy().astype(np.float64), 6)
    truth_rest = exact_top10(
        torch.as_tensor(q_rest, dtype=torch.float32, device=dev),
        torch.as_tensor(x_rest, dtype=torch.float32, device=dev),
    ).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        rest = rest_phase(data_dir, x_rest, q_rest, truth_rest, dev, card)
        phase("10 restart on the same data dir")
        k1_restart = restart_phase(data_dir, q_rest, rest, dev, card)
    del x_rest

    phase(f"11 served throughput at {N} x {DIM}")
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
        server = RestServer(ctx)
        client = RestClient(server.port)
        client.login()
        served = served_phase(ctx, client, u8_handle, q4_handle, q, truth, card)
        phase("12 gRPC")
        k1_grpc = grpc_phase(ctx, served, card)
        client.close()
        server.close()
        ctx.close()
    for name, n_launch in (("9 (K1)", rest["launches"]), ("10 (K1)", k1_restart), ("11 (K1)", served["k1"]),
                           ("11 (K2)", served["k2"]), ("12 (K1)", k1_grpc)):
        if n_launch == 0:
            fail(f"phase {name} never launched its kernel")
    launches += rest["launches"] + k1_restart + served["k1"] + k1_grpc
    k2_launches += served["k2"]
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
