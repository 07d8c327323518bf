"""Chip smoke of the PyTorch/CUDA port: dense search at 1M x 768, u8 and
sub-byte, by the exact scan and by the HNSW graph, the serving stack
(REST, restart, gRPC) over it, then sparse search at 500,000 docs, dense +
sparse hybrid search, BM25 full-text search at 100,000 docs and dense +
text hybrid search.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases: 0 environment; 1 build both kernels (u8_bin_max, K1;
subbyte_code_scores, K2) from the checkout's sources, in parallel; 2 K1
against its plain PyTorch version at the u8 path's shapes and the tiles'
edges, by cosine, dot and euclidean, timed beside its bound and
torch._int_mm (cosine at B=1024 and 128, euclidean at B=1024); 3 the u8
path at 1M x 768: a DenseIndexHandle filled as the reference's bench fills
it (983,616 rows in one call: the graph's bulk build), one search, then 16
insertion waves of 1,024 rows, searched through DenseIndexHandle.search
and FlatIndex.search, recall@10 against an exact f32 oracle and K1's launch
count, then one batch of 12,288 queries, whose bin table passes the
limit, through the approx select mode (K1 per 65,536-row chunk), against
the oracle and the bins mode on its thirds; 4 u8 search semantics, and the graph routes with the serving limits
below the rows (unfiltered and 50% filter by the graph, 5% filter by the
scan, a deleted id never back); 5 K2 and its query unpack against their
plain versions, bit for bit, timed likewise; 6 the sub-byte path on the
same corpus through a quaternary DenseIndexHandle at 1M rows (its graph
built the same way), recall@10 and K2's launch count; 7 quaternary search
semantics; 8 a quaternary FlatIndex at 262,144 rows (the reference's bench
row) at b1024 and b4096, then binary, octal and f16 at b1024; 9 the REST
server (``AppContext`` on the card, aiohttp on a local port): a 65,536 x
768 collection written through one explicit transaction (its graph
bulk-built), searched in batches (recall@10 against an exact oracle),
filtered, read back by id and streamed a delete; 10 a restart of the
context on the same data dir (snapshot + WAL replay) answering the same
queries identically, by the scan and by the reloaded graph; 11 served
throughput: the phase-3 u8 and the phase-6 quaternary 1M handles mounted
into collections and searched over HTTP in 128-query requests from 8
threads; 12 the gRPC server over the u8 collection, whose
FindSimilarVectors must return REST's ids; 13 the sparse inverted index at
the reference's bench scale (500,000 docs x 64 pairs, vocab 30,000):
ingest, b64/b256/b1 search through the dense-head engine, recall against
the index's exhaustive oracle and against a brute-force exact score
computed on the card from the raw pairs, and one timing of each quantized
route without raw rows; 14 a collection with a dense and a sparse index
written over REST (16,384 rows in one transaction), sparse, batch-sparse
and batch-hybrid searches held against brute force and against RRF of the
two legs, GET by id, a streamed delete, a restart answering identically
and gRPC sparse search equal to REST's; 15 hybrid search at 100,000 docs (a
u8 dense leg on K1, a sparse leg on the head engine) through
Collection.hybrid_search_batch and /search/batch-hybrid, held against RRF
of the legs; 16 the native text pipeline built with g++ from the checkout
and held bit for bit against its plain Python version (the corpus's
documents and queries, a Unicode corpus), then the BM25 engine at the
reference's bench scale (100,000 docs of 40 zipf words): ingest through
the library, first search, b64/b256/b1 search, recall
against the index's exhaustive oracle and against a brute-force Σ idf·tf
computed on the card from its postings, a profile of a b256 search, the
host time of its query texts (library and plain), then
dense + text hybrid search (a u8 dense leg on K1 over 100,000 rows) held
against RRF of the legs; 17 a collection with a dense and a tf-idf index
written over REST (16,384 rows with texts in one transaction), tf-idf,
batch-tf-idf, hybrid and batch-hybrid searches equal to the direct
Collection calls, a text read back, a streamed delete, a restart
answering identically, gRPC tf-idf search equal to REST's, the reloaded
graph answering above the serving limit as before the restart, then the
dense snapshot rewritten without its graph and reloaded scan-only, served
above the limit by the scan with the scan's answers; 18 the HNSW graph of
phase 3: HNSWIndex.search at ef 128, 256 and 512 (b1024, recall@10
gated at 0.99 and 0.995 for ef 128 and 256), 8 single queries, a profile,
the quaternary graph at ef 256, and a quaternary exact-path bulk build
(K2 through the chunked scan); 19 beyond the device budget (the phase-3
and phase-6 handles freed first): a u8 HNSWIndex with host raw rows over
the same 1M rows (the reference bench's beyond_hbm build), its resident
scan, then force_spill(keep_graph=True) and the streamed scan at b1024 and
b64 (K1 once per 65,536-row chunk; recall@10, ids equal to the resident
scan on untied slots, bytes streamed beside a measured pinned H2D rate,
device time by kernel group), the host-codes graph at ef 128 and 256 b64
beside the streamed scan (ef 128 gated at recall@10 0.99 against it; the
resident graph's recall and the host-codes beam's with 8x its random
seeds printed beside), promotion back to the device (answers identical
to the resident scan, one K1 launch) and the re-pin of a spilled
doubling; the reference bench's beyond_hbm section at its 262,144 rows
(the host-codes graph at ef 128 gated at recall 0.99 against the streamed
exact scan); a quaternary index spilled while empty that ingests the 1M
rows into the host tier and streams them through K2 (b1024, 20x host
rerank); and a raw_storage "disk" collection of phase 9's 65,536 rows
written over REST under a pinned COSDATA_HBM_GB, whose codes spill while
the transaction is indexed, searched, filtered and streamed a delete
against an exact oracle, then restarted with the budget pinned (codes
loaded on the host, answers identical, gRPC equal to REST) and lifted
(flush promotes the codes; answers identical, K1 launched); 20 the other
metrics over phase 3's rows scaled by a seeded factor in [0.5, 1.5] (so
that euclidean ranks unlike cosine): a euclidean u8 DenseIndexHandle with
host raw rows filled as phase 3's (the scan, the graph at ef 128 and 256,
the approx mode at 12,288 queries, then force_spill(keep_graph=True) and
the streamed scan, K1 per chunk), a hamming u8 handle (scan-only, no
adjacency) whose unreranked distances equal an XOR-popcount oracle
computed on the card, hamming binary and f16 FlatIndexes at 262,144 rows
held the same way, a euclidean f32 FlatIndex, the quaternary euclidean
ValueError, and a euclidean and a hamming collection of 16,384 rows over
REST (a streamed delete, a restart answering identically, gRPC equal to
REST); 21 sharded dense collections: a u8 DenseIndexHandle with 4 shards
(ShardedHNSWIndex, shards cycled over the card's devices: 4 on one card)
over phase 3's rows, 995,904 in one call (a bulk build per shard) and
4,096 more (one insertion wave per shard), its scan route (K1 once per
shard per batch, counted; K1 held against its plain version on each
shard's own store, masked and not), its graph route at ef 128, a 50% mask against
a masked oracle, served over HTTP from 8 threads, a delete; a quaternary
handle of 4 shards of 65,536 rows (K2 once per shard chunk, counted);
ShardedFlatIndex over the 1M rows on a dp 2 x tp 2 mesh of the first card
and on the default mesh (recall@10 gated at 0.999, ids equal to the
oracle's on untied slots); and the dry run's served path: a collection
with ``config.shards`` 4 written over REST (16,384 rows), filtered,
streamed a delete, gRPC equal to REST, restarted from its sharded
snapshot with identical answers. K1 and K2 launch counts are read around
each path. Any failure exits non-zero. The last line is one JSON
object naming the device.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http.client
import importlib.util
import json
import os
import socket
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

#: packages the port's serving stack and text pipeline import
REQUIRED = ("aiohttp", "msgpack", "grpc", "xxhash")
try:
    from cosdata_tpu_torch.config import load_config
    from cosdata_tpu_torch.core.app_context import AppContext
    from cosdata_tpu_torch.core.collection import DenseIndexHandle, tune_dense_range
    from cosdata_tpu_torch.core.fusion import rrf_fuse
    from cosdata_tpu_torch.indexes.flat import FlatIndex
    from cosdata_tpu_torch.indexes.hnsw import HNSWIndex
    from cosdata_tpu_torch.indexes.inverted import InvertedIndex
    from cosdata_tpu_torch.indexes.tf_idf import TFIDFIndex
    from cosdata_tpu_torch.ops import flat_scan, sparse_kernels
    from cosdata_tpu_torch.ops.kernels import subbyte_scan, u8_scan
    from cosdata_tpu_torch.ops.quantize import quantize_subbyte, quantize_u8
    from cosdata_tpu_torch.parallel.sharded import ShardedFlatIndex, make_mesh
    from cosdata_tpu_torch.text import native as text_native
    from cosdata_tpu_torch.text import processing as text_processing
    from cosdata_tpu_torch.text.processing import process_text_query
    from cosdata_tpu_torch.tools.measure import bound, card_line, clustered, cuda_ms, device_ms
    from cosdata_tpu_torch.tools.profile_dense import device_us
    from cosdata_tpu_torch.tools.text_check import UNICODE_CORPUS, differences, pipeline
    from cosdata_tpu_torch.tools.text_check import bm25_corpus as text_corpus
except ModuleNotFoundError as err:
    raise SystemExit(f"FAIL: 0 environment: module {err.name} is missing ({err})") from err

SEED = 0
N, DIM, NQ = 1_000_000, 768, 4096
#: one batch whose bin table (NQ_APPROX x 32,768 bins at 1M rows) passes
#: flat_scan.MAX_BIN_TABLE, so the scan takes the approx select mode
NQ_APPROX = 12_288
#: the reference's quaternary bench row (BENCH_r05.json, bench.py:777-805)
N_SUB = 262_144
ADD_BATCH = 131072
#: rows the 1M handles take by insertion waves after their bulk build
WAVE_ROWS = 16384
RTOL, ATOL = 2e-5, 1e-5
MIN_RECALL = 0.99
#: the REST phases: collection rows (one scan chunk, so the capacity takes
#: the K1 engine), rows per upsert request, queries and queries per request
N_REST, UPSERT_ROWS, NQ_REST, QUERY_ROWS, WORKERS = 65_536, 512, 1024, 128, 8
ADMIN_KEY = "chip-smoke"
#: the reference's sparse bench corpus (bench.py:537-633): docs, vocab,
#: pairs per doc, query dims (each query is a doc's rarest dims), seed
N_SP, VOCAB_SP, NNZ_SP, NNZ_Q, SEED_SP = 500_000, 30_000, 64, 24, 7
#: the reference's hybrid section (bench.py:962-1070): docs, sparse seed;
#: phase 14 serves the first N_SP_REST of its rows over REST
N_HY, SEED_HY, N_SP_REST = 100_000, 13, 16_384
#: phase 21: shards of the sharded engines (the dry run's count), and the
#: rows phase 21a adds after its bulk build (one insertion wave per shard)
SHARDS, SHARD_WAVE_ROWS = 4, 4096
#: the reference's BM25 bench corpus (bench.py:638-714): docs, vocabulary,
#: words per doc, words per query (a doc's rarest), seed; phase 17 serves
#: the first N_SP_REST docs over REST
N_BM, VOCAB_BM, WORDS_BM, QWORDS_BM, SEED_BM = 100_000, 20_000, 40, 6, 9


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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


#: K1's timed shapes: B=1024 (the bench batch) and B=128 (one served
#: request), both at C=1,048,576, Dp=768, cosine; euclidean at B=1024
K1_TIMED_CASES = (("cosine", 1024), ("cosine", 128), ("euclidean", 1024))


def kernel_timing(what: str, kernel, plain, library, plain_reps: int, ops: float, nbytes: float,
                  card: str, f32_ops: float = 0.0) -> dict:
    """Plain, kernel, kernel, plain in turns, each the median of single
    calls timed alone (``cuda_ms``: 5 calls, ``plain_reps`` for the plain
    version), then one library call on the same inputs (``torch._int_mm``:
    the product only; None where there is none) timed the same way. Then
    the kernel and the library call back to back (``device_ms``, 20 calls
    behind a spin kernel: no host time between calls), under their own
    keys. And the bound for ``ops`` int8 operations (and ``f32_ops`` float32
    ones) moving ``nbytes``."""
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, 5)
    k2 = cuda_ms(kernel, 5)
    p2 = cuda_ms(plain, plain_reps)
    lib = cuda_ms(library, 5) if library else None
    b2b = device_ms(kernel, 20)
    lib_b2b = device_ms(library, 20) if library else None
    bound_ms, bound_by = bound(ops, nbytes, f32_ops)
    lib_text = f"torch._int_mm (product only) {lib:.4f} ms, back to back {lib_b2b:.4f}; " if library else ""
    print(f"  time at {what}: kernel {k1:.4f}/{k2:.4f} ms, back to back {b2b:.4f}; plain {p1:.3f}/{p2:.3f} ms; "
          f"{lib_text}bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_back_to_back": b2b, "library_ms_back_to_back": lib_b2b}


def k1_against_plain(metric: str, t, where: str) -> float:
    """K1 against its plain version on the terms ``t``: the same shape,
    invalid bins sunk, live bins within RTOL/ATOL. Returns the max abs
    error; fails otherwise."""
    got = u8_scan.u8_bin_max(metric, 32, t)
    want = u8_scan.u8_bin_max_plain(metric, 32, t)
    torch.cuda.synchronize(t.codes.device)
    if got.shape != want.shape:
        fail(f"K1 shape {tuple(got.shape)} != {tuple(want.shape)} at {where}")
    live = want > -1e37
    if not bool((got[~live] < -1e37).all()):
        fail(f"invalid bins not sunk at {where}")
    err = (got[live] - want[live]).abs()
    e = float(err.max()) if err.numel() else 0.0
    if bool((err > ATOL + RTOL * want[live].abs()).any()):
        fail(f"kernel disagrees with plain at {where}: {e}")
    return e


def kernel_check(gen, dev, card: str) -> tuple[float, dict]:
    """K1 against its plain version at the listed shapes (B = 1, 100 and 128
    and C = 4,128 hit the tiles' edges), by cosine, dot and euclidean;
    returns (max_abs_err, timings by B for cosine and "euclidean" at
    B=1024)."""
    max_err = 0.0
    timed = {}
    for c in (4_128, 65_536, 1_048_576):
        for dp in (128, 768):
            d_true = dp - 28 if dp == 128 else dp
            x = torch.rand((c, dp), generator=gen, device=dev) * 2 - 1
            store = quantize_u8(x, -0.6, 0.7, d_true)
            del x
            valid = torch.ones(c, dtype=torch.bool, device=dev)
            valid[5] = False
            valid[c - 1000 :] = False  # ragged valid tail
            valid[c // 2 : c // 2 + 64] = False  # two whole invalid bins
            for metric in ("cosine", "dot", "euclidean"):
                errs = []
                for b in (1, 8, 100, 128, 1024, 4096):
                    q = quantize_u8(torch.rand((b, dp), generator=gen, device=dev) * 2 - 1, -0.6, 0.7, d_true)
                    t = u8_scan.bin_max_terms(metric, q, store, valid, dp)
                    e = k1_against_plain(metric, t, f"B={b} C={c} Dp={dp} {metric}")
                    errs.append(f"B={b}:{e:.3g}")
                    max_err = max(max_err, e)
                    if (c, dp) == (1_048_576, 768) and (metric, b) in K1_TIMED_CASES:
                        # codes and query codes read once, the row and query terms, the bins
                        # written; euclidean's f32 epilogue is ~12 operations per score
                        timed[b if metric == "cosine" else metric] = kernel_timing(
                            f"B={b} C={c} Dp={dp} {metric}", lambda: u8_scan.u8_bin_max(metric, 32, t),
                            lambda: u8_scan.u8_bin_max_plain(metric, 32, t),
                            lambda: torch._int_mm(t.q_codes, t.codes.t()), 3, 2.0 * b * c * dp,
                            c * dp + b * dp + 12 * c + 8 * b + 4 * b * (c // 32), card,
                            f32_ops=12.0 * b * c if metric == "euclidean" else 0.0)
                    del t
                print(f"  C={c:8d} Dp={dp:4d} {metric:6s} max_abs_err {' '.join(errs)}", flush=True)
            del store
            torch.cuda.empty_cache()
    return max_err, timed


def check_results(name: str, ids, truth: torch.Tensor, t: float, card: str, gate: bool) -> None:
    b = truth.shape[0]
    if ids.shape != (b, 10) or (ids < 0).any():
        fail(f"{name}: bad result shape {ids.shape} or missing ids")
    r = recall10(ids, truth)
    print(f"{name}: recall@10 {r:.4f}, {t * 1e3:.2f} ms/batch, {b / t:.1f} qps [{card}]", flush=True)
    if gate and r < MIN_RECALL:
        fail(f"{name}: recall@10 {r:.4f} < {MIN_RECALL}")


def sync_all(devices) -> None:
    """Wait for every one of ``devices`` (torch.cuda.synchronize waits for
    the current device only)."""
    for d in set(devices):
        torch.cuda.synchronize(d)


def reset_counts() -> None:
    u8_scan.u8_bin_max.launches = 0
    subbyte_scan.subbyte_code_scores.launches = 0
    subbyte_scan.unpack_query_codes.launches = 0


def graph_ingest(handle: DenseIndexHandle, x, q, card: str, name: str) -> None:
    """Fill a 1M handle as the reference's bench does, plus insertion waves:
    the first N - WAVE_ROWS rows in one add_batch (the bulk build on the RP
    path), one search (the scan's capacity step, as a first search makes
    it), then the last WAVE_ROWS rows (insertion waves of 1,024)."""
    n_bulk = N - WAVE_ROWS
    t0 = time.perf_counter()
    handle.add_batch(list(range(n_bulk)), x[:n_bulk])
    torch.cuda.synchronize()
    t_bulk = time.perf_counter() - t0
    idx = handle.index
    stats = idx.last_build_stats
    t0 = time.perf_counter()
    handle.search(q[:8], 10)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle.add_batch(list(range(n_bulk, N)), x[n_bulk:])
    torch.cuda.synchronize()
    t_waves = time.perf_counter() - t0
    adj = sum(t.numel() * t.element_size() for t in (idx.adj0, idx.adj0_d, idx.up_adj, idx.up_d))
    print(f"{name}: bulk build of {n_bulk} rows {t_bulk:.1f} s (ingest {stats['ingest_s']} s, graph "
          f"{stats['graph_s']} s); first search {t_first:.2f} s; {WAVE_ROWS // 1024} waves of 1024 in "
          f"{t_waves:.2f} s = {t_waves / (WAVE_ROWS // 1024) * 1e3:.0f} ms per wave; levels "
          f"{idx.level_counts[:5].tolist()}, entry level {idx.entry_level}; adjacency {adj} B, capacity "
          f"{idx.cap} [{card}]", flush=True)
    if idx.n != N or idx.scan_only or idx.entry < 0:
        fail(f"{name}: the graph was not built ({idx.n} rows, scan_only {idx.scan_only})")


def approx_check(name: str, search, q_big, truth_big: torch.Tensor, capacity: int, card: str) -> int:
    """One batch of NQ_APPROX queries through ``search`` (host ids and
    scores): its bin table passes flat_scan.MAX_BIN_TABLE, so the scan
    selects in the approx mode, K1 once per CODES_CHUNK-row chunk; gated on
    recall@10 against ``truth_big``, on K1's launches per batch, and on ids
    equal, on untied slots, to the bins mode run on the batch's thirds.
    Returns K1's launches over the check."""
    reset_counts()
    search(q_big)
    per_batch = u8_scan.u8_bin_max.launches
    t, (ids, _) = timed_search(lambda: search(q_big), reps=1)
    third = NQ_APPROX // 3
    parts = [search(q_big[s : s + third]) for s in range(0, NQ_APPROX, third)]
    launches = u8_scan.u8_bin_max.launches
    b_ids, b_sc = (np.concatenate([p[i] for p in parts]) for i in (0, 1))
    check_results(f"{name} b{NQ_APPROX} (approx select)", ids, truth_big, t, card, True)
    same, share = untied_equal(ids, b_ids, b_sc)
    chunks = -(-capacity // flat_scan.CODES_CHUNK)
    print(f"  bin table {NQ_APPROX} x {capacity // 32} > {flat_scan.MAX_BIN_TABLE}: K1 launches per batch "
          f"{per_batch} ({chunks} chunks of {flat_scan.CODES_CHUNK}); ids equal to the bins mode on the thirds "
          f"(b{third}) on untied slots {same} ({share:.1%} of slots) [{card}]", flush=True)
    if per_batch != chunks:
        fail(f"{name}: the approx mode launched K1 {per_batch} times per batch, want {chunks}")
    if not same:
        fail(f"{name}: the approx mode's ids differ from the bins mode's on untied slots")
    return launches


def main_path(x, q, q_big, truth, dev, card: str) -> tuple[int, DenseIndexHandle]:
    """Phases 3 and 4; returns K1's launches during the u8 path and the
    handle, which phases 11 and 18 serve."""
    t0 = time.perf_counter()
    handle = DenseIndexHandle(DIM, dev)  # quantization "auto"
    graph_ingest(handle, x, q, card, "u8 handle")
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
    launches += approx_check("DenseIndexHandle.search", lambda qq: handle.search(qq, 10), q_big,
                             exact_top10(q_big, x), handle.index.cap, card)

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
    print("self-query, delete, mask: ok")
    graph_routes(handle, x, q, truth, card)
    return launches, handle


def graph_routes(handle: DenseIndexHandle, x, q, truth, card: str) -> None:
    """Phase 4's graph routes, with the serving limits below the rows: an
    unfiltered search and a 50% filter take the graph, a 5% filter the
    scan, and a deleted id never comes back from the graph."""
    n = handle.index.n
    limits = handle.flat_serve_threshold, handle.graph_filter_min
    handle.flat_serve_threshold = handle.graph_filter_min = n - 1
    reset_counts()
    t, (ids, _) = timed_search(lambda: handle.search(q[:1024], 10), reps=1)
    k1_graph = u8_scan.u8_bin_max.launches
    r = recall10(ids, truth[:1024])
    half = np.zeros(n, bool)
    half[::2] = True
    t_half, (h_ids, _) = timed_search(lambda: handle.search(q[:1024], 10, row_mask=half), reps=1)
    keep = torch.as_tensor(np.flatnonzero(half), device=q.device)
    masked_truth = keep[exact_top10(q[:1024], x[keep])]
    r_half = recall10(h_ids, masked_truth)
    in_half = bool((h_ids >= 0).all() and half[h_ids].all())
    five = np.zeros(n, bool)
    five[::20] = True
    reset_counts()
    f_ids, _ = handle.search(q[:64], 10, row_mask=five)
    k1_five = u8_scan.u8_bin_max.launches
    in_five = bool((f_ids >= 0).all() and five[f_ids].all())
    d_ids, _ = handle.search(x[[7, 8]], 10)
    handle.flat_serve_threshold, handle.graph_filter_min = limits
    print(f"graph routes (limits {n - 1} < {n} rows): unfiltered b1024 recall@10 {r:.4f} in {t * 1e3:.1f} ms "
          f"(K1 launches {k1_graph}); 50% filter recall@10 {r_half:.4f} against the masked oracle, ids in the "
          f"mask {in_half}, {t_half * 1e3:.1f} ms; 5% filter: the scan (K1 launches {k1_five}), ids in the mask "
          f"{in_five}; deleted 7 absent {7 not in d_ids} [{card}]", flush=True)
    if r < MIN_RECALL or r_half < MIN_RECALL:
        fail(f"graph routes: recall@10 {r:.4f} / {r_half:.4f} < {MIN_RECALL}")
    if not (in_half and in_five) or k1_graph or not k1_five:
        fail("graph routes: a filter leaked, or a route took the wrong engine")
    if 7 in d_ids or d_ids[1, 0] != 8:
        fail(f"graph routes: deleted 7 came back or 8 did not find itself: {d_ids[:, :3].tolist()}")


def k2_check(gen, dev, card: str) -> tuple[int, dict, int, dict]:
    """K2 against its plain version, bit for bit: res 1-3; Dp 128 (d_true
    100), 160 (a partial K-slice), 768 and 1,536 (two K-chunks); the whole
    store and two row chunks of it, strided views of its planes (C = 65,440
    and 4,128 ragged against the 128-row store tile); B = 1 to 4,096. The
    query unpack kernel against word_major_codes at the same shapes; the
    row chunks take its codes as the chunked scan passes them, the whole
    store has the wrapper unpack. Returns (K2's max_abs_err, its timing at
    res=2, B=1024, C=65,536, Dp=768, the unpack's max_abs_err, its timing
    at res=2, B=1024, Dp=768)."""
    max_err = unpack_err = 0
    timed = unpack_timed = None
    for res in (1, 2, 3):
        for dp in (128, 160, 768, 1536):
            d_true = dp - 28 if dp == 128 else dp
            x = torch.rand((65_536 if dp in (128, 768) else 8_192, dp), generator=gen, device=dev) * 2 - 1
            whole = quantize_subbyte(x, res, d_true)
            del x
            for planes in (whole.planes, whole.planes[:, 96:], whole.planes[:, 1000:5128]):
                c = planes.shape[1]
                errs = []
                for b in (1, 8, 100, 128, 1024, 4096):
                    q = quantize_subbyte(torch.rand((b, dp), generator=gen, device=dev) * 2 - 1, res, d_true)
                    q_codes = subbyte_scan.unpack_query_codes(q.planes)
                    ue = int((q_codes.to(torch.int32) - subbyte_scan.word_major_codes(q.planes).to(torch.int32))
                             .abs().max())
                    if ue != 0:
                        fail(f"the query unpack disagrees with word_major_codes at res={res} B={b} Dp={dp}: {ue}")
                    unpack_err = max(unpack_err, ue)
                    chunk = planes is not whole.planes
                    got = subbyte_scan.subbyte_code_scores(q.planes, planes, dp, q_codes if chunk else None)
                    want = subbyte_scan.subbyte_code_scores_plain(q.planes, planes, dp)
                    torch.cuda.synchronize()
                    if got.shape != (b, c):
                        fail(f"K2 shape {tuple(got.shape)} at res={res} B={b} C={c} Dp={dp}")
                    e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                    errs.append(f"B={b}:{e}")
                    if e != 0:
                        fail(f"K2 disagrees with plain at res={res} B={b} C={c} Dp={dp}: {e}")
                    max_err = max(max_err, e)
                    if (res, b, c, dp) == (2, 1024, 65_536, 768):
                        qc, vc = subbyte_scan.word_major_codes(q.planes), subbyte_scan.word_major_codes(planes)
                        # both sides' planes read once, the int32 dots written (the wrapper's
                        # query unpack included)
                        timed = kernel_timing(
                            f"res={res} B={b} C={c} Dp={dp}",
                            lambda: subbyte_scan.subbyte_code_scores(q.planes, planes, dp),
                            lambda: subbyte_scan.subbyte_code_scores_plain(q.planes, planes, dp),
                            lambda: torch._int_mm(qc, vc.t()), 5, 2.0 * b * c * dp,
                            4 * res * (dp // 32) * (b + c) + 4 * b * c, card)
                        # the query planes read once, the int8 codes written; no arithmetic to speak of
                        unpack_timed = kernel_timing(
                            f"the query unpack, res={res} B={b} Dp={dp}",
                            lambda: subbyte_scan.unpack_query_codes(q.planes),
                            lambda: subbyte_scan.word_major_codes(q.planes), None, 5, 0.0,
                            4 * res * (dp // 32) * b + b * dp, card)
                        del qc, vc
                    del got, want, q, q_codes
                print(f"  res={res} C={c:6d} Dp={dp:4d} d_true={d_true:4d} max_abs_err {' '.join(errs)}", flush=True)
            del whole, planes
            torch.cuda.empty_cache()
    return max_err, timed, unpack_err, unpack_timed


def flat_index(kind: str, x, dev) -> FlatIndex:
    flat = FlatIndex(DIM, dev, kind=kind, initial_capacity=len(x))
    for s in range(0, len(x), ADD_BATCH):
        flat.add(x[s : s + ADD_BATCH])
    return flat


def subbyte_path(x, q, truth, dev, card: str) -> tuple[int, int, DenseIndexHandle]:
    """Phases 6 to 8; returns K2's and the query unpack's launches during
    the quaternary runs and the quaternary handle, which phases 11 and 18
    serve."""
    k2, unpack = subbyte_scan.subbyte_code_scores, subbyte_scan.unpack_query_codes
    t0 = time.perf_counter()
    handle = DenseIndexHandle(DIM, dev, quantization={"type": "scalar", "data_type": "quaternary"})
    graph_ingest(handle, x, q, card, "quaternary handle")
    print(f"quaternary handle ingest {time.perf_counter() - t0:.1f} s, rerank factor {handle.index._rerank_factor()}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_h, (h_ids, _) = timed_search(lambda: handle.search(q[:1024], 10))
    launches_h, unpack_h = k2.launches, unpack.launches
    check_results(f"quaternary DenseIndexHandle.search {N} rows b1024", h_ids, truth[:1024], t_h, card, True)
    print(f"store bytes {handle.index.store.device_nbytes()}; peak allocated during search "
          f"{torch.cuda.max_memory_allocated()} B; K2 launches {launches_h}, query unpack {unpack_h} [{card}]")
    if launches_h == 0 or unpack_h == 0:
        fail("the quaternary DenseIndexHandle path never launched K2 or the query unpack")

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
    launches_f, unpack_f = k2.launches, unpack.launches
    check_results("quaternary FlatIndex.search(rerank x20) b1024", f1_ids, truth_s[:1024], t_f1, card, True)
    check_results("quaternary FlatIndex.search(rerank x20) b4096", f4_ids, truth_s, t_f4, card, True)
    print(f"store bytes {flat.store.device_nbytes()}; peak allocated during search "
          f"{torch.cuda.max_memory_allocated()} B; K2 launches {launches_f}, query unpack {unpack_f} [{card}]")
    if launches_f == 0 or unpack_f == 0:
        fail("the quaternary FlatIndex path never launched K2 or the query unpack")
    del flat
    torch.cuda.empty_cache()
    # octal at the handle's 5x ladder step and at 20x
    for kind, factors in (("binary", (20,)), ("octal", (5, 20)), ("f16", (5,))):
        flat = flat_index(kind, xs, dev)
        for factor in factors:
            reset_counts()
            t, (ids, _) = timed_search(lambda: flat.search(q[:1024], 10, rerank=True, rerank_factor=factor), reps=1)
            check_results(f"{kind} FlatIndex.search(rerank x{factor}) b1024", ids, truth_s[:1024], t, card, False)
            print(f"  store bytes {flat.store.device_nbytes()}; K2 launches {k2.launches}, query unpack "
                  f"{unpack.launches}")
        del flat
        torch.cuda.empty_cache()
    return launches_h + launches_f, unpack_h + unpack_f, handle


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
    graph = graph_answers(coll, q_rest)
    print(f"u8_bin_max launches in phase 9: {launches}; graph answers (limit {N_REST - 1} < {N_REST} rows) "
          f"recall@10 {recall10(graph[0], torch.as_tensor(truth[:256])):.4f} [{card}]", flush=True)
    client.close()
    server.close()
    ctx.close()
    return {"launches": launches, "ids": seq[0], "scores": seq[1], "victim": victim, "graph": graph}


def graph_answers(coll, q_rest: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The collection's dense answers to 256 queries with the serving limit
    below its rows: the graph's."""
    d = coll.dense
    if d.index.scan_only:
        fail("the REST collection's dense index holds no graph")
    limit, d.flat_serve_threshold = d.flat_serve_threshold, d.index.n - 1
    out = rows_of(coll.search_dense(np.asarray(q_rest[:256], np.float32), 10))
    d.flat_serve_threshold = limit
    return out


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
    g_ids, g_scores = graph_answers(ctx.get_collection("rest"), q_rest)
    same_graph = bool((g_ids == before["graph"][0]).all() and (g_scores == before["graph"][1]).all())
    print(f"after restart: ids identical {same_ids}, scores identical {same_scores}; graph answers identical "
          f"{same_graph}; deleted {before['victim']} answers HTTP {status}; {dt:.3f} s; u8_bin_max launches "
          f"{launches} [{card}]", flush=True)
    client.close()
    server.close()
    ctx.close()
    if not (same_ids and same_scores and same_graph):
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
    k2, unpack = subbyte_scan.subbyte_code_scores.launches, subbyte_scan.unpack_query_codes.launches
    served_line(f"served quaternary {N} rows, {WORKERS} workers", ids4, truth[: len(sub)].cpu().numpy(),
                dt4, lat4, card)
    print(f"subbyte_code_scores launches in phase 11: {k2}, query unpack {unpack}", flush=True)
    return {"k1": k1, "k2": k2, "unpack": unpack, "ids": ids, "qr": qr}


def grpc_find(ctx: AppContext, requests: list) -> tuple[list, float]:
    """Serve ``ctx`` over gRPC on a free local port, log in, and send each
    FindSimilarVectorsRequest; returns each one's match ids and the seconds
    the searches took."""
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
        t0 = time.perf_counter()
        out = [[int(m.id) for m in call("FindSimilarVectors", "VectorsService", req,
                                        pb.FindSimilarVectorsResponse, md).matches] for req in requests]
        return out, time.perf_counter() - t0
    finally:
        channel.close()
        server.stop(0)


def grpc_phase(ctx: AppContext, served: dict, card: str) -> int:
    """Phase 12: FindSimilarVectors on the u8 collection returns REST's ids."""
    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

    reset_counts()
    got, dt = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
        collection_id="served_u8", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
    ) for v in served["qr"][:8]])
    launches = u8_scan.u8_bin_max.launches
    want = served["ids"][:8].tolist()
    print(f"gRPC FindSimilarVectors x8: ids equal REST's {got == want}; {dt:.3f} s; "
          f"u8_bin_max launches {launches} [{card}]", flush=True)
    if got != want:
        fail(f"gRPC ids differ from REST's: {got} vs {want}")
    return launches

def sparse_corpus(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's sparse corpus: zipf-ish dims pareto(1.2)·50 mod vocab,
    gamma(2.0, 0.8) values; (n, NNZ_SP) each."""
    rng = np.random.default_rng(seed)
    dims = (rng.pareto(1.2, size=n * NNZ_SP) * 50).astype(np.int64) % VOCAB_SP
    vals = rng.gamma(2.0, 0.8, size=n * NNZ_SP).astype(np.float32)
    return dims.reshape(n, NNZ_SP), vals.reshape(n, NNZ_SP)


def rare_queries(dims: np.ndarray, vals: np.ndarray, rows) -> list:
    """Each query is a doc's NNZ_Q rarest (highest) dims with its values."""
    out = []
    for j in rows:
        pick = np.argsort(dims[j])[-NNZ_Q:]
        out.append([(int(d), float(v)) for d, v in zip(dims[j][pick], vals[j][pick])])
    return out


def overlap(ids, want, k: int = 10) -> float:
    """Mean |top-k ∩ wanted top-k| / k (bench.py's recall_vs_exact)."""
    return float(np.mean([len(set(map(int, a[:k])) & set(map(int, b[:k]))) / k for a, b in zip(ids, want)]))


def fusion_match(ids, want) -> float:
    """bench.py's fusion_vs_oracle: tie-tolerant set match of fused lists."""
    return float(np.mean([len(set(map(int, a)) & set(map(int, b))) / max(int((b >= 0).sum()), 1)
                          for a, b in zip(ids, want)]))


class BruteSparse:
    """Exact sparse scores on the card from the raw pairs, independent of
    the index: Σ over a doc's pairs of max(q, 0)·max(v, 0), the query as a
    dense vocab row gathered by the doc's dims."""

    def __init__(self, dims: np.ndarray, vals: np.ndarray, dev):
        self.dev = dev
        self.dims = torch.as_tensor(dims, device=dev)
        self.vals = torch.as_tensor(np.maximum(vals, 0).astype(np.float32), device=dev)

    def scores(self, q) -> torch.Tensor:
        arr = np.asarray(q, np.float64)
        row = torch.zeros(VOCAB_SP, dtype=torch.float32, device=self.dev)
        row.index_add_(0, torch.as_tensor(arr[:, 0].astype(np.int64), device=self.dev),
                       torch.as_tensor(np.maximum(arr[:, 1], 0).astype(np.float32), device=self.dev))
        return (row[self.dims] * self.vals).sum(1)

    def recall(self, queries, ids, k: int = 10) -> float:
        """Tie-tolerant recall@k: a returned id counts when its exact score
        reaches the k-th best exact score (rtol 1e-5)."""
        hits = 0
        for q, row in zip(queries, ids):
            sc = self.scores(q)
            kth = float(torch.topk(sc, k).values[-1])
            got = torch.as_tensor([int(i) for i in row[:k] if i >= 0], dtype=torch.int64, device=self.dev)
            hits += int((sc[got] >= kth - 1e-5 * abs(kth)).sum())
        return hits / (k * len(queries))


def sparse_phase(dev, card: str) -> None:
    """Phase 13: the sparse engine at the reference's bench scale."""
    t0 = time.perf_counter()
    dims, vals = sparse_corpus(N_SP, SEED_SP)
    print(f"corpus {N_SP} docs x {NNZ_SP} pairs, vocab {VOCAB_SP}, in {time.perf_counter() - t0:.1f} s")
    inv = InvertedIndex(dev, quantization=64, sample_threshold=256)
    for i in range(256):
        inv.add(i, dims[i], vals[i])
    t0 = time.perf_counter()
    for s in range(256, N_SP, 65536):
        e = min(s + 65536, N_SP)
        inv.add_batch(np.arange(s, e), dims[s:e].ravel(), vals[s:e].ravel(), np.full(e - s, NNZ_SP))
    inv.flush()
    ingest = (N_SP - 256) / (time.perf_counter() - t0)
    queries = rare_queries(dims, vals, range(64))
    t0 = time.perf_counter()
    inv.search(queries, 10)  # the first search uploads the CSR, doc rows and head
    print(f"ingest {ingest:.0f} docs/s (add_batch + flush, host); first search {time.perf_counter() - t0:.2f} s; "
          f"upper bound {inv.values_upper_bound}, n_cap {inv.n_cap}, head dims {len(inv._head_didx)}", flush=True)
    if inv.n_cap < inv.HEAD_MIN_CAP or inv._head_codes_dev is None:
        fail("the dense-head engine did not engage")
    tensors = {"csr ids": inv._csr_ids, "csr values": inv._csr_vals, "doc dims": inv._doc_dims_dev,
               "doc values": inv._doc_vals_dev, "alive": inv._alive_dev, "head codes": inv._head_codes_dev}
    off = [name for name, x in tensors.items() if x.device.type != "cuda"]
    if off:
        fail(f"sparse tensors off the card: {off}")
    print("device bytes: " + ", ".join(f"{name} {x.numel() * x.element_size()}" for name, x in tensors.items()))
    torch.cuda.reset_peak_memory_stats()
    t64, (ids, _) = timed_search(lambda: inv.search(queries, 10), reps=3)
    t256, (ids4, _) = timed_search(lambda: inv.search(queries * 4, 10), reps=3)
    peak = torch.cuda.max_memory_allocated()
    saved = inv.SCAN_BUDGET
    inv.SCAN_BUDGET, inv.EXHAUSTIVE = 1 << 30, True  # the oracle: every tail posting rescored
    t_ex = time.perf_counter()
    ids_ex, _ = inv.search(queries, 10)
    t_ex = time.perf_counter() - t_ex
    inv.SCAN_BUDGET, inv.EXHAUSTIVE = saved, False
    brute = BruteSparse(dims, vals, dev)
    rec_ex = overlap(ids, ids_ex)
    rec_brute = brute.recall(queries, ids)
    rec_ex_brute = brute.recall(queries, ids_ex)
    self_hit = float(np.mean([j in set(map(int, ids[j])) for j in range(64)]))
    inv.search([queries[0]], 10)  # warm the single-query shapes
    ids1, lat1 = [], []
    for q1 in queries[:8]:
        t0 = time.perf_counter()
        ids1.append(inv.search([q1], 10)[0][0])
        lat1.append(time.perf_counter() - t0)
    rec1 = overlap(ids1, ids_ex[:8])
    print(f"sparse {N_SP} docs: b64 {t64 * 1e3:.2f} ms = {64 / t64:.1f} qps, b256 {t256 * 1e3:.2f} ms = "
          f"{256 / t256:.1f} qps, b1 median {statistics.median(lat1) * 1e3:.2f} ms; peak allocated "
          f"{peak} B [{card}]", flush=True)
    print(f"recall_vs_exact {rec_ex:.4f} (exhaustive oracle, {t_ex:.2f} s), {rec_brute:.4f} (brute-force score; "
          f"the oracle itself {rec_ex_brute:.4f}), b1 {rec1:.4f}; b256 rows equal b64's "
          f"{bool((ids4[:64] == ids).all())}; self_recall {self_hit:.3f}", flush=True)
    for name, r in (("recall_vs_exact", rec_ex), ("recall against brute force", rec_brute), ("b1 recall", rec1)):
        if r < MIN_RECALL:
            fail(f"sparse {name} {r:.4f} < {MIN_RECALL}")

    # keep_raw=False: the two quantized-score routes on the same segments
    raw_less = InvertedIndex(dev, quantization=64, values_upper_bound=inv.values_upper_bound, keep_raw=False)
    del inv
    torch.cuda.empty_cache()
    raw_less.add_batch(np.arange(N_SP), dims.ravel(), vals.ravel(), np.full(N_SP, NNZ_SP))
    raw_less.flush()
    t_route, (ids_q, _) = timed_search(lambda: raw_less.search(queries, 10), reps=3)
    # a width the router sends to the segment route (at most 65,536 slots)
    starts, lens, mults = raw_less._segments_batch(queries, 16384)
    args = (*(torch.as_tensor(a, device=dev) for a in (starts, lens, mults)), raw_less._csr_ids,
            raw_less._csr_vals, raw_less._alive_dev)
    seg = sparse_kernels.csr_segment_topk(*args, 10, raw_less.SEGCAP, aligned=True)
    sca = sparse_kernels.csr_accumulate_topk(*args, raw_less.n_cap, 10, raw_less.SEGCAP, aligned=True)
    ms_seg = cuda_ms(lambda: sparse_kernels.csr_segment_topk(*args, 10, raw_less.SEGCAP, aligned=True), 3)
    ms_sca = cuda_ms(lambda: sparse_kernels.csr_accumulate_topk(*args, raw_less.n_cap, 10, raw_less.SEGCAP,
                                                                aligned=True), 3)
    width = starts.shape[1] * raw_less.SEGCAP
    print(f"keep_raw=False b64, {width} gathered slots per query: segment route {ms_seg:.3f} ms, scatter route "
          f"{ms_sca:.3f} ms (device, not gated), max score difference {float((seg[0] - sca[0]).abs().max()):.3g}; "
          f"search() at the default budget {t_route * 1e3:.2f} ms, quantized recall_vs_exact "
          f"{overlap(ids_q, ids_ex):.4f} [{card}]",
          flush=True)
    del raw_less, args, seg, sca, brute
    torch.cuda.empty_cache()


def sparse_rest_phase(data_dir: str, x_hy: np.ndarray, q_rest: np.ndarray, hy_dims, hy_vals, dev,
                      card: str) -> dict:
    """Phase 14: dense + sparse written over REST, sparse and hybrid
    searched, read back, deleted, then the restart and gRPC; returns K1's
    launches over the phase."""
    n = N_SP_REST
    dims, vals = hy_dims[:n], np.round(hy_vals[:n].astype(np.float64), 6)
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    c = "/vectordb/collections/hyrest"
    client.ok("POST", "/vectordb/collections", {
        "name": "hyrest", "dense_vector": {"enabled": True, "dimension": DIM}, "sparse_vector": {"enabled": True},
    })
    client.ok("POST", c + "/indexes/dense", {"name": "hyrest_dense", "distance_metric_type": "cosine",
                                             "quantization": {"type": "auto"}})
    client.ok("POST", c + "/indexes/sparse", {"name": "hyrest_sparse", "quantization": 64, "sample_threshold": 256})
    rows = x_hy.tolist()
    pairs = [[[int(d), float(v)] for d, v in zip(dims[i], vals[i])] for i in range(n)]
    t0 = time.perf_counter()
    txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
    for s in range(0, n, UPSERT_ROWS):
        client.ok("POST", f"{c}/transactions/{txn}/upsert", {"vectors": [
            {"id": i, "dense_values": rows[i], "sparse_values": pairs[i]} for i in range(s, s + UPSERT_ROWS)
        ]})
    client.ok("POST", f"{c}/transactions/{txn}/commit", {})
    while (st := client.ok("GET", f"{c}/transactions/{txn}/status"))["status"] != "complete":
        if time.perf_counter() - t0 > 600:
            fail(f"the transaction did not complete: {st}")
        time.sleep(0.2)
    print(f"REST ingest of {n} x ({DIM} dense + {NNZ_SP} sparse pairs) in {n // UPSERT_ROWS} requests: "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    queries = rare_queries(dims, vals, range(64))
    hybrid = [{"query_vector": q_rest[j].tolist(), "query_terms": queries[j]} for j in range(64)]
    reset_counts()

    def answers(cl) -> dict:
        out = cl.ok("POST", c + "/search/batch-sparse", {"query_terms_list": queries, "top_k": 10})
        sp = rows_of([r["results"] for r in out["responses"]])
        out = cl.ok("POST", c + "/search/batch-hybrid", {"queries": hybrid, "top_k": 10})
        hy = rows_of([r["results"] for r in out["responses"]])
        one = rows_of([cl.ok("POST", c + "/search/sparse", {"query_terms": q, "top_k": 10})["results"]
                       for q in queries[:8]])
        return {"sparse": sp, "hybrid": hy, "one": one}

    first = answers(client)
    brute = BruteSparse(dims, vals, dev)
    rec = brute.recall(queries, first["sparse"][0])
    rec1 = brute.recall(queries[:8], first["one"][0])
    coll = ctx.get_collection("hyrest")
    d_ids, _ = coll.dense.search(np.asarray(q_rest[:64], np.float32), 30)
    s_ids, _ = coll.sparse.search(queries, top_k=30)
    fuse = fusion_match(first["hybrid"][0], rrf_fuse([d_ids, s_ids], 10, 30)[0])
    probe = n // 2 + 1
    rec_get = client.ok("GET", f"{c}/vectors/{probe}")
    got = sorted((int(d), float(v)) for d, v in rec_get["sparse_values"])
    want = sorted(zip(dims[probe].tolist(), vals[probe].tolist()))
    get_err = max(abs(a[1] - b[1]) for a, b in zip(got, want)) if len(got) == len(want) else float("inf")
    if [a[0] for a in got] != [b[0] for b in want] or get_err > 1e-6:
        fail(f"GET /vectors/{probe}: sparse_values differ from the written pairs (max value error {get_err})")
    victim = int(first["one"][0][0, 0])
    client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
    res = client.ok("POST", c + "/search/sparse", {"query_terms": queries[0], "top_k": 10})["results"]
    if victim in [r["id"] for r in res]:
        fail(f"streamed delete of {victim}: it came back for its own terms")
    before = answers(client)
    print(f"sparse recall@10 against brute force: /batch-sparse (64) {rec:.4f}, /sparse (8 single) {rec1:.4f}; "
          f"/batch-hybrid ids = RRF of the legs {fuse:.4f}; GET /vectors/{probe}: sparse max value error "
          f"{get_err:.3g}; streamed delete of {victim}: ok [{card}]", flush=True)
    for name, r in (("/batch-sparse recall", rec), ("/sparse recall", rec1), ("hybrid fusion match", fuse)):
        if r < MIN_RECALL:
            fail(f"phase 14 {name} {r:.4f} < {MIN_RECALL}")
    client.close()
    server.close()
    ctx.close()

    t0 = time.perf_counter()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    t_load = time.perf_counter() - t0
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    after = answers(client)
    same = {k: bool((after[k][0] == before[k][0]).all() and (after[k][1] == before[k][1]).all()) for k in after}
    status, _ = client.call("GET", f"{c}/vectors/{victim}")
    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

    grpc_ids, _ = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
        collection_id="hyrest",
        sparse=pb.FindSimilarSparseVectorsQuery(values=[pb.SparsePair(index=d, value=v) for d, v in q], top_k=10),
    ) for q in queries[:8]])
    launches = u8_scan.u8_bin_max.launches
    grpc_same = grpc_ids == [[int(i) for i in row if i >= 0] for row in after["one"][0]]
    print(f"after restart ({t_load:.1f} s): identical ids and scores {same}; deleted {victim} answers HTTP {status}; "
          f"gRPC FindSimilarVectors (sparse) x8: ids equal REST's {grpc_same}; u8_bin_max launches in phase 14: "
          f"{launches} (dense capacity {N_SP_REST}, below one scan chunk: the reference's plain scan) [{card}]",
          flush=True)
    client.close()
    server.close()
    ctx.close()
    if not all(same.values()):
        fail("the restarted context answered sparse or hybrid queries differently")
    if status != 404:
        fail(f"the deleted vector came back after the restart (HTTP {status})")
    if not grpc_same:
        fail(f"gRPC sparse ids differ from REST's: {grpc_ids} vs {after['one'][0]}")
    return {"launches": launches}


def hybrid_phase(x, q, hy_dims, hy_vals, dev, card: str) -> int:
    """Phase 15: hybrid served at 100,000 (bench.py:962-1070); returns K1's launches."""
    dims, vals = hy_dims[:N_HY], hy_vals[:N_HY]
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
        coll = ctx.create_collection({"name": "hybench", "dense_vector": {"enabled": True, "dimension": DIM},
                                      "sparse_vector": {"enabled": True}})
        lo, hi = tune_dense_range(x[:1000].cpu().numpy())
        coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8", "range": {"min": lo, "max": hi}},
                                raw_storage="device")
        t0 = time.perf_counter()
        coll.dense.add_batch(list(range(N_HY)), x[:N_HY])  # one call: the bulk build
        coll.create_sparse_index(quantization=64, sample_threshold=256)
        for i in range(256):
            coll.sparse.add(i, dims[i], vals[i])
        coll.sparse.add_batch(np.arange(256, N_HY), dims[256:].ravel(), vals[256:].ravel(),
                              np.full(N_HY - 256, NNZ_SP))
        coll.sparse.flush()
        coll.raw = {i: {"id": i, "document_id": None} for i in range(N_HY)}
        print(f"ingest (engine API) {time.perf_counter() - t0:.1f} s; dense capacity {coll.dense.index.cap}",
              flush=True)
        hq_dense = np.concatenate([q[:64].cpu().numpy()] * 4)
        hq_sparse = rare_queries(dims, vals, [j % 64 for j in range(256)])
        queries = [{"query_vector": hq_dense[j], "query_terms": hq_sparse[j]} for j in range(256)]
        reset_counts()
        t_hy, res = timed_search(lambda: coll.hybrid_search_batch(queries, top_k=10), reps=3)
        fused, _ = rows_of(res)
        server = RestServer(ctx)
        client = RestClient(server.port)
        client.login()
        same_direct, lat = [], []
        http_ids = []
        for s in range(0, 256, 64):
            part = queries[s : s + 64]
            direct, _ = rows_of(coll.hybrid_search_batch(part, top_k=10))
            t0 = time.perf_counter()
            out = client.ok("POST", "/vectordb/collections/hybench/search/batch-hybrid", {"queries": [
                {"query_vector": p["query_vector"].tolist(), "query_terms": p["query_terms"]} for p in part
            ], "top_k": 10})
            lat.append(time.perf_counter() - t0)
            ids, _ = rows_of([r["results"] for r in out["responses"]])
            http_ids.append(ids)
            same_direct.append(bool((ids == direct).all()))
        launches = u8_scan.u8_bin_max.launches
        # the oracle: RRF of the two legs' own searches, outside the count
        d_ids, _ = coll.dense.search(hq_dense, 30)
        s_ids, _ = coll.sparse.search(hq_sparse, top_k=30)
        fuse = fusion_match(fused, rrf_fuse([d_ids, s_ids], 10, 30)[0])
        self_hit = float(np.mean([(j % 64) in set(map(int, fused[j])) for j in range(256)]))
        http_ids = np.concatenate(http_ids)
        print(f"hybrid {N_HY} docs, Collection.hybrid_search_batch b256: {t_hy * 1e3:.2f} ms = {256 / t_hy:.1f} qps; "
              f"fusion_vs_oracle {fuse:.4f}; self_recall {self_hit:.3f}; /batch-hybrid 4 requests of 64: median "
              f"{statistics.median(lat) * 1e3:.1f} ms = {256 / sum(lat):.1f} qps, ids equal the direct calls' "
              f"{same_direct}, equal the b256 call's {bool((http_ids == fused).all())}; u8_bin_max launches "
              f"{launches} [{card}]", flush=True)
        client.close()
        server.close()
        ctx.close()
    if fuse < MIN_RECALL:
        fail(f"hybrid fusion_vs_oracle {fuse:.4f} < {MIN_RECALL}")
    if not all(same_direct):
        fail("/batch-hybrid ids differ from the direct hybrid_search_batch calls'")
    if launches == 0:
        fail("the hybrid dense leg never launched u8_bin_max")
    return launches


def bm25_corpus() -> tuple[list[str], np.ndarray]:
    """bench.py's BM25 corpus: words w0..w19999, pareto(1.1) ids mod the
    vocabulary, WORDS_BM per doc; returns the texts and the (N_BM,
    WORDS_BM) word ids."""
    return text_corpus(N_BM, VOCAB_BM, WORDS_BM, SEED_BM)


def bm25_queries(ids: np.ndarray, rows) -> list[str]:
    """Each query is a doc's QWORDS_BM rarest (highest-id) words."""
    return [" ".join(f"w{w}" for w in np.sort(ids[j])[-QWORDS_BM:]) for j in rows]


class BruteBM25:
    """Exact BM25 scores on the card from an index's host postings,
    independent of its device layout: Σ over a query's terms of idf·tf,
    the idf over live documents (f32, as the index computes it), the query
    as a dense row over the terms gathered by every live posting."""

    def __init__(self, tfi: TFIDFIndex, dev):
        terms = sorted(tfi._postings)
        self.col = {t: i for i, t in enumerate(terms)}
        docs = np.concatenate([np.asarray(tfi._postings[t], np.int64) for t in terms])
        term_idx = np.repeat(np.arange(len(terms)), [len(tfi._postings[t]) for t in terms])
        tfs = np.concatenate([np.asarray(tfi._tfs[t], np.float32) for t in terms])
        live = tfi._alive[docs]
        df = np.bincount(term_idx[live], minlength=len(terms))
        n = tfi.live_documents
        self.idf = np.log1p((n - df + 0.5) / (df + 0.5)).astype(np.float32)
        self.docs = torch.as_tensor(docs[live], device=dev)
        self.terms = torch.as_tensor(term_idx[live], device=dev)
        self.tfs = torch.as_tensor(tfs[live], device=dev)
        self.n_cap, self.dev, self.max_token_len = tfi.n_cap, dev, tfi.max_token_len

    def scores(self, text: str) -> torch.Tensor:
        """(n_cap,) exact scores, -inf where a doc holds no query term."""
        row = np.zeros(len(self.idf), np.float32)
        for t in process_text_query(text, self.max_token_len):
            if t in self.col:
                row[self.col[t]] = self.idf[self.col[t]]
        q = torch.as_tensor(row, device=self.dev)[self.terms]
        sc = torch.zeros(self.n_cap, device=self.dev).index_add_(0, self.docs, q * self.tfs)
        hit = torch.zeros(self.n_cap, device=self.dev).index_add_(0, self.docs, (q > 0).float())
        return torch.where(hit > 0, sc, float("-inf"))

    def recall(self, queries: list[str], ids, k: int = 10) -> float:
        """Tie-aware recall@k: a returned id counts when its exact score
        reaches the k-th best (rtol 1e-5); a query matching fewer than k
        docs counts those."""
        hits = want = 0
        for text, row in zip(queries, ids):
            sc = self.scores(text)
            m = min(k, int(torch.isfinite(sc).sum()))
            if m == 0:
                continue
            kth = float(torch.topk(sc, m).values[-1])
            got = torch.as_tensor([int(i) for i in row[:k] if i >= 0], dtype=torch.int64, device=self.dev)
            hits += int((sc[got] >= kth - 1e-5 * abs(kth)).sum())
            want += m
        return hits / max(want, 1)


def profile_top(fn, card: str, top: int = 5) -> None:
    """One torch.profiler pass over ``fn``: its wall time, the device time
    of its kernels, the busy share and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(device_us(e) for e in kernels) / 1e3
    print(f"  profile: wall {wall:.2f} ms (under the profiler), device {busy:.2f} ms, busy {busy / wall:.1%} "
          f"[{card}]", flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:100]}", flush=True)


def text_library_check(docs: list[str], queries: list[str], card: str) -> None:
    """The native text pipeline, built from the checkout with g++, held bit
    for bit against its plain Python version on this interpreter: every
    document and query of the corpus and the Unicode corpus; any
    difference fails. Prints the build time and both versions' rates."""
    t_build = text_native.LIBRARY.build()
    text_native.LIBRARY.load()
    avgdl = float(WORDS_BM)
    t0 = time.perf_counter()
    for text in docs:
        text_processing.process_text(text, 40, avgdl)
    t_process = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = pipeline(docs, False, 40, avgdl)
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = pipeline(docs, True, 40, avgdl)
    t_plain = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(lib, plain)) if a != b]
    bad_q = differences(queries, 40, avgdl)
    bad_u = differences(UNICODE_CORPUS) + differences(UNICODE_CORPUS, 6, 3.5, 2.0, 0.3)
    print(f"text library {text_native.LIBRARY.library.name} built by g++ in {t_build:.2f} s; process_text "
          f"{len(docs) / t_process:.0f} docs/s; process_text + count_tokens + process_text_query: library "
          f"{len(docs) / t_lib:.0f} docs/s, plain {len(docs) / t_plain:.0f} docs/s (host) [{card}]", flush=True)
    print(f"library against plain, bit for bit: {len(docs)} docs, {len(bad)} differ; {len(queries)} queries, "
          f"{len(bad_q)} differ; Unicode corpus of {len(UNICODE_CORPUS)} cases x 2 settings, {len(bad_u)} differ",
          flush=True)
    if bad or bad_q or bad_u:
        fail(f"the text library differs from its plain version: docs {bad[:5]}, queries {bad_q[:5]}, "
             f"Unicode cases {bad_u}")


def bm25_phase(x, q, docs: list[str], word_ids: np.ndarray, dev, card: str) -> int:
    """Phase 16: the text library against its plain version, the BM25
    engine at 100,000 docs, then dense + text hybrid over the same docs;
    returns K1's launches in the hybrid run."""
    text_library_check(docs, bm25_queries(word_ids, range(64)), card)
    tfi = TFIDFIndex(dev, sample_threshold=256)
    t0 = time.perf_counter()
    for i, text in enumerate(docs):
        tfi.add(i, text)
    tfi.flush()
    ingest = N_BM / (time.perf_counter() - t0)
    queries = bm25_queries(word_ids, range(64))
    t0 = time.perf_counter()
    tfi.search(queries, 10)  # the first search builds the CSR, doc rows and head on the host, uploads them
    print(f"ingest {ingest:.0f} docs/s (add + flush, host); first search {time.perf_counter() - t0:.2f} s; "
          f"avgdl {tfi.average_document_length:.3f}, terms {len(tfi._term_sorted)}, n_cap {tfi.n_cap}, head terms "
          f"{len(tfi._head_tidx)} [{card}]", flush=True)
    if tfi._head_codes_dev is None:
        fail("the BM25 dense head did not engage")
    tensors = {"csr ids": tfi._csr_ids, "csr tfs": tfi._csr_vals, "doc terms": tfi._doc_terms_dev,
               "doc tfs": tfi._doc_tfs_dev, "alive": tfi._alive_dev, "head codes": tfi._head_codes_dev}
    off = [name for name, t in tensors.items() if t.device.type != dev.type]
    if off:
        fail(f"BM25 tensors off the card: {off}")
    print("device bytes: " + ", ".join(f"{name} {t.numel() * t.element_size()} {tuple(t.shape)}"
                                       for name, t in tensors.items()), flush=True)
    torch.cuda.reset_peak_memory_stats()
    t64, (ids, _) = timed_search(lambda: tfi.search(queries, 10), reps=3)
    t256, (ids4, _) = timed_search(lambda: tfi.search(queries * 4, 10), reps=3)
    peak = torch.cuda.max_memory_allocated()
    tfi.search([queries[0]], 10)  # warm the single-query shapes
    ids1, lat1 = [], []
    for text in queries[:8]:
        t0 = time.perf_counter()
        ids1.append(tfi.search([text], 10)[0][0])
        lat1.append(time.perf_counter() - t0)
    # the oracle: unbounded budgets, every tail posting rescored (bench.py's)
    saved = (tfi.SCAN_BUDGET, tfi.MAX_TERM_POSTINGS)
    tfi.SCAN_BUDGET, tfi.MAX_TERM_POSTINGS, tfi.EXHAUSTIVE = 1 << 30, 1 << 30, True
    t_ex = time.perf_counter()
    ids_ex, _ = tfi.search(queries, 10)
    t_ex = time.perf_counter() - t_ex
    tfi.SCAN_BUDGET, tfi.MAX_TERM_POSTINGS = saved
    tfi.EXHAUSTIVE = False
    brute = BruteBM25(tfi, dev)
    rec_ex, rec_brute = overlap(ids, ids_ex), brute.recall(queries, ids)
    rec_ex_brute, rec1 = brute.recall(queries, ids_ex), brute.recall(queries[:8], ids1)
    self_hit = float(np.mean([j in set(map(int, ids[j])) for j in range(64)]))
    # bench.py's tie-aware self-recall: doc j counts when it sits in a widened
    # top-50 with a score at least the 10th-ranked one
    ids50, sc50 = tfi.search(queries, 50)
    tie_hits = sum(int(sc50[j][list(ids50[j]).index(j)] >= sc50[j][9] - 1e-4) for j in range(64) if j in ids50[j])
    print(f"BM25 {N_BM} docs: b64 {t64 * 1e3:.2f} ms = {64 / t64:.1f} qps, b256 {t256 * 1e3:.2f} ms = "
          f"{256 / t256:.1f} qps, b1 median {statistics.median(lat1) * 1e3:.2f} ms; peak allocated {peak} B [{card}]",
          flush=True)
    print(f"recall_vs_exact {rec_ex:.4f} (exhaustive oracle, {t_ex:.2f} s), {rec_brute:.4f} (brute-force Σ idf·tf; "
          f"the oracle itself {rec_ex_brute:.4f}), b1 {rec1:.4f}; b256 rows equal b64's "
          f"{bool((ids4[:64] == ids).all())}; self_recall {self_hit:.3f}, tie-aware {tie_hits / 64:.3f}", flush=True)
    for name, r in (("recall_vs_exact", rec_ex), ("recall against brute force", rec_brute), ("b1 recall", rec1)):
        if r < MIN_RECALL:
            fail(f"BM25 {name} {r:.4f} < {MIN_RECALL}")
    profile_top(lambda: tfi.search(queries * 4, 10), card)
    t_query = {}
    for name, fn in (("library", process_text_query), ("plain", text_processing.process_text_query_plain)):
        t0 = time.perf_counter()
        for text in queries * 4:
            fn(text, tfi.max_token_len)
        t_query[name] = time.perf_counter() - t0
    print(f"b256 query texts to term ids: library {t_query['library'] * 1e3:.3f} ms, plain "
          f"{t_query['plain'] * 1e3:.3f} ms, of the b256 search's {t256 * 1e3:.2f} ms (host) [{card}]", flush=True)
    del brute

    # dense + text hybrid: a u8 handle over phase 3's first N_BM rows (one
    # K1 scan chunk and more), the text leg on this index
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
        coll = ctx.create_collection({"name": "bm25hy", "dense_vector": {"enabled": True, "dimension": DIM},
                                      "tf_idf_options": {"enabled": True}})
        lo, hi = tune_dense_range(x[:1000].cpu().numpy())
        coll.create_dense_index(quantization={"type": "scalar", "data_type": "u8", "range": {"min": lo, "max": hi}})
        coll.dense.add_batch(list(range(N_BM)), x[:N_BM])  # one call: the bulk build
        coll.tfidf = tfi
        coll.raw = {i: {"id": i, "document_id": None} for i in range(N_BM)}
        hq_dense = np.concatenate([q[:64].cpu().numpy()] * 4)
        hq_text = queries * 4
        hybrid = [{"query_vector": hq_dense[j], "query_text": hq_text[j]} for j in range(256)]
        reset_counts()
        t_hy, res = timed_search(lambda: coll.hybrid_search_batch(hybrid, top_k=10), reps=3)
        launches = u8_scan.u8_bin_max.launches
        fused, _ = rows_of(res)
        d_ids, _ = coll.dense.search(hq_dense, 30)
        t_ids, _ = tfi.search(hq_text, top_k=30)
        fuse = fusion_match(fused, rrf_fuse([d_ids, t_ids], 10, 30)[0])
        self_hit = float(np.mean([(j % 64) in set(map(int, fused[j])) for j in range(256)]))
        print(f"dense + text hybrid {N_BM} docs, Collection.hybrid_search_batch b256: {t_hy * 1e3:.2f} ms = "
              f"{256 / t_hy:.1f} qps; fusion_vs_oracle {fuse:.4f}; self_recall {self_hit:.3f}; dense capacity "
              f"{coll.dense.index.cap}; u8_bin_max launches {launches} [{card}]", flush=True)
        ctx.close()
    if fuse < MIN_RECALL:
        fail(f"dense + text fusion_vs_oracle {fuse:.4f} < {MIN_RECALL}")
    if launches == 0:
        fail("the dense + text hybrid's dense leg never launched u8_bin_max")
    return launches


def bm25_rest_phase(data_dir: str, x_hy: np.ndarray, q_rest: np.ndarray, docs: list[str], word_ids: np.ndarray,
                    dev, card: str) -> int:
    """Phase 17: dense + text written over REST, tf-idf and hybrid searched
    against the direct calls, a text read back, a streamed delete, then the
    restart, gRPC, the reloaded graph and a scan-only reload; returns K1's
    launches."""
    n = N_SP_REST
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    c = "/vectordb/collections/bmrest"
    client.ok("POST", "/vectordb/collections", {
        "name": "bmrest", "dense_vector": {"enabled": True, "dimension": DIM}, "tf_idf_options": {"enabled": True},
    })
    client.ok("POST", c + "/indexes/dense", {"name": "bmrest_dense", "distance_metric_type": "cosine",
                                             "quantization": {"type": "auto"}})
    client.ok("POST", c + "/indexes/tf-idf", {"name": "bmrest_text", "sample_threshold": 256})
    rows = x_hy.tolist()
    t0 = time.perf_counter()
    txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
    for s in range(0, n, UPSERT_ROWS):
        client.ok("POST", f"{c}/transactions/{txn}/upsert", {"vectors": [
            {"id": i, "dense_values": rows[i], "text": docs[i]} for i in range(s, s + UPSERT_ROWS)
        ]})
    client.ok("POST", f"{c}/transactions/{txn}/commit", {})
    while (st := client.ok("GET", f"{c}/transactions/{txn}/status"))["status"] != "complete":
        if time.perf_counter() - t0 > 600:
            fail(f"the transaction did not complete: {st}")
        time.sleep(0.2)
    print(f"REST ingest of {n} x ({DIM} dense + a {WORDS_BM}-word text) in {n // UPSERT_ROWS} requests: "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    coll = ctx.get_collection("bmrest")
    queries = bm25_queries(word_ids, range(64))
    hybrid = [{"query_vector": q_rest[j].tolist(), "query_text": queries[j]} for j in range(64)]
    reset_counts()

    def answers(cl) -> dict:
        out = cl.ok("POST", c + "/search/batch-tf-idf", {"queries": queries, "top_k": 10})
        text = rows_of([r["results"] for r in out["responses"]])
        one = rows_of([cl.ok("POST", c + "/search/tf-idf", {"query": t, "top_k": 10})["results"]
                       for t in queries[:8]])
        out = cl.ok("POST", c + "/search/batch-hybrid", {"queries": hybrid, "top_k": 10})
        hy = rows_of([r["results"] for r in out["responses"]])
        hy_one = rows_of([cl.ok("POST", c + "/search/hybrid", {**hybrid[j], "top_k": 10})["results"]
                          for j in range(4)])
        return {"text": text, "one": one, "hybrid": hy, "hybrid_one": hy_one}

    def same(a, b) -> bool:
        return bool((a[0] == b[0]).all() and np.allclose(a[1], b[1], rtol=1e-6, atol=0))

    first = answers(client)
    # the same batches as the requests (the scan budget depends on the batch)
    direct = {
        "text": rows_of(coll.search_tfidf(queries, 10)),
        "one": rows_of([coll.search_tfidf([t], 10)[0] for t in queries[:8]]),
        "hybrid": rows_of(coll.hybrid_search_batch(hybrid, 10)),
        "hybrid_one": rows_of([coll.hybrid_search(hybrid[j], 10) for j in range(4)]),
    }
    equal_direct = {k: same(first[k], direct[k]) for k in first}
    brute = BruteBM25(coll.tfidf, dev)
    rec, rec1 = brute.recall(queries, first["text"][0]), brute.recall(queries[:8], first["one"][0])
    d_ids, _ = coll.dense.search(np.asarray(q_rest[:64], np.float32), 30)
    t_ids, _ = coll.tfidf.search(queries, top_k=30)
    fuse = fusion_match(first["hybrid"][0], rrf_fuse([d_ids, t_ids], 10, 30)[0])
    probe = n // 2 + 1
    rec_get = client.ok("GET", f"{c}/vectors/{probe}")
    raw = client.ok("POST", c + "/search/tf-idf", {"query": queries[5], "top_k": 3, "return_raw_text": True})
    texts_ok = rec_get.get("text") == docs[probe] and all(r["text"] == docs[r["id"]] for r in raw["results"])
    victim = int(first["one"][0][0, 0])
    client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
    res = client.ok("POST", c + "/search/tf-idf", {"query": queries[0], "top_k": 10})["results"]
    if victim in [r["id"] for r in res]:
        fail(f"streamed delete of {victim}: it came back for its own words")
    before = answers(client)
    print(f"REST equals the direct Collection calls {equal_direct}; tf-idf recall@10 against brute force: "
          f"/batch-tf-idf (64) {rec:.4f}, /tf-idf (8 single) {rec1:.4f}; /batch-hybrid ids = RRF of the legs "
          f"{fuse:.4f}; GET /vectors/{probe} and return_raw_text give the written texts {texts_ok}; streamed delete "
          f"of {victim}: ok [{card}]", flush=True)
    if not all(equal_direct.values()):
        fail(f"REST answers differ from the direct Collection calls: {equal_direct}")
    if not texts_ok:
        fail("a text read back differs from the written one")
    for name, r in (("/batch-tf-idf recall", rec), ("/tf-idf recall", rec1), ("hybrid fusion match", fuse)):
        if r < MIN_RECALL:
            fail(f"phase 17 {name} {r:.4f} < {MIN_RECALL}")
    qd = np.asarray(q_rest[:64], np.float32)
    graph_before = dense_graph_ids(coll.dense, qd, n // 4)
    client.close()
    server.close()
    ctx.close()

    t0 = time.perf_counter()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    t_load = time.perf_counter() - t0
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    after = answers(client)
    same_after = {k: bool((after[k][0] == before[k][0]).all() and (after[k][1] == before[k][1]).all())
                  for k in after}
    status, _ = client.call("GET", f"{c}/vectors/{victim}")
    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

    grpc_ids, _ = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
        collection_id="bmrest", tf_idf=pb.FindSimilarTFIDFDocumentQuery(query=t, top_k=10),
    ) for t in queries[:8]])
    grpc_same = grpc_ids == [[int(i) for i in row if i >= 0] for row in after["one"][0]]
    # the restarted dense index holds the graph of the port's snapshot:
    # above its serving limit it answers as before the restart
    coll = ctx.get_collection("bmrest")
    dense = coll.dense
    scan_ids, _ = dense.search(qd, 10)
    graph_ids = dense_graph_ids(dense, qd, n // 4)
    share = float((graph_ids[:, :, None] == scan_ids[:, None, :]).any(-1).mean())
    graph_kept = not dense.index.scan_only and bool((graph_ids == graph_before).all())
    print(f"after restart ({t_load:.1f} s): identical ids and scores {same_after}; deleted {victim} answers HTTP "
          f"{status}; gRPC FindSimilarVectors (tf_idf) x8: ids equal REST's {grpc_same}; reloaded graph "
          f"(flat_serve_threshold {n // 4} < {dense.index.n} rows, scan_only {dense.index.scan_only}): ids "
          f"identical {graph_kept}, the scan's ids {share:.4f} [{card}]", flush=True)
    # rewrite the dense snapshot without its graph: the reloaded scan-only
    # index serves above its serving limit, by the scan, with the same answers
    dense.index.scan_only = True
    coll.save_snapshot()
    client.close()
    server.close()
    ctx.close()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    dense = ctx.get_collection("bmrest").dense
    dense.flat_serve_threshold = dense.graph_filter_min = n // 4
    scan = answers(client)
    same_scan = all(bool((scan[k][0] == after[k][0]).all() and (scan[k][1] == after[k][1]).all()) for k in scan)
    scan_above, _ = dense.search(qd, 10)
    same_scan = same_scan and bool((scan_above == scan_ids).all()) and victim not in scan_above
    launches = u8_scan.u8_bin_max.launches
    print(f"scan-only reload (flat_serve_threshold {dense.flat_serve_threshold} < {dense.index.n} rows, scan_only "
          f"{dense.index.scan_only}): tf-idf, hybrid and dense answers identical to the scan's under the limit, "
          f"{victim} absent: {same_scan}; u8_bin_max launches in phase 17: {launches} (dense capacity "
          f"{dense.index.cap}, below one scan chunk: the plain scan) [{card}]", flush=True)
    scan_only = dense.index.scan_only
    client.close()
    server.close()
    ctx.close()
    if not all(same_after.values()):
        fail("the restarted context answered tf-idf or hybrid queries differently")
    if status != 404:
        fail(f"the deleted vector came back after the restart (HTTP {status})")
    if not grpc_same:
        fail(f"gRPC tf-idf ids differ from REST's: {grpc_ids} vs {after['one'][0]}")
    if not graph_kept:
        fail("the reloaded dense index holds no graph, or its graph answered differently")
    if not scan_only or not same_scan:
        fail("the scan-only dense index was not reloaded as such, or answered differently above its serving limit")
    return launches


def dense_graph_ids(dense: DenseIndexHandle, qd: np.ndarray, limit: int) -> np.ndarray:
    """A handle's ids for ``qd`` with its serving limits at ``limit``
    (below its rows: the graph's), the limits put back after."""
    limits = dense.flat_serve_threshold, dense.graph_filter_min
    dense.flat_serve_threshold = dense.graph_filter_min = limit
    ids, _ = dense.search(qd, 10)
    dense.flat_serve_threshold, dense.graph_filter_min = limits
    return ids


def graph_phase(u8_handle: DenseIndexHandle, q4_handle: DenseIndexHandle, x, q, truth, dev, card: str) -> int:
    """Phase 18: HNSWIndex.search on phase 3's 1M graph at ef 128, 256 and
    512 (b1024, recall@10 against the exact f32 oracle, median of 5), 8
    single queries, a profile, the quaternary graph at ef 256, and a
    quaternary exact-path bulk build (K2 through the chunked scan);
    returns K2's launches in that build."""
    idx, qb = u8_handle.index, q[:1024]
    recall = {}
    for ef in (128, 256, 512):
        t, (ids, _) = timed_search(lambda: idx.search(qb, 10, ef=ef))
        recall[ef] = recall10(ids, truth[:1024])
        print(f"HNSWIndex.search ef={ef} b1024: recall@10 {recall[ef]:.4f}, {t * 1e3:.1f} ms/batch, "
              f"{1024 / t:.0f} qps [{card}]", flush=True)
    lat = []
    for i in range(8):
        t0 = time.perf_counter()
        ids, _ = idx.search(q[i : i + 1], 10, ef=128)
        lat.append(time.perf_counter() - t0)
    print(f"8 single queries at ef=128: median {statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms "
          f"[{card}]", flush=True)
    profile_top(lambda: idx.search(qb, 10, ef=128), card)
    t, (ids, _) = timed_search(lambda: q4_handle.index.search(qb, 10, ef=256), reps=1)
    # the 5 x k rerank shortlist of 2-bit scores bounds this recall (the
    # scan's 20 x k shortlist, printed beside it, does not)
    deep, _ = q4_handle.index.search(qb, 10, ef=256, rerank_keep=200)
    print(f"quaternary graph ef=256 b1024: recall@10 {recall10(ids, truth[:1024]):.4f}, {t * 1e3:.1f} ms; "
          f"rerank_keep 200: {recall10(deep, truth[:1024]):.4f} (not gated) [{card}]", flush=True)
    # the exact bulk path of a sub-byte index scans with K2
    n_ex = HNSWIndex.RP_THRESHOLD
    small = HNSWIndex(DIM, dev, kind="quaternary", initial_capacity=n_ex)
    reset_counts()
    t0 = time.perf_counter()
    small.add(x[:n_ex])
    torch.cuda.synchronize()
    k2 = subbyte_scan.subbyte_code_scores.launches
    ids, _ = small.search(qb, 10, rerank_keep=200)
    r_small = recall10(ids, exact_top10(qb, x[:n_ex]))
    print(f"quaternary exact-path bulk build of {n_ex} rows: {time.perf_counter() - t0:.1f} s, K2 launches {k2}; "
          f"graph recall@10 (rerank_keep 200) {r_small:.4f} (not gated) [{card}]", flush=True)
    if recall[128] < MIN_RECALL or recall[256] < 0.995:
        fail(f"graph recall@10 ef=128 {recall[128]:.4f} (gate {MIN_RECALL}), ef=256 {recall[256]:.4f} (gate 0.995)")
    if k2 == 0:
        fail("the quaternary exact bulk build never launched K2")
    return k2


def untied_equal(ids, want_ids, want_scores) -> tuple[bool, float]:
    """Whether ``ids`` equal ``want_ids`` on every slot whose score in
    ``want_scores`` has no near-tie on either side (the last slot never
    counts), and the share of slots compared."""
    s = np.asarray(want_scores, np.float64)
    tol = 1e-5 * np.abs(s) + 1e-6
    gap = s[:, :-1] - s[:, 1:]
    inf, zero = np.full((s.shape[0], 1), np.inf), np.zeros((s.shape[0], 1))
    untied = (np.concatenate([inf, gap], 1) > tol) & (np.concatenate([gap, zero], 1) > tol)
    return bool((np.asarray(ids)[untied] == np.asarray(want_ids)[untied]).all()), float(untied.mean())


def h2d_gbps(dev) -> float:
    """Host-to-device rate of one pinned 256 MB copy (CUDA events, median of 5)."""
    src = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    return (256 << 20) / ms / 1e6


#: device-time buckets of a streamed search, by kernel name
SPLIT = (("copy", ("Memcpy HtoD",)), ("K1", ("u8_bin_max",)), ("K2", ("subbyte_code_scores",)),
         ("query unpack", ("unpack_queries",)), ("select and merge", ("topk", "sort", "radix", "Sort", "TopK")))


def profile_split(name: str, fn, card: str) -> dict:
    """One torch.profiler pass over ``fn``: device ms by bucket (copies,
    K1, K2, the query unpack, top-k selection and merges, and the rest:
    the rescore gathers and products, masks, the rerank), beside the wall
    time. Copies overlap kernels, so the sum may pass the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {key: 0.0 for key, _ in SPLIT}
    split["rescore and other"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k, words in SPLIT if any(w in e.key for w in words)), "rescore and other")
        split[key] += device_us(e) / 1e3
    text = ", ".join(f"{k} {v:.2f}" for k, v in split.items())
    print(f"  {name} device ms: {text}; wall {wall:.1f} ms (under the profiler) [{card}]", flush=True)
    return split


def spill_u8_phase(x, q, truth, dev, card: str) -> dict:
    """Phase 19a: a u8 HNSWIndex with host raw rows over all N rows (the
    reference bench's beyond_hbm build), its device scan and graph, then
    force_spill(keep_graph=True): the streamed scan (K1 per chunk) at b1024
    and b64 against the oracle and the resident scan, the host-codes graph
    at ef 128 b64 against the streamed scan (gated at 0.99), promotion back
    to the device, and the re-pin of a spilled doubling. Returns K1's
    launches (counted over every search) and its launches per streamed
    b1024 batch."""
    launches = 0
    t0 = time.perf_counter()
    idx = HNSWIndex(DIM, dev, kind="u8", range_=tune_dense_range(x[:1000].cpu().numpy()), seed=5,
                    keep_raw="host", initial_capacity=N)
    idx.add(x)
    torch.cuda.synchronize()
    print(f"u8 HNSWIndex(keep_raw='host') of {N} rows: {time.perf_counter() - t0:.1f} s (graph "
          f"{idx.last_build_stats['graph_s']} s); device store {idx.store.device_nbytes()} B, host raw "
          f"{idx.store.raw_host.numel() * 4} B pinned {idx.store.raw_host.is_pinned()} [{card}]", flush=True)
    qb, qs = q[:1024], q[:64]
    reset_counts()
    t_base, (base_ids, base_s) = timed_search(lambda: idx.search_brute(qb, 10), reps=3)
    resident_graph = {ef: idx.search(qs, 10, ef=ef)[0] for ef in (128, 256)}
    launches += u8_scan.u8_bin_max.launches
    check_results("resident search_brute b1024 (host rerank)", base_ids, truth[:1024], t_base, card, True)
    t0 = time.perf_counter()
    idx.force_spill(keep_graph=True)
    t_spill = time.perf_counter() - t0
    if not (idx.store.codes_on_host and idx.graph_on_spill and idx.store.device_nbytes() == 0):
        fail("force_spill(keep_graph=True) did not spill the codes")
    cap = idx.cap
    chunks = -(-cap // flat_scan.STREAM_CHUNK)
    bw = h2d_gbps(dev)
    out = {}
    for b, qq in ((1024, qb), (64, qs)):
        reset_counts()
        idx.search_brute(qq, 10)
        per_batch = u8_scan.u8_bin_max.launches
        nbytes = flat_scan.streamed_flat_topk.last_stats["bytes"]
        t, (ids, sc) = timed_search(lambda: idx.search_brute(qq, 10), reps=3)
        launches += u8_scan.u8_bin_max.launches
        check_results(f"streamed search_brute b{b} (K1 per chunk, host rerank)", ids, truth[:b], t, card, True)
        same, share = untied_equal(ids, base_ids[:b], base_s[:b])
        bound_ms = nbytes / (bw * 1e6)
        print(f"  K1 launches per batch {per_batch} (capacity {cap}: {chunks} chunks of "
              f"{flat_scan.STREAM_CHUNK}); streamed {nbytes} B per batch; pinned H2D {bw:.2f} GB/s, so the copy "
              f"bound is {bound_ms:.2f} ms, {bound_ms / (t * 1e3):.1%} of the batch; ids equal to the resident "
              f"scan on untied slots {same} ({share:.1%} of slots) [{card}]", flush=True)
        if per_batch != chunks:
            fail(f"the streamed u8 scan launched K1 {per_batch} times, want {chunks}")
        if not same:
            fail("the streamed u8 scan's ids differ from the resident scan's on untied slots")
        out[b] = {"ms": t * 1e3, "ids": ids, "bytes": nbytes, "per_batch": per_batch}
    reset_counts()
    out["split"] = profile_split("streamed u8 b1024", lambda: idx.search_brute(qb, 10), card)
    for ef in (128, 256):
        rec = hostcodes_graph(idx, qs, out[64], ef, f"{N} rows", card)
        resident = recall_against(resident_graph[ef], out[64]["ids"])
        print(f"  the same graph resident (upper levels, before the spill) ef={ef}: recall@10 vs the streamed "
              f"exact scan {resident:.4f} [{card}]", flush=True)
        if ef == 128 and rec < MIN_RECALL:
            fail(f"host-codes graph recall {rec:.4f} < {MIN_RECALL} at {N} rows, ef 128")
    # not gated: the host-codes beam starts from the entry and random seeds
    # in place of upper levels; with 8x the seeds its recall shows what they cost
    idx.HOSTCODES_SEEDS = 8 * HNSWIndex.HOSTCODES_SEEDS
    g_ids, _ = idx.search(qs, 10, ef=128)
    del idx.HOSTCODES_SEEDS
    print(f"  host-codes graph ef=128 with {8 * HNSWIndex.HOSTCODES_SEEDS} random seeds: recall@10 vs the "
          f"streamed exact scan {recall_against(g_ids, out[64]['ids']):.4f} [{card}]", flush=True)
    launches += u8_scan.u8_bin_max.launches
    os.environ.pop("COSDATA_HBM_GB", None)
    t0 = time.perf_counter()
    if not idx.maybe_promote() or idx.store.codes_on_host:
        fail("maybe_promote with no budget pinned left the codes on the host")
    t_promote = time.perf_counter() - t0
    reset_counts()
    ids, sc = idx.search_brute(qb, 10)
    k1_promoted = u8_scan.u8_bin_max.launches
    launches += k1_promoted
    identical = bool((ids == base_ids).all() and (sc == base_s).all())
    print(f"spill {t_spill:.2f} s, promote {t_promote:.2f} s; promoted search_brute b1024 identical to the "
          f"resident baseline {identical}, K1 launches {k1_promoted} [{card}]", flush=True)
    if not identical or k1_promoted != 1:
        fail(f"after promotion: identical {identical}, K1 launches {k1_promoted} (want 1)")
    idx.force_spill()
    t0 = time.perf_counter()
    idx.store.grow_to(2 * cap)
    t_repin = time.perf_counter() - t0
    print(f"re-pin: a spilled doubling to {2 * cap} rows (codes, sums, magnitudes and host raw rows, "
          f"{2 * cap * (idx.store.dim_pad * 5 + 8)} B pinned, {cap * (idx.store.dim_pad * 5 + 8)} B copied) "
          f"{t_repin:.2f} s [{card}]", flush=True)
    del idx
    torch.cuda.empty_cache()
    out["launches"], out["per_batch"] = launches, out[1024]["per_batch"]
    return out


def recall_against(ids, want_ids) -> float:
    """recall@10 of host ids against host ids (the streamed exact scan's)."""
    return float(np.mean([len(set(g) & set(e)) / 10 for g, e in zip(np.asarray(ids).tolist(),
                                                                    np.asarray(want_ids).tolist())]))


def hostcodes_graph(idx, qs, scan: dict, ef: int, what: str, card: str) -> float:
    """The host-codes graph of a kept-graph spill at ``ef``, b64: recall@10
    against the streamed exact scan's ids (``scan``), time beside the
    scan's, waves and bytes uploaded. Returns the recall."""
    idx.search(qs, 10, ef=ef)  # warm-up
    t_g, (g_ids, _) = timed_search(lambda: idx.search(qs, 10, ef=ef), reps=3)
    st = idx.last_hostcodes_stats
    g_rec = recall_against(g_ids, scan["ids"])
    scan_qps, graph_qps = len(qs) * 1e3 / scan["ms"], len(qs) / t_g
    print(f"host-codes graph {what} ef={ef} b{len(qs)}: recall@10 vs the streamed exact scan {g_rec:.4f}, "
          f"{t_g * 1e3:.1f} ms = {graph_qps:.1f} q/s; {st['waves']} waves, {st['rows']} rows = {st['bytes']} B "
          f"uploaded, {st['bytes'] / max(st['waves'], 1):.0f} B per wave; streamed scan {scan_qps:.1f} q/s; winner "
          f"{'graph' if graph_qps > scan_qps else 'scan'} [{card}]", flush=True)
    return g_rec


#: the reference bench's beyond_hbm rows (bench.py:815, min(n, 262,144))
N_BEYOND = 262_144


def beyond_hbm_section(x, q, dev, card: str) -> int:
    """Phase 19a's second half, the reference bench's beyond_hbm section
    (bench.py:806-851) at its 262,144 rows: a u8 index with host raw rows
    (seed 5), force_spill(keep_graph=True), the streamed exact scan b64 as
    the oracle, the host-codes graph at ef 128 gated at recall@10 0.99.
    Returns K1's launches."""
    idx = HNSWIndex(DIM, dev, kind="u8", range_=tune_dense_range(x[:1000].cpu().numpy()), seed=5,
                    keep_raw="host", initial_capacity=N_BEYOND)
    t0 = time.perf_counter()
    idx.add(x[:N_BEYOND])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    idx.force_spill(keep_graph=True)
    qs = q[:64]
    reset_counts()
    idx.search_brute(qs, 10)
    per_batch = u8_scan.u8_bin_max.launches
    t, (ids, _) = timed_search(lambda: idx.search_brute(qs, 10), reps=3)
    launches = u8_scan.u8_bin_max.launches
    print(f"beyond_hbm at {N_BEYOND} rows: build {t_build:.1f} s; streamed exact scan b64 {t * 1e3:.1f} ms = "
          f"{64 / t:.1f} q/s, K1 launches {per_batch} per batch [{card}]", flush=True)
    rec = hostcodes_graph(idx, qs, {"ids": ids, "ms": t * 1e3}, 128, f"{N_BEYOND} rows", card)
    if rec < MIN_RECALL:
        fail(f"host-codes graph recall {rec:.4f} < {MIN_RECALL} at {N_BEYOND} rows")
    del idx
    torch.cuda.empty_cache()
    return launches


def spill_q4_phase(x, q, truth, dev, card: str) -> tuple[int, int, int, int]:
    """Phase 19b: a quaternary HNSWIndex with host raw rows, spilled while
    empty, takes all N rows into the host tier (quantized on the card);
    the streamed scan (K2 per chunk, one query unpack) b1024 with the 20x
    host rerank. Returns K2's and the unpack's launches, then each's
    launches per batch."""
    idx = HNSWIndex(DIM, dev, kind="quaternary", keep_raw="host", initial_capacity=N)
    idx.force_spill()
    t0 = time.perf_counter()
    for s in range(0, N, ADD_BATCH):
        idx.add(x[s : s + ADD_BATCH])
    t_add = time.perf_counter() - t0
    if not (idx.store.codes_on_host and idx.scan_only and idx.n == N):
        fail("the quaternary index did not ingest into the host tier")
    print(f"quaternary spilled ingest of {N} rows: {t_add:.1f} s = {N / t_add:.0f} rows/s [{card}]", flush=True)
    chunks = -(-idx.cap // flat_scan.STREAM_CHUNK)
    qb = q[:1024]
    reset_counts()
    idx.search_brute(qb, 10)
    k2, unpack = subbyte_scan.subbyte_code_scores.launches, subbyte_scan.unpack_query_codes.launches
    t, (ids, _) = timed_search(lambda: idx.search_brute(qb, 10), reps=3)
    check_results("quaternary streamed search_brute b1024 (K2 per chunk, 20x host rerank)", ids, truth[:1024], t,
                  card, True)
    print(f"  K2 launches per batch {k2}, query unpack {unpack} (capacity {idx.cap}: {chunks} chunks); streamed "
          f"{flat_scan.streamed_flat_topk.last_stats['bytes']} B per batch [{card}]", flush=True)
    if k2 != chunks or unpack != 1:
        fail(f"the streamed quaternary scan launched K2 {k2} times (want {chunks}), the unpack {unpack} (want 1)")
    profile_split("streamed quaternary b1024", lambda: idx.search_brute(qb, 10), card)
    k2_all, unpack_all = subbyte_scan.subbyte_code_scores.launches, subbyte_scan.unpack_query_codes.launches
    del idx
    torch.cuda.empty_cache()
    return k2_all, unpack_all, k2, unpack


#: phase 19c's budget: below the 65,536-row u8 store's 50.9 MB, so growth
#: spills while the transaction is indexed
SPILL_BUDGET_GB = 4 / 1024


def spill_rest_phase(data_dir: str, x_sp: np.ndarray, q_rest: np.ndarray, dev, card: str) -> int:
    """Phase 19c: a raw_storage "disk" collection written over REST under a
    pinned budget (its codes spill while the transaction is indexed),
    searched, filtered and streamed a delete against an exact oracle; a
    restart with the budget still pinned (codes loaded onto the host) and
    gRPC; a restart with it lifted, whose flush promotes the codes so that
    the device scan (K1, the store being one scan chunk) serves. Returns
    K1's launches."""
    n = len(x_sp)
    os.environ["COSDATA_HBM_GB"] = str(SPILL_BUDGET_GB)
    xd = torch.as_tensor(x_sp, dtype=torch.float32, device=dev)
    qr = q_rest[:256]
    truth = exact_top10(torch.as_tensor(qr, dtype=torch.float32, device=dev), xd)
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    c = "/vectordb/collections/spill"
    client.ok("POST", "/vectordb/collections", {
        "name": "spill", "dense_vector": {"enabled": True, "dimension": DIM},
        "metadata_schema": {"fields": [{"name": "half", "values": ["a", "b"]}], "supported_conditions": []},
    })
    client.ok("POST", c + "/indexes/dense", {"name": "spill_dense", "distance_metric_type": "cosine",
                                             "quantization": {"type": "auto"}, "raw_storage": "disk"})
    t0 = time.perf_counter()
    txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
    rows = x_sp.tolist()
    for s in range(0, n, UPSERT_ROWS):
        vectors = [{"id": i, "dense_values": rows[i], **({"metadata": {"half": "a" if i % 4 == 0 else "b"}}
                                                         if i % 2 == 0 else {})} for i in range(s, s + UPSERT_ROWS)]
        client.ok("POST", f"{c}/transactions/{txn}/upsert", {"vectors": vectors})
    client.ok("POST", f"{c}/transactions/{txn}/commit", {})
    while client.ok("GET", f"{c}/transactions/{txn}/status")["status"] != "complete":
        if time.perf_counter() - t0 > 600:
            fail("the spilled transaction did not complete")
        time.sleep(0.2)
    idx = ctx.get_collection("spill").dense.index
    print(f"REST ingest of {n} x {DIM} (raw_storage 'disk', budget {SPILL_BUDGET_GB * 1024:.0f} MiB) in "
          f"{time.perf_counter() - t0:.1f} s; codes on the host {idx.store.codes_on_host}, scan_only "
          f"{idx.scan_only}, raw rows in {idx.store._raw_path} [{card}]", flush=True)
    if not (idx.store.codes_on_host and idx.store.keep_raw == "disk"):
        fail("the collection's store did not spill under its budget")
    reset_counts()
    ids, _, dt, lat = batch_search(client, "spill", qr, WORKERS)
    served_line(f"spilled REST /search/batch-dense {n} rows", ids, truth.cpu().numpy(), dt, lat, card)
    flt = {"Is": {"field_name": "half", "field_value": "a", "operator": "Equal"}}
    res = client.ok("POST", c + "/search/dense", {"query_vector": qr[0].tolist(), "top_k": 10, "filter": flt})
    got = [r["id"] for r in res["results"]]
    quarter = torch.arange(0, n, 4, device=dev)
    want = quarter[exact_top10(torch.as_tensor(qr[:1], dtype=torch.float32, device=dev), xd[quarter])[0]].tolist()
    if len(got) != 10 or any(i % 4 for i in got) or len(set(got) & set(want)) < 9:
        fail(f"spilled filtered search {got}, exact {want}")
    victim = int(ids[0, 0])
    client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
    res = client.ok("POST", c + "/search/dense", {"query_vector": x_sp[victim].tolist(), "top_k": 10})["results"]
    if victim in [r["id"] for r in res] or len(res) != 10:
        fail(f"spilled streamed delete of {victim}: it came back")
    seq = batch_search(client, "spill", qr, 1)
    launches = u8_scan.u8_bin_max.launches
    print(f"spilled filtered search: ok; streamed delete of {victim}: ok; K1 launches {launches} [{card}]", flush=True)
    if launches == 0:
        fail("the spilled REST searches never launched K1")
    client.close()
    server.close()
    ctx.close()
    idx.store.close()  # its raw rows' file (the snapshot holds them)
    for pinned in (True, False):
        if not pinned:
            os.environ.pop("COSDATA_HBM_GB", None)
        ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
        server = RestServer(ctx)
        client = RestClient(server.port)
        client.login()
        coll = ctx.get_collection("spill")
        loaded_host = coll.dense.index.store.codes_on_host
        if not pinned:
            coll.flush_indexes()  # promotes the codes: the device scan (K1) serves again
        reset_counts()
        r_ids, r_scores, dt, _ = batch_search(client, "spill", qr, 1)
        k1 = u8_scan.u8_bin_max.launches
        launches += k1
        same_ids = bool((r_ids == seq[0]).all())
        max_diff = float(np.abs(r_scores - seq[1]).max())
        line = (f"restart with the budget {'pinned' if pinned else 'lifted'}: codes loaded on the host {loaded_host}, "
                f"on the host after {'the load' if pinned else 'flush'} {coll.dense.index.store.codes_on_host}; ids "
                f"identical {same_ids}, scores identical {max_diff == 0.0} (max diff {max_diff:.3g}); K1 launches "
                f"{k1}")
        if pinned:
            from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

            g_ids, _ = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
                collection_id="spill", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
            ) for v in qr[:8]])
            same_grpc = g_ids == r_ids[:8].tolist()
            line += f"; gRPC FindSimilarVectors x8 equal to REST {same_grpc}"
        print(line + f" [{card}]", flush=True)
        client.close()
        server.close()
        ctx.close()
        coll.dense.index.store.close()
        if not loaded_host or coll.dense.index.store.codes_on_host != pinned or not same_ids or max_diff > 1e-6:
            fail("a restart of the spilled collection answered differently")
        if pinned and not same_grpc:
            fail("gRPC answered differently from REST on the spilled collection")
        if k1 == 0:
            fail("the restarted spilled collection never launched K1")
    return launches


#: popcount of each byte value, the hamming oracle's table
POPCOUNT8 = [bin(i).count("1") for i in range(256)]


def euclidean_top10(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact f32 euclidean top-10 (least distance): the largest 2 q·x - |x|²."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x_sq = (x * x).sum(1)
    return torch.cat([torch.topk(2.0 * (q[s : s + 512] @ x.T) - x_sq[None, :], 10, dim=1).indices
                      for s in range(0, len(q), 512)])


def hamming_oracle(q_bytes: torch.Tensor, x_bytes: torch.Tensor) -> torch.Tensor:
    """The 10 least hamming distances of each query, ascending, by an
    independent formula: XOR of the stored bytes (B, nb) x (N, nb) uint8 and
    a byte popcount table, summed over the bytes."""
    table = torch.tensor(POPCOUNT8, dtype=torch.uint8, device=x_bytes.device)
    out = []
    for s in range(0, len(q_bytes), 8):
        qq = q_bytes[s : s + 8]
        dist = torch.cat([
            torch.index_select(table, 0, (qq[:, None, :] ^ x_bytes[None, r : r + 65_536]).reshape(-1).int())
            .view(len(qq), -1, x_bytes.shape[1]).sum(-1, dtype=torch.int32)
            for r in range(0, len(x_bytes), 65_536)
        ], 1)
        out.append(torch.topk(dist, 10, dim=1, largest=False).values)
    return torch.cat(out)


def hamming_gate(name: str, vals, oracle: torch.Tensor, t: float, card: str) -> None:
    """Unreranked hamming scores are negated distances: slot for slot the oracle's."""
    got = -torch.as_tensor(np.asarray(vals), device=oracle.device).to(torch.float32)
    same = bool((got == oracle.to(torch.float32)).all())
    print(f"{name}: hamming distances equal the XOR-popcount oracle's top-10, slot for slot, {same} "
          f"(distances {int(oracle[:, 0].min())}-{int(oracle[:, -1].max())}); {t * 1e3:.2f} ms/batch [{card}]",
          flush=True)
    if not same:
        fail(f"{name}: hamming distances differ from the oracle's")


def euclidean_handle_phase(xs, q, q_big, truth_e, dev, card: str) -> dict:
    """Phase 20a: a euclidean u8 DenseIndexHandle (host raw rows) filled as
    phase 3's: the scan, the graph at ef 128 and 256, the approx mode, then
    force_spill(keep_graph=True) and the streamed scan. Returns K1's
    launches and its launches per streamed batch."""
    handle = DenseIndexHandle(DIM, dev, distance_metric="euclidean", raw_storage="host")
    graph_ingest(handle, xs, q, card, "euclidean u8 handle")
    idx = handle.index
    reset_counts()
    t, (ids, _) = timed_search(lambda: handle.search(q[:1024], 10))
    check_results("euclidean DenseIndexHandle.search b1024 (scan, host rerank)", ids, truth_e[:1024], t, card, True)
    launches = u8_scan.u8_bin_max.launches
    print(f"  K1 (euclidean) launches {launches} [{card}]", flush=True)
    if launches == 0:
        fail("the euclidean scan never launched u8_bin_max")
    for ef in (128, 256):
        t, (ids, _) = timed_search(lambda: idx.search(q[:1024], 10, ef=ef), reps=1)
        check_results(f"euclidean HNSWIndex.search ef={ef} b1024 (graph)", ids, truth_e[:1024], t, card, ef == 256)
    reset_counts()
    launches += approx_check("euclidean DenseIndexHandle.search", lambda qq: handle.search(qq, 10), q_big,
                             euclidean_top10(q_big, xs), idx.cap, card)
    idx.force_spill(keep_graph=True)
    if not (idx.store.codes_on_host and idx.graph_on_spill):
        fail("force_spill(keep_graph=True) did not spill the euclidean codes")
    reset_counts()
    idx.search_brute(q[:1024], 10)
    per_batch = u8_scan.u8_bin_max.launches
    t, (ids, _) = timed_search(lambda: idx.search_brute(q[:1024], 10), reps=2)
    launches += u8_scan.u8_bin_max.launches
    check_results("euclidean streamed search_brute b1024 (K1 per chunk, host rerank)", ids, truth_e[:1024], t,
                  card, True)
    chunks = -(-idx.cap // flat_scan.STREAM_CHUNK)
    print(f"  streamed K1 launches per batch {per_batch} ({chunks} chunks) [{card}]", flush=True)
    if per_batch != chunks:
        fail(f"the streamed euclidean scan launched K1 {per_batch} times, want {chunks}")
    idx.store.close()
    return {"launches": launches, "streamed_per_batch": per_batch}


def hamming_handle_phase(xs, q, truth_e, dev, card: str) -> None:
    """Phase 20b: a hamming u8 DenseIndexHandle over the same rows:
    scan-only with no adjacency; unreranked distances held to the oracle,
    the served (euclidean-reranked) answers' recall printed."""
    handle = DenseIndexHandle(DIM, dev, distance_metric="hamming")
    t0 = time.perf_counter()
    handle.add_batch(list(range(N)), xs)
    torch.cuda.synchronize()
    idx = handle.index
    adj = sum(t.numel() for t in (idx.adj0, idx.adj0_d, idx.up_adj, idx.up_d))
    print(f"hamming u8 handle: ingest of {N} rows {time.perf_counter() - t0:.1f} s; scan_only {idx.scan_only}, "
          f"adjacency entries {adj} (placeholders), range {handle.range} [{card}]", flush=True)
    if not idx.scan_only or idx.adj0.shape[0] != 1 or idx.n_up:
        fail("the hamming index holds an adjacency")
    qb = q[:1024]
    reset_counts()
    t, (_, vals) = timed_search(lambda: idx.search_brute(qb, 10, rerank=False))
    store = idx.store
    codes = lambda data: data.view(torch.uint8) ^ 0x80  # noqa: E731  (the u8 code of a centered byte)
    t0 = time.perf_counter()
    oracle = hamming_oracle(codes(store.quantize_queries(qb).data), codes(store.arrays.data[: idx.n]))
    print(f"  oracle in {time.perf_counter() - t0:.1f} s; K1 launches {u8_scan.u8_bin_max.launches} (hamming "
          f"has no bin kernel)", flush=True)
    hamming_gate("hamming DenseIndexHandle search_brute(rerank=False) b1024", vals, oracle, t, card)
    t, (ids, _) = timed_search(lambda: handle.search(qb, 10), reps=2)
    r = recall10(ids, truth_e[:1024])
    print(f"hamming DenseIndexHandle.search b1024, reranked by euclidean distance: recall@10 against the "
          f"euclidean oracle {r:.4f} (the reference's semantics, not gated); {t * 1e3:.2f} ms/batch [{card}]",
          flush=True)
    store.close()


def flat_metrics_phase(xs, q, dev, card: str) -> None:
    """Phase 20c: hamming binary and f16 FlatIndexes at N_SUB rows held to
    the oracle, a euclidean f32 FlatIndex's recall, and the quaternary
    euclidean ValueError."""
    xs = xs[:N_SUB]
    qb = q[:1024]
    for kind in ("binary", "f16"):
        flat = FlatIndex(DIM, dev, metric="hamming", kind=kind, initial_capacity=N_SUB)
        flat.add(xs)
        t, (_, vals) = timed_search(lambda: flat.search(qb, 10), reps=2)
        store = flat.store
        if kind == "binary":
            q_bytes = store.quantize_queries(qb).planes[0].contiguous().view(torch.uint8)
            x_bytes = store.arrays.planes[0, :N_SUB].contiguous().view(torch.uint8)
        else:
            q_bytes = store.quantize_queries(qb).data.contiguous().view(torch.uint8)
            x_bytes = store.arrays.data[:N_SUB].contiguous().view(torch.uint8)
        hamming_gate(f"hamming {kind} FlatIndex.search b1024 ({N_SUB} rows)", vals, hamming_oracle(q_bytes, x_bytes),
                     t, card)
        del flat, store, q_bytes, x_bytes
        torch.cuda.empty_cache()
    flat = FlatIndex(DIM, dev, metric="euclidean", kind="f32", initial_capacity=N_SUB)
    flat.add(xs)
    t, (ids, _) = timed_search(lambda: flat.search(qb, 10, rerank=True), reps=2)
    check_results(f"euclidean f32 FlatIndex.search b1024 ({N_SUB} rows)", ids, euclidean_top10(qb, xs), t, card, True)
    del flat
    flat = FlatIndex(DIM, dev, metric="euclidean", kind="quaternary", initial_capacity=65_536)
    flat.add(xs[:65_536])
    try:
        flat.search(qb[:8], 10)
    except ValueError as err:
        print(f"quaternary euclidean FlatIndex.search raises ValueError: {err}", flush=True)
        if "euclidean unsupported for sub-byte storage" not in str(err):
            fail(f"quaternary euclidean raised another ValueError: {err}")
    else:
        fail("quaternary euclidean search answered; the reference raises ValueError")
    del flat
    torch.cuda.empty_cache()


def metric_rest_phase(data_dir: str, x_rest: np.ndarray, q_rest: np.ndarray, dev, card: str) -> None:
    """Phase 20d: a euclidean and a hamming collection of N_SP_REST rows
    written over REST in one transaction, searched, streamed a delete,
    answered by gRPC as by REST, and restarted: the same answers, the
    deleted vector gone."""
    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

    truth = euclidean_top10(torch.as_tensor(q_rest, dtype=torch.float32, device=dev),
                            torch.as_tensor(x_rest, dtype=torch.float32, device=dev)).cpu().numpy()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    before = {}
    rows = x_rest.tolist()
    for metric in ("euclidean", "hamming"):
        name, c = f"m_{metric}", f"/vectordb/collections/m_{metric}"
        client.ok("POST", "/vectordb/collections", {"name": name, "dense_vector": {"enabled": True, "dimension": DIM}})
        client.ok("POST", c + "/indexes/dense", {"name": f"{name}_dense", "distance_metric_type": metric,
                                                 "quantization": {"type": "auto"}})
        t0 = time.perf_counter()
        txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
        for s in range(0, len(rows), UPSERT_ROWS):
            client.ok("POST", f"{c}/transactions/{txn}/upsert",
                      {"vectors": [{"id": i, "dense_values": rows[i]} for i in range(s, s + UPSERT_ROWS)]})
        client.ok("POST", f"{c}/transactions/{txn}/commit", {})
        while client.ok("GET", f"{c}/transactions/{txn}/status")["status"] != "complete":
            if time.perf_counter() - t0 > 600:
                fail(f"the {metric} transaction did not complete")
            time.sleep(0.2)
        t_ingest = time.perf_counter() - t0
        ids, _, dt, lat = batch_search(client, name, q_rest, WORKERS)
        r = float((ids[:, :, None] == truth[:, None, :]).any(-1).sum()) / truth.size
        print(f"REST {metric} collection: ingest of {len(rows)} x {DIM} {t_ingest:.1f} s; /search/batch-dense "
              f"recall@10 against the euclidean oracle {r:.4f}{' (not gated)' if metric == 'hamming' else ''}; "
              f"{len(q_rest) / dt:.1f} qps [{card}]", flush=True)
        if metric == "euclidean" and r < MIN_RECALL:
            fail(f"REST euclidean recall@10 {r:.4f} < {MIN_RECALL}")
        victim = int(ids[0, 0])
        client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
        res = client.ok("POST", c + "/search/dense", {"query_vector": rows[victim], "top_k": 10})["results"]
        if victim in [r["id"] for r in res] or len(res) != 10:
            fail(f"{metric}: the streamed delete of {victim} came back")
        seq = batch_search(client, name, q_rest[:256], 1)
        got, _ = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
            collection_id=name, dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
        ) for v in q_rest[:8]])
        print(f"  streamed delete of {victim}: ok; gRPC FindSimilarVectors x8: ids equal REST's "
              f"{got == seq[0][:8].tolist()}", flush=True)
        if got != seq[0][:8].tolist():
            fail(f"{metric}: gRPC ids differ from REST's")
        before[metric] = (seq[0], seq[1], victim)
    client.close()
    server.close()
    ctx.close()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    for metric, (ids0, sc0, victim) in before.items():
        ids, sc, _, _ = batch_search(client, f"m_{metric}", q_rest[:256], 1)
        status, _ = client.call("GET", f"/vectordb/collections/m_{metric}/vectors/{victim}")
        res = client.ok("POST", f"/vectordb/collections/m_{metric}/search/dense",
                        {"query_vector": rows[victim], "top_k": 10})["results"]
        same = bool((ids == ids0).all() and (sc == sc0).all())
        gone = status == 404 and victim not in [r["id"] for r in res]
        print(f"  {metric} after restart: ids and scores identical {same}; deleted {victim} absent {gone} "
              f"(HTTP {status}) [{card}]", flush=True)
        if not (same and gone):
            fail(f"the restarted {metric} collection answered differently or served the deleted vector")
    client.close()
    server.close()
    ctx.close()


def other_metrics_phase(x, q, q_big, truth, dev, card: str) -> dict:
    """Phase 20 (module doc); returns K1's euclidean launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    xs = x * (torch.rand((N, 1), generator=gen, device=dev) + 0.5)
    t0 = time.perf_counter()
    truth_e = euclidean_top10(q, xs)
    print(f"corpus: phase 3's rows scaled by U[0.5, 1.5]; euclidean oracle in {time.perf_counter() - t0:.1f} s; "
          f"its top-10 overlap with the cosine oracle's {recall10(truth_e, truth):.4f}", flush=True)
    out = euclidean_handle_phase(xs, q, q_big, truth_e, dev, card)
    torch.cuda.empty_cache()
    hamming_handle_phase(xs, q, truth_e, dev, card)
    torch.cuda.empty_cache()
    flat_metrics_phase(xs, q, dev, card)
    x_rest = np.round(xs[:N_SP_REST].cpu().numpy().astype(np.float64), 6)
    q_rest = np.round(q[:NQ_REST].cpu().numpy().astype(np.float64), 6)
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        metric_rest_phase(data_dir, x_rest, q_rest, dev, card)
    del xs
    torch.cuda.empty_cache()
    return out


def shard_k1_check(idx, qb, mask: np.ndarray, card: str) -> None:
    """K1 against its plain version on every shard's own store, alive rows
    and query codes, as the sharded scan builds its terms after its first
    search (C = the shard's capacity in whole scan chunks, about half of it
    past the shard's rows), and on each shard again under the global
    ``mask``."""
    errs = []
    for s, sh in enumerate(idx.shards):
        if sh.cap % HNSWIndex.SCAN_CHUNK:
            fail(f"21a: shard {s}'s capacity {sh.cap} is not the whole scan chunks its search scans")
        store = sh.store
        qc = store.ship_query_codes(qb.to(store.device))
        for label, local in (("", None), (" masked", idx._local_mask(s, mask))):
            valid = sh._valid(local)
            t = u8_scan.bin_max_terms(store.metric, qc, store.arrays, valid, store.dim_pad)
            where = (f"shard {s}{label} B={len(qb)} C={sh.cap} Dp={store.dim_pad} {store.metric} "
                     f"({int(valid.sum())} valid rows)")
            errs.append(k1_against_plain(store.metric, t, where))
            del t
    print(f"  K1 against plain on each shard's store (C={[sh.cap for sh in idx.shards]}, rows "
          f"{[sh.n for sh in idx.shards]}, unmasked and masked): max_abs_err {max(errs):.3g} "
          f"(rtol {RTOL}, atol {ATOL}) [{card}]", flush=True)


def sharded_u8_phase(x, q, truth, dev, card: str) -> dict:
    """Phase 21a: a u8 DenseIndexHandle with SHARDS shards over the card's
    devices (ShardedHNSWIndex), filled with N - SHARD_WAVE_ROWS rows in one
    call (a bulk build per shard) and SHARD_WAVE_ROWS more (one insertion
    wave per shard); the scan route (K1 once per shard), the graph route at
    ef 128, a 50% mask, served over HTTP from 8 threads, and a delete.
    Returns K1's launches and its launches per batch."""
    lo, hi = tune_dense_range(x[:1000].cpu().numpy())
    handle = DenseIndexHandle(DIM, dev, shards=SHARDS,
                              quantization={"type": "scalar", "data_type": "u8", "range": {"min": lo, "max": hi}})
    idx = handle.index
    n_bulk = N - SHARD_WAVE_ROWS
    t0 = time.perf_counter()
    handle.add_batch(list(range(n_bulk)), x[:n_bulk])
    sync_all(idx.devices)
    t_bulk = time.perf_counter() - t0
    builds = [sh.last_build_stats for sh in idx.shards]
    t0 = time.perf_counter()
    handle.add_batch(list(range(n_bulk, N)), x[n_bulk:])
    sync_all(idx.devices)
    t_waves = time.perf_counter() - t0
    per_shard = ", ".join(f"{b['ingest_s']} + {b['graph_s']} s" for b in builds)
    print(f"ShardedHNSWIndex of {SHARDS} shards on {[str(d) for d in idx.devices]}: bulk build of {n_bulk} rows "
          f"{t_bulk:.1f} s (per shard ingest + graph: {per_shard}); {SHARD_WAVE_ROWS} rows more (one wave of "
          f"{SHARD_WAVE_ROWS // SHARDS} per shard) {t_waves:.2f} s; rows per shard {[sh.n for sh in idx.shards]}; "
          f"range ({lo}, {hi}) [{card}]", flush=True)
    if idx.n != N or any(sh.scan_only or sh.entry < 0 for sh in idx.shards):
        fail("21a: a shard built no graph")

    qb, tb = q[:1024], truth[:1024]
    mask = np.zeros(N, bool)
    mask[::2] = True
    handle.search(qb, 10)  # the first search grows each shard's capacity to whole scan chunks
    shard_k1_check(idx, qb, mask, card)  # before the counts are reset: these launches are not the path's
    reset_counts()
    handle.search(qb, 10)
    per_batch = u8_scan.u8_bin_max.launches
    t, (ids, _) = timed_search(lambda: handle.search(qb, 10))
    check_results(f"sharded u8 DenseIndexHandle.search b1024 (scan, {SHARDS} shards)", ids, tb, t, card, True)
    print(f"  u8_bin_max launches per batch {per_batch} (one per shard; capacities "
          f"{[sh.cap for sh in idx.shards]}) [{card}]", flush=True)
    if per_batch != SHARDS:
        fail(f"21a: the sharded scan launched K1 {per_batch} times per batch, want {SHARDS}")
    profile_top(lambda: handle.search(qb, 10), card)

    idx.flat_serve_threshold = min(sh.n for sh in idx.shards) - 1  # every shard takes its graph
    before = u8_scan.u8_bin_max.launches
    t, (ids, _) = timed_search(lambda: handle.search(qb, 10, ef=128), reps=3)
    check_results(f"sharded graph route ef=128 b1024 (limit {idx.flat_serve_threshold} per shard)", ids, tb, t,
                  card, True)
    print(f"  u8_bin_max launches in the graph route {u8_scan.u8_bin_max.launches - before}", flush=True)
    del idx.flat_serve_threshold

    want = exact_top10(qb, x[::2]) * 2
    t, (ids, _) = timed_search(lambda: handle.search(qb, 10, row_mask=mask), reps=3)
    if not mask[ids].all():
        fail("21a: the masked search returned rows outside the mask")
    check_results("sharded 50% mask b1024 (masked scan on every shard)", ids, want, t, card, True)

    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
        server = RestServer(ctx)
        client = RestClient(server.port)
        client.login()
        mount(ctx, "sharded_u8", handle)
        qr = np.round(q.cpu().numpy().astype(np.float64), 6)
        batch_search(client, "sharded_u8", qr[:QUERY_ROWS], WORKERS)  # first search of the collection
        ids_r, _, dt, lat = batch_search(client, "sharded_u8", qr, WORKERS)
        served_line(f"served sharded u8 {N} rows, {WORKERS} workers", ids_r, truth.cpu().numpy(), dt, lat, card)
        client.close()
        server.close()
        ctx.close()

    victim = int(ids[0, 0])
    handle.delete(victim)
    got, _ = handle.search(x[victim : victim + 1], 10)
    print(f"  deleted {victim} absent from its own query: {victim not in got} [{card}]", flush=True)
    if victim in got:
        fail(f"21a: the deleted row {victim} answered its own query")
    return {"launches": u8_scan.u8_bin_max.launches, "per_batch": per_batch}


def sharded_q4_phase(x, q, dev, card: str) -> dict:
    """Phase 21b: a quaternary DenseIndexHandle with SHARDS shards over the
    reference's N_SUB rows (one 65,536-row chunk per shard): K2 once per
    shard chunk and one query unpack per shard per batch."""
    handle = DenseIndexHandle(DIM, dev, shards=SHARDS, quantization={"type": "scalar", "data_type": "quaternary"})
    idx = handle.index
    t0 = time.perf_counter()
    handle.add_batch(list(range(N_SUB)), x[:N_SUB])
    sync_all(idx.devices)
    print(f"quaternary ShardedHNSWIndex: {N_SUB} rows in {time.perf_counter() - t0:.1f} s (per shard graph "
          f"{[b['graph_s'] for b in (sh.last_build_stats for sh in idx.shards)]} s); rows per shard "
          f"{[sh.n for sh in idx.shards]} [{card}]", flush=True)
    qb = q[:1024]
    want = exact_top10(qb, x[:N_SUB])
    reset_counts()
    handle.search(qb, 10)
    k2, unpack = subbyte_scan.subbyte_code_scores.launches, subbyte_scan.unpack_query_codes.launches
    chunks = sum(-(-sh.cap // HNSWIndex.SCAN_CHUNK) for sh in idx.shards)
    t, (ids, _) = timed_search(lambda: handle.search(qb, 10))
    check_results(f"sharded quaternary DenseIndexHandle.search b1024 ({SHARDS} shards of {N_SUB // SHARDS})",
                  ids, want, t, card, True)
    print(f"  subbyte_code_scores launches per batch {k2} ({chunks} chunks of {HNSWIndex.SCAN_CHUNK}), query "
          f"unpack {unpack} [{card}]", flush=True)
    if k2 != chunks or chunks != SHARDS:
        fail(f"21b: K2 launched {k2} times per batch over {chunks} shard chunks, want {SHARDS}")
    return {"k2": subbyte_scan.subbyte_code_scores.launches, "unpack": subbyte_scan.unpack_query_codes.launches,
            "k2_per_batch": k2, "unpack_per_batch": unpack}


def sharded_flat_phase(x, q, truth, dev, card: str) -> None:
    """Phase 21c: ShardedFlatIndex over the 1M rows on a dp 2 x tp 2 mesh of
    the first card repeated, then on the default mesh over the real
    devices: recall@10 against the oracle (gated at 0.999) and ids equal to
    the oracle's on untied slots."""
    qb = q[:1024]
    vals, ids = [], []
    for s in range(0, len(qb), 512):
        v, i = torch.topk(qb[s : s + 512] @ x.T, 10, dim=1)
        vals.append(v)
        ids.append(i)
    o_vals, o_ids = torch.cat(vals).cpu().numpy(), torch.cat(ids).cpu().numpy()
    first = torch.device("cuda", 0)  # the first card, repeated
    for name, mesh in (("dp 2 x tp 2 on the first card", lambda: make_mesh(devices=[first] * 4)),
                       ("the default mesh", make_mesh)):
        m = mesh()
        flat = ShardedFlatIndex(m, DIM, N)
        t0 = time.perf_counter()
        flat.add(x)
        sync_all([d for row in m.devices for d in row])
        t_add = time.perf_counter() - t0
        t, (got, _) = timed_search(lambda: flat.search(qb, 10), reps=3)
        r = recall10(got, truth[:1024])
        same, share = untied_equal(got, o_ids, o_vals)
        print(f"ShardedFlatIndex on {name} ({m.shape}, {torch.cuda.device_count()} device(s)): add {t_add:.2f} s; "
              f"b1024 recall@10 {r:.4f}, {t * 1e3:.2f} ms/batch, {1024 / t:.1f} qps; ids equal to the oracle's on "
              f"untied slots {same} ({share:.1%} of slots) [{card}]", flush=True)
        if r < 0.999 or not same:
            fail(f"21c: ShardedFlatIndex on {name}: recall@10 {r:.4f} (< 0.999?) or ids differ on untied slots")
        del flat
        torch.cuda.empty_cache()


def sharded_rest_phase(data_dir: str, x_rest: np.ndarray, q_rest: np.ndarray, dev, card: str) -> None:
    """Phase 21d: the dry run's served path (``__graft_entry__.py:84-166``)
    over the port: a collection with ``config.shards`` SHARDS written over
    REST in one transaction, searched, filtered, streamed a delete,
    answered by gRPC as by REST, and restarted from its sharded snapshot.
    The dense index tunes its u8 range on the rows ("auto"), as phase 9's
    does, where the dry run fixes (-0.5, 0.5)."""
    from cosdata_tpu_torch.grpc_api import vector_service_pb2 as pb

    truth = exact_top10(torch.as_tensor(q_rest, dtype=torch.float32, device=dev),
                        torch.as_tensor(x_rest, dtype=torch.float32, device=dev)).cpu().numpy()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    c = "/vectordb/collections/sharded"
    client.ok("POST", "/vectordb/collections", {
        "name": "sharded", "dense_vector": {"enabled": True, "dimension": DIM},
        "config": {"max_vectors": None, "shards": SHARDS},
        "metadata_schema": {"fields": [{"name": "half", "values": ["a", "b"]}], "supported_conditions": []},
    })
    desc = client.ok("POST", c + "/indexes/dense", {"name": "i", "distance_metric_type": "cosine",
                                                    "hnsw_params": {"num_layers": 2}, "quantization": {"type": "auto"}})
    t0 = time.perf_counter()
    rows = x_rest.tolist()
    txn = client.ok("POST", c + "/transactions", {})["transaction_id"]
    for s in range(0, len(rows), UPSERT_ROWS):
        client.ok("POST", f"{c}/transactions/{txn}/upsert", {"vectors": [
            {"id": i, "dense_values": rows[i], "metadata": {"half": "a" if i % 2 == 0 else "b"}}
            for i in range(s, s + UPSERT_ROWS)]})
    client.ok("POST", f"{c}/transactions/{txn}/commit", {})
    while client.ok("GET", f"{c}/transactions/{txn}/status")["status"] != "complete":
        if time.perf_counter() - t0 > 600:
            fail("21d: the transaction did not complete")
        time.sleep(0.2)
    t_ingest = time.perf_counter() - t0
    idx = ctx.get_collection("sharded").dense.index
    shards = [sh.n for sh in idx.shards]
    if not getattr(idx, "is_sharded", False) or sum(shards) != len(rows) or desc.get("shards") != SHARDS:
        fail(f"21d: the collection is not sharded as asked: {desc}, rows per shard {shards}")
    ids, _, dt, lat = batch_search(client, "sharded", q_rest, WORKERS)
    r = float((ids[:, :, None] == truth[:, None, :]).any(-1).sum()) / truth.size
    print(f"REST sharded collection ({SHARDS} shards {shards}): ingest of {len(rows)} x {DIM} {t_ingest:.1f} s; "
          f"/search/batch-dense recall@10 {r:.4f}, {len(q_rest) / dt:.1f} qps [{card}]", flush=True)
    if r < MIN_RECALL:
        fail(f"21d: REST sharded recall@10 {r:.4f} < {MIN_RECALL}")
    flt = {"Is": {"field_name": "half", "field_value": "a", "operator": "Equal"}}
    res = client.ok("POST", c + "/search/dense", {"query_vector": q_rest[0].tolist(), "top_k": 10,
                                                  "filter": flt})["results"]
    if len(res) != 10 or any(r["id"] % 2 for r in res):
        fail(f"21d: the filtered search returned ids without the filter value: {[r['id'] for r in res]}")
    victim = int(ids[0, 0])
    client.ok("DELETE", f"{c}/streaming/vectors/{victim}")
    res = client.ok("POST", c + "/search/dense", {"query_vector": rows[victim], "top_k": 10})["results"]
    if victim in [r["id"] for r in res] or len(res) != 10:
        fail(f"21d: the streamed delete of {victim} came back")
    seq = batch_search(client, "sharded", q_rest[:256], 1)
    got, _ = grpc_find(ctx, [pb.FindSimilarVectorsRequest(
        collection_id="sharded", dense=pb.FindSimilarDenseVectorsQuery(vector=v.tolist(), top_k=10),
    ) for v in q_rest[:8]])
    print(f"  filtered search: ok; streamed delete of {victim}: ok; gRPC FindSimilarVectors x8: ids equal REST's "
          f"{got == seq[0][:8].tolist()}", flush=True)
    if got != seq[0][:8].tolist():
        fail("21d: gRPC ids differ from REST's")
    client.close()
    server.close()
    ctx.close()
    t0 = time.perf_counter()
    ctx = AppContext(load_config(data_path=data_dir), admin_key=ADMIN_KEY, device=dev)
    server = RestServer(ctx)
    client = RestClient(server.port)
    client.login()
    ids2, sc2, _, _ = batch_search(client, "sharded", q_rest[:256], 1)
    status, _ = client.call("GET", f"{c}/vectors/{victim}")
    res = client.ok("POST", c + "/search/dense", {"query_vector": rows[victim], "top_k": 10})["results"]
    idx = ctx.get_collection("sharded").dense.index
    same = bool((ids2 == seq[0]).all() and (sc2 == seq[1]).all())
    gone = status == 404 and victim not in [r["id"] for r in res]
    print(f"  after restart ({time.perf_counter() - t0:.1f} s; sharded {getattr(idx, 'is_sharded', False)}, rows "
          f"per shard {[sh.n for sh in idx.shards]}): ids and scores identical {same}; deleted {victim} absent "
          f"{gone} (HTTP {status}) [{card}]", flush=True)
    client.close()
    server.close()
    ctx.close()
    if not (same and gone):
        fail("21d: the restarted sharded collection answered differently or served the deleted vector")


def sharded_phase(x, q, truth, x_rest, q_rest, dev, card: str) -> dict:
    """Phase 21 (module doc); returns the kernels' launches and launches per batch."""
    t0 = time.perf_counter()
    out = sharded_u8_phase(x, q, truth, dev, card)
    torch.cuda.empty_cache()
    phase(f"21b sharded quaternary at {N_SUB} x {DIM}")
    out.update(sharded_q4_phase(x, q, dev, card))
    torch.cuda.empty_cache()
    phase(f"21c ShardedFlatIndex at {N} x {DIM}")
    sharded_flat_phase(x, q, truth, dev, card)
    phase(f"21d sharded collection over REST and gRPC at {len(x_rest)} rows")
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        sharded_rest_phase(data_dir, x_rest, q_rest, dev, card)
    print(f"phase 21 in {time.perf_counter() - t0:.1f} s")
    return out


def launches_per_batch(kernels, search) -> list[int]:
    """The launches of each of ``kernels`` in one b1024 search of the main path."""
    reset_counts()
    search()
    n = [kernel.launches for kernel in kernels]
    reset_counts()
    return n


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
    # nltk: the reference's stemmer, which the port does not need
    for mod in (*REQUIRED, "nltk"):
        print(f"package {mod}: {'present' if importlib.util.find_spec(mod) else 'absent'}")
    missing = [mod for mod in REQUIRED if importlib.util.find_spec(mod) is None]
    if missing:
        fail(f"packages the port needs are missing: {missing}")

    phase("1 build u8_bin_max and subbyte_code_scores")
    t0 = time.perf_counter()
    libs = (u8_scan.LIBRARY, subbyte_scan.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, together
        logs = list(ex.map(lambda lib: lib.build(), libs))
    print(f"built {', '.join(lib.library.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib, log in zip(libs, logs):
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "smem", "wgmma", "arning")):
                print(f"  {lib.name}: {line.strip()}")

    phase("2 kernel against plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err, k1_timed = kernel_check(gen, dev, card)
    print(f"kernel vs plain: max_abs_err {max_err:.3g} (rtol {RTOL}, atol {ATOL}); B=1024 C=1048576 Dp=768: "
          f"kernel {k1_timed[1024]['ms']:.4f} ms, plain {k1_timed[1024]['plain_ms']:.3f} ms; B=128: kernel "
          f"{k1_timed[128]['ms']:.4f} ms; euclidean B=1024: kernel {k1_timed['euclidean']['ms']:.4f} ms, plain "
          f"{k1_timed['euclidean']['plain_ms']:.3f} ms [{card}]")

    phase(f"3 main path at {N} x {DIM}")
    t0 = time.perf_counter()
    x, q, q_big = clustered(N, NQ, DIM, gen, dev, NQ_APPROX)
    truth = exact_top10(q, x)
    torch.cuda.synchronize()
    print(f"corpus + oracle in {time.perf_counter() - t0:.1f} s")
    launches, u8_handle = main_path(x, q, q_big, truth, dev, card)
    (k1_per_batch,) = launches_per_batch([u8_scan.u8_bin_max], lambda: u8_handle.search(q[:1024], 10))
    torch.cuda.empty_cache()

    phase("5 K2 against plain")
    k2_err, k2_timed, unpack_err, unpack_timed = k2_check(gen, dev, card)
    print(f"K2 vs plain: max_abs_err {k2_err} (bit-exact required), query unpack {unpack_err}; res=2 B=1024 "
          f"C=65536 Dp=768: kernel {k2_timed['ms']:.4f} ms, plain {k2_timed['plain_ms']:.3f} ms [{card}]")

    phase(f"6 quaternary DenseIndexHandle at {N} x {DIM}")
    k2_launches, unpack_launches, q4_handle = subbyte_path(x, q, truth, dev, card)
    k2_per_batch, unpack_per_batch = launches_per_batch(
        [subbyte_scan.subbyte_code_scores, subbyte_scan.unpack_query_codes], lambda: q4_handle.search(q[:1024], 10))

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
    x_hy = x_rest[:N_SP_REST]
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
                           ("11 (K2)", served["k2"]), ("11 (query unpack)", served["unpack"]),
                           ("12 (K1)", k1_grpc)):
        if n_launch == 0:
            fail(f"phase {name} never launched its kernel")
    launches += rest["launches"] + k1_restart + served["k1"] + k1_grpc
    k2_launches += served["k2"]
    unpack_launches += served["unpack"]

    phase(f"13 sparse engine at {N_SP} docs")
    sparse_phase(dev, card)

    phase(f"14 sparse and hybrid over REST and gRPC at {N_SP_REST} rows")
    hy_dims, hy_vals = sparse_corpus(N_HY, SEED_HY)
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        k1_hy_rest = sparse_rest_phase(data_dir, x_hy, q_rest, hy_dims, hy_vals, dev, card)["launches"]

    phase(f"15 hybrid served at {N_HY} docs")
    k1_hybrid = hybrid_phase(x, q, hy_dims, hy_vals, dev, card)
    launches += k1_hy_rest + k1_hybrid
    del hy_dims, hy_vals

    phase(f"16 BM25 engine at {N_BM} docs")
    t0 = time.perf_counter()
    bm_docs, bm_ids = bm25_corpus()
    print(f"corpus {N_BM} docs x {WORDS_BM} words, vocabulary {VOCAB_BM}, in {time.perf_counter() - t0:.1f} s")
    k1_bm25 = bm25_phase(x, q, bm_docs, bm_ids, dev, card)
    torch.cuda.empty_cache()

    phase(f"17 BM25 and dense + text hybrid over REST and gRPC at {N_SP_REST} rows")
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        k1_bm_rest = bm25_rest_phase(data_dir, x_hy, q_rest, bm_docs, bm_ids, dev, card)
    launches += k1_bm25 + k1_bm_rest

    phase(f"18 HNSW graph at {N} x {DIM}")
    k2_launches += graph_phase(u8_handle, q4_handle, x, q, truth, dev, card)
    del u8_handle, q4_handle, ctx  # phase 11's context still held both handles
    torch.cuda.empty_cache()

    phase(f"19 beyond the device budget at {N} x {DIM}")
    spilled = spill_u8_phase(x, q, truth, dev, card)
    spilled["launches"] += beyond_hbm_section(x, q, dev, card)
    k2_spill, unpack_spill, k2_streamed, unpack_streamed = spill_q4_phase(x, q, truth, dev, card)
    x_rest = np.round(x[:N_REST].cpu().numpy().astype(np.float64), 6)  # phase 9's rows
    with tempfile.TemporaryDirectory(prefix="cosdata_smoke_") as data_dir:
        k1_spill_rest = spill_rest_phase(data_dir, x_rest, q_rest, dev, card)
    del x_rest
    launches += spilled["launches"] + k1_spill_rest
    k2_launches += k2_spill
    unpack_launches += unpack_spill

    phase(f"20 other metrics at {N} x {DIM}: euclidean and hamming")
    t0 = time.perf_counter()
    other = other_metrics_phase(x, q, q_big, truth, dev, card)
    launches += other["launches"]
    print(f"phase 20 in {time.perf_counter() - t0:.1f} s")

    phase(f"21a sharded u8 DenseIndexHandle at {N} x {DIM}, {SHARDS} shards")
    sharded = sharded_phase(x, q, truth, x_hy, q_rest, dev, card)
    launches += sharded["launches"]
    k2_launches += sharded["k2"]
    unpack_launches += sharded["unpack"]
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(card)
    # ms, plain_ms, library_ms and bound_ms at the headline shapes (K1 B=1024,
    # C=1,048,576, Dp=768; K2 res=2, B=1024, C=65,536, Dp=768; the query
    # unpack res=2, B=1024, Dp=768): ms and plain_ms are single calls timed
    # alone, *_back_to_back the mean of calls queued back to back; library_ms
    # is torch._int_mm, the product only; K1 at B=128 beside it
    print(json.dumps({"kernels": [{
        "name": "u8_bin_max",
        "route": "cuda",
        "source": "cosdata_tpu_torch/csrc/u8_bin_max.cu",
        "replaces": "cosdata_tpu/ops/pallas/u8_scan.py:69",
        "launches": launches,
        "launches_per_batch": k1_per_batch,
        "streamed_launches_per_batch": spilled["per_batch"],
        "sharded_launches_per_batch": sharded["per_batch"],
        "max_abs_err": max_err,
        **k1_timed[1024],
        "b128": k1_timed[128],
        "euclidean": {**k1_timed["euclidean"], "launches": other["launches"],
                      "streamed_launches_per_batch": other["streamed_per_batch"]},
    }, {
        "name": "subbyte_code_scores",
        "route": "cuda",
        "source": "cosdata_tpu_torch/csrc/subbyte_code_scores.cu",
        "replaces": "cosdata_tpu/ops/pallas/subbyte_scan.py:55",
        "launches": k2_launches,
        "launches_per_batch": k2_per_batch,
        "streamed_launches_per_batch": k2_streamed,
        "sharded_launches_per_batch": sharded["k2_per_batch"],
        "max_abs_err": k2_err,
        **k2_timed,
    }, {
        "name": "unpack_query_codes",
        "route": "cuda",
        "source": "cosdata_tpu_torch/csrc/subbyte_code_scores.cu",
        "replaces": "cosdata_tpu/ops/pallas/subbyte_scan.py:99",
        "launches": unpack_launches,
        "launches_per_batch": unpack_per_batch,
        "streamed_launches_per_batch": unpack_streamed,
        "sharded_launches_per_batch": sharded["unpack_per_batch"],
        "max_abs_err": unpack_err,
        **unpack_timed,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
