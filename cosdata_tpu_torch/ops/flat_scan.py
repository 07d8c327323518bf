"""Exact-scan search (port of cosdata_tpu/ops/flat_scan.py).

Two engines:

- u8 stores take the codes engine (:func:`fused_flat_search_codes`);
- sub-byte, f16 and f32 stores take the chunked scan with a running top-k
  (:func:`fused_flat_search`): each chunk of ``chunk`` rows is scored in
  full, masked, cut to its top-k and merged into a running (B, k_fetch)
  top-k; an exact f32 rerank against the raw rows follows. The
  reference's per-chunk ``approx_max_k(recall_target=0.99)`` is an exact
  selection here (on XLA:CPU the reference's is exact too). Sub-byte
  chunks are scored and masked by kernel K2's fused entry, which also
  writes the maxima of every 32 rows; the group_topk kernel then merges
  the rows of the chunk's best groups into the running top-k
  (``kernels/group_topk.py``).

The codes engine's five stages:

1. the caller quantizes the queries to centered int8 codes;
2. the u8_bin_max kernel scans the whole store and writes ONE (B, cap/G)
   f32 table of per-bin score maxima (contiguous bins of G rows) — the
   (B, cap) scores never reach device memory;
3. one exact ``torch.topk`` over the maxima picks the winning bins (the
   reference's ``approx_max_k(recall_target=0.999)``);
4. the winning bins expand as contiguous (G·D)-byte blocks of the code
   table, rescored in u8 space by the u8_block_dot kernel
   (``kernels/u8_block_dot.py``, one launch for the batch: each chosen
   block read once, its int8 dots and scores for every query that chose
   it), then cut to their top-k;
5. the shortlist is reranked in exact f32 against the raw rows (a hamming
   shortlist by euclidean distance, as in the reference).

Stages 2-4 select in one of the reference's two modes:

- ``bins`` (above): one (B, cap/G) table of bin maxima for the whole store;
- ``approx``, taken where that table would pass ``MAX_BIN_TABLE``
  elements and always for hamming (which has no bin kernel): a running
  (B, k_fetch) top-k merged over ``CODES_CHUNK``-row slices of the store,
  each slice cut to its exact top-k by :func:`codes_chunk_topk`. The
  reference's per-chunk ``approx_max_k`` is exact on XLA:CPU, so both
  modes answer the same wherever scores are untied.

A store whose codes spilled to the host tier takes
:func:`streamed_flat_topk`: its codes stream to the device in
``STREAM_CHUNK``-row chunks, each chunk scanned by K1 (u8: stages 2-4 on
the chunk) or K2 (sub-byte) and merged into a running top-k.
"""

from __future__ import annotations

import torch

from cosdata_tpu_torch.ops import distance as D
from cosdata_tpu_torch.ops.kernels.group_topk import merge_group_topk
from cosdata_tpu_torch.ops.kernels.subbyte_scan import subbyte_scores_fused, unpack_query_codes
from cosdata_tpu_torch.ops.kernels.u8_block_dot import u8_block_dot
from cosdata_tpu_torch.ops.kernels.u8_scan import u8_bin_max_from_store
from cosdata_tpu_torch.ops.quantize import QuantizedU8, quantize_u8
from cosdata_tpu_torch.ops.storage import exact_scores, quantize_batch
from cosdata_tpu_torch.ops.storage import rerank as rerank_raw
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k

#: the bins table's size limit (elements); past it the scan takes the
#: per-chunk "approx" mode, as the reference's does
MAX_BIN_TABLE = 1 << 28
#: store rows per slice of the approx mode and of the streamed scan
CODES_CHUNK = 1 << 16
#: rows per bin of K1 in both (one warp of the kernel)
CHUNK_GROUP = 32


def _topk_take(scores, k, ids):
    """Top-k of ``scores`` along dim 1, with the matching entries of ``ids``."""
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, torch.gather(ids, 1, pos)


def fused_flat_search_codes(
    metric: str,
    d_true: int,
    d_pad: int,
    k_bins: int,
    group: int,
    k_fetch: int,
    k: int,
    rerank: bool,
    q: QuantizedU8,  # quantized u8 queries (B rows)
    store: QuantizedU8,  # quantized u8 store (capacity rows)
    raw: torch.Tensor | None,  # (cap, d_pad) f32/f16 raw rows when rerank
    q_re: torch.Tensor | None,  # (B, d_pad) exact queries for the rerank
    valid: torch.Tensor,  # (cap,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (ids (B, k), vals (B, k)); ids are -1 where nothing was found.
    Selects in the ``bins`` mode, or in the ``approx`` mode for hamming and
    where the bin table would pass ``MAX_BIN_TABLE`` (module doc)."""
    b = q.data.shape[0]
    capacity = store.data.shape[0]
    if metric == "hamming" or b * (capacity // group) > MAX_BIN_TABLE:
        vals, ids = approx_topk(metric, d_pad, k_fetch, q, store, valid)
    else:
        # stage 2: K1
        bins = u8_bin_max_from_store(metric, group, q, store, valid, d_pad)
        # stage 3: one exact selection over the maxima
        k_bins = min(k_bins, capacity // group)
        bin_s, bin_ids = torch.topk(bins, k_bins, dim=1)
        del bins
        # stage 4: contiguous block expansion + u8 rescore
        vals, ids = expand_bins(metric, d_pad, group, k_fetch, q, store, valid, bin_s, bin_ids)
    if rerank:
        # stage 5, fused: exact rerank with the exact (f16-rounded) queries
        ids, vals = exact_rerank_sorted(metric, d_true, d_pad, k, q_re, raw, ids, vals)
    else:
        vals, ids = vals[:, :k], ids[:, :k]
    ids = torch.where(vals > NEG_INF / 2, ids, -1)
    return ids, vals


def expand_bins(metric: str, d_pad: int, group: int, k_fetch: int, q: QuantizedU8, store: QuantizedU8,
                valid: torch.Tensor, bin_s: torch.Tensor, bin_ids: torch.Tensor):
    """Stage 4: the (B, k_bins) winning bins expand as contiguous blocks of
    G rows of the code table, rescored in u8 space (:func:`u8_block_dot`:
    on the card one launch reads each chosen block once and writes the
    scores) and cut to their top ``k_fetch``. Returns (vals, row ids); a row
    of a sunk bin or an invalid row scores NEG_INF."""
    sc = u8_block_dot(metric, d_pad, group, q, store, valid, bin_s, bin_ids)
    vals, pos = torch.topk(sc, min(k_fetch, sc.shape[1]), dim=1)
    return vals, torch.gather(bin_ids, 1, pos // group) * group + pos % group


def codes_chunk_topk(metric: str, d_pad: int, k: int, q: QuantizedU8, chunk: QuantizedU8,
                     valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k (scores, rows) of one u8 chunk on the device.

    Cosine, dot and euclidean run K1 over the chunk (``CHUNK_GROUP``-row
    bins), an exact top-k of its bins and the expansion and u8 rescore of
    their rows: each of the chunk's top-k rows bounds its own bin's
    maximum, so at most k-1 bins outrank it and the chunk's top-k survives
    the bin cut. Hamming scores the whole chunk (``distance.score``) and
    selects with ``lax_top_k``, the reference's plain merge."""
    rows = chunk.data.shape[0]
    if metric == "hamming":
        scores = torch.where(valid[None, :], D.score(metric, "u8", q, chunk, d_pad), NEG_INF)
        return lax_top_k(scores, min(k, rows))
    bins = u8_bin_max_from_store(metric, CHUNK_GROUP, q, chunk, valid, d_pad)
    bin_s, bin_ids = torch.topk(bins, min(k, rows // CHUNK_GROUP), dim=1)
    del bins
    return expand_bins(metric, d_pad, CHUNK_GROUP, k, q, chunk, valid, bin_s, bin_ids)


def approx_topk(metric: str, d_pad: int, k_fetch: int, q: QuantizedU8, store: QuantizedU8,
                valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The approx mode's stages 2-4 (the reference's ``abody``): each
    ``CODES_CHUNK``-row slice of a resident store is cut to its top-k by
    :func:`codes_chunk_topk` and merged into a running (B, k_fetch) top-k,
    ties to the earlier entry. Returns (vals, ids), ids -1 where nothing
    was found."""
    b, capacity = q.data.shape[0], store.data.shape[0]
    top_s = torch.full((b, k_fetch), NEG_INF, dtype=torch.float32, device=valid.device)
    top_i = torch.full((b, k_fetch), -1, dtype=torch.int64, device=valid.device)
    for start in range(0, capacity, CODES_CHUNK):
        rows = min(CODES_CHUNK, capacity - start)
        chunk = _slice_store(store, "u8", start, rows)
        c_s, c_i = codes_chunk_topk(metric, d_pad, k_fetch, q, chunk, valid[start : start + rows])
        top_s, pos = lax_top_k(torch.cat([top_s, c_s], dim=1), k_fetch)
        top_i = torch.gather(torch.cat([top_i, c_i + start], dim=1), 1, pos)
    return top_s, torch.where(top_s > NEG_INF / 2, top_i, -1)


def fused_flat_search_codes_f16q(
    metric: str,
    d_true: int,
    d_pad: int,
    k_bins: int,
    group: int,
    k_fetch: int,
    k: int,
    q_f16: torch.Tensor,  # (B, d_pad) f16-rounded exact queries
    lo,
    hi,
    store: QuantizedU8,
    valid: torch.Tensor,
):
    """Stages 1-4 fed by one f16-rounded query tensor: the scan quantizes it
    to u8 codes; the caller reranks against the same tensor."""
    q = quantize_u8(q_f16.to(torch.float32), lo, hi, d_true)
    return fused_flat_search_codes(
        metric, d_true, d_pad, k_bins, group, k_fetch, k, False, q, store, None, None, valid
    )


def exact_rerank_sorted(metric, d_true, d_pad, k, q_re, raw, ids, vals):
    """Exact f32 rerank of a (B, kf) shortlist; returns the top-k (ids, vals).

    Raw rows are gathered in ascending id order and put back (gather
    locality); the math is that of an unsorted gather."""
    b, kf = ids.shape
    lanes = torch.arange(d_pad, device=ids.device) < d_true
    q_deq = torch.where(lanes[None, :], q_re.to(torch.float32), 0.0)
    flat = torch.clamp_min(ids, 0).reshape(-1)
    order = torch.argsort(flat)
    cand = torch.empty((flat.shape[0], d_pad), dtype=torch.float32, device=ids.device)
    cand[order] = raw[flat[order]].to(torch.float32)
    re = exact_scores(metric, q_deq, cand.view(b, kf, d_pad))
    re = torch.where(vals > NEG_INF / 2, re, NEG_INF)
    vals_k, ids_k = _topk_take(re, min(k, kf), ids)
    ids_k = torch.where(vals_k > NEG_INF / 2, ids_k, -1)
    return ids_k, vals_k


def _slice_store(store, kind: str, start: int, chunk: int):
    """Rows [start, start + chunk) of a quantized store, as views."""
    sl = slice(start, start + chunk)
    if kind == "subbyte":
        return store._replace(planes=store.planes[:, sl], sums=store.sums[sl], mags=store.mags[sl])
    if kind == "u8":
        return store._replace(data=store.data[sl], sums=store.sums[sl], mags=store.mags[sl])
    return store._replace(data=store.data[sl], mags=store.mags[sl])


def flat_scan_topk(metric: str, kind: str, d: int, k: int, chunk: int, q, store, valid: torch.Tensor,
                   ref_select: bool = False, merge=merge_group_topk):
    """Returns (scores (B, k), ids (B, k)) over the whole store, ids -1 where
    nothing was found; ``kind`` in {"u8", "subbyte", "float"}, capacity a
    multiple of ``chunk``, ``valid`` (capacity,) bool. ``ref_select`` takes
    the reference's selection, for callers whose results are the
    reference's edges (the graph's exact bulk build): u8 chunk scores
    rounded through bf16, as the reference's shortlist selects them, and
    ties in index order (``lax.top_k``'s). Sub-byte cosine and dot chunks
    come scored and masked from K2's fused entry; without ``ref_select``
    the group_topk kernel merges them from their group maxima
    (:func:`merge_group_topk`, or ``merge``, called as it is: a tool
    wraps it to read each merge's inputs). Without ``ref_select`` (or
    hamming) the running top-k is kept in no order and sorted once at the
    end."""
    capacity = valid.shape[0]
    b = q.mags.shape[0]
    top_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=valid.device)
    top_i = torch.full((b, k), -1, dtype=torch.int64, device=valid.device)
    ordered = ref_select or metric == "hamming"
    select = lax_top_k if ordered else (lambda s, kk: torch.topk(s, kk, dim=1, sorted=False))
    fused = kind == "subbyte" and metric in ("cosine", "dot")  # D.score raises for euclidean
    # sub-byte queries are unpacked once, for every chunk's K2 product
    q_codes = unpack_query_codes(q.planes) if kind == "subbyte" else None
    for start in range(0, capacity, chunk):
        sl = _slice_store(store, kind, start, chunk)
        v = valid[start : start + chunk]
        if fused:
            scores, gmax = subbyte_scores_fused(metric, q, sl, d, v, q_codes)  # (B, chunk), (B, chunk / 32)
            if not ref_select:
                top_s, top_i = merge(scores, gmax, top_s, top_i, start)
                del scores, gmax
                continue
            del gmax
        else:
            scores = torch.where(v[None, :], D.score(metric, kind, q, sl, d, q_codes), NEG_INF)
            if ref_select and kind == "u8":
                scores = scores.to(torch.bfloat16).to(torch.float32)
        c_s, c_i = select(scores, min(k, chunk))
        del scores
        top_s, pos = select(torch.cat([top_s, c_s], dim=1), k)
        top_i = torch.gather(torch.cat([top_i, c_i + start], dim=1), 1, pos)
    if not ordered:
        top_s, pos = torch.sort(top_s, dim=1, descending=True)
        top_i = torch.gather(top_i, 1, pos)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, -1)
    return top_s, top_i


def fused_flat_search(
    metric: str,
    kind: str,
    d_true: int,
    d_pad: int,
    resolution: int,
    k_fetch: int,
    k: int,
    chunk: int,
    rerank: bool,
    q_raw: torch.Tensor,  # (B, d_pad) f32
    lo,
    hi,
    store,
    raw: torch.Tensor | None,  # (cap, d_pad) f32/f16 raw rows when rerank
    valid: torch.Tensor,  # (cap,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize the queries, scan in chunks, exact-rerank, take the top-k.
    Returns (ids (B, k), vals (B, k)); ids are -1 where nothing was found."""
    q = quantize_batch(q_raw, lo, hi, kind, resolution, d_true)  # "float" queries stay f32
    vals, ids = flat_scan_topk(metric, kind, d_pad, k_fetch, chunk, q, store, valid)
    if rerank:
        re = rerank_raw(metric, q_raw, raw, ids)
        re = torch.where(vals > NEG_INF / 2, re, NEG_INF)
        vals, pos = torch.topk(re, k, dim=1)
        ids = torch.gather(ids, 1, pos)
    else:
        vals, ids = vals[:, :k], ids[:, :k]
    ids = torch.where(vals > NEG_INF / 2, ids, -1)
    return ids, vals


#: rows per streamed chunk of a spilled store (x dim_pad bytes of u8 codes
#: per copy)
STREAM_CHUNK = CODES_CHUNK


def _stream_chunks(store, stats: dict):
    """Yield (base, rows, chunk) over a spilled store's host-tier codes, in
    ``STREAM_CHUNK``-row slices up to its capacity; ``chunk`` is the slice
    as a quantized batch on the store's device, carrying the device scalars.

    On the CPU the slices are views. On CUDA two device buffers alternate:
    the copies of chunk i+1 are queued on a side stream, from the pinned
    host tier without blocking, before chunk i is handed out, so they
    overlap chunk i's kernels. An event orders each buffer's copies before
    the kernels that read it, and another its readers before its next fill;
    the first two fills wait for the main stream's work up to the buffers'
    allocation. ``stats["bytes"]`` counts the bytes moved."""
    a, cap, kind = store.arrays, store.capacity, store.kind
    bases = list(range(0, store.n, STREAM_CHUNK))

    def span(base):
        return base, min(base + STREAM_CHUNK, cap)

    def nbytes(lo, hi):
        row = (a.planes.shape[0] * a.planes.shape[2] * 4 if kind == "subbyte" else a.data.shape[1]) + 8
        return (hi - lo) * row

    if store.device.type != "cuda":
        for base in bases:
            lo, hi = span(base)
            stats["bytes"] += nbytes(lo, hi)
            yield base, hi - lo, _slice_store(a, kind, lo, hi - lo)
        return
    dev = store.device
    rows_max = min(STREAM_CHUNK, cap)
    bufs = [store._empty(rows_max) for _ in range(2)]
    side = torch.cuda.Stream(device=dev)
    main = torch.cuda.current_stream(dev)
    ready = [torch.cuda.Event(), torch.cuda.Event()]
    free = [torch.cuda.Event(), torch.cuda.Event()]

    def fill(slot, base):
        lo, hi = span(base)
        buf = bufs[slot]
        with torch.cuda.stream(side):
            side.wait_event(free[slot])  # the kernels of this buffer's last chunk are done
            if kind == "subbyte":
                for p in range(a.planes.shape[0]):
                    buf.planes[p, : hi - lo].copy_(a.planes[p, lo:hi], non_blocking=True)
            else:
                buf.data[: hi - lo].copy_(a.data[lo:hi], non_blocking=True)
            buf.sums[: hi - lo].copy_(a.sums[lo:hi], non_blocking=True)
            buf.mags[: hi - lo].copy_(a.mags[lo:hi], non_blocking=True)
            ready[slot].record(side)
        stats["bytes"] += nbytes(lo, hi)

    # the buffers were allocated (and filled empty) on the main stream, and
    # their blocks may have been read there by earlier kernels: the first
    # copies wait for all of it (``free`` has no record yet)
    side.wait_stream(main)
    try:
        fill(0, bases[0])
        for i, base in enumerate(bases):
            slot = i % 2
            if i + 1 < len(bases):
                fill(1 - slot, bases[i + 1])
            main.wait_event(ready[slot])
            lo, hi = span(base)
            yield base, hi - lo, _slice_store(bufs[slot], kind, 0, hi - lo)
            free[slot].record(main)
    finally:
        # a scan left early must not free the buffers under a copy in flight
        main.wait_stream(side)


def streamed_flat_topk(metric: str, store, queries, k_fetch: int, valid: torch.Tensor):
    """Exact scan of a store whose codes spilled to the host tier (port of
    the reference's ``streamed_flat_topk``): the codes stream to the device
    chunk by chunk (:func:`_stream_chunks`) into a running (B, k) top-k,
    k = min(k_fetch, capacity).

    - u8 chunks take :func:`codes_chunk_topk` while the chunk is on the
      device: K1 with its bins expanded and rescored (the reference's
      ``_streamed_chunk_merge_codes``, whose answers are the plain
      merge's), or for hamming the plain merge (``_streamed_chunk_merge``).
    - sub-byte chunks run K2 against the query codes, unpacked once per batch.

    ``valid`` is a (capacity,) bool tensor on the device (rows, tombstones
    and filters). Returns device (scores (B, k), ids (B, k)), ids -1 where
    nothing was found; ``streamed_flat_topk.last_stats`` holds the last
    call's chunks and bytes moved."""
    kind, d_pad = store.kind, store.dim_pad
    if kind == "u8":
        q, q_codes = store.ship_query_codes(queries), None
    else:
        q = store.quantize_queries(queries)
        q_codes = unpack_query_codes(q.planes)
    b = q.mags.shape[0]
    k = min(k_fetch, store.capacity)
    top_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=store.device)
    top_i = torch.full((b, k), -1, dtype=torch.int64, device=store.device)
    stats = {"chunks": 0, "bytes": 0}
    for base, rows, chunk in _stream_chunks(store, stats):
        valid_c = valid[base : base + rows]
        if kind == "u8":
            c_s, c_i = codes_chunk_topk(metric, d_pad, k, q, chunk, valid_c)
        else:
            # sub-byte scores tie often: equal scores keep the lower row, as
            # the reference's selections do, so both keep the same shortlist
            scores = D.score(metric, kind, q, chunk, d_pad, q_codes)
            c_s, c_i = lax_top_k(torch.where(valid_c[None, :], scores, NEG_INF), min(k, rows))
            del scores
        top_s, pos = lax_top_k(torch.cat([top_s, c_s], dim=1), k)
        top_i = torch.gather(torch.cat([top_i, c_i + base], dim=1), 1, pos)
        stats["chunks"] += 1
    streamed_flat_topk.last_stats = stats
    return top_s, torch.where(top_s > NEG_INF / 2, top_i, -1)


streamed_flat_topk.last_stats = {"chunks": 0, "bytes": 0}
