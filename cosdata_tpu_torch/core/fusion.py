"""Vectorized reciprocal-rank fusion for hybrid search.

The serving-path counterpart of the reference's hybrid RRF
(upstream src/api/vectordb/search/repo.rs:168-341: each leg fetches
3*top_k, score = 1/(rank + k_const), summed across legs). Legs are
(B, fetch) id arrays in rank order and fusion is one sort + run-boundary
segment sum per batch.

Port of ``cosdata_tpu/core/fusion.py`` (a host-only copy).
"""

from __future__ import annotations

import numpy as np


def rrf_fuse(
    id_lists, k: int, fetch: int, k_rrf: float = 60.0
) -> tuple[np.ndarray, np.ndarray]:
    """Fuse legs of ranked ids into (ids (B, k), scores (B, k)).

    ``id_lists``: list of (B, >=fetch) int arrays, -1 padded, each row in
    descending-rank order. Duplicate ids across legs sum their reciprocal
    ranks 1/(rank + k_rrf); output rows are fused-score descending with
    -1/0.0 padding past the unique-candidate count.
    """
    rr = (1.0 / (np.arange(fetch) + float(k_rrf))).astype(np.float32)
    ids = np.concatenate(
        [np.asarray(leg, np.int64)[:, :fetch] for leg in id_lists], axis=1
    )
    b = ids.shape[0]
    sc = np.broadcast_to(rr, (b, fetch))
    sc = np.concatenate([sc] * len(id_lists), axis=1).copy()
    sc[ids < 0] = 0.0
    # sort by id: duplicates become adjacent runs; segment totals via
    # cumsum difference at run boundaries (no per-query loop)
    order = np.argsort(ids, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, order, axis=1)
    sc_s = np.take_along_axis(sc, order, axis=1)
    csum = np.cumsum(sc_s, axis=1, dtype=np.float64)
    last = np.ones_like(ids_s, bool)
    last[:, :-1] = ids_s[:, :-1] != ids_s[:, 1:]
    first = np.ones_like(ids_s, bool)
    first[:, 1:] = last[:, :-1]
    # total of each run lands at its LAST slot: csum[last] - csum[before first]
    before = np.where(first, csum - sc_s, 0.0)
    seg_start = np.maximum.accumulate(np.where(first, before, -np.inf), axis=1)
    total = csum - seg_start
    fused = np.where(last & (ids_s >= 0), total, -np.inf)
    kk = min(k, fused.shape[1])
    top = np.argpartition(-fused, min(kk, fused.shape[1] - 1), axis=1)[:, :kk]
    rows = np.arange(b)[:, None]
    ordk = np.argsort(-fused[rows, top], axis=1, kind="stable")
    top = top[rows, ordk]
    out_ids = ids_s[rows, top]
    out_sc = fused[rows, top].astype(np.float32)
    dead = ~np.isfinite(out_sc)
    out_ids[dead] = -1
    out_sc[dead] = 0.0
    if kk < k:
        out_ids = np.pad(out_ids, ((0, 0), (0, k - kk)), constant_values=-1)
        out_sc = np.pad(out_sc, ((0, 0), (0, k - kk)))
    return out_ids, out_sc
