"""Sparse scoring functions: posting gather, scatter-accumulate, nominate,
exact raw-row rescore and top-k.

Port of ``cosdata_tpu/ops/sparse_kernels.py``. The reference's functions
are XLA ops, not Pallas kernels, and these are plain PyTorch on the
tensors' own device: the CPU path and the CUDA path are the same code.
The host ships (start, len, mult) posting-segment descriptors; the device
gathers the device-resident postings at 128-lane row grain, scores them,
and runs top-k.

Changed from the reference:

- where the reference takes ``approx_max_k`` on a TPU, the port takes an
  exact top-k, the reference's branch on every other backend;
- each ``fori_loop`` is a Python loop over the same chunks (the slot and
  candidate chunks of the rescore, the ``n_cap`` chunks of the head
  product), so the workspace stays bounded as in the reference;
- ``csr_accumulate_topk`` takes one top-k over its (B, n_cap) rows, which
  it holds whole anyway: the reference chunks that top-k only because a
  wide ``lax.top_k`` lowers to a full sort on a TPU;
- the reference's unused ``vocab_pad`` argument is dropped;
- ids come back as int64 tensors (torch indexes with int64).

Every top-k here keeps ``lax.top_k``'s order among equal scores (the
lower index first), which ``torch.topk`` does not promise: posting
contributions are small integers and tie by the hundred, and the order
decides which tied postings a nomination keeps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cosdata_tpu_torch.ops.topk import NEG_INF
from cosdata_tpu_torch.ops.topk import lax_top_k as _topk

#: posting-gather lane width: device CSR lists start at multiples of it,
#: so postings are fetched as (LANE,)-wide rows
GATHER_LANE = 128


def _finish(top_s: torch.Tensor, top_i: torch.Tensor, k: int | None = None):
    """Ids -1 and scores 0 where no candidate; pad to ``k`` columns."""
    live = top_s > NEG_INF / 2
    top_i = torch.where(live, top_i, -1)
    top_s = torch.where(live, top_s, 0.0)
    if k is not None and top_i.shape[1] < k:
        top_i = F.pad(top_i, (0, k - top_i.shape[1]), value=-1)
        top_s = F.pad(top_s, (0, k - top_s.shape[1]))
    return top_s, top_i


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """True at the first position of each id in its row."""
    ids_s, perm = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    return ~torch.zeros_like(dup).scatter_(1, perm, dup)


def _merge_topk(top_s, top_i, c_s, c_i, k: int, distinct: bool = False):
    """Running top-k: merge a chunk's (scores, ids) into the carried ones.
    ``distinct``: an id already carried is not taken again (exact scores
    of one doc are equal, so the copy adds nothing)."""
    all_s = torch.cat([top_s, c_s], dim=1)
    all_i = torch.cat([top_i, c_i], dim=1)
    if distinct:
        all_s = torch.where(_first_occurrence(all_i), all_s, NEG_INF)
    top_s, pos = _topk(all_s, k)
    return top_s, torch.gather(all_i, 1, pos)


def _empty_topk(b: int, k: int, device):
    return (
        torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
        torch.full((b, k), -1, dtype=torch.int64, device=device),
    )


def _score_doc_rows(dd, dv, q_dim_idx, q_weights):
    """Exact score Σ_j qv[dim_j]·val_j of gathered candidate doc rows by
    broadcast compares over the query dims (no gather of query rows).

    dd: (B, C, R) int32 compact doc-dim ids (0-padded rows);
    dv: (B, C, R) f32 doc values (0-padded);
    q_dim_idx: (B, QD) int32 (-1 pad); q_weights: (B, QD) f32.
    Duplicate query dims sum. Returns (B, C) f32 scores."""
    b, c, _r = dd.shape
    acc = torch.zeros((b, c), dtype=torch.float32, device=dd.device)
    for t in range(q_dim_idx.shape[1]):
        qi = q_dim_idx[:, t, None, None]
        m = (dd == qi) & (qi >= 0)
        contrib = torch.where(m, dv, 0.0).sum(dim=-1)  # (B, C)
        acc = acc + q_weights[:, t, None] * contrib
    return acc


def _gather_segments(starts, lens, post_ids, post_vals, segcap: int, aligned: bool):
    """Gather (B, MAXD, segcap) posting ids and values for segment
    descriptors. ``aligned=True`` (every list starts at a GATHER_LANE
    multiple, padding slots hold id -1 / value 0) fetches whole 128-lane
    rows; otherwise single elements. Returns (ids, vals, valid), each
    (B, MAXD, segcap); ids and vals are garbage where ~valid."""
    b, maxd = starts.shape
    dev = starts.device
    iota = torch.arange(segcap, device=dev)
    valid = (iota < lens[:, :, None]) & (starts[:, :, None] >= 0)
    p = post_ids.shape[0]
    lane = GATHER_LANE
    if aligned and segcap % lane == 0 and p % lane == 0:
        riota = torch.arange(segcap // lane, device=dev)
        rows = torch.clamp(
            torch.div(starts, lane, rounding_mode="floor")[:, :, None] + riota, 0, p // lane - 1
        )
        ids = post_ids.view(-1, lane)[rows].reshape(b, maxd, segcap)
        vals = post_vals.view(-1, lane)[rows].reshape(b, maxd, segcap) if post_vals is not None else None
        return ids, vals, valid
    safe = torch.clamp(starts[:, :, None] + iota, 0, p - 1)
    return post_ids[safe], post_vals[safe] if post_vals is not None else None, valid


def _gathered_contrib(starts, lens, mults, post_ids, post_vals, segcap, aligned, fill):
    """(B, MAXD·segcap) posting ids (-1 where invalid) and mult·value
    contributions (``fill`` where invalid)."""
    b = starts.shape[0]
    g_ids, g_vals, valid = _gather_segments(starts, lens, post_ids, post_vals, segcap, aligned)
    ids = torch.where(valid, g_ids.long(), -1).reshape(b, -1)
    contrib = torch.where(valid, mults[:, :, None] * g_vals, fill).reshape(b, -1)
    return ids, contrib


def csr_accumulate_topk(starts, lens, mults, post_ids, post_vals, alive, n_cap: int, k: int,
                        segcap: int, aligned: bool = False):
    """Scatter-add of the gathered contributions into (B, n_cap) score
    rows, a hit mask, top-k. starts/lens (B, MAXD) int32 (-1 = unused
    slot), mults (B, MAXD) f32, post_ids (P,) int32, post_vals (P,) f32,
    alive (n_cap,) bool. Returns (scores (B, k), ids (B, k)), ids -1 where
    no candidate."""
    b = starts.shape[0]
    ids, contrib = _gathered_contrib(starts, lens, mults, post_ids, post_vals, segcap, aligned, 0.0)
    hit = ids >= 0
    safe_ids = ids.clamp_min(0)
    vals = torch.where(hit, contrib, 0.0)
    scores = torch.zeros((b, n_cap), dtype=torch.float32, device=ids.device).scatter_add_(1, safe_ids, vals)
    # a hit count by add, as the reference counts (a scatter-set of mixed
    # True/False for the padded id-0 lanes would be order dependent)
    hits = torch.zeros((b, n_cap), dtype=torch.int32, device=ids.device).scatter_add_(
        1, safe_ids, hit.to(torch.int32)
    )
    masked = torch.where((hits > 0) & alive[None, :], scores, NEG_INF)
    return _finish(*_topk(masked, k))


def nominate_rescore_topk(starts, lens, mults, post_ids, post_vals, doc_dims, doc_vals, q_dim_idx,
                          q_weights, alive, k_fetch: int, nom: int, segcap: int, slot_chunk: int,
                          aligned: bool = False):
    """Contribution-nominated candidates + exact raw-row rescore.

    1. per-slot contribution = mult · posting value;
    2. the top-``nom`` contributions per query (running over slot chunks)
       nominate candidate docs;
    3. only those get the R-wide exact rescore Σ_j qdense[dim_j]·val_j.

    doc_dims (n_cap, R) int32 compact dim ids, doc_vals (n_cap, R) f32,
    q_dim_idx (B, QD) int32 (-1 pad), q_weights (B, QD) f32. A doc
    nominated by several dims fills that many slots; the caller dedups.
    Returns (scores (B, k_fetch), ids (B, k_fetch))."""
    b = starts.shape[0]
    ids, contrib = _gathered_contrib(starts, lens, mults, post_ids, post_vals, segcap, aligned, NEG_INF)
    safe = ids.clamp_min(0)
    contrib = torch.where((ids >= 0) & alive[safe], contrib, NEG_INF)
    nom_eff = min(nom, slot_chunk)
    top_s, nom_ids = _empty_topk(b, nom_eff, ids.device)
    for s in range(0, ids.shape[1], slot_chunk):
        c_contrib = contrib[:, s : s + slot_chunk]
        c_s, c_pos = _topk(c_contrib, min(nom_eff, c_contrib.shape[1]))
        c_i = torch.gather(ids[:, s : s + slot_chunk], 1, c_pos)
        top_s, nom_ids = _merge_topk(top_s, nom_ids, c_s, c_i, nom_eff)
    # exact rescore of the nominated docs only
    safe_c = nom_ids.clamp_min(0)
    sc = _score_doc_rows(doc_dims[safe_c], doc_vals[safe_c], q_dim_idx, q_weights)
    sc = torch.where((nom_ids >= 0) & alive[safe_c] & _first_occurrence(nom_ids), sc, NEG_INF)
    top_s, pos = _topk(sc, min(k_fetch, nom_eff))
    return _finish(top_s, torch.gather(nom_ids, 1, pos), k_fetch)


def candidates_rescore_topk(starts, lens, post_ids, doc_dims, doc_vals, q_dim_idx, q_weights, alive,
                            k_fetch: int, segcap: int, cand_chunk: int, aligned: bool = False):
    """Candidate gather + exact raw-row rescore + top-k, no scatter: every
    budgeted posting slot's doc is rescored from its own raw row, in
    chunks of ``cand_chunk`` slots. Duplicate candidates carry identical
    scores; the caller dedups. Returns (scores (B, k_fetch), ids (B, k_fetch))."""
    b = starts.shape[0]
    g_ids, _g_vals, valid = _gather_segments(starts, lens, post_ids, None, segcap, aligned)
    cand = torch.where(valid, g_ids.long(), -1).reshape(b, -1)
    top_s, top_i = _empty_topk(b, k_fetch, cand.device)
    for s in range(0, cand.shape[1], cand_chunk):
        ids_c = cand[:, s : s + cand_chunk]
        safe_c = ids_c.clamp_min(0)
        sc = _score_doc_rows(doc_dims[safe_c], doc_vals[safe_c], q_dim_idx, q_weights)
        sc = torch.where((ids_c >= 0) & alive[safe_c] & _first_occurrence(ids_c), sc, NEG_INF)
        c_s, c_pos = _topk(sc, min(k_fetch, ids_c.shape[1]))
        top_s, top_i = _merge_topk(top_s, top_i, c_s, torch.gather(ids_c, 1, c_pos), k_fetch, distinct=True)
    return _finish(top_s, top_i)


def csr_segment_topk(starts, lens, mults, post_ids, post_vals, alive, k: int, segcap: int,
                     aligned: bool = False):
    """Sort + segment-sum CSR scoring: O(B × gathered) with no n_cap-sized
    buffers and no scatter, for narrow gathers (the router caps the
    gathered width at 65,536). Returns (scores (B, k), ids (B, k))."""
    b = starts.shape[0]
    ids, contrib = _gathered_contrib(starts, lens, mults, post_ids, post_vals, segcap, aligned, 0.0)
    pad = ids.shape[1]
    # group equal ids per row (-1 padding sorts first)
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    csum = torch.cumsum(torch.gather(contrib, 1, order), dim=1)
    pos = torch.arange(pad, device=ids.device).expand(b, pad)
    ones = torch.ones((b, 1), dtype=torch.bool, device=ids.device)
    first = torch.cat([ones, ids_s[:, 1:] != ids_s[:, :-1]], dim=1)
    last = torch.cat([ids_s[:, :-1] != ids_s[:, 1:], ones], dim=1)
    seg_start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    before = torch.where(
        seg_start > 0, torch.gather(csum, 1, (seg_start - 1).clamp_min(0)), 0.0
    )
    total = csum - before
    ok = last & (ids_s >= 0) & alive[ids_s.clamp_min(0)]
    top_s, pos2 = _topk(torch.where(ok, total, NEG_INF), min(k, pad))
    return _finish(top_s, torch.gather(ids_s, 1, pos2), k)


def head_matmul_topk(q_head, head_codes, alive, k: int, chunk: int):
    """Candidate nomination over the dense head of the inverted index:
    scores = q_head @ head_codes, chunked along n_cap with a running exact
    top-k. q_head (B, Dh) f32, head_codes (Dh, n_cap) uint8 (0 = no
    posting). The reference multiplies bf16(q) by bf16(codes) with f32
    accumulation; u8 codes are exact in bf16 and bf16 products are exact
    in f32, so the port multiplies the bf16-rounded queries by the codes
    in f32. Returns (scores (B, k), ids (B, k)): head-part scores only."""
    b = q_head.shape[0]
    n_cap = head_codes.shape[1]
    qh = q_head.to(torch.bfloat16).float()
    top_s, top_i = _empty_topk(b, k, q_head.device)
    for s in range(0, n_cap, chunk):
        sc = qh @ head_codes[:, s : s + chunk].float()  # (B, chunk)
        # score 0 = no overlap with any head dim: not a candidate
        sc = torch.where(alive[None, s : s + chunk] & (sc > 0), sc, NEG_INF)
        c_s, c_pos = _topk(sc, min(k, sc.shape[1]))
        top_s, top_i = _merge_topk(top_s, top_i, c_s, c_pos + s, k)
    return _finish(top_s, top_i)


def rescore_ids_topk(cand, doc_dims, doc_vals, q_dim_idx, q_weights, alive, k: int):
    """Exact raw-row rescore of an explicit candidate set ``cand`` (B, C)
    int64 (-1 = empty slot). Duplicate ids carry identical scores; the
    caller dedups. Returns (scores (B, k), ids (B, k))."""
    safe_c = cand.clamp_min(0)
    sc = _score_doc_rows(doc_dims[safe_c], doc_vals[safe_c], q_dim_idx, q_weights)
    sc = torch.where((cand >= 0) & alive[safe_c] & _first_occurrence(cand), sc, NEG_INF)
    top_s, pos = _topk(sc, min(k, cand.shape[1]))
    return _finish(top_s, torch.gather(cand, 1, pos), k)


def head_tail_union_rescore(starts, lens, mults, post_ids, post_vals, doc_dims, doc_vals, q_dim_idx,
                            q_weights, q_head, head_codes, alive, top_k: int, nom_out: int,
                            nom_width: int, segcap: int, slot_chunk: int, head_chunk: int,
                            aligned: bool):
    """The dense-head + CSR-tail engine in one call: head nomination, tail
    nomination + exact rescore, their union, and the final exact rescore,
    with no host round trip between them. Returns (scores, ids) of the
    union ranked by exact score, min(2·top_k, 2·nom_out) wide."""
    _h_sc, h_ids = head_matmul_topk(q_head, head_codes, alive, nom_out, head_chunk)
    _t_sc, t_ids = nominate_rescore_topk(
        starts, lens, mults, post_ids, post_vals, doc_dims, doc_vals, q_dim_idx, q_weights, alive,
        nom_out, nom_width, segcap, slot_chunk, aligned=aligned,
    )
    cand = torch.cat([h_ids, t_ids], dim=1)
    return rescore_ids_topk(
        cand, doc_dims, doc_vals, q_dim_idx, q_weights, alive, min(2 * top_k, cand.shape[1])
    )
