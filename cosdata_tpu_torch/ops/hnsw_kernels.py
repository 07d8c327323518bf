"""Batched HNSW graph kernels (port of cosdata_tpu/ops/hnsw_kernels.py).

The graph is a fixed-degree adjacency table on the device and search is a
batched beam search: every wave expands the top-E unexpanded candidates
of B queries at once (one gather for the neighbor ids, one exact code
product for their scores, one top-k merge). The reference's
``lax.while_loop`` becomes a host loop that looks for an open frontier
every ``FRONTIER_CHECK`` waves: a wave with no frontier changes nothing,
so the extra waves give the same beam, and the host syncs once per
``FRONTIER_CHECK`` waves instead of once per wave.

The visited set has the reference's two forms:

- ``bitmask``: a per-query bit table (B, ceil(N/32)) of ``int32`` words
  holding the reference's ``uint32`` bits (torch's ``uint32`` has no
  shifts on the CPU). Bit 31 is the word's sign bit; marking adds each
  fresh id's bit once (a scatter-add of distinct unset bits is an exact
  OR, and never carries into or past the sign bit).
- ``ring``: a per-query ring of recently visited ids, compared in full
  every wave (the fallback for id spans whose bit tables would not fit).

Top-k selections keep ``lax.top_k``'s order (``topk.lax_top_k``): the
diversity heuristic ranks every kept candidate at ``score + 1e9``, which
ties them all in f32, so only the index order separates them. Scatter
rows of -1 (padding) are filtered out before every write (the reference
maps them past the table's end and drops them; a torch index of -1 would
write the last row). All code products are exact (``ops/distance.py``);
the reference's grouped GEMMs exist only to reach the TPU's matrix unit.
Hamming has no graph scoring (an index of it is scan-only), as in the
reference.

The spill tier's graph engine splits a beam wave in two around the host:
``beam_wave_select`` picks the wave's fresh candidate ids on the device,
the host gathers their code rows from the spilled tier and uploads the
unique ones, and ``beam_wave_merge`` scores them through ``slots`` and
merges them into the beam; ``beam_hostcodes_init`` builds the first beam
and its visited bit table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cosdata_tpu_torch.ops import distance as D
from cosdata_tpu_torch.ops.distance import take_rows
from cosdata_tpu_torch.ops.storage import gather_queries, score_table, scores_gathered, word_major_rows
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k, unique_mask_ids

#: beam waves between two host checks for an open frontier
FRONTIER_CHECK = 4


class BeamState(NamedTuple):
    ids: torch.Tensor  # (B, EF) int64, -1 = empty slot
    scores: torch.Tensor  # (B, EF) f32 similarity (higher better)
    expanded: torch.Tensor  # (B, EF) bool
    visited: torch.Tensor  # (B, VCAP) int64 ring | (B, W) int32 bit table
    t: int  # waves run


def _probe_bits(visited: torch.Tensor, ids: torch.Tensor):
    """Bit-table membership probe: (seen (B, k) bool, word index, bit).
    Ids < 0 probe word 0; callers mask them out of ``fresh``."""
    safe = torch.clamp_min(ids, 0)
    word = safe >> 5
    bit = torch.ones_like(safe) << (safe & 31)
    bitv = torch.where(bit >= 1 << 31, bit - (1 << 32), bit).to(torch.int32)
    got = torch.gather(visited, 1, word)
    return (got & bitv) != 0, word, bitv


def _mark_bits(visited: torch.Tensor, word, bitv, fresh) -> None:
    """Set the bits of the ``fresh`` ids in place: each fresh id is unique
    in its wave and its bit unset, so the scatter-add is an exact OR."""
    visited.scatter_add_(1, word, torch.where(fresh, bitv, 0))


def _init_beam(metric, kind, d, ef, vcap, q, store, start_ids, bitmask_w=0) -> BeamState:
    """The initial beam from (B, S) start ids (-1 padded)."""
    b, s = start_ids.shape
    uniq = unique_mask_ids(start_ids)
    scores = scores_gathered(metric, kind, d, q, store, start_ids, uniq)
    if bitmask_w:
        visited = torch.zeros((b, bitmask_w), dtype=torch.int32, device=start_ids.device)
        _, word, bitv = _probe_bits(visited, start_ids)
        _mark_bits(visited, word, bitv, uniq & (start_ids >= 0))
    else:
        visited = torch.full((b, vcap), -1, dtype=torch.int64, device=start_ids.device)
    if s < ef:
        scores = torch.nn.functional.pad(scores, (0, ef - s), value=NEG_INF)
        start_ids = torch.nn.functional.pad(start_ids, (0, ef - s), value=-1)
    top_scores, pos = lax_top_k(scores, ef)
    top_ids = torch.gather(start_ids, 1, pos)
    top_ids = torch.where(top_scores > NEG_INF / 2, top_ids, -1)
    return BeamState(top_ids, top_scores, top_ids < 0, visited, 0)


def beam_search(
    metric: str,
    kind: str,
    d: int,
    ef: int,
    expand: int,
    vcap: int,
    max_iters: int,
    q,  # quantized query batch, B rows
    store,  # quantized store (capacity rows)
    adj_table: torch.Tensor,  # (rows, m) int32 adjacency, -1 padded
    row_of: torch.Tensor,  # (capacity,) int32 node id -> adjacency row
    start_ids: torch.Tensor,  # (B, S) int64 entry candidates, -1 padded
    use_row_of: bool = True,
    visited_impl: str = "bitmask",
):
    """One-level batched beam search. Returns (ids (B, EF) int64, scores)."""
    # a wave cannot expand more entries than the beam holds; full
    # convergence needs ceil(ef/expand) waves to expand every entry once,
    # and twice that is the iteration floor
    expand = min(expand, ef)
    max_iters = max(max_iters, 2 * -(-ef // expand))
    m = adj_table.shape[1]
    k = expand * m
    vcap = max(vcap // k, 1) * k  # the ring holds whole waves
    bitmask_w = -(-row_of.shape[0] // 32) if visited_impl == "bitmask" else 0
    ids, scores, expanded, visited, _ = _init_beam(metric, kind, d, ef, vcap, q, store, start_ids, bitmask_w)
    b = ids.shape[0]
    for t in range(max_iters):
        if t % FRONTIER_CHECK == 0 and not bool(((~expanded) & (ids >= 0)).any()):
            break
        # 1. the top-E unexpanded beam entries of each query
        sel_scores = torch.where(expanded | (ids < 0), NEG_INF, scores)
        sel_vals, sel_pos = lax_top_k(sel_scores, expand)
        expanded = expanded.scatter(1, sel_pos, True)
        exp_ids = torch.where(sel_vals > NEG_INF / 2, torch.gather(ids, 1, sel_pos), -1)
        # 2. their adjacency rows
        if use_row_of:
            rows = torch.where(exp_ids >= 0, take_rows(row_of, torch.clamp_min(exp_ids, 0)).long(), -1)
        else:
            rows = exp_ids
        nbrs = take_rows(adj_table, torch.clamp_min(rows, 0)).long()  # (B, E, m)
        nbrs = torch.where(rows[:, :, None] >= 0, nbrs, -1).reshape(b, k)
        # 3. wave-unique and never scored before
        uniq = unique_mask_ids(nbrs)
        if bitmask_w:
            # every scored id has its bit set, so the probe covers the beam
            seen, word, bitv = _probe_bits(visited, nbrs)
            fresh = uniq & ~seen & (nbrs >= 0)
            _mark_bits(visited, word, bitv, fresh)
        else:
            in_beam = (nbrs[:, :, None] == ids[:, None, :]).any(-1)
            in_vis = (nbrs[:, :, None] == visited[:, None, :]).any(-1)
            fresh = uniq & ~in_beam & ~in_vis & (nbrs >= 0)
        # 4. score the fresh candidates
        nscores = scores_gathered(metric, kind, d, q, store, nbrs, fresh)
        nids = torch.where(fresh, nbrs, -1)
        if not bitmask_w:
            # 5. record the wave in the ring
            pos = (t * k) % vcap
            visited[:, pos : pos + k] = nids
        # 6. merge into the beam
        all_scores = torch.cat([scores, nscores], dim=1)
        all_ids = torch.cat([ids, nids], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(fresh)], dim=1)
        scores, pos2 = lax_top_k(all_scores, ef)
        ids = torch.gather(all_ids, 1, pos2)
        expanded = torch.gather(all_exp, 1, pos2) | (ids < 0)
    return ids, scores


def _merge_beam(ids, scores, expanded, nids, nscores):
    """The top-EF of the beam and the new (unexpanded) candidates."""
    all_scores = torch.cat([scores, nscores], dim=1)
    all_ids = torch.cat([ids, nids], dim=1)
    all_exp = torch.cat([expanded, torch.zeros(nids.shape, dtype=torch.bool, device=nids.device)], dim=1)
    top_scores, pos = lax_top_k(all_scores, ids.shape[1])
    top_ids = torch.gather(all_ids, 1, pos)
    return top_ids, top_scores, torch.gather(all_exp, 1, pos) | (top_ids < 0)


def beam_wave_select(ids, scores, expanded, visited, adj_table, expand: int):
    """One beam wave's device half for the host-codes graph engine: select
    the top-``expand`` unexpanded entries, gather their level-0 adjacency
    rows (row == node id), keep the wave-unique ids not yet visited and
    mark them in the bit table (in place). Returns (fresh candidate ids
    (B, expand·m), -1 elsewhere; expanded; visited; done, a 0-d bool that
    is True when no entry was left to expand)."""
    b, ef = ids.shape
    e = min(expand, ef)
    sel_scores = torch.where(expanded | (ids < 0), NEG_INF, scores)
    sel_vals, sel_pos = lax_top_k(sel_scores, e)
    expanded = expanded.scatter(1, sel_pos, True)
    exp_ids = torch.where(sel_vals > NEG_INF / 2, torch.gather(ids, 1, sel_pos), -1)
    nbrs = take_rows(adj_table, torch.clamp_min(exp_ids, 0)).long()
    nbrs = torch.where(exp_ids[:, :, None] >= 0, nbrs, -1).reshape(b, e * adj_table.shape[1])
    seen, word, bitv = _probe_bits(visited, nbrs)
    fresh = unique_mask_ids(nbrs) & ~seen & (nbrs >= 0)
    _mark_bits(visited, word, bitv, fresh)
    done = ~((~expanded) & (ids >= 0)).any()
    return torch.where(fresh, nbrs, -1), expanded, visited, done


def beam_wave_merge(metric: str, d: int, q, chunk, slots, nbrs, ids, scores, expanded):
    """Score a wave's candidates from ``chunk``, the QuantizedU8 of its
    unique uploaded rows (``slots`` (B, K): each candidate's row in it, -1
    for none), and merge them into the beam. Returns (ids, scores,
    expanded)."""
    live = slots >= 0
    nscores = scores_gathered(metric, "u8", d, q, chunk, slots, live)
    return _merge_beam(ids, scores, expanded, torch.where(live, nbrs, -1), nscores)


def beam_hostcodes_init(metric: str, d: int, ef: int, bitmask_w: int, q, chunk, slots, start_ids):
    """The host-codes engine's first beam: score the start ids (uploaded as
    ``chunk``/``slots``), mark them in a fresh (B, ``bitmask_w``) bit table
    and keep the top ``ef``. Returns (ids, scores, expanded, visited)."""
    b, s = start_ids.shape
    uniq = unique_mask_ids(start_ids)
    sc = scores_gathered(metric, "u8", d, q, chunk, slots, uniq & (slots >= 0))
    visited = torch.zeros((b, bitmask_w), dtype=torch.int32, device=start_ids.device)
    _, word, bitv = _probe_bits(visited, start_ids)
    _mark_bits(visited, word, bitv, uniq & (start_ids >= 0))
    if s < ef:
        sc = torch.nn.functional.pad(sc, (0, ef - s), value=NEG_INF)
        start_ids = torch.nn.functional.pad(start_ids, (0, ef - s), value=-1)
    top_scores, pos = lax_top_k(sc, ef)
    top_ids = torch.where(top_scores > NEG_INF / 2, torch.gather(start_ids, 1, pos), -1)
    return top_ids, top_scores, top_ids < 0, visited


def _topk_rows(all_ids, all_d, m):
    """The m best (id, score) of each row; -1 / NEG_INF where none."""
    masked = torch.where(all_ids >= 0, all_d, NEG_INF)
    top_d, pos = lax_top_k(masked, m)
    top_i = torch.gather(all_ids, 1, pos)
    top_i = torch.where(top_d > NEG_INF / 2, top_i, -1)
    return top_i, torch.where(top_i >= 0, top_d, NEG_INF)


def _write_rows(adj, dist, rows, ids, d) -> None:
    """adj[rows] = ids, dist[rows] = d for the rows >= 0 (in place)."""
    keep = rows >= 0
    r = rows[keep].long()
    adj[r] = ids[keep].to(adj.dtype)
    dist[r] = d[keep]


def merge_neighbors(
    adj_table: torch.Tensor,  # (rows, m) int32, updated in place
    dist_table: torch.Tensor,  # (rows, m) f32 similarity
    rows: torch.Tensor,  # (T,) target rows (unique; -1 = padding)
    inc_ids: torch.Tensor,  # (T, G) incoming neighbor ids, -1 padded
    inc_dists: torch.Tensor,  # (T, G) f32
    m: int,
    dedup: bool = True,
):
    """Keep-the-m-closest neighbor merge of incoming edges into rows.
    ``dedup=False`` skips the incoming-vs-current membership test, for
    incoming ids known to be disjoint from the rows."""
    safe = torch.clamp_min(rows, 0)
    cur_ids = adj_table[safe].long()
    cur_d = dist_table[safe]
    inc_ids = inc_ids.long()
    if dedup:
        dup = (inc_ids[:, :, None] == cur_ids[:, None, :]).any(-1)
        inc_dists = torch.where(dup, NEG_INF, inc_dists)
    top_i, top_d = _topk_rows(torch.cat([cur_ids, inc_ids], 1), torch.cat([cur_d, inc_dists], 1), m)
    _write_rows(adj_table, dist_table, rows, top_i, top_d)
    return adj_table, dist_table


def _decode_rows(kind: str, d: int, store, safe_ids: torch.Tensor):
    """Rows as (codes (..., D) int8 or f32, sums f32 or None, mags f32);
    ``safe_ids`` >= 0. Sub-byte codes come in ``word_major_rows``' order,
    which their products with each other do not see."""
    mags = take_rows(store.mags, safe_ids)
    if kind == "u8":
        return take_rows(store.data, safe_ids), take_rows(store.sums, safe_ids).to(torch.float32), mags
    if kind == "subbyte":
        return word_major_rows(store.planes, safe_ids), take_rows(store.sums, safe_ids).to(torch.float32), mags
    return take_rows(store.data, safe_ids).to(torch.float32), None, mags


def _affine_dot(kind, d, store, cc, s1, s2):
    """Dequantized dot products from exact code dots ``cc`` (f32) and the
    two sides' code sums, broadcast against each other."""
    if kind == "u8":
        # stored codes are centered int8: code = u - 128
        code_dot = cc + 128.0 * (s1 + s2) + d * 128.0 * 128.0
        u1, u2 = s1 + 128.0 * d, s2 + 128.0 * d
    else:
        code_dot, u1, u2 = cc, s1, s2
    return store.a * store.a * code_dot + store.a * store.b * (u1 + u2) + store.b * store.b * store.dtrue


def _metric(metric, dot, m1, m2):
    """Similarity from dot products and the two sides' magnitudes, already
    broadcast against each other."""
    if metric == "dot":
        return dot
    if metric == "cosine":
        return D.safe_div(dot, m1 * m2)
    if metric != "euclidean":
        # hamming has no dot formulation; its index is scan-only
        raise ValueError(f"graph kernels do not support metric {metric!r}")
    d2 = m1**2 + m2**2 - 2.0 * dot
    return -D.sqrt_rn(torch.clamp_min(d2, 0.0))


def _block_scores(metric, kind, d, store, g1, s1, m1, g2, s2, m2):
    """Similarity of decoded row blocks: g1 (..., A, D) x g2 (..., B, D) ->
    (..., A, B), with the u8/sub-byte dequantization applied."""
    if kind in ("u8", "subbyte"):
        cc = D.code_bmm(g1, g2).to(torch.float32)
        dot = _affine_dot(kind, d, store, cc, s1[..., :, None], s2[..., None, :])
    else:
        if g1.device.type == "cuda":
            D._no_tf32()
        dot = torch.matmul(g1, g2.transpose(-1, -2))
    return _metric(metric, dot, m1[..., :, None], m2[..., None, :])


def pairwise_scores(metric: str, kind: str, d: int, ids: torch.Tensor, store, chunk: int = 256):
    """(W, C, C) similarity among each row's candidate ids, W-chunked so
    the gathered rows stay ~chunk*C*D bytes (the chunk changes time, not
    results). Used by the diversity heuristic."""
    w, c = ids.shape
    out = torch.empty((w, c, c), dtype=torch.float32, device=ids.device)
    for s in range(0, w, chunk):
        g, sm, mg = _decode_rows(kind, d, store, torch.clamp_min(ids[s : s + chunk].long(), 0))
        out[s : s + chunk] = _block_scores(metric, kind, d, store, g, sm, mg, g, sm, mg)
    return out


def select_diverse(
    cand_ids: torch.Tensor,  # (W, C) desc-sorted by score, -1 padded
    cand_scores: torch.Tensor,  # (W, C) similarity to the node
    pair: torch.Tensor,  # (W, C, C) candidate-candidate similarity
    m: int,
):
    """The HNSW neighbor-selection heuristic (Algorithm 4 of the HNSW
    paper), batched: scan candidates best-first, keep one only if it is
    closer to the node than to every kept neighbor; backfill with the best
    pruned candidates. Returns (ids (W, m), scores (W, m))."""
    w, c = cand_ids.shape
    keep = torch.zeros((w, c), dtype=torch.bool, device=cand_ids.device)
    n_kept = torch.zeros((w,), dtype=torch.int64, device=cand_ids.device)
    for j in range(c):
        ok = (cand_ids[:, j] >= 0) & (n_kept < m)
        if j:
            max_kept = torch.where(keep[:, :j], pair[:, j, :j], NEG_INF).amax(1)
            ok &= cand_scores[:, j] > max_kept
        else:
            ok &= cand_scores[:, 0] > NEG_INF
        keep[:, j] = ok
        n_kept += ok
    # kept first, then the best pruned, all in score order
    priority = torch.where(keep, cand_scores + 1e9, cand_scores)
    priority = torch.where(cand_ids >= 0, priority, NEG_INF)
    top_p, pos = lax_top_k(priority, m)
    out_ids = torch.where(top_p > NEG_INF / 2, torch.gather(cand_ids, 1, pos), -1)
    out_scores = torch.where(out_ids >= 0, torch.gather(cand_scores, 1, pos), NEG_INF)
    return out_ids, out_scores


def leaf_knn_gather(
    metric: str,
    kind: str,
    d: int,
    kk: int,
    leaf_chunk: int,
    leaf_ids: torch.Tensor,  # (NL, L) member ids per leaf, -1 padded
    pos_mem: torch.Tensor,  # (Mpad,) flat position of each member (-1 pad)
    store,
    rt: float = 0.85,
):
    """Leaf kNN, then each member's row by its flat leaf position.
    Returns (ids (Mpad, kk), scores (Mpad, kk))."""
    ids_t, sc_t = _leaf_knn_body(metric, kind, d, kk, leaf_chunk, leaf_ids, store, rt)
    kk_t = ids_t.shape[-1]
    safe = torch.clamp_min(pos_mem, 0)
    live = pos_mem[:, None] >= 0
    ids_m = torch.where(live, ids_t.reshape(-1, kk_t)[safe], -1)
    sc_m = torch.where(live, sc_t.reshape(-1, kk_t)[safe], NEG_INF)
    if kk_t < kk:
        ids_m = torch.nn.functional.pad(ids_m, (0, kk - kk_t), value=-1)
        sc_m = torch.nn.functional.pad(sc_m, (0, kk - kk_t), value=NEG_INF)
    return ids_m, sc_m


def _leaf_knn_body(metric, kind, d, kk, leaf_chunk, leaf_ids, store, rt=0.85):
    """Exact kNN inside each leaf: (NL, L, kk) ids and scores. The
    reference's ``approx_max_k(recall_target=rt)`` for leaves of 4,096 rows
    or more is an exact top-k here (``rt`` is unused)."""
    nl, L = leaf_ids.shape
    kk = min(kk, L - 1)
    # query-side blocking bounds the (lc, qc, L) score block to ~2^26
    qc = L
    while leaf_chunk * qc * L > (1 << 26) and qc > 512:
        qc //= 2
    dev = leaf_ids.device
    out_i = torch.empty((nl, L, kk), dtype=torch.int64, device=dev)
    out_s = torch.empty((nl, L, kk), dtype=torch.float32, device=dev)
    col = torch.arange(L, device=dev)
    for c0 in range(0, nl, leaf_chunk):
        ids_c = leaf_ids[c0 : c0 + leaf_chunk].long()
        lc = ids_c.shape[0]
        g, s, m = _decode_rows(kind, d, store, torch.clamp_min(ids_c, 0))
        valid = ids_c >= 0
        for start in range(0, L, qc):
            sl = slice(start, start + qc)
            sc = _block_scores(metric, kind, d, store, g[:, sl], None if s is None else s[:, sl], m[:, sl], g, s, m)
            selfmask = (start + torch.arange(qc, device=dev))[:, None] == col[None, :]
            sc = torch.where(valid[:, None, :] & ~selfmask[None], sc, NEG_INF)
            top_s, pos = lax_top_k(sc, kk)
            del sc
            top_i = torch.gather(ids_c[:, None, :].expand(lc, qc, L), 2, pos)
            out_i[c0 : c0 + lc, sl] = torch.where(top_s > NEG_INF / 2, top_i, -1)
            out_s[c0 : c0 + lc, sl] = top_s
    return out_i, out_s


#: reverse-edge source chunk: the reference bounds each of its compiled
#: sorts to (REV_SRC_CHUNK * m) edges; m-best merging is associative, so
#: the chunked cumulative merges select the same reverse edges as one pass
REV_SRC_CHUNK = 65536


def apply_forward_and_reverse(adj, dist, mem, fwd_ids, fwd_d, m: int):
    """Forward-edge writes of members ``mem`` (-1 padded), then the
    reverse-edge merge per source chunk. Updates the tables in place and
    returns them."""
    _write_rows(adj, dist, mem, fwd_ids, fwd_d)
    for s in range(0, mem.shape[0], REV_SRC_CHUNK):
        e = s + REV_SRC_CHUNK
        adj, dist = _reverse_edges_body(adj, dist, mem[s:e], fwd_ids[s:e], fwd_d[s:e], m, m)
    return adj, dist


def nn_descent_round(metric, kind, d, m, sample, node_chunk, adj, dist, mem, store):
    """One NN-descent refinement round."""
    return _nn_descent_body(metric, kind, d, m, sample, node_chunk, mem, adj, dist, store)


def reverse_from_table(adj, dist, mem, m: int):
    """Reverse-edge merge sourcing the CURRENT table rows of ``mem``, per
    source chunk; later chunks source rows already refreshed by earlier
    chunks' merges, as in the reference."""
    for s in range(0, mem.shape[0], REV_SRC_CHUNK):
        mem_c = mem[s : s + REV_SRC_CHUNK]
        safe = torch.clamp_min(mem_c, 0)
        adj, dist = _reverse_edges_body(adj, dist, mem_c, adj[safe], dist[safe], m, m)
    return adj, dist


def finalize_level0(metric, kind, d, m, rounds, sample, node_chunk, adj, dist, mem, fwd_ids, fwd_d, store):
    """Level-0 tail: forward-edge writes + reverse edges, then per round an
    NN-descent refinement and the reverse edges again."""
    adj, dist = apply_forward_and_reverse(adj, dist, mem, fwd_ids, fwd_d, m)
    for _ in range(rounds):
        adj, dist = nn_descent_round(metric, kind, d, m, sample, node_chunk, adj, dist, mem, store)
        adj, dist = reverse_from_table(adj, dist, mem, m)
    return adj, dist


def upper_level_exact(metric, kind, d, m, heuristic, mem, slots, up_slot, adj_l, dist_l, store):
    """A whole small upper level: exact member x member kNN, diversity
    prune, slot writes and reverse edges. ``adj_l``/``dist_l`` (cap_up, m)
    are updated in place and returned. Rows of an upper table are slots;
    its values are node ids."""
    mp = mem.shape[0]
    mem = mem.long()
    g, s, mg = _decode_rows(kind, d, store, torch.clamp_min(mem, 0))
    sc = _block_scores(metric, kind, d, store, g, s, mg, g, s, mg)  # (Mp, Mp)
    valid = mem >= 0
    eye = torch.eye(mp, dtype=torch.bool, device=mem.device)
    sc = torch.where(valid[None, :] & valid[:, None] & ~eye, sc, NEG_INF)
    kk = min(2 * m, mp)
    top_s, pos = lax_top_k(sc, kk)
    top_i = torch.where(top_s > NEG_INF / 2, mem[pos], -1)
    if heuristic:
        fwd_i, fwd_d = select_diverse(top_i, top_s, _gather_pair(sc, pos), m)
    else:
        fwd_s, p2 = lax_top_k(top_s, min(m, kk))
        fwd_i = torch.gather(top_i, 1, p2)
        if fwd_i.shape[1] < m:
            fwd_i = torch.nn.functional.pad(fwd_i, (0, m - fwd_i.shape[1]), value=-1)
            fwd_s = torch.nn.functional.pad(fwd_s, (0, m - fwd_s.shape[1]), value=NEG_INF)
        fwd_d = torch.where(fwd_i >= 0, fwd_s, NEG_INF)
        fwd_i = torch.where(fwd_d > NEG_INF / 2, fwd_i, -1)
    del sc
    return upper_level_apply(m, mem, slots, up_slot, fwd_i, fwd_d, adj_l, dist_l)


def upper_level_apply(m, mem, slots, up_slot, fwd_ids, fwd_d, adj_l, dist_l):
    """Slot writes + reverse edges of one upper level, in place."""
    _write_rows(adj_l, dist_l, slots.long(), fwd_ids, fwd_d)
    tgt_slots = torch.where(fwd_ids >= 0, up_slot[torch.clamp_min(fwd_ids, 0).long()].long(), -1)
    # source VALUES are node ids (mem), scatter rows are tgt_slots
    return _reverse_edges_body(adj_l, dist_l, mem, tgt_slots, fwd_d, m, m)


def _gather_pair(sc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Candidate-candidate scores of the selected top-kk member columns:
    pair[i, a, b] = sc[pos[i, a], pos[i, b]], one flat gather."""
    mp = sc.shape[0]
    return sc.reshape(-1)[pos[:, :, None] * mp + pos[:, None, :]]


def _asc_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32), ordered as the floats ascend."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits + (1 << 31), (1 << 31) - 1 - (bits & 0x7FFFFFFF))


def incoming_edges(rows_n: int, src, fwd_rows, fwd_d, g_cap: int):
    """The ``g_cap`` best incoming edges of every row among the edges
    src -> fwd_rows (scores ``fwd_d``), grouped by target with one sort by
    (target, -score): (ids (rows_n, g_cap), scores), -1 / NEG_INF padded."""
    w, mf = fwd_rows.shape
    e = w * mf
    tgt = fwd_rows.reshape(e).long()
    d_ = fwd_d.reshape(e)
    s_ = src.long()[:, None].expand(w, mf).reshape(e)
    ok = (tgt >= 0) & (s_ >= 0) & (d_ > NEG_INF / 2)
    tgt_k = torch.where(ok, tgt, rows_n)  # invalid edges sort last
    order = torch.sort(tgt_k * (1 << 32) + _asc_key(-d_), stable=True).indices
    tgt_s, d_s, s_s = tgt_k[order], d_[order], s_[order]
    pos = torch.arange(e, device=fwd_rows.device)
    first = torch.ones(e, dtype=torch.bool, device=fwd_rows.device)
    first[1:] = tgt_s[1:] != tgt_s[:-1]
    seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - seg_start  # rank within the target (best = 0)
    keep = (rank < g_cap) & (tgt_s < rows_n)
    inc_ids = torch.full((rows_n, g_cap), -1, dtype=torch.int64, device=fwd_rows.device)
    inc_d = torch.full((rows_n, g_cap), NEG_INF, dtype=torch.float32, device=fwd_rows.device)
    inc_ids[tgt_s[keep], rank[keep]] = s_s[keep]
    inc_d[tgt_s[keep], rank[keep]] = d_s[keep]
    return inc_ids, inc_d


def _reverse_edges_body(adj, dist, src, fwd_rows, fwd_d, m, g_cap, chunk=65536):
    """Merge the reverse of the edges src -> fwd_rows into the tables, in
    place: each target's g_cap best incoming edges (:func:`incoming_edges`),
    then a keep-the-m-closest merge of every row (in row chunks of
    ``chunk``). Returns the tables."""
    rows_n = adj.shape[0]
    inc_ids, inc_d = incoming_edges(rows_n, src, fwd_rows, fwd_d, g_cap)
    for r0 in range(0, rows_n, chunk):
        sl = slice(r0, r0 + chunk)
        cur_i, ii = adj[sl].long(), inc_ids[sl]
        dup = (ii[:, :, None] == cur_i[:, None, :]).any(-1)
        id_ = torch.where(dup, NEG_INF, inc_d[sl])
        top_i, top_d = _topk_rows(torch.cat([cur_i, ii], 1), torch.cat([dist[sl], id_], 1), m)
        adj[sl] = top_i.to(adj.dtype)
        dist[sl] = top_d
    return adj, dist


def _grouped_scores(metric, kind, store, gq, sq, mq, gc, sc_, mc):
    """Per-node candidate scores (N, K): rows gq (N, D) against their own
    candidates gc (N, K, D), as exact diagonal products."""
    dd = gq.shape[-1]
    if kind in ("u8", "subbyte"):
        diag = D.diag_code_dot(gq, gc).to(torch.float32)
        dot = _affine_dot(kind, dd, store, diag, sq[:, None], sc_)
    else:
        dot = D.diag_dot(gq, gc)
    return _metric(metric, dot, mq[:, None], mc)


def _nn_descent_body(metric, kind, d, m, sample, node_chunk, node_ids, adj, dist, store):
    """One NN-descent round: each node scores a subsample of its
    neighbors' neighbors and keeps its m best. Every chunk reads the table
    as it was before the round; the rows are written at the end."""
    n = node_ids.shape[0]
    m0 = adj.shape[1]
    stride = max(m0 // sample, 1)
    node_ids = node_ids.long()
    out_i = torch.empty((n, m), dtype=torch.int64, device=adj.device)
    out_d = torch.empty((n, m), dtype=torch.float32, device=adj.device)
    for c0 in range(0, n, node_chunk):
        ids_c = node_ids[c0 : c0 + node_chunk]
        safe_c = torch.clamp_min(ids_c, 0)
        nbrs = adj[safe_c].long()
        sub = nbrs[:, ::stride][:, :sample]
        nn2 = adj[torch.clamp_min(sub, 0)].long()[:, :, ::stride][:, :, :sample]
        cand = torch.where(sub[:, :, None] >= 0, nn2, -1).reshape(ids_c.shape[0], -1)
        fresh = (
            unique_mask_ids(cand)
            & (cand >= 0)
            & (cand != ids_c[:, None])
            & ~(cand[:, :, None] == nbrs[:, None, :]).any(-1)
        )
        gq, sq, mq = _decode_rows(kind, d, store, safe_c)
        gc, sc_, mc = _decode_rows(kind, d, store, torch.clamp_min(cand, 0))
        sc = torch.where(fresh, _grouped_scores(metric, kind, store, gq, sq, mq, gc, sc_, mc), NEG_INF)
        cand = torch.where(fresh, cand, -1)
        out_i[c0 : c0 + node_chunk], out_d[c0 : c0 + node_chunk] = _topk_rows(
            torch.cat([nbrs, cand], 1), torch.cat([dist[safe_c], sc], 1), m
        )
    _write_rows(adj, dist, node_ids, out_i, out_d)
    return adj, dist


def wave_scores(metric: str, kind: str, d: int, q_wave, wave_ids: torch.Tensor, store, causal: bool = True):
    """(W, W) intra-wave similarity with self (and, causal, later nodes)
    masked to NEG_INF: nodes inserted together link to each other. One
    (W, W) product of the wave against its own rows, with the f32
    operations of the reference's gathered (W, W, D) product."""
    w = wave_ids.shape[0]
    s = score_table(metric, kind, d, q_wave, gather_queries(kind, store, wave_ids))
    i = torch.arange(w, device=wave_ids.device)
    mask = i[:, None] > i[None, :] if causal else i[:, None] != i[None, :]
    return torch.where(mask, s, NEG_INF)
