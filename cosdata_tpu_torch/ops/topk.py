"""Top-k selection (port of cosdata_tpu/ops/topk.py).

``torch.topk`` orders ties differently from ``lax.top_k``: compare scores
at ties, not ids, or take :func:`lax_top_k`, which keeps ``lax.top_k``'s
order (equal values in index order).
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38


def topk(
    scores: torch.Tensor, k: int, mask: torch.Tensor | None = None, ties_by_index: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis. Returns (values, indices), sorted desc.

    ``mask`` (broadcastable bool): False entries are excluded (score -> NEG_INF).
    ``ties_by_index`` orders equal scores by index, as ``lax.top_k``
    (:func:`lax_top_k`), for scores that tie often (hamming distances).
    """
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    if ties_by_index:
        return lax_top_k(scores, k)
    return torch.topk(scores, k, dim=-1)


def lax_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of f32 ``x`` along the last axis, sorted, equal values in index
    order (as ``lax.top_k``). Each score's order-preserving integer image
    takes the high 32 bits of an int64 key and the complemented index the
    low 32, so one ``torch.topk`` over the keys orders by (score desc, index
    asc). Returns (values, indices)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    low = (1 << 32) - 1 - torch.arange(x.shape[-1], device=x.device)
    top = torch.topk(key * (1 << 32) + low, k, dim=-1).values
    pos = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, pos), pos


def merge_topk(
    values_a: torch.Tensor,
    idx_a: torch.Tensor,
    values_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (…, ka/kb) top-k lists into one top-k list of size k."""
    vals = torch.cat([values_a, values_b], dim=-1)
    idxs = torch.cat([idx_a, idx_b], dim=-1)
    top_vals, pos = lax_top_k(vals, k)
    return top_vals, torch.gather(idxs, -1, pos)


def unique_mask_ids(ids: torch.Tensor, fill: int = -1) -> torch.Tensor:
    """Boolean mask keeping the first occurrence of each id along the last
    axis; ``fill`` ids are dropped. A stable sort finds the duplicates in
    O(k log k) (the reference compares all (k, k) pairs)."""
    ids_s, perm = torch.sort(ids, dim=-1, stable=True)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    first = ~torch.zeros_like(dup).scatter_(-1, perm, dup)
    return first & (ids != fill)
