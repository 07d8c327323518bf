"""Top-k selection (port of cosdata_tpu/ops/topk.py).

``torch.topk`` orders ties differently from ``lax.top_k``: compare scores
at ties, not ids.
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38


def topk(
    scores: torch.Tensor, k: int, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis. Returns (values, indices), sorted desc.

    ``mask`` (broadcastable bool): False entries are excluded (score -> NEG_INF).
    """
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return torch.topk(scores, k, dim=-1)
