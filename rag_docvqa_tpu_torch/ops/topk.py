"""Masked top-k for per-sample retrieval.

Counterpart of `masked_topk` and `l2_normalize` in
`rag_docvqa_tpu/ops/topk.py`. The corpus-index kernels of that module (K4,
K5) wait for the corpus-index slice.

Tie order: `lax.top_k` breaks ties to the lowest index; `torch.topk`
promises no order. Here the scores are sorted descending with a stable sort,
which keeps equal scores in ascending index order, and the first k are taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """The reference's eps placement: x / (||x|| + eps) (not F.normalize's
    x / max(||x||, eps))."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def masked_topk(
    scores: torch.Tensor,  # (..., N) float
    mask: Optional[torch.Tensor],  # (..., N) bool, True = valid
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k over the last axis ignoring masked entries; ties go to the
    lowest index. Returns (values, indices, valid)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return vals, idx, vals > NEG_INF / 2
