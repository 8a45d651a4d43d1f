"""VT5 table-embedding retriever encoder.

Counterpart of `rag_docvqa_tpu/models/embedder.py` (`mean_pool`,
`vt5_table_embed`): a sentence embedding is the masked mean of the
generator's shared-table token embeddings. The BERT backends wait for the
BERT slice.
"""

from __future__ import annotations

import torch


def mean_pool(embs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the token axis; the count is clipped at 1e-9."""
    mask_f = mask.to(embs.dtype)[..., None]
    summed = (embs * mask_f).sum(dim=-2)
    counts = mask_f.sum(dim=-2).clamp(min=1e-9)
    return summed / counts


def vt5_table_embed(shared: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (..., L) tokens and mask -> (..., D)."""
    return mean_pool(shared[tokens], mask)
