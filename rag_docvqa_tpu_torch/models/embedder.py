"""Bi-encoder text embedders.

Counterpart of `rag_docvqa_tpu/models/embedder.py` (`mean_pool`,
`vt5_table_embed`, `embed_batch`). Backends: "VT5", the masked mean of the
generator's shared-table token embeddings; "BGE", the BERT sentence encoder
(CLS pooling, L2 normalize; models/bert.py, through K9); "JINA", the same
encoder with the ALiBi/GLU/mean-pool options of its BertConfig.
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


def embed_batch(params, backend: str, tokens: torch.Tensor, mask: torch.Tensor, bert_cfg=None) -> torch.Tensor:
    """`params` is the generator's `T5Params` (anything with `.shared`) for
    "VT5", a `BertParams` for "BGE" and "JINA"."""
    if backend == "VT5":
        return vt5_table_embed(params.shared, tokens, mask)
    if backend in ("BGE", "JINA"):
        from rag_docvqa_tpu_torch.models.bert import bert_sentence_embed

        return bert_sentence_embed(params, bert_cfg, tokens, mask)
    raise ValueError(f"unknown embedder backend: {backend}")
