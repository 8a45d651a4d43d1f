"""Fixed-shape data contract between the host ingest layer and the device.

Counterpart of `rag_docvqa_tpu/data/contract.py`, without jax or flax: the
host batch is a dataclass of numpy arrays, and `to_device` turns it into the
same dataclass holding torch tensors on one device. Integer fields become
int64 there, the index type that `torch.gather` and advanced indexing take.

Coordinate systems are those of the JAX package: *word slots* are, per
document, every chunk's words in chunk order (overlap duplicates included),
so a page's slots are contiguous and surrounding-word expansion and dedup are
index-interval computations.

The module imports torch only inside `to_device`, so the host data layer
(`data/contract.py`, `ingest.py`, `tokenizer.py`, `datasets.py`) loads
without it: `data/ingest_mp.py`'s spawned workers never import torch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class RawDocument:
    """One host-side sample before ingestion (ragged, Python-native)."""

    question: str
    words: List[List[str]]  # (n_pages, n_words)
    boxes: List[List[Sequence[float]]]  # (n_pages, n_words, 4), normalized 0-1
    answers: List[str] = field(default_factory=list)
    answer_page_idx: int = 0
    question_id: int = 0
    answer_type: str = "string"
    images: Optional[List[np.ndarray]] = None  # (n_pages,) HxWx3 uint8
    layout: Optional[List[Dict[str, Any]]] = None  # per page: boxes/labels/clusters
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class Caps:
    """Static padding caps (the same fields and defaults as the JAX package)."""

    max_pages: int = 20
    max_chunks: int = 128
    max_slots: int = 2048
    tokens_per_word: int = 8
    embed_tokens: int = 96  # per-chunk embedder token cap
    question_tokens: int = 48
    prompt_tokens: int = 64


@dataclass
class ChunkedBatch:
    """Everything the retrieval + generation pipeline needs, as numpy arrays
    from `DocVQAIngestor.ingest` or as tensors after `to_device`."""

    # --- embedder inputs ---
    chunk_emb_tokens: Any  # (B, C, LE) int
    chunk_emb_mask: Any  # (B, C, LE) bool
    q_tokens: Any  # (B, LQ) int
    q_mask: Any  # (B, LQ) bool
    # --- chunk metadata ---
    chunk_mask: Any  # (B, C) bool
    chunk_page: Any  # (B, C) int
    chunk_label: Any  # (B, C) int
    chunk_box: Any  # (B, C, 4) float32
    chunk_slot_start: Any  # (B, C) int
    chunk_slot_len: Any  # (B, C) int
    # --- word-slot arrays (generator token source) ---
    slot_tokens: Any  # (B, W, TW) int
    slot_ntok: Any  # (B, W) int
    slot_box: Any  # (B, W, 4) float32
    slot_page: Any  # (B, W) int
    slot_label: Any  # (B, W) int
    slot_mask: Any  # (B, W) bool
    page_slot_start: Any  # (B, P) int
    page_slot_end: Any  # (B, P) int
    # --- raw word arrays (original page word order, no chunk duplication) ---
    raw_tokens: Any  # (B, R, TW) int
    raw_ntok: Any  # (B, R) int
    raw_box: Any  # (B, R, 4) float32
    raw_label: Any  # (B, R) int
    raw_mask: Any  # (B, R) bool
    page_raw_start: Any  # (B, P) int
    page_raw_end: Any  # (B, P) int
    # --- generator prompt ("question: {q}  context: ") ---
    prompt_tokens: Any  # (B, LP) int
    prompt_len: Any  # (B,) int
    # --- misc ---
    num_pages: Any  # (B,) int
    answer_page: Any  # (B,) int

    @property
    def batch_size(self) -> int:
        return self.chunk_mask.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.chunk_mask.shape[1]


def to_device(batch: ChunkedBatch, device) -> ChunkedBatch:
    """numpy `ChunkedBatch` -> the same batch as tensors on `device`
    (integers as int64, floats as float32, masks as bool)."""
    import torch

    out = {}
    for f in dataclasses.fields(batch):
        a = np.asarray(getattr(batch, f.name))
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ChunkedBatch(**out)


def on_device(batch: ChunkedBatch, device) -> ChunkedBatch:
    """`batch` already of tensors as it is, wherever they live; a numpy
    `batch` through `to_device`."""
    import torch

    return batch if isinstance(batch.chunk_mask, torch.Tensor) else to_device(batch, device)


@dataclass
class GeneratorInputs:
    """Assembled generator inputs (tensors)."""

    input_ids: torch.Tensor  # (N, S) int64
    input_boxes: torch.Tensor  # (N, S, 4) int64, scaled to [0, 1000]
    input_labels: torch.Tensor  # (N, S) int64 layout labels
    attention_mask: torch.Tensor  # (N, S) bool

    @property
    def seq_len(self) -> int:
        return self.input_ids.shape[1]


@dataclass
class RetrievalResult:
    """Top-k retrieval output (tensors)."""

    top_k_idx: torch.Tensor  # (B, K) int64 chunk indices (into the C axis)
    top_k_valid: torch.Tensor  # (B, K) bool
    top_k_score: torch.Tensor  # (B, K) float32 cosine similarity
    top_k_page: torch.Tensor  # (B, K) int64
    top_k_label: torch.Tensor  # (B, K) int64
    top_k_box: torch.Tensor  # (B, K, 4) float32
    similarities: torch.Tensor  # (B, C) float32 (masked chunks = NEG_INF)
