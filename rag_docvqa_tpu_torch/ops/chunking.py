"""Host-side chunk index computation.

The port's own copy of `rag_docvqa_tpu/ops/chunking.py` (plain Python, no
array library); `tests/test_torch_copies.py` holds it against the original.

Chunking depends only on the OCR (words + boxes + optional layout), never on
the query, so it runs once at ingest time and emits *word-index lists* that the
device pipeline consumes as gather indices. Semantics are an exact port of the
reference Chunker (src/_modules.py:843-1100):

  * fixed-stride word chunks of `chunk_size` with `overlap`,
  * small-tail merge: a chunk is merged into its predecessor when
    prev + (this - overlap) <= chunk_size * (1 + chunk_size_tol)
    (src/_modules.py:922-934),
  * oracle mode: the whole page is one chunk (src/_modules.py:967-979),
  * layout mode: regions sorted by (xmin, ymin), words assigned to a region
    when containment_ratio > 0.5, optional cluster concatenation with
    majority-vote labels (src/_modules.py:992-1084).

Returned indices are page-local word positions; duplicates are possible both
across chunks (stride overlap) and, in a rare chained-tail-merge edge case,
inside one chunk — both match the reference exactly.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# Framework layout label map — matches both reference detectors' 4-label
# output space (src/_modules.py:308-313,630-636); label 4 is the out-of-band
# value used for prompt/EOS/pad tokens (src/VT5.py:136-137).
DEFAULT_TEXT_LABEL = 1

LAYOUT_LABEL_MAP: Dict[int, str] = {
    0: "title",
    1: "text",
    2: "figure",
    3: "table",
}


@dataclass(frozen=True)
class ChunkSpec:
    """Chunking hyperparameters (defaults match configs/RAGVT5.yml usage)."""

    chunk_size: int = 60
    chunk_size_tol: float = 0.2
    overlap: int = 10
    mode: str = "fixed"  # "fixed" | "oracle"
    cluster_layouts: bool = False
    default_label: int = DEFAULT_TEXT_LABEL

    def __post_init__(self) -> None:
        assert self.chunk_size > 1, "chunk_size should be > 1"
        assert 0 <= self.chunk_size_tol <= 1, "chunk_size_tol should be in [0, 1]"
        assert 0 <= self.overlap < self.chunk_size, "need 0 <= overlap < chunk_size"


@dataclass
class PageChunks:
    """Chunks of a single page: page-local word indices + labels."""

    word_indices: List[List[int]] = field(default_factory=list)  # (n_chunks, n_words)
    labels: List[int] = field(default_factory=list)  # (n_chunks,)
    word_labels: List[int] = field(default_factory=list)  # (n_words,) per-word layout label


def containment_ratio(small_box: Sequence[float], large_box: Sequence[float]) -> float:
    """Fraction of `small_box` area inside `large_box` (src/utils.py:328-341)."""
    x1 = max(small_box[0], large_box[0])
    y1 = max(small_box[1], large_box[1])
    x2 = min(small_box[2], large_box[2])
    y2 = min(small_box[3], large_box[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    small_area = (small_box[2] - small_box[0]) * (small_box[3] - small_box[1])
    return inter / small_area if small_area > 0 else 0


def make_chunk_indices(
    word_indices: Sequence[int],
    chunk_size: int,
    overlap: int,
    tol: float,
) -> List[List[int]]:
    """Stride chunking with tail merge over an ordered index sequence.

    Port of the `make_chunks` closure (src/_modules.py:907-943). Within one
    call all chunks share a page/region, so the reference's same-page guard is
    always true for i > 0 and is omitted.
    """
    chunks: List[List[int]] = []
    stride = chunk_size - overlap
    prev_size = 0
    for i in range(0, len(word_indices), stride):
        chunk = list(word_indices[i : i + chunk_size])
        this_size = len(chunk)
        if i > 0 and prev_size + (this_size - overlap) <= chunk_size * (1 + tol):
            chunks[-1].extend(chunk[overlap:])
            this_size = prev_size + this_size - overlap
        else:
            chunks.append(chunk)
        prev_size = this_size
    return chunks


def chunk_page(
    words: Sequence[str],
    boxes: Sequence[Sequence[float]],
    spec: ChunkSpec,
    layout_boxes: Optional[Sequence[Sequence[float]]] = None,
    layout_labels: Optional[Sequence[int]] = None,
    layout_clusters: Optional[Sequence[int]] = None,
) -> PageChunks:
    """Chunk one page. Dispatches oracle / fixed / layout-guided modes."""
    n = len(words)
    out = PageChunks(word_labels=[spec.default_label] * n)

    if spec.mode == "oracle":
        # Whole page as a single chunk (src/_modules.py:967-979).
        out.word_indices.append(list(range(n)))
        out.labels.append(spec.default_label)
        return out

    # len-based: detector outputs arrive as numpy arrays, whose truthiness
    # is ambiguous for >1 box
    if layout_boxes is None or len(layout_boxes) == 0:
        if n > 0:
            chunks = make_chunk_indices(range(n), spec.chunk_size, spec.overlap, spec.chunk_size_tol)
        else:
            chunks = []
        out.word_indices.extend(chunks)
        out.labels.extend([spec.default_label] * len(chunks))
        return out

    # --- layout-guided path (src/_modules.py:992-1084) ---
    labels_in = list(layout_labels) if layout_labels is not None else [spec.default_label] * len(layout_boxes)
    clusters_in = list(layout_clusters) if (layout_clusters is not None and spec.cluster_layouts) else None

    # Sort regions left-right then top-bottom (src/_modules.py:1006-1018).
    region_order = sorted(range(len(layout_boxes)), key=lambda r: (layout_boxes[r][0], layout_boxes[r][1]))
    sorted_boxes = [layout_boxes[r] for r in region_order]
    sorted_labels = [labels_in[r] for r in region_order]
    sorted_clusters = [clusters_in[r] for r in region_order] if clusters_in is not None else None

    # Assign words to regions by containment > 0.5; the LAST matching region
    # (in sorted order) wins the per-word label (src/_modules.py:1023-1033).
    region_words: List[List[int]] = []
    for rb, (rbox, rlabel) in enumerate(zip(sorted_boxes, sorted_labels)):
        inside = []
        for i, box in enumerate(boxes):
            if containment_ratio(box, rbox) > 0.5:
                inside.append(i)
                out.word_labels[i] = rlabel
        region_words.append(inside)
    region_labels = list(sorted_labels)

    # Optional cluster concatenation (src/_modules.py:1035-1064).
    if sorted_clusters is not None:
        cluster_words: List[List[int]] = []
        cluster_label_counts: List[Counter] = []
        cluster2idx: Dict[int, int] = {}
        for wlist, rlabel, cl in zip(region_words, sorted_labels, sorted_clusters):
            if cl == -1 or cl not in cluster2idx:
                if cl != -1:
                    cluster2idx[cl] = len(cluster_words)
                cluster_words.append(list(wlist))
                cluster_label_counts.append(Counter([rlabel]))
            else:
                idx = cluster2idx[cl]
                cluster_words[idx].extend(wlist)
                cluster_label_counts[idx][rlabel] += 1
        region_words = cluster_words
        region_labels = [c.most_common(1)[0][0] for c in cluster_label_counts]

    # Stride-chunk inside each region/cluster (src/_modules.py:1066-1074).
    for wlist, rlabel in zip(region_words, region_labels):
        chunks = make_chunk_indices(wlist, spec.chunk_size, spec.overlap, spec.chunk_size_tol)
        out.word_indices.extend(chunks)
        out.labels.extend([rlabel] * len(chunks))
    return out


def compact_chunk_box(
    boxes: Sequence[Sequence[float]],
    word_indices: Sequence[int],
) -> Tuple[float, float, float, float]:
    """Bounding-box union of a chunk's word boxes (src/_modules.py:1120-1128).

    Empty chunks fall back to the full page box [0, 0, 1, 1].
    """
    if not word_indices:
        return (0.0, 0.0, 1.0, 1.0)
    xs0 = min(boxes[i][0] for i in word_indices)
    ys0 = min(boxes[i][1] for i in word_indices)
    xs1 = max(boxes[i][2] for i in word_indices)
    ys1 = max(boxes[i][3] for i in word_indices)
    return (float(xs0), float(ys0), float(xs1), float(ys1))
