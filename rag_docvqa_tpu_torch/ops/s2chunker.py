"""S2 chunker: spatial(+semantic) clustering of layout regions.

The port's own copy of `rag_docvqa_tpu/ops/s2chunker.py` (numpy only), held
against the original by `tests/test_torch_copies.py`: a fully connected
graph over layout regions whose edge weight is the mean of a spatial
affinity 1 / (1 + centroid distance) and, when region text embeddings are
given, their cosine; the normalized-Laplacian spectral embedding; k-means on
it, the cluster count chosen by silhouette; and the optional token-length
split of oversized clusters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class S2Config:
    max_clusters: int = 8
    use_semantics: bool = True
    max_tokens_per_cluster: int = 0  # 0 = no splitting
    seed: int = 0


# --------------------------------------------------------------------------- #
# graph + spectral embedding
# --------------------------------------------------------------------------- #
def region_affinity(
    boxes: np.ndarray,  # (N, 4) normalized
    embeddings: Optional[np.ndarray] = None,  # (N, D)
) -> np.ndarray:
    centers = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2], axis=1)
    dist = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    spatial = 1.0 / (1.0 + dist)
    if embeddings is None:
        return spatial
    e = embeddings / (np.linalg.norm(embeddings, axis=-1, keepdims=True) + 1e-12)
    cos = e @ e.T
    return (spatial + cos) / 2.0


def spectral_embedding(affinity: np.ndarray, n_components: int) -> np.ndarray:
    """Eigenvectors of the symmetric normalized Laplacian (smallest non-trivial)."""
    w = np.asarray(affinity, np.float64)
    np.fill_diagonal(w, 0.0)
    d = w.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    lap = np.eye(len(w)) - d_inv_sqrt[:, None] * w * d_inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    emb = vecs[:, 1 : n_components + 1]
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 50) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = len(x)
    centers = x[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        d = np.linalg.norm(x[:, None] - centers[None], axis=-1)
        new_labels = d.argmin(axis=1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for c in range(k):
            pts = x[labels == c]
            if len(pts):
                centers[c] = pts.mean(axis=0)
    return labels


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    n = len(x)
    uniq = np.unique(labels)
    if len(uniq) < 2:
        return -1.0
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)
    scores = []
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i][same].mean() if same.any() else 0.0
        b = min(d[i][labels == c].mean() for c in uniq if c != labels[i])
        denom = max(a, b)
        scores.append((b - a) / denom if denom > 0 else 0.0)
    return float(np.mean(scores))


# --------------------------------------------------------------------------- #
# chunker
# --------------------------------------------------------------------------- #
def cluster_regions(
    boxes: Sequence[Sequence[float]],
    embeddings: Optional[np.ndarray] = None,
    cfg: S2Config = S2Config(),
) -> np.ndarray:
    """Cluster layout regions; returns (N,) cluster ids (N < 2 -> all zeros)."""
    n = len(boxes)
    if n == 0:
        return np.zeros(0, np.int32)
    if n <= 2:
        return np.zeros(n, np.int32)
    aff = region_affinity(np.asarray(boxes, np.float64), embeddings if cfg.use_semantics else None)
    best_labels, best_score = np.zeros(n, np.int32), -2.0
    for k in range(2, min(cfg.max_clusters, n - 1) + 1):
        emb = spectral_embedding(aff, k)
        labels = kmeans(emb, k, seed=cfg.seed)
        score = silhouette_score(emb, labels)
        if score > best_score:
            best_score, best_labels = score, labels
    return best_labels.astype(np.int32)


def split_oversized_clusters(
    labels: np.ndarray,
    token_counts: Sequence[int],
    max_tokens: int,
) -> np.ndarray:
    """Split clusters whose total token count exceeds max_tokens into
    contiguous sub-clusters (src/_modules.py:1869-1902)."""
    labels = np.asarray(labels).copy()
    if max_tokens <= 0:
        return labels
    next_id = labels.max() + 1 if len(labels) else 0
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        total, current = 0, c
        for i in idx:
            if total + token_counts[i] > max_tokens and total > 0:
                current = next_id
                next_id += 1
                total = 0
            labels[i] = current
            total += token_counts[i]
    return labels
