"""Distributional statistics of ingest and retrieval.

The port's own copy of `rag_docvqa_tpu/utils_stats.py` (plain Python and
numpy; `tests/test_torch_copies.py` holds it against the original):
`StatsCollector` counts keyed values per statistic with a few example ids
per bucket, `collect_ingest_stats` the chunk distributions of an ingested
batch (chunk_size_dist, n_chunks_per_page_dist, n_chunks_per_doc_dist) and
`collect_topk_label_stats` the layout labels of the retrieved chunks
(layout_labels_topk_dist).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List


class StatsCollector:
    def __init__(self, compute_stats: bool = True, compute_examples: bool = False, n_examples: int = 5):
        self.compute_stats = compute_stats
        self.compute_examples = compute_examples and compute_stats
        self.n_examples = n_examples
        self.stats: Dict[str, Counter] = {}
        self.stats_examples: Dict[str, Dict[Any, List[Any]]] = {}

    def add(self, stat: str, key: Any, value: int = 1, example: Any = None) -> None:
        if not self.compute_stats:
            return
        self.stats.setdefault(stat, Counter())[key] += value
        if self.compute_examples and example is not None:
            bucket = self.stats_examples.setdefault(stat, {}).setdefault(key, [])
            if len(bucket) < self.n_examples:
                bucket.append(example)

    def merge(self, other: "StatsCollector") -> None:
        """Counter merging as in eval.py:359-378."""
        for stat, counter in other.stats.items():
            self.stats.setdefault(stat, Counter()).update(counter)
        for stat, buckets in other.stats_examples.items():
            mine = self.stats_examples.setdefault(stat, {})
            for key, examples in buckets.items():
                bucket = mine.setdefault(key, [])
                for e in examples:
                    if len(bucket) < self.n_examples:
                        bucket.append(e)

    def summary(self) -> Dict[str, Dict[Any, int]]:
        return {k: dict(sorted(v.items())) for k, v in self.stats.items()}


def collect_ingest_stats(batch, aux, question_ids=None) -> StatsCollector:
    """Chunk distributions from an ingested batch."""
    import numpy as np

    sc = StatsCollector()
    chunk_mask = np.asarray(batch.chunk_mask)
    chunk_len = np.asarray(batch.chunk_slot_len)
    chunk_page = np.asarray(batch.chunk_page)
    for b in range(chunk_mask.shape[0]):
        qid = question_ids[b] if question_ids else aux["question_ids"][b]
        valid = np.where(chunk_mask[b])[0]
        sc.add("n_chunks_per_doc_dist", int(len(valid)), example=f"{qid}")
        per_page = Counter(int(chunk_page[b, c]) for c in valid)
        for p, n in per_page.items():
            sc.add("n_chunks_per_page_dist", n, example=f"{qid}_p{p}")
        for c in valid:
            sc.add("chunk_size_dist", int(chunk_len[b, c]), example=f"{qid}_p{int(chunk_page[b, c])}")
    return sc


def collect_topk_label_stats(ret, layout_map: Dict[int, str]) -> StatsCollector:
    import numpy as np

    sc = StatsCollector()
    labels = np.asarray(ret.top_k_label)
    valid = np.asarray(ret.top_k_valid)
    for b in range(labels.shape[0]):
        for r in np.where(valid[b])[0]:
            sc.add("layout_labels_topk_dist", layout_map.get(int(labels[b, r]), str(int(labels[b, r]))))
    return sc
