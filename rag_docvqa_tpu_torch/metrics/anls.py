"""Edit-distance primitives: Levenshtein, ANLS, fuzzy substring similarity.

The reference uses the `editdistance` C wheel (src/metrics.py:22) and
`difflib.SequenceMatcher` (src/utils.py:255-281). We implement Levenshtein
with a banded numpy DP (vectorized over one string axis) so the evaluator has
no non-baked-in dependencies, and the fuzzy substring score with a sliding
SequenceMatcher identical to the reference.
"""

from __future__ import annotations

import difflib
import math
from functools import lru_cache

import numpy as np


def levenshtein(s1: str, s2: str) -> int:
    """Levenshtein edit distance.

    Matches editdistance.eval / src/eval/eval_score.py:5-19. Uses the native
    C++ kernel (rag_docvqa_tpu_torch/native.py) when available, else a vectorized
    numpy DP.
    """
    if s1 == s2:
        return 0
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)

    from rag_docvqa_tpu_torch import native

    d = native.levenshtein(s1, s2)
    if d is not None:
        return d

    b = np.frombuffer(s2.encode("utf-32-le"), dtype=np.uint32)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    cur = np.empty_like(prev)
    for i, c1 in enumerate(s1):
        cost = (b != ord(c1)).astype(np.int64)
        cur[0] = i + 1
        sub_or_del = np.minimum(prev[:-1] + cost, prev[1:] + 1)
        # Insertion has a sequential dependency; resolve with running min trick:
        # cur[j] = min(sub_or_del[j-1], cur[j-1] + 1)
        # => cur[j] - j = running_min(sub_or_del[j-1] - j... )
        shifted = sub_or_del - np.arange(1, len(b) + 1)
        np.minimum.accumulate(shifted, out=shifted)
        cur[1:] = np.minimum(sub_or_del, shifted + np.arange(1, len(b) + 1))
        prev, cur = cur, prev
    return int(prev[-1])


def anls(gt: str, pred: str, threshold: float = 0.5) -> float:
    """Normalized Levenshtein similarity with threshold (src/metrics.py:241-243)."""
    if max(len(gt), len(pred)) == 0:
        return 0.0
    sim = 1.0 - levenshtein(gt, pred) / max(len(gt), len(pred))
    return sim if sim >= threshold else 0.0


@lru_cache(maxsize=4096)
def _cached_similarity(a: str, b: str) -> float:
    a = a.lower()
    b = b.lower()

    # native sliding-window matcher; skip when difflib's autojunk heuristic
    # would kick in (windows >= 200 chars) to preserve exact parity
    if 0 < len(b) < 200:
        from rag_docvqa_tpu_torch import native

        ratio = native.best_substring_ratio(a, b)
        if ratio is not None:
            return math.log(ratio + 1.0) / math.log(2.0)

    best_score = 0.0
    len_b = len(b)
    matcher = difflib.SequenceMatcher(None, b)
    for i in range(len(a) - len_b + 1):
        matcher.set_seq2(a[i : i + len_b])
        score = matcher.ratio()
        if score > best_score:
            best_score = score
            if best_score == 1.0:
                break
    return math.log(best_score + 1.0) / math.log(2.0)


def similarity_score(a: str, b: str) -> float:
    """Best fuzzy similarity of `b` against any substring of `a`.

    Port of src/utils.py:255-281 (sliding SequenceMatcher.ratio, log2(1+x)).
    Note the reference constructs SequenceMatcher(None, b, substring) per
    window; we keep seq1=b fixed and slide seq2, which yields identical ratios.
    """
    return _cached_similarity(a, b)
