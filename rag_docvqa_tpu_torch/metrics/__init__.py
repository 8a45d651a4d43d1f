"""Evaluation metrics with exact parity to the reference implementation.

The port's own copy of `rag_docvqa_tpu/metrics/` (plain Python and numpy);
`tests/test_torch_copies.py` holds it against the original.

Ported behaviors (reference citations):
  * typed accuracy + ANLS        -> src/metrics.py:155-243
  * page retrieval precision     -> src/metrics.py:94-109
  * chunk score (fuzzy substring)-> src/metrics.py:111-133, src/utils.py:255-281
  * MMLongBenchDoc scorer        -> src/eval/eval_score.py
"""

from rag_docvqa_tpu_torch.metrics.anls import anls, levenshtein, similarity_score
from rag_docvqa_tpu_torch.metrics.evaluator import Evaluator
from rag_docvqa_tpu_torch.metrics.mmlongbench import (
    anls_compute,
    eval_acc_and_f1,
    eval_score,
)

__all__ = [
    "anls",
    "levenshtein",
    "similarity_score",
    "Evaluator",
    "anls_compute",
    "eval_score",
    "eval_acc_and_f1",
]
