"""Batch evaluator: typed accuracy, ANLS, retrieval precision, chunk score.

Parity port of the reference Evaluator (src/metrics.py:12-243):
  * case-insensitive strip preprocessing        (:148-153)
  * special-case exact matching                 (:155-173)
  * typed accuracy int/float/list/not-answerable(:175-215)
  * ANLS with 0.5 threshold                     (:217-243)
  * Anyconf max-over-k scoring                  (:54-68)
  * page retrieval precision gt-in-topk         (:94-109)
  * chunk score = log2(1 + fuzzy substring sim) (:111-133)
    (the inner similarity already applies log2(1+ratio) — the reference
    double-applies the log transform; replicated faithfully)
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from rag_docvqa_tpu_torch.metrics.anls import anls as _anls
from rag_docvqa_tpu_torch.metrics.anls import similarity_score


class Evaluator:
    def __init__(self, case_sensitive: bool = False, layout_map: Optional[Dict[int, str]] = None):
        self.case_sensitive = case_sensitive
        self.anls_threshold = 0.5
        self.layout_map = layout_map or {}
        self.best_accuracy = 0.0
        self.best_epoch = 0

    # ------------------------------------------------------------------ #
    # answer metrics
    # ------------------------------------------------------------------ #
    def get_metrics(
        self,
        gt_answers: List[List[str]],
        preds: Union[List[str], List[List[str]], None],
        answer_types: Optional[List[str]] = None,
    ) -> Dict[str, List[float]]:
        if preds is None:
            return {"accuracy": [0] * len(gt_answers), "anls": [0] * len(gt_answers)}
        answer_types = answer_types or ["string"] * len(gt_answers)
        batch_accuracy: List[float] = []
        batch_anls: List[float] = []
        for b in range(len(preds)):
            gt = [self._preprocess_str(g) for g in gt_answers[b]]
            if isinstance(preds[b], list):  # Anyconf: max over the k answers
                acc_max, anls_max = 0.0, 0.0
                for pred in preds[b]:
                    pred = self._preprocess_str(pred)
                    acc_max = max(acc_max, self._calculate_accuracy(gt, pred, answer_types[b]))
                    anls_max = max(anls_max, self._calculate_anls(gt, pred, answer_types[b]))
                batch_accuracy.append(acc_max)
                batch_anls.append(anls_max)
            else:
                pred = self._preprocess_str(preds[b])
                batch_accuracy.append(self._calculate_accuracy(gt, pred, answer_types[b]))
                batch_anls.append(self._calculate_anls(gt, pred, answer_types[b]))
        return {"accuracy": batch_accuracy, "anls": batch_anls}

    # ------------------------------------------------------------------ #
    # retrieval metrics
    # ------------------------------------------------------------------ #
    def get_retrieval_metric(
        self,
        gt_answer_page: Sequence[int],
        pred_answer_pages: Union[Sequence[int], Sequence[Sequence[int]]],
    ) -> List[int]:
        if len(pred_answer_pages) and isinstance(pred_answer_pages[0], (int, np.integer)):
            return [int(gt == pred) for gt, pred in zip(gt_answer_page, pred_answer_pages)]
        return [int(gt in preds) for gt, preds in zip(gt_answer_page, pred_answer_pages)]

    def eval_retrieval(
        self,
        answers: List[List[str]],
        top_k_text: Optional[List[List[str]]],
    ) -> Dict[str, List[float]]:
        """Chunk score: is the answer (fuzzily) inside the retrieved chunks?"""
        if not top_k_text:
            return {"chunk_score": [0] * len(answers)}
        scores = []
        for b in range(len(answers)):
            best = 0.0
            for ans in answers[b]:
                ans_scores = [similarity_score(chunk, ans) for chunk in top_k_text[b]]
                best = max(best, max(ans_scores + [0.0]))
            scores.append(float(np.log(best + 1) / np.log(2)))
        return {"chunk_score": scores}

    def update_global_metrics(self, accuracy: float, anls: float, current_epoch: int) -> bool:
        if accuracy > self.best_accuracy:
            self.best_accuracy = accuracy
            self.best_epoch = current_epoch
            return True
        return False

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _preprocess_str(self, string: Optional[str]) -> str:
        if string is None:
            return ""
        if not self.case_sensitive:
            string = string.lower()
        return string.strip()

    @staticmethod
    def _is_special_case(string: str) -> bool:
        if "https://" in string or "http://" in string:
            return True
        if string.endswith((".py", ".ipynb")):
            return True
        if string.startswith("page"):
            return True
        if re.fullmatch(r"\b\d+(-\d+|\s\d+)?\b", string):
            return True
        if "a.m." in string or "p.m." in string:
            return True
        if re.fullmatch(r"\b\d{4}[-\s]\d{2}[-\s]\d{2}\b", string):
            return True
        if re.fullmatch(r"\b\d{4}[-\s]\d{2}\b", string):
            return True
        if re.fullmatch(r"[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}", string):
            return True
        return False

    def _calculate_accuracy(self, gt: List[str], pred: str, answer_type: str) -> int:
        if answer_type == "not-answerable":
            return 1 if pred in ["", "none", "NA", None, []] else 0
        if pred == "none" and answer_type != "not-answerable":
            return 0
        if any(self._is_special_case(g) for g in gt):
            return 1 if pred in gt else 0
        if answer_type == "int":
            try:
                return 1 if int(float(pred)) in [int(g) for g in gt] else 0
            except Exception:
                return 0
        if answer_type == "float":
            try:
                gt_float = [float(g.strip().rstrip("%")) for g in gt]
                pred_float = float(pred.strip().rstrip("%"))
                return 1 if any(abs(pred_float - g) < 0.01 for g in gt_float) else 0
            except Exception:
                return 0
        if answer_type == "list":
            try:
                gt_list = [sorted(g.strip("[]").split(",")) for g in gt]
                pred_list = sorted(pred.strip("[]").split(","))
                return 1 if pred_list in gt_list else 0
            except Exception:
                return 0
        return 1 if pred in gt else 0

    def _calculate_anls(self, gt: List[str], pred: str, answer_type: str) -> float:
        if len(pred) == 0:
            return 0.0
        if answer_type == "not-answerable" or "" in gt:
            return 1.0 if pred in ["", "none", "NA", None, []] else 0.0
        if pred == "none" and answer_type != "not-answerable":
            return 0.0
        if any(self._is_special_case(g) for g in gt):
            return 1.0 if pred in gt else 0.0
        if answer_type in ("int", "float", "list"):
            return 1.0 if self._calculate_accuracy(gt, pred, answer_type) == 1 else 0.0
        return max(_anls(g, pred, self.anls_threshold) for g in gt)
