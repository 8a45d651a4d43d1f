"""MMLongBenchDoc scoring — parity port of reference src/eval/eval_score.py.

Typed scoring (Int/Float/Str/List/None), percentage-tolerant float equality,
exact-match special cases, and accuracy/F1 over the answerable split.
`eval()` calls on ground-truth strings in the reference (eval_score.py:138,142)
are replaced with ast.literal_eval for safety; behavior is identical for the
list-literal strings they are applied to.
"""

from __future__ import annotations

import ast
import re
from math import isclose
from typing import Any, Dict, List, Tuple

from rag_docvqa_tpu_torch.metrics.anls import levenshtein


def anls_compute(groundtruth: str, prediction: str, threshold: float = 0.5) -> float:
    """ANLS used by MMLongBench (eval_score.py:21-29).

    NOTE: the reference zeroes scores `<= threshold` here (strict at the
    boundary), unlike the main evaluator's `< threshold`. Kept as-is.
    """
    dist = levenshtein(groundtruth, prediction)
    length = max(len(groundtruth.upper()), len(prediction.upper()))
    value = 0.0 if length == 0 else float(dist) / float(length)
    score = 1.0 - value
    if score <= threshold:
        score = 0.0
    return score


def is_float_equal(
    reference: Any,
    prediction: Any,
    include_percentage: bool = False,
    is_close: bool = False,
) -> bool:
    """Float equality with %-scaling tolerance (eval_score.py:31-59)."""

    def get_precision(x: float) -> int:
        s = str(x)
        return len(s.split(".")[-1]) if "." in s else 3

    reference = float(str(reference).strip().rstrip("%").strip())
    try:
        prediction = float(str(prediction).strip().rstrip("%").strip())
    except Exception:
        return False

    gt_result = [reference / 100, reference, reference * 100] if include_percentage else [reference]
    for item in gt_result:
        try:
            if is_close and isclose(item, prediction, rel_tol=0.01):
                return True
            precision = max(min(get_precision(prediction), get_precision(item)), 2)
            if round(prediction, precision) == round(item, precision):
                return True
        except Exception:
            continue
    return False


def get_clean_string(s: Any) -> str:
    """Normalization before comparison (eval_score.py:61-76)."""
    s = str(s).lower().strip()
    # The reference calls rstrip without assignment for mile/miles/million —
    # i.e. these are no-ops. Replicated faithfully (do nothing).
    s = re.sub(r"\s*\([^)]*\)", "", s).strip()
    s = re.sub(r"^['\"]|['\"]$", "", s).strip()
    s = s.strip().lstrip("$").strip()
    s = s.strip().rstrip("%").strip()
    return s


def is_exact_match(s: str) -> bool:
    """Strings that require exact matching (eval_score.py:78-104)."""
    if "https://" in s:
        return True
    if s.endswith(".py") or s.endswith("ipynb"):
        return True
    if s.startswith("page"):
        return True
    if re.fullmatch(r"\b\d+(-\d+|\s\d+)?\b", s):
        return True
    if "a.m." in s or "p.m." in s:
        return True
    if re.fullmatch(r"\b\d{4}[-\s]\d{2}[-\s]\d{2}\b", s):
        return True
    if re.fullmatch(r"\b\d{4}[-\s]\d{2}\b", s):
        return True
    if re.fullmatch(r"[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}", s):
        return True
    return False


def isfloat(num: Any) -> bool:
    try:
        float(num)
        return True
    except (ValueError, TypeError):
        return False


def _maybe_list(x: Any) -> Any:
    if isinstance(x, str) and x.startswith("["):
        try:
            return ast.literal_eval(x)
        except (ValueError, SyntaxError):
            return x
    return x


def eval_score(gt: Any, pred: Any, answer_type: str) -> float:
    """Typed scoring (eval_score.py:114-155)."""
    if answer_type == "Int":
        try:
            gt_i, pred_i = int(gt), int(float(pred))
        except Exception:
            return 0.0
        return float(gt_i == pred_i)
    if answer_type == "Float":
        try:
            gt_f = float(get_clean_string(str(gt)))
            pred_f = float(get_clean_string(str(pred)))
        except Exception:
            return 0.0
        return float(is_float_equal(gt_f, pred_f, include_percentage=True, is_close=True))
    if answer_type in ("Str", "None"):
        gt_s = get_clean_string(gt)
        pred_s = get_clean_string(pred)
        if is_exact_match(gt_s):
            return float(gt_s == pred_s)
        return float(anls_compute(gt_s, pred_s))

    # List type
    gt_l = _maybe_list(gt)
    pred_l = _maybe_list(pred)
    if not isinstance(gt_l, list):
        gt_l = [gt_l]
    if not isinstance(pred_l, list):
        pred_l = [pred_l]
    if len(gt_l) != len(pred_l):
        return 0.0
    gt_l = sorted(get_clean_string(a) for a in gt_l)
    pred_l = sorted(get_clean_string(a) for a in pred_l)
    if isfloat(gt_l[0]) or is_exact_match(gt_l[0]):
        return float("-".join(gt_l) == "-".join(pred_l))
    return float(min(anls_compute(g, p) for g, p in zip(gt_l, pred_l)))


def show_results(samples: List[Dict], show_path: str) -> None:
    """Breakdown report by page span / evidence source / doc type
    (eval_score.py:173-217). Accepts lists directly (the reference eval()s
    stringified lists)."""
    import ast

    for s in samples:
        for key in ("evidence_pages", "evidence_sources"):
            if isinstance(s.get(key), str):
                s[key] = ast.literal_eval(s[key])

    with open(show_path, "w") as f:
        acc, f1 = eval_acc_and_f1(samples)
        f.write(f"Overall Acc: {acc} | Question Number: {len(samples)}\n")
        f.write(f"Overall F1-score: {f1} | Question Number: {len(samples)}\n")
        f.write("-----------------------\n")
        single = [s for s in samples if len(s.get("evidence_pages", [])) == 1]
        multi = [s for s in samples if len(s.get("evidence_pages", [])) != 1 and s["answer"] != "Not answerable"]
        neg = [s for s in samples if s["answer"] == "Not answerable"]
        f.write(f"Single-page | Accuracy: {eval_acc_and_f1(single)[0]} | Question Number: {len(single)}\n")
        f.write(f"Cross-page | Accuracy: {eval_acc_and_f1(multi)[0]} | Question Number: {len(multi)}\n")
        f.write(f"Unanswerable | Accuracy: {eval_acc_and_f1(neg)[0]} | Question Number: {len(neg)}\n")
        f.write("-----------------------\n")
        by_source: Dict[str, List[Dict]] = {}
        by_doc: Dict[str, List[Dict]] = {}
        for s in samples:
            for src in s.get("evidence_sources", []):
                by_source.setdefault(src, []).append(s)
            by_doc.setdefault(s.get("doc_type", "unknown"), []).append(s)
        for typ, subs in by_source.items():
            f.write(f"Evidence Sources: {typ} | Accuracy: {eval_acc_and_f1(subs)[0]} | Question Number: {len(subs)}\n")
        f.write("-----------------------\n")
        for typ, subs in by_doc.items():
            f.write(f"Document Type: {typ} | Accuracy: {eval_acc_and_f1(subs)[0]} | Question Number: {len(subs)}\n")


def extract_answer(
    question: str,
    output: str,
    prompt: str = None,
    model_name: str = "gpt-4o",
) -> str:
    """LLM-judge answer extraction (reference src/eval/extract_answer.py).

    Gated on OPENAI_API_KEY + the openai package; returns the raw output
    unchanged otherwise (the reference does the same, :24-26)."""
    import os

    if not os.getenv("OPENAI_API_KEY"):
        return output
    try:
        from openai import OpenAI

        client = OpenAI()
        system = prompt or "Extract the answer from the model output. Return only the answer, nothing else."
        response = client.chat.completions.create(
            model=model_name,
            messages=[
                {"role": "system", "content": system},
                {"role": "user", "content": f"Question: {question}\nModel Output: {output}"},
            ],
            temperature=0,
            max_tokens=100,
        )
        return response.choices[0].message.content.strip()
    except Exception as e:  # degrade to the raw output (reference :52-54)
        print(f"Error in answer extraction: {e}")
        return output


def eval_acc_and_f1(samples: List[Dict]) -> Tuple[float, float]:
    """Accuracy + F1 over the answerable split (eval_score.py:157-171)."""
    evaluated = [s for s in samples if "score" in s]
    if not evaluated:
        return 0.0, 0.0
    acc = sum(s["score"] for s in evaluated) / len(evaluated)
    try:
        answerable = [s for s in evaluated if s["answer"] != "Not answerable"]
        pred_answerable = [s for s in evaluated if s["pred"] != "Not answerable"]
        recall = sum(s["score"] for s in answerable) / len(answerable)
        precision = sum(s["score"] for s in answerable) / len(pred_answerable)
        f1 = 2 * recall * precision / (recall + precision) if (recall + precision) > 0.0 else 0.0
    except ZeroDivisionError:
        f1 = 0.0
    return acc, f1
