"""Evaluation loop: ingest -> engine.inference -> accuracy, ANLS, retrieval
precision and chunk score over a document set.

The single-device path of `rag_docvqa_tpu/engine/evaluate.py::evaluate`,
without jax: batches are ingested and copied to the engine's device on a
background thread (`data/prefetch.py`) while the engine answers the
previous one, and scored with this package's own copy of the `Evaluator`
(`metrics/`, plain Python). MMLongBench-typed scoring runs when the documents carry an
answer format, as there. With `compute_stats` the chunk distributions of
every ingested batch (`utils_stats.collect_ingest_stats`, on the host copy
before it goes to the device) are merged in batch order into
"retrieval_stats" and "retrieval_stats_examples". The mesh (data-parallel)
path waits for ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.data.contract import RawDocument, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.prefetch import map_prefetch
from rag_docvqa_tpu_torch.utils_stats import StatsCollector, collect_ingest_stats


def evaluate(
    engine,
    docs: Sequence[RawDocument],
    ingestor: DocVQAIngestor,
    evaluator: Optional[Evaluator] = None,
    batch_size: int = 8,
    save_path: Optional[str] = None,
    save_continuously: bool = False,
    compute_stats: bool = False,
    prefetch_depth: int = 2,
) -> Dict[str, Any]:
    evaluator = evaluator or Evaluator()
    stats = StatsCollector(compute_examples=True) if compute_stats else None
    mmlb = bool(docs) and bool(getattr(docs[0], "extra", {}).get("answer_format"))
    mmlb_samples: List[Dict[str, Any]] = []
    total_acc: List[float] = []
    total_anls: List[float] = []
    total_ret_prec: List[float] = []
    total_chunk_score: List[float] = []
    scores_by_samples: Dict[Any, Dict[str, Any]] = {}
    load_time = retrieval_time = generation_time = 0.0
    all_answers: List[Any] = []

    def _ingest_one(start: int):
        chunk = list(docs[start : start + batch_size])
        t0 = time.time()
        batch, aux = ingestor.ingest(chunk)
        batch_stats = collect_ingest_stats(batch, aux) if compute_stats else None
        return chunk, to_device(batch, engine.device), aux, time.time() - t0, batch_stats

    for chunk, batch, aux, ingest_t, batch_stats in map_prefetch(_ingest_one, range(0, len(docs), batch_size),
                                                                 depth=prefetch_depth):
        load_time += ingest_t
        if stats is not None:
            stats.merge(batch_stats)
        t0 = time.time()
        out = engine.inference(batch, aux)
        step_total = time.time() - t0
        r = out.get("retrieval", {}) or {}
        retrieval_time += r.get("retrieval_time", 0.0)
        generation_time += r.get("generation_time", step_total - r.get("retrieval_time", 0.0))

        metrics = evaluator.get_metrics(aux["answers"], out["pred_answers"], aux.get("answer_types"))
        ret_prec = evaluator.get_retrieval_metric([d.answer_page_idx for d in chunk], out["pred_answer_pages"])
        ret_eval = evaluator.eval_retrieval(aux["answers"], out["retrieval"].get("text"))

        total_acc.extend(metrics["accuracy"])
        total_anls.extend(metrics["anls"])
        total_ret_prec.extend(ret_prec)
        total_chunk_score.extend(ret_eval["chunk_score"])
        all_answers.extend(out["pred_answers"])

        if mmlb:
            from rag_docvqa_tpu_torch.metrics.mmlongbench import eval_score, extract_answer

            for i, d in enumerate(chunk):
                fmt = d.extra.get("answer_format", "Str")
                gt = d.answers[0] if d.answers else ""
                preds = out["pred_answers"][i]
                preds = preds if isinstance(preds, list) else [preds]
                score = max((eval_score(gt, extract_answer(d.question, p or ""), fmt) for p in preds), default=0.0)
                mmlb_samples.append({
                    "question": d.question, "answer": gt, "pred": (preds[0] or "") if preds else "",
                    "score": score, "answer_format": fmt,
                    "evidence_pages": d.extra.get("evidence_pages", []),
                    "evidence_sources": d.extra.get("evidence_sources", []),
                    "doc_type": d.extra.get("doc_type", "unknown"),
                })

        for i, d in enumerate(chunk):
            scores_by_samples[d.question_id] = {
                "question": d.question,
                "gt_answer": d.answers,
                "pred_answer": out["pred_answers"][i],
                "pred_answer_conf": out["confidences"][i],
                "pred_answer_pages": out["pred_answer_pages"][i],
                "gt_answer_page": d.answer_page_idx,
                "accuracy": metrics["accuracy"][i],
                "anls": metrics["anls"][i],
                "retrieval_precision": ret_prec[i],
                "chunk_score": ret_eval["chunk_score"][i],
            }

        if save_continuously and save_path:
            _save(save_path, total_acc, total_anls, total_ret_prec, total_chunk_score,
                  scores_by_samples, load_time, retrieval_time, generation_time)

    result = _summary(total_acc, total_anls, total_ret_prec, total_chunk_score,
                      load_time, retrieval_time, generation_time)
    result["scores_by_samples"] = scores_by_samples
    result["pred_answers"] = all_answers
    if stats is not None:
        result["retrieval_stats"] = stats.summary()
        result["retrieval_stats_examples"] = stats.stats_examples
    if mmlb:
        from rag_docvqa_tpu_torch.metrics.mmlongbench import eval_acc_and_f1, show_results

        acc, f1 = eval_acc_and_f1(mmlb_samples)
        result["mmlongbench"] = {"accuracy": acc, "f1": f1, "n_samples": len(mmlb_samples)}
        if save_path:
            show_results(mmlb_samples, os.path.splitext(save_path)[0] + "_mmlb_breakdown.txt")
    if save_path:
        _save(save_path, total_acc, total_anls, total_ret_prec, total_chunk_score,
              scores_by_samples, load_time, retrieval_time, generation_time)
    return result


def _summary(acc, anls, prec, chunk, load_t, ret_t, gen_t) -> Dict[str, Any]:
    m = lambda xs: float(np.mean(xs)) if xs else 0.0
    return {
        "accuracy": m(acc),
        "anls": m(anls),
        "retrieval_precision": m(prec),
        "chunk_score": m(chunk),
        "n_samples": len(acc),
        "timing": {"load_time": load_t, "retrieval_time": ret_t, "generation_time": gen_t},
    }


def _save(path, acc, anls, prec, chunk, samples, load_t, ret_t, gen_t) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = _summary(acc, anls, prec, chunk, load_t, ret_t, gen_t)
    data["scores_by_samples"] = samples
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=str)
