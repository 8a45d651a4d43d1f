"""Evaluation loop: ingest -> engine.inference -> accuracy, ANLS, retrieval
precision and chunk score over a document set.

Counterpart of `rag_docvqa_tpu/engine/evaluate.py::evaluate`, without jax:
batches are ingested on a background thread (`data/prefetch.py`) while the
engine answers the previous one; that thread also queues each batch's copy
to the engine's device (`data/transfer.py::device_put_batch_async`: token
ids as int16 when the tokenizer's vocabulary allows, one pinned
non-blocking copy on a stream of its own), and the loop waits for the copy
on its own stream before the engine reads the batch. Batches are scored
with this package's own copy of the `Evaluator` (`metrics/`, plain Python).
MMLongBench-typed scoring runs when the documents carry an answer format,
as there. With `compute_stats` the chunk distributions of every ingested
batch (`utils_stats.collect_ingest_stats`, on the host copy before it goes
to the device) are merged in batch order into "retrieval_stats" and
"retrieval_stats_examples".

With `mesh=` (`parallel/mesh.py`) the evaluation is data-parallel over the
mesh's data axis, as the JAX `mesh=` path: the last partial batch is padded
to a multiple of the axis by repeating its final document, and each rank
ingests, copies and answers only its own rows of every batch (the padding
and the row choice come before the copy). The per-sample outputs, the
answers the scores need and the ingest statistics of the real rows are
gathered in rank order (`all_gather_object`), the padding is dropped, and
the metrics and statistics are computed from the gathered samples, so every
rank returns the unsharded run's result. Stage times are the slowest
rank's. Only the mesh's first rank writes `save_path`.

Each batch's loop is three spans of `profiling.py` (off unless enabled):
`evaluate.wait` (the prefetched batch and its copy), `evaluate.inference`
and `evaluate.score`; on the prefetch thread, `ingest.batch` with the child
`ingest.transfer` (the queued copy).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.data.contract import RawDocument
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.prefetch import map_prefetch
from rag_docvqa_tpu_torch.data.transfer import device_put_batch_async
from rag_docvqa_tpu_torch.parallel.mesh import Mesh, local_rows
from rag_docvqa_tpu_torch.profiling import span
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
    mesh: Optional[Mesh] = None,  # data-parallel over its "data" axis (module docstring)
    prefetch_depth: int = 2,
) -> Dict[str, Any]:
    evaluator = evaluator or Evaluator()
    if mesh is not None and not mesh.first:
        save_path = None  # the mesh's first rank alone writes the file
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
    vocab = getattr(ingestor.tokenizer, "vocab_size", 1 << 30)

    def _ingest_one(start: int):
        chunk = list(docs[start : start + batch_size])
        mine, n_mine = chunk, len(chunk)
        if mesh is not None:  # pad to a multiple of the data axis, then this rank's rows
            size = mesh.size("data")
            padded = chunk + [chunk[-1]] * (-len(chunk) % size)
            rows = local_rows(len(padded), mesh)
            mine, n_mine = padded[rows], max(0, min(rows.stop, len(chunk)) - rows.start)
        with span("ingest.batch", start // batch_size):
            t0 = time.time()
            batch, aux = ingestor.ingest(mine)
            batch_stats = collect_ingest_stats(*_real_rows(batch, aux, n_mine)) if compute_stats else None
            with span("ingest.transfer"):
                pending = device_put_batch_async(batch, vocab, engine.device)
            return chunk, pending, aux, time.time() - t0, batch_stats

    batches = map_prefetch(_ingest_one, range(0, len(docs), batch_size), depth=prefetch_depth)
    for index in itertools.count():
        with span("evaluate.wait", index):
            ingested = next(batches, None)
            if ingested is None:
                break
            chunk, pending, aux, ingest_t, batch_stats = ingested
            batch = pending.wait()
        with span("evaluate.inference", index):
            load_time += ingest_t
            t0 = time.time()
            out = engine.inference(batch, aux)
            step_total = time.time() - t0
        with span("evaluate.score", index):
            r = out.get("retrieval", {}) or {}
            ret_t = r.get("retrieval_time", 0.0)
            gen_t = r.get("generation_time", step_total - ret_t)
            if mesh is not None:
                out, aux, (ret_t, gen_t), batch_stats = _gather_rows(mesh, out, aux, ret_t, gen_t, batch_stats,
                                                                     len(chunk))
            if stats is not None:
                for part in batch_stats if mesh is not None else [batch_stats]:
                    stats.merge(part)
            retrieval_time += ret_t
            generation_time += gen_t

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
                    score = max((eval_score(gt, extract_answer(d.question, p or ""), fmt) for p in preds),
                                default=0.0)
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


def _real_rows(batch, aux, n: int):
    """The first n rows of an ingested batch and of its per-sample aux lists
    (the rows of a rank that are not padding)."""
    if n == batch.batch_size:
        return batch, aux
    batch = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)})
    return batch, {k: v[:n] if isinstance(v, list) else v for k, v in aux.items()}


def _gather_rows(mesh: Mesh, out: Dict[str, Any], aux: Dict[str, Any], ret_t: float, gen_t: float, batch_stats,
                 n_real: int):
    """Every rank's per-sample outputs and answers over the data axis, in
    rank order and cut to the batch's n_real samples, the slowest rank's
    stage times and each rank's ingest statistics."""
    text = (out.get("retrieval") or {}).get("text")
    mine = {"pred_answers": list(out["pred_answers"]), "confidences": list(out["confidences"]),
            "pred_answer_pages": list(out["pred_answer_pages"]), "text": None if text is None else list(text),
            "answers": aux["answers"], "answer_types": aux.get("answer_types"), "times": (ret_t, gen_t),
            "stats": batch_stats}
    parts = mesh.all_gather_object(mine, "data")
    joined = lambda key: None if any(p[key] is None for p in parts) else [x for p in parts for x in p[key]][:n_real]
    out = {k: joined(k) for k in ("pred_answers", "confidences", "pred_answer_pages")}
    out["retrieval"] = {"text": joined("text")}
    aux = {"answers": joined("answers"), "answer_types": joined("answer_types")}
    times = tuple(max(p["times"][i] for p in parts) for i in range(2))
    return out, aux, times, [p["stats"] for p in parts]


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
