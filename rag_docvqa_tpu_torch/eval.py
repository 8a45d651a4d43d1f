"""Evaluation CLI of the PyTorch port.

    python -m rag_docvqa_tpu_torch.eval -m configs/VT5_tiny.yml -d configs/Synthetic.yml \
        [k=v ...] [--split val] [--ckpt DIR] [--save-path FILE] [--sweep] [--device cuda|cpu]

The CLI of the root `eval.py` for RAG-VT5: layered YAML configs and
key=value overrides, random weights from the config's seed (with the
not-answerable classifier from seed + 1 when `use_not_answerable_classifier`
is set), or the latest step of a checkpoint directory the port's trainer
wrote (`--ckpt`), then `engine.evaluate` over the synthetic corpus's split
with the configured page-retrieval strategy (`compute_stats` adds the ingest
statistics). Prints one JSON summary line per config, with the keys of the
root CLI's (accuracy, anls, retrieval_precision, chunk_score, n_samples,
page_retrieval, wall_time), and `--save-path` writes the per-sample scores
(one file per config of a sweep, `<stem>_<i><ext>`). `--sweep` expands the
list-valued keys into the cross product of configs.

`--device` takes the place of `--platform`; the default is cuda, and without
a CUDA device the CLI raises unless `--device cpu` is given. Not ported yet,
and raising: converted HF weights and multi-process ingest (ROADMAP Queue 1
item 18a), data-parallel evaluation (item 17), the Hi-VT5 (item 12) and
causal-LM (item 15) engines, and RAG-Pix2Struct here, whose synthetic page
images wait for item 18a.
"""

from __future__ import annotations

import argparse
import json
import os
import time

SUMMARY_KEYS = ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples")


def main(argv=None):
    parser = argparse.ArgumentParser(description="rag_docvqa_tpu_torch evaluation")
    parser.add_argument("-m", "--model", required=True, help="model config yml")
    parser.add_argument("-d", "--dataset", required=True, help="dataset config yml")
    parser.add_argument("--split", default="val")
    parser.add_argument("--ckpt", default=None, help="checkpoint directory of the port's trainer")
    parser.add_argument("--hf-weights", default=None, help="not ported yet")
    parser.add_argument("--save-path", default=None)
    parser.add_argument("--sweep", action="store_true", help="expand list-valued config keys into a sweep")
    parser.add_argument("--data-parallel", action="store_true", help="not ported yet")
    parser.add_argument("--ingest-workers", type=int, default=0, help="not ported yet: 0 only")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)

    if args.hf_weights:
        raise NotImplementedError("converted HF weights wait for the port of models/loader.py "
                                  "(ROADMAP Queue 1 item 18a)")
    if args.ingest_workers > 0:
        raise NotImplementedError("multi-process ingest (data/ingest_mp.py) waits for ROADMAP Queue 1 item 18a")
    if args.data_parallel:
        raise NotImplementedError("data-parallel evaluation waits for ROADMAP Queue 1 item 17")

    from rag_docvqa_tpu_torch.config import (build_caps, build_chunk_spec, build_engine, build_vt5_config,
                                             expand_sweep, load_config, load_tokenizer)
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.metrics import Evaluator
    from rag_docvqa_tpu_torch.train import build_docs, init_params, parse_overrides, resolve_device

    device = resolve_device(args.device)
    overrides = parse_overrides(args.overrides)
    if args.ckpt:
        overrides["ckpt"] = args.ckpt
    base = load_config(model=args.model, dataset=args.dataset, overrides=overrides)
    configs = list(expand_sweep(base)) if args.sweep else [base]

    results = []
    for run_idx, config in enumerate(configs):
        model_name = str(config.get("model_name", "VT5")).lower()
        if model_name in ("hi-vt5", "hivt5"):
            raise NotImplementedError("the Hi-VT5 engine waits for ROADMAP Queue 1 item 12")
        if model_name in ("qwen", "qwen2", "qwen2.5-vl", "ragqwen"):
            raise NotImplementedError("the causal-LM engines wait for ROADMAP Queue 1 item 15")
        if model_name in ("pix2struct", "ragpix2struct"):
            raise NotImplementedError("RAG-Pix2Struct reads page images, which the synthetic corpus of the port "
                                      "does not draw yet (ROADMAP Queue 1 item 18a)")
        tokenizer = load_tokenizer(config.get("tokenizer"))
        ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
        docs = build_docs(config, args.split)
        if config.get("auto_caps", config.get("dataset_name") == "MMLongBenchDoc"):
            ingestor.caps = ingestor.plan_caps(docs)
        vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
        engine = build_engine(config, init_params(config, vt5_cfg, device, config.get("ckpt")), tokenizer)

        save_path = args.save_path
        if save_path and len(configs) > 1:
            stem, ext = os.path.splitext(save_path)
            save_path = f"{stem}_{run_idx}{ext or '.json'}"
        t0 = time.time()
        out = evaluate(engine, docs, ingestor, Evaluator(), batch_size=config.get("batch_size", 8),
                       save_path=save_path, save_continuously=config.get("save_continuously", False),
                       compute_stats=config.get("compute_stats", False))
        summary = {k: out[k] for k in SUMMARY_KEYS}
        if "mmlongbench" in out:
            summary["mmlongbench"] = out["mmlongbench"]
        summary["page_retrieval"] = str(config.get("page_retrieval", engine.cfg.page_retrieval))
        summary["wall_time"] = round(time.time() - t0, 2)
        print(json.dumps(summary))
        results.append(summary)
    return results


if __name__ == "__main__":
    main()
