"""Evaluation CLI of the PyTorch port.

    python -m rag_docvqa_tpu_torch.eval -m configs/VT5_tiny.yml -d configs/Synthetic.yml \
        [k=v ...] [--split val] [--ckpt DIR] [--hf-weights DIR] [--save-path FILE] [--sweep] [--device cuda|cpu]

The CLI of the root `eval.py` for RAG-VT5, Hi-VT5 (`model_name: Hi-VT5`,
configs/HiVT5_tiny.yml) and RAG-Pix2Struct (`model_name: Pix2Struct`,
configs/Pix2Struct_tiny.yml): layered YAML configs and key=value overrides,
random weights from the config's seed (with the not-answerable classifier
from seed + 1 when `use_not_answerable_classifier` is set), overlaid by the
best (else the latest) step of a checkpoint directory the port's trainer
wrote (`--ckpt`) or else by a local Hugging Face weight directory
(`--hf-weights`, `models/loader.py`; its tokenizer and widths become the
config's defaults), then `engine.evaluate` over the split's documents
(`train.build_docs`: the synthetic corpus, with seeded page images for
`synthetic_images`, or a dataset from local files, e.g. `-d
configs/MP-DocVQA.yml imdb_dir=... images_dir=... use_images=true`) with the
configured page-retrieval strategy (`compute_stats` adds the ingest
statistics). The page images feed RAG-Pix2Struct, Hi-VT5's per-page visual
branch and RAG-VT5's `use_visual`. `--ingest-workers N` ingests through
`data/ingest_mp.py::MPIngestor`, N spawned worker processes, closed at the
end of each run. Prints one JSON summary line per config, with the keys of
the root CLI's (accuracy, anls, retrieval_precision, chunk_score, n_samples,
page_retrieval, wall_time), and `--save-path` writes the per-sample scores
(one file per config of a sweep, `<stem>_<i><ext>`). `--sweep` expands the
list-valued keys into the cross product of configs.

`--device` takes the place of `--platform`; the default is cuda, and without
a CUDA device the CLI raises unless `--device cpu` is given. Not ported yet,
and raising: data-parallel evaluation (ROADMAP Queue 1 item 17) and the
causal-LM engines (item 15).
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
    parser.add_argument("--hf-weights", default=None, help="local Hugging Face checkpoint directory (converted on load)")
    parser.add_argument("--save-path", default=None)
    parser.add_argument("--sweep", action="store_true", help="expand list-valued config keys into a sweep")
    parser.add_argument("--data-parallel", action="store_true", help="not ported yet")
    parser.add_argument("--ingest-workers", type=int, default=0,
                        help="shard host ingest over N worker processes (data/ingest_mp.py); 0 = in-process")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError("data-parallel evaluation waits for ROADMAP Queue 1 item 17")

    from rag_docvqa_tpu_torch.config import (build_caps, build_chunk_spec, build_engine, build_hivt5_config,
                                             build_p2s_config, build_vt5_config, expand_sweep, load_config,
                                             load_tokenizer)
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.metrics import Evaluator
    from rag_docvqa_tpu_torch.train import (build_docs, hf_defaults, init_params, is_hivt5, parse_overrides,
                                            resolve_device)

    device = resolve_device(args.device)
    overrides = parse_overrides(args.overrides)
    overrides.update(ckpt=args.ckpt, hf_weights=args.hf_weights)
    base = load_config(model=args.model, dataset=args.dataset, overrides=overrides)
    configs = list(expand_sweep(base)) if args.sweep else [base]

    results = []
    for run_idx, config in enumerate(configs):
        model_name = str(config.get("model_name", "VT5")).lower()
        if model_name in ("qwen", "qwen2", "qwen2.5-vl", "ragqwen"):
            raise NotImplementedError("the causal-LM engines wait for ROADMAP Queue 1 item 15")
        hf_defaults(config)
        tokenizer = load_tokenizer(config.get("tokenizer"))
        if args.ingest_workers > 0:
            from rag_docvqa_tpu_torch.data.ingest_mp import MPIngestor

            ingestor = MPIngestor(tokenizer, build_chunk_spec(config), build_caps(config),
                                  num_workers=args.ingest_workers)
        else:
            ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
        docs = build_docs(config, args.split)
        if config.get("auto_caps", config.get("dataset_name") == "MMLongBenchDoc"):
            ingestor.caps = ingestor.plan_caps(docs)
        if is_hivt5(config):
            params = init_params(config, build_hivt5_config(config, tokenizer.vocab_size), device, kind="hivt5")
        elif model_name in ("pix2struct", "ragpix2struct"):
            params = init_params(config, build_p2s_config(config, tokenizer.vocab_size), device, kind="pix2struct")
        else:
            params = init_params(config, build_vt5_config(config, tokenizer.vocab_size), device)
        engine = build_engine(config, params, tokenizer)

        save_path = args.save_path
        if save_path and len(configs) > 1:
            stem, ext = os.path.splitext(save_path)
            save_path = f"{stem}_{run_idx}{ext or '.json'}"
        t0 = time.time()
        try:
            out = evaluate(engine, docs, ingestor, Evaluator(), batch_size=config.get("batch_size", 8),
                           save_path=save_path, save_continuously=config.get("save_continuously", False),
                           compute_stats=config.get("compute_stats", False))
        finally:
            if hasattr(ingestor, "close"):  # MPIngestor: shut the worker pool down
                ingestor.close()
        summary = {k: out[k] for k in SUMMARY_KEYS}
        if "mmlongbench" in out:
            summary["mmlongbench"] = out["mmlongbench"]
        summary["page_retrieval"] = str(config["page_retrieval"])
        summary["wall_time"] = round(time.time() - t0, 2)
        print(json.dumps(summary))
        results.append(summary)
    return results


if __name__ == "__main__":
    main()
