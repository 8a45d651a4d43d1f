"""Noise-robustness experiment of the PyTorch port (the root
`noise_experiment.py`'s, reference noise_experiment.py).

    python -m rag_docvqa_tpu_torch.noise_experiment -m configs/VT5_tiny.yml -d configs/Synthetic.yml \\
        --noise-pages 0 3 20 --seeds 0 1 [--save-path FILE] [--device cuda|cpu]

Sweeps noise_pages x seeds over the split's documents wrapped in
`NoisePagesWrapper` (the distractor pool drawn from the documents
themselves, mixed in), evaluates RAG-VT5 from the config's seeded weights
over each (`engine/evaluate.py`, caps planned for the noisy documents) and
reports the mean and standard deviation over the seeds of accuracy, ANLS,
retrieval precision and chunk score, and of ANLS and retrieval precision by
each document's own page count (noise_experiment.py:96-175, 272-275). Prints
one JSON line per noise level, as the root CLI does, and `--save-path`
writes the whole result. `--device` takes the place of `--platform`; the
default is cuda, and without a CUDA device the CLI raises unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


class _ListDataset:
    """A list of documents behind the dataset interface NoisePagesWrapper reads."""

    def __init__(self, docs):
        self.docs = docs

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i]

    def __iter__(self):
        return iter(self.docs)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-d", "--dataset", required=True)
    parser.add_argument("--noise-pages", type=int, nargs="+", default=[0, 3, 20])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--split", default="val")
    parser.add_argument("--save-path", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.config import (
        build_caps, build_chunk_spec, build_rag_config, build_vt5_config, load_config, load_tokenizer,
    )
    from rag_docvqa_tpu_torch.data.datasets import NoisePagesWrapper
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGVT5Engine
    from rag_docvqa_tpu_torch.metrics import Evaluator
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.train import build_docs, parse_overrides, resolve_device

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=args.dataset, overrides=parse_overrides(args.overrides))
    tokenizer = load_tokenizer(config.get("tokenizer"))
    vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(config["seed"]), vt5_cfg)
    engine = RAGVT5Engine(build_rag_config(config), vt5_cfg, params, tokenizer)
    base_docs = build_docs(config, args.split)
    # results are broken down by each document's own page count (noise_experiment.py:96-175)
    qid_to_seed_pages = {d.question_id: len(d.words) for d in base_docs}

    results = {}
    for n_noise in args.noise_pages:
        per_seed = defaultdict(list)  # metric -> one value a seed
        by_pages = defaultdict(lambda: defaultdict(list))  # page count -> metric -> values
        for seed in args.seeds:
            noisy = NoisePagesWrapper(_ListDataset(base_docs), noise_pages=n_noise, mix=True, seed=seed)
            docs = [noisy[i] for i in range(len(noisy))]
            # the caps take the pages, chunks and slots the noise adds
            ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
            ingestor.caps = ingestor.plan_caps(docs)
            out = evaluate(engine, docs, ingestor, Evaluator(), batch_size=config.get("batch_size", 8))
            for k in ("accuracy", "anls", "retrieval_precision", "chunk_score"):
                per_seed[k].append(out[k])
            for qid, s in out["scores_by_samples"].items():
                seed_pages = qid_to_seed_pages.get(qid, 0)
                by_pages[seed_pages]["anls"].append(s["anls"])
                by_pages[seed_pages]["retrieval_precision"].append(s["retrieval_precision"])

        results[n_noise] = {k: {"mean": float(np.mean(v)), "std": float(np.std(v))} for k, v in per_seed.items()}
        results[n_noise]["by_seed_pages"] = {
            str(p): {m: {"mean": float(np.mean(vals)), "std": float(np.std(vals))} for m, vals in metrics.items()}
            for p, metrics in by_pages.items()
        }
        print(json.dumps({"noise_pages": n_noise,
                          **{k: results[n_noise][k] for k in ("accuracy", "anls", "retrieval_precision")}}))

    if args.save_path:
        with open(args.save_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
