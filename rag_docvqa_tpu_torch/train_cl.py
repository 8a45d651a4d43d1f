"""Contrastive retriever fine-tuning CLI of the PyTorch port.

    python -m rag_docvqa_tpu_torch.train_cl mine -m configs/VT5_tiny.yml -d configs/Synthetic.yml \
        --pairs pairs.jsonl [--split train] [--anls-threshold 0.8] [k=v ...] [--device cuda|cpu]
    python -m rag_docvqa_tpu_torch.train_cl train -m configs/VT5_tiny.yml --pairs pairs.jsonl \
        [--out DIR] [--loss mnrl|clip] [k=v ...] [--device cuda|cpu]

The two commands of the root `train_cl.py`. `mine` runs the `anyconf`
strategy (one answer per retrieved chunk) over the synthetic corpus's split
and writes the (question, chunk text) pairs whose chunk's own answer scores
ANLS above the threshold as JSONL lines {"anchor", "positive"}, then prints
one JSON line with the counts. `train` fine-tunes the VT5
shared-table embedder on the (anchor, positive) pairs of a JSONL file with
MultipleNegativesRankingLoss (in-batch InfoNCE at scale 20) or the symmetric
CLIP-style loss, prints one JSON line with the first and last epoch loss, and
with --out saves the tuned table with the port's `CheckpointManager` (one
`step_<n>.pt` in that directory, n the number of epochs).
`--device` takes the place of `--platform`; the default is cuda, and without
a CUDA device the CLI raises unless `--device cpu` is given.

"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="contrastive embedder fine-tune")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_mine = sub.add_parser("mine")
    p_mine.add_argument("-m", "--model", required=True)
    p_mine.add_argument("-d", "--dataset", required=True)
    p_mine.add_argument("--split", default="train")
    p_mine.add_argument("--pairs", required=True)
    p_mine.add_argument("--anls-threshold", type=float, default=0.8)
    p_mine.add_argument("overrides", nargs="*")

    p_train = sub.add_parser("train")
    p_train.add_argument("-m", "--model", required=True)
    p_train.add_argument("--pairs", required=True)
    p_train.add_argument("--out", default=None, help="directory for the tuned embedder table")
    p_train.add_argument("--loss", choices=("mnrl", "clip"), default="mnrl")
    p_train.add_argument("overrides", nargs="*")

    for p in (p_mine, p_train):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    import torch
    from torch import nn

    from rag_docvqa_tpu_torch.config import build_vt5_config, load_config, load_tokenizer
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed
    from rag_docvqa_tpu_torch.models.layers import frozen
    from rag_docvqa_tpu_torch.train import parse_overrides, resolve_device
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
    from rag_docvqa_tpu_torch.training.contrastive import ContrastiveConfig, load_pairs, train_contrastive
    from rag_docvqa_tpu_torch.training.train_step import TrainState

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=getattr(args, "dataset", None),
                         overrides=parse_overrides(args.overrides))
    tokenizer = load_tokenizer(config.get("tokenizer"))
    vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(config["seed"]), vt5_cfg)

    if args.cmd == "mine":
        import dataclasses

        from rag_docvqa_tpu_torch.config import build_caps, build_chunk_spec, build_rag_config
        from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
        from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGVT5Engine
        from rag_docvqa_tpu_torch.train import build_docs
        from rag_docvqa_tpu_torch.training.contrastive import mine_positive_pairs, save_pairs

        # anyconf answers once per retrieved chunk: the mining signal
        rag_cfg = dataclasses.replace(build_rag_config(config), page_retrieval="anyconf")
        engine = RAGVT5Engine(rag_cfg, vt5_cfg, params, tokenizer)
        ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
        docs = build_docs(config, args.split)
        pairs = mine_positive_pairs(engine, docs, ingestor, anls_threshold=args.anls_threshold,
                                    batch_size=config.get("batch_size", 8))
        save_pairs(args.pairs, pairs)
        print(json.dumps({"n_pairs": len(pairs), "n_docs": len(docs), "out": args.pairs}))
        return pairs

    pairs = load_pairs(args.pairs)
    cl_cfg = ContrastiveConfig(
        lr=float(config.get("lr", 2e-5)),
        epochs=config.get("train_epochs", 15),
        batch_size=config.get("batch_size", 32),
        loss=args.loss,
        max_tokens=config.get("embed_tokens", 64),
        seed=config["seed"],
    )
    embedder = nn.Module()
    embedder.shared = frozen(params.t5.shared.detach().clone())
    tuned, losses = train_contrastive(lambda p, ids, mask: vt5_table_embed(p.shared, ids, mask), embedder, tokenizer,
                                      pairs, cl_cfg)
    print(json.dumps({"n_pairs": len(pairs), "loss_first": round(losses[0], 4) if losses else None,
                      "loss_last": round(losses[-1], 4) if losses else None}))
    if args.out:
        CheckpointManager(args.out).save(len(losses), TrainState(params=tuned, opt_state={}, step=len(losses)),
                                         metrics={"loss": losses[-1] if losses else 0.0})
        print(f"embedder saved to {args.out}")
    return tuned


if __name__ == "__main__":
    main()
