"""LoRA SFT CLI of the PyTorch port.

    python -m rag_docvqa_tpu_torch.train_lora -m configs/Qwen_tiny.yml -d configs/Synthetic.yml \
        [--ckpt DIR] [--save-dir DIR] [--device cuda|cpu] [k=v ...]

The CLI of the root `train_lora.py`: the Qwen engine (engine/rag_qwen.py)
builds ChatML SFT batches on the retrieved context, adapters of rank
`lora_rank` (8) on the `lora_targets` projections (q and v) come from
models/lora.py, and each step differentiates the masked-label SFT loss of
the merged model into the adapters only, the base frozen, then takes one
AdamW update (training/optimizer.py: constant `lr`, `weight_decay` 0.0 by
default, no clipping: `optax.adamw`). The base is random from the config's
seed, or the best (else the latest) step of a checkpoint directory the
port's trainer wrote (`--ckpt`); the adapters are drawn from seed + 1.
Each epoch prints `epoch=<e> sft_loss=<mean> wall=<s>s`, and
`--save-dir` (or `save_dir`) writes the adapters with training/checkpoint.py.

The attention of the forward is K2 and of the backward K6 on the card
(models/causal_lm.py). `--device` takes the place of `--platform`; without
a CUDA device the CLI raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="rag_docvqa_tpu_torch LoRA SFT")
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-d", "--dataset", required=True)
    parser.add_argument("--ckpt", default=None, help="checkpoint directory of the port's trainer with the base LM")
    parser.add_argument("--save-dir", default=None, help="where to write the adapters")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.config import (build_caps, build_chunk_spec, build_qwen_config, load_config,
                                             load_tokenizer)
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.rag_qwen import QwenRAGConfig, RAGQwenEngine
    from rag_docvqa_tpu_torch.models import causal_lm as clm
    from rag_docvqa_tpu_torch.models.lora import init_lora, merge_lora
    from rag_docvqa_tpu_torch.train import build_docs, parse_overrides, resolve_device
    from rag_docvqa_tpu_torch.training.optimizer import Optimizer

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=args.dataset, overrides=parse_overrides(args.overrides))
    tokenizer = load_tokenizer(config.get("tokenizer"))
    lm_cfg = build_qwen_config(config, tokenizer.vocab_size)
    rag_cfg = QwenRAGConfig(
        chunk_num=config.get("chunk_num", 10),
        max_prompt_tokens=config.get("max_prompt_tokens", config.get("max_source_length", 512)),
        max_new_tokens=config.get("max_new_tokens", 16),
        answer_max_tokens=config.get("answer_max_tokens", 24),
    )
    params = clm.init_causal_lm_params(torch.Generator(device=device).manual_seed(config["seed"]), lm_cfg)
    if config.get("ckpt") or args.ckpt:
        from rag_docvqa_tpu_torch.models.loader import load_checkpoint_params

        params = load_checkpoint_params(args.ckpt or config["ckpt"], params)
    engine = RAGQwenEngine(rag_cfg, lm_cfg, params, tokenizer)
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))

    lora = init_lora(torch.Generator(device=device).manual_seed(config["seed"] + 1), params,
                     targets=tuple(config.get("lora_targets", ("q", "v"))), rank=config.get("lora_rank", 8))
    opt = Optimizer(lr=float(config.get("lr", 1e-4)), clip_norm=None,
                    weight_decay=float(config.get("weight_decay", 0.0)), constant_lr=True)
    opt_state = opt.init(lora)
    named = dict(lora.named_parameters())

    def step(ids, mask, labels) -> float:
        loss = clm.sft_loss(merge_lora(params, lora), lm_cfg, ids, mask, labels)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        opt.update(named, grads, opt_state)
        return float(loss)

    train_docs = build_docs(config, "train")
    bs = config.get("batch_size", 4)
    epochs = config.get("train_epochs", 1)
    rng = np.random.RandomState(config["seed"])
    t0 = time.time()
    for epoch in range(epochs):
        order = rng.permutation(len(train_docs))
        losses = []
        for start in range(0, len(order) - bs + 1, bs):
            docs = [train_docs[i] for i in order[start: start + bs]]
            batch, aux = ingestor.ingest(docs)
            ids, mask, labels = engine.build_sft_batch(batch, aux, seed=int(rng.randint(1 << 30)))[:3]
            losses.append(step(ids, mask, labels))
        print(f"epoch={epoch} sft_loss={np.mean(losses):.4f} wall={time.time() - t0:.1f}s")

    if args.save_dir or config.get("save_dir"):
        from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
        from rag_docvqa_tpu_torch.training.train_step import TrainState

        out = args.save_dir or config["save_dir"]
        CheckpointManager(out).save(opt_state["count"], TrainState(params=lora, opt_state=opt_state,
                                                                    step=opt_state["count"]))
        print(f"adapters saved to {out}")
    return lora


if __name__ == "__main__":
    main()
