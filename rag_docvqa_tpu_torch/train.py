"""VT5 training CLI of the PyTorch port.

    python -m rag_docvqa_tpu_torch.train -m configs/VT5_tiny.yml -d configs/Synthetic.yml \
        [k=v ...] [--no-eval-start] [--ckpt DIR] [--device cuda|cpu]

The CLI of the root `train.py` for VT5: layered YAML configs and key=value
overrides, random weights from the config's seed (or the latest step of a
checkpoint directory this trainer wrote), the synthetic planted-fact corpus,
then `Trainer.fit` with per-epoch evaluation. `--device` takes the place of
`--platform`; the default is cuda, and without a CUDA device the CLI raises
unless `--device cpu` is given. Hi-VT5, the
dataset loaders, converted HF weights and synthetic page images are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import ast


def parse_overrides(pairs):
    """key=value overrides; values parse as Python literals when they can
    ("[2,3]" -> list, "0.5" -> float), true/false as booleans."""
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass  # keep as string
        out[k] = v
    return out


def build_docs(config, split):
    if config.get("dataset_name") != "Synthetic":
        raise NotImplementedError("the port trains on the synthetic corpus only; the dataset loaders wait for "
                                  "ROADMAP Queue 1 item 18")
    if config.get("synthetic_images"):
        raise NotImplementedError("synthetic page images feed the visual branch, which serves but does not train yet "
                                  "(training with visual tokens: ROADMAP Queue 1 item 13)")
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus

    n = config.get("n_train_docs", 64) if split == "train" else config.get("n_val_docs", 16)
    return make_corpus(n, n_pages=config.get("n_pages", 4), words_per_page=config.get("words_per_page", 120),
                       seed=0 if split == "train" else 1)


def resolve_device(name: str):
    """The device a CLI runs on: `cuda` needs a CUDA device and raises without
    one, naming the flag; the CPU is used only when asked for."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: this command runs on the GPU by default; "
                           "pass --device cpu to run it on the CPU")
    return torch.device(name)


def init_params(config, vt5_cfg, device, ckpt=None):
    """VT5 weights: random from the config's seed, with the not-answerable
    classifier (from seed + 1) when the config uses one; the latest step of
    a checkpoint directory this trainer wrote overlays them."""
    import torch

    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.models.nac import NACConfig, init_nac_params
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager

    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(config["seed"]), vt5_cfg)
    if config.get("use_not_answerable_classifier", False):
        params.nac = init_nac_params(torch.Generator(device=device).manual_seed(config["seed"] + 1),
                                     NACConfig(emb_dim=vt5_cfg.t5.d_model))
    if ckpt:
        CheckpointManager(ckpt).restore_params(params)
    return params


def main(argv=None):
    parser = argparse.ArgumentParser(description="rag_docvqa_tpu_torch training")
    parser.add_argument("-m", "--model", required=True, help="model config yml")
    parser.add_argument("-d", "--dataset", required=True, help="dataset config yml")
    parser.add_argument("--ckpt", default=None, help="checkpoint directory of this trainer to start from")
    parser.add_argument("--hf-weights", default=None, help="not ported yet")
    parser.add_argument("--no-eval-start", action="store_false", dest="eval_start", default=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)

    from rag_docvqa_tpu_torch.config import (build_caps, build_chunk_spec, build_rag_config, build_vt5_config,
                                             load_config, load_tokenizer)
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.training.logger import RunLogger
    from rag_docvqa_tpu_torch.training.trainer import TrainLoopConfig, Trainer

    if args.hf_weights:
        raise NotImplementedError("converted HF weights wait for the port of models/loader.py "
                                  "(ROADMAP Queue 1 item 18)")
    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=args.dataset, overrides=parse_overrides(args.overrides))
    if str(config.get("model_name", "VT5")).lower() in ("hi-vt5", "hivt5"):
        raise NotImplementedError("Hi-VT5 training waits for ROADMAP Queue 1 item 12")
    tokenizer = load_tokenizer(config.get("tokenizer"))
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
    rag_cfg = build_rag_config(config)
    vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
    params = init_params(config, vt5_cfg, device, args.ckpt)
    loop_cfg = TrainLoopConfig(
        epochs=config.get("train_epochs", 10),
        batch_size=config.get("batch_size", 8),
        lr=float(config.get("lr", 2e-4)),
        warmup_steps=config.get("warmup_iterations", 1000),
        save_dir=config.get("save_dir"),
        eval_start=args.eval_start,
        seed=config["seed"],
        train_metrics_every=config.get("train_metrics_every", 0),
        log_every=config.get("log_every", 10),
        remat=config.get("remat", False),
        use_nac=bool(config.get("use_not_answerable_classifier", False)
                     and config.get("train_not_answerable_classifier", True)),
        nac_loss_weight=float(config.get("nac_loss_weight", 1.0)),
        nac_threshold=float(config.get("not_answerable_threshold", 0.5)),
    )
    logger = RunLogger(name=config.get("experiment_name"), config=config, use_wandb=config.get("use_wandb", False),
                       log_dir=config.get("save_dir"))
    trainer = Trainer(vt5_cfg, rag_cfg, params, tokenizer, ingestor, loop_cfg, logger=logger)
    result = trainer.fit(build_docs(config, "train"), build_docs(config, "val"))
    logger.log({"best_accuracy": result["best"]["accuracy"], "best_epoch": result["best"]["epoch"]})
    logger.finish()
    return result


if __name__ == "__main__":
    main()
