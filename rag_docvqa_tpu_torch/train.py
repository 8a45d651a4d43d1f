"""Training CLI of the PyTorch port (VT5 and Hi-VT5).

    python -m rag_docvqa_tpu_torch.train -m configs/VT5_tiny.yml -d configs/Synthetic.yml \
        [k=v ...] [--no-eval-start] [--ckpt DIR] [--hf-weights DIR] [--device cuda|cpu]

The CLI of the root `train.py`: layered YAML configs and key=value
overrides, random weights from the config's seed, overlaid by the best (else
the latest) step of a checkpoint directory this trainer wrote (`--ckpt`) or
else by a local Hugging Face weight directory converted by
`models/loader.py` (`--hf-weights`; its tokenizer and its config.json's
widths become the config's defaults), the synthetic planted-fact corpus,
the documents of `build_docs` (the synthetic planted-fact corpus with, for
`synthetic_images`, seeded page images drawn as the root `train.py` draws
them, or a dataset from local files through `data/datasets.py`), then
`Trainer.fit` with per-epoch evaluation; `model_name: Hi-VT5` trains
Hi-VT5 (configs/HiVT5_tiny.yml); `remat` (False, True or "layer") is
passed to the train step. `--device` takes the place of `--platform`; the
default is cuda, and without a CUDA device the CLI raises unless `--device
cpu` is given.
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
    """The documents of a split: the synthetic corpus (`dataset_name:
    Synthetic`; train from seed 0, the other splits from seed 1) with, when
    `synthetic_images` is set, one seeded (size, size, 3) uint8 page image a
    page, drawn from `np.random.RandomState(0 | 1)` in document and page
    order (`synthetic_image_size`, default 256): the root `train.py`'s
    images bit for bit. Any other `dataset_name` loads through
    `data/datasets.py::build_dataset` from local files."""
    if config.get("dataset_name") == "Synthetic":
        import numpy as np

        from rag_docvqa_tpu_torch.data.synthetic import make_corpus

        n = config.get("n_train_docs", 64) if split == "train" else config.get("n_val_docs", 16)
        docs = make_corpus(n, n_pages=config.get("n_pages", 4), words_per_page=config.get("words_per_page", 120),
                           seed=0 if split == "train" else 1)
        if config.get("synthetic_images"):
            rng = np.random.RandomState(0 if split == "train" else 1)
            size = config.get("synthetic_image_size", 256)
            for d in docs:
                d.images = [rng.randint(0, 255, (size, size, 3)).astype(np.uint8) for _ in d.words]
        return docs
    from rag_docvqa_tpu_torch.data.datasets import build_dataset

    return list(build_dataset(config, split))


def resolve_device(name: str):
    """The device a CLI runs on: `cuda` needs a CUDA device and raises without
    one, naming the flag; the CPU is used only when asked for."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: this command runs on the GPU by default; "
                           "pass --device cpu to run it on the CPU")
    return torch.device(name)


def hf_defaults(config) -> None:
    """Defaults from a Hugging Face checkpoint directory (`hf_weights`): its
    tokenizer where it ships one, the widths of its config.json, and without
    a shipped tokenizer the hash tokenizer at the checkpoint's vocabulary."""
    import json
    import os

    d = config.get("hf_weights")
    if not d:
        return
    if not config.get("tokenizer") and any(os.path.exists(os.path.join(d, f))
                                           for f in ("tokenizer_config.json", "tokenizer.json", "spiece.model")):
        config["tokenizer"] = d
    cfg_path = os.path.join(d, "config.json")
    if not os.path.exists(cfg_path):
        return
    with open(cfg_path) as f:
        hf = json.load(f)
    text = hf.get("text_config", hf)  # Pix2Struct nests its text widths
    dims = {
        "d_model": text.get("d_model", text.get("hidden_size")),
        "d_kv": text.get("d_kv"),
        "num_heads": text.get("num_heads", text.get("num_attention_heads")),
        "d_ff": text.get("d_ff", text.get("intermediate_size")),
        "num_layers": text.get("num_layers", text.get("num_hidden_layers")),
        "num_decoder_layers": text.get("num_decoder_layers", text.get("num_layers", text.get("num_hidden_layers"))),
        "num_kv_heads": text.get("num_key_value_heads"),
    }
    config.update({k: v for k, v in dims.items() if v is not None})
    vocab = hf.get("vocab_size", hf.get("text_config", {}).get("vocab_size"))
    if vocab and config.get("tokenizer") in (None, "hash"):
        config["tokenizer"] = f"hash:{vocab}"


def init_params(config, model_cfg, device, kind: str = "vt5"):
    """The weights of a `kind` model ("vt5", "hivt5", "pix2struct" or "qwen",
    the causal LM): random from the config's seed (VT5 with the not-answerable classifier,
    from seed + 1, when the config uses one), then overlaid by the best (else
    the latest) step of the checkpoint directory `ckpt` this trainer wrote,
    or else by the local Hugging Face weights `hf_weights`
    (models/loader.py)."""
    import torch

    from rag_docvqa_tpu_torch.models import loader

    g = torch.Generator(device=device).manual_seed(config["seed"])
    if kind == "hivt5":
        from rag_docvqa_tpu_torch.models import hivt5 as hivt5m

        params = hivt5m.init_hivt5_params(g, model_cfg)
    elif kind == "pix2struct":
        from rag_docvqa_tpu_torch.models import pix2struct as p2s

        params = p2s.init_p2s_params(g, model_cfg)
    elif kind == "qwen":
        from rag_docvqa_tpu_torch.models import causal_lm as clm

        params = clm.init_causal_lm_params(g, model_cfg)
    else:
        from rag_docvqa_tpu_torch.models import vt5 as vt5m
        from rag_docvqa_tpu_torch.models.nac import NACConfig, init_nac_params

        params = vt5m.init_vt5_params(g, model_cfg)
        if config.get("use_not_answerable_classifier", False):
            params.nac = init_nac_params(torch.Generator(device=device).manual_seed(config["seed"] + 1),
                                         NACConfig(emb_dim=model_cfg.t5.d_model))
    path = config.get("ckpt") or config.get("hf_weights")
    return loader.load_params_for(kind, path, model_cfg, params) if path else params


def is_hivt5(config) -> bool:
    return str(config.get("model_name", "VT5")).lower() in ("hi-vt5", "hivt5")


def main(argv=None):
    parser = argparse.ArgumentParser(description="rag_docvqa_tpu_torch training")
    parser.add_argument("-m", "--model", required=True, help="model config yml")
    parser.add_argument("-d", "--dataset", required=True, help="dataset config yml")
    parser.add_argument("--ckpt", default=None, help="checkpoint directory of this trainer to start from")
    parser.add_argument("--hf-weights", default=None, help="local Hugging Face checkpoint directory (converted on load)")
    parser.add_argument("--no-eval-start", action="store_false", dest="eval_start", default=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)

    from rag_docvqa_tpu_torch.config import (build_caps, build_chunk_spec, build_hivt5_config, build_rag_config,
                                             build_vt5_config, load_config, load_tokenizer)
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.training.logger import RunLogger
    from rag_docvqa_tpu_torch.training.trainer import TrainLoopConfig, Trainer

    device = resolve_device(args.device)
    overrides = parse_overrides(args.overrides)
    overrides.update(ckpt=args.ckpt, hf_weights=args.hf_weights)
    config = load_config(model=args.model, dataset=args.dataset, overrides=overrides)
    hf_defaults(config)
    tokenizer = load_tokenizer(config.get("tokenizer"))
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
    if is_hivt5(config):
        # oracle / custom page windows are the ingest's; RAGConfig drives only the chunked engines
        rag_cfg, vt5_cfg = RAGConfig(), None
        hivt5_cfg = build_hivt5_config(config, tokenizer.vocab_size)
        params = init_params(config, hivt5_cfg, device, kind="hivt5")
    else:
        rag_cfg, hivt5_cfg = build_rag_config(config), None
        vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
        params = init_params(config, vt5_cfg, device)
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
    trainer = Trainer(vt5_cfg, rag_cfg, params, tokenizer, ingestor, loop_cfg, logger=logger, hivt5_cfg=hivt5_cfg)
    result = trainer.fit(build_docs(config, "train"), build_docs(config, "val"))
    logger.log({"best_accuracy": result["best"]["accuracy"], "best_epoch": result["best"]["epoch"]})
    logger.finish()
    return result


if __name__ == "__main__":
    main()
