"""Layered YAML configs -> the port's config dataclasses.

Counterpart of the VT5, Hi-VT5 and Pix2Struct parts of
`rag_docvqa_tpu/config.py`: `load_config` merges the dataset config, the
model config, its `training_parameters` and the CLI overrides in that order,
as there, and the `build_*` helpers map the flat dict onto `RAGConfig`,
`VT5Config` (with the `use_visual` and `visual_*` keys of the DiT tower),
`HiVT5Config`, `Pix2StructConfig`, `CausalLMConfig` (`build_qwen_config`),
`Qwen25VisionConfig` (`build_qwen25_vision_config`),
`ChunkSpec` and `Caps`; `expand_sweep` expands list-valued keys into the
cross product of runs; `build_reranker` is the JAX one, the BERT
cross-encoder and the "gemma" LLM pair reranker (random weights, or a local
weight directory), `build_engine` the VT5, Hi-VT5, Pix2Struct and Qwen
branches of the JAX model registry with its `rerank` key and the not-answerable classifier
(`use_not_answerable_classifier`, `not_answerable_threshold`), and
`load_tokenizer` the hash, byte and local Hugging Face tokenizers.
PyYAML is imported only by `load_yaml`, so the rest of the port runs where
it is not installed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, Optional, Sequence

from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.tokenizer import BaseTokenizer, ByteTokenizer, HashTokenizer, HFTokenizer
from rag_docvqa_tpu_torch.engine.rag_vt5 import STRATEGIES, RAGConfig
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.models.vit import ViTConfig

HIERARCHICAL_MODELS = ("hi-vt5", "hivt5", "hi-lt5", "hi-layoutlmv3")
_CHUNKED = tuple(s for s in STRATEGIES if s not in ("oracle", "none"))


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(model: Optional[str] = None, dataset: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """dataset < model < model's training_parameters < overrides. A dataset
    that is not a .yml path names configs/<name>.yml."""
    model_cfg = dict(load_yaml(model)) if model else {}
    dataset_cfg: Dict[str, Any] = {}
    if dataset:
        dataset_cfg = load_yaml(dataset if dataset.endswith((".yml", ".yaml")) else f"configs/{dataset}.yml")
    training_cfg = model_cfg.pop("training_parameters", {}) or {}
    config = {**dataset_cfg, **model_cfg, **training_cfg}
    config.update({k: v for k, v in (overrides or {}).items() if v is not None})
    config.setdefault("seed", 42)
    config.setdefault("page_retrieval", "concat")
    check_config(config)
    return config


def check_config(config: Dict[str, Any]) -> None:
    """The validity rules of the JAX `check_config`."""
    model_name = str(config.get("model_name", "vt5")).lower()
    pr = str(config.get("page_retrieval", "none")).lower()
    if model_name not in HIERARCHICAL_MODELS and pr == "custom":
        raise ValueError(f'"custom" retrieval is not allowed for {model_name}')
    if model_name in HIERARCHICAL_MODELS and pr in _CHUNKED:
        raise ValueError(f'Hierarchical model {model_name} cannot run "{pr}" retrieval; only "oracle" and '
                         '"custom" are allowed.')


def expand_sweep(config: Dict[str, Any], sweep_keys: Optional[Sequence[str]] = None) -> Iterator[Dict[str, Any]]:
    """One config per combination of the list-valued keys (those in
    `sweep_keys` when given), in `itertools.product` order."""
    keys = [k for k, v in config.items() if isinstance(v, list) and (sweep_keys is None or k in sweep_keys)]
    if not keys:
        yield dict(config)
        return
    for combo in itertools.product(*(config[k] for k in keys)):
        out = dict(config)
        out.update(dict(zip(keys, combo)))
        yield out


def _scalar(v):
    if isinstance(v, (list, tuple)):
        return v[0] if v else 0
    return v


def build_rag_config(c: Dict[str, Any]) -> RAGConfig:
    return RAGConfig(
        page_retrieval=str(c.get("page_retrieval", "concat")).lower(),
        chunk_num=c.get("chunk_num", 10),
        include_surroundings=_scalar(c.get("include_surroundings", 0)),
        sep_token_id=c.get("sep_token_id", 0) if c.get("add_sep_token", False) else 0,
        max_source_length=c.get("max_source_length", 512),
        per_chunk_seq_len=c.get("per_chunk_seq_len", 256),
        max_new_tokens=c.get("max_new_tokens", 100),
        embed_backend=c.get("embed_model", "VT5"),
        use_visual=bool(c.get("use_visual", False)),
        reorder_chunks=bool(c.get("reorder_chunks", False)),
    )


def build_vt5_config(c: Dict[str, Any], vocab_size: int) -> vt5m.VT5Config:
    d = c.get("d_model", 768)
    return vt5m.VT5Config(
        t5=t5m.T5Config(
            vocab_size=vocab_size,
            d_model=d,
            d_kv=c.get("d_kv", 64),
            num_heads=c.get("num_heads", 12),
            d_ff=c.get("d_ff", d * 4),
            num_encoder_layers=c.get("num_layers", 12),
            num_decoder_layers=c.get("num_decoder_layers", c.get("num_layers", 12)),
            dropout_rate=c.get("dropout_rate", 0.1),
            decode_kv_int8=bool(c.get("decode_kv_int8", False)),
        ),
        spatial=SpatialConfig(max_2d_positions=c.get("max_2d_position_embeddings", 1024), hidden_size=d,
                              dropout_rate=c.get("dropout_rate", 0.1)),
        use_layout_labels=c.get("use_layout_labels", "Default"),
        use_visual=bool(c.get("use_visual", False)),
        # `visual_hidden_size` is the one key RAG-VT5's tower reads, as JAX's
        # `build_vt5_config` does: the rest of the tower stays at ViTConfig's defaults
        vit=ViTConfig(hidden_size=c.get("visual_hidden_size", 768)),
    )


def build_p2s_config(c: Dict[str, Any], vocab_size: int):
    from rag_docvqa_tpu_torch.models import pix2struct as p2s

    d = c.get("d_model", 768)
    return p2s.Pix2StructConfig(
        vision=p2s.P2SVisionConfig(hidden_size=d, num_layers=c.get("num_layers", 12),
                                   num_heads=c.get("num_heads", 12), d_ff=c.get("d_ff", d * 4)),
        text=t5m.T5Config(
            vocab_size=vocab_size, d_model=d, d_kv=c.get("d_kv", 64), num_heads=c.get("num_heads", 12),
            d_ff=c.get("d_ff", d * 4), num_encoder_layers=0,
            num_decoder_layers=c.get("num_decoder_layers", c.get("num_layers", 12)),
            dropout_rate=c.get("dropout_rate", 0.0), gated_ffn=True, tie_word_embeddings=False,
            decode_kv_int8=bool(c.get("decode_kv_int8", False)),
        ),
    )


def build_hivt5_config(c: Dict[str, Any], vocab_size: int):
    """Hi-VT5: the VT5 T5 and spatial widths, `page_tokens`, `max_pages` page
    slots, `max_text_tokens` (else `max_source_length`) a page, and the
    per-page ViT of the `visual_*` keys."""
    from rag_docvqa_tpu_torch.models import hivt5 as hivt5m

    base = build_vt5_config(c, vocab_size)
    return hivt5m.HiVT5Config(
        t5=base.t5,
        spatial=base.spatial,
        page_tokens=c.get("page_tokens", 10),
        max_doc_pages=c.get("max_pages", 20) or 20,
        page_seq_len=c.get("max_text_tokens", c.get("max_source_length", 512)),
        retrieval_loss_weight=c.get("retrieval_loss_weight", 0.25),
        use_visual=bool(c.get("use_visual", False)),
        vit=ViTConfig(
            hidden_size=c.get("visual_hidden_size", 768),
            num_layers=c.get("visual_num_layers", 12),
            num_heads=c.get("visual_num_heads", 12),
            mlp_dim=c.get("visual_mlp_dim", 3072),
            patch_size=c.get("visual_patch_size", 16),
            image_size=c.get("visual_image_size", 224),
        ),
    )


def build_chunk_spec(c: Dict[str, Any]) -> ChunkSpec:
    return ChunkSpec(
        chunk_size=c.get("chunk_size", 60),
        chunk_size_tol=c.get("chunk_size_tol", 0.2),
        overlap=c.get("overlap", 10),
        mode="oracle" if str(c.get("page_retrieval", "")).lower() == "oracle" else "fixed",
        cluster_layouts=c.get("cluster_layouts", False),
    )


def build_caps(c: Dict[str, Any]) -> Caps:
    return Caps(
        max_pages=c.get("max_pages", 20) or 20,
        max_chunks=c.get("max_chunks", 128),
        max_slots=c.get("max_slots", 2048),
        tokens_per_word=c.get("tokens_per_word", 8),
        embed_tokens=c.get("embed_tokens", 96),
        question_tokens=c.get("question_tokens", 48),
        prompt_tokens=c.get("prompt_tokens", 64),
    )


def build_reranker(c: Dict[str, Any], tokenizer, seed: int = 0, device="cuda"):
    """The reranker of a config: the `rerank_*` keys and the `reranker_*`
    widths (the JAX defaults), vocabulary the tokenizer's, random weights
    from `seed` on `device`: the card by default, as the CLIs, which raises
    without one; the CPU only when asked for. A weight name with "gemma"
    selects the LLM pair reranker (`FlagLLMReranker`, a Gemma-arch causal LM
    of the `reranker_*` widths with `reranker_num_kv_heads` and
    `reranker_head_dim`; a local directory of that name loads its Hugging Face
    Gemma weights, its config.json giving the widths); any other name the
    BERT / XLM-R cross-encoder, whose local weight directory is read
    likewise (models/loader.py, then `convert_bert_state_dict`)."""
    import os

    import torch

    from rag_docvqa_tpu_torch.engine.reranker import FlagLLMReranker, Reranker, RerankerConfig
    from rag_docvqa_tpu_torch.models.bert import BertConfig, init_bert_params

    rcfg = RerankerConfig(
        filter_thresh=float(c.get("rerank_filter_tresh", 0.4)),
        max_chunk_num=c.get("rerank_max_chunk_num", 5),
        min_chunk_num=c.get("rerank_min_chunk_num", 1),
        pair_len=c.get("rerank_pair_len", 192),
        rerank_on_surroundings=bool(c.get("rerank_on_surroundings", False)),
        include_surroundings=_scalar(c.get("include_surroundings", 0)),
    )
    weights = str(c.get("reranker_weights", "") or "")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('build_reranker: no CUDA device found; the reranker is built on the GPU by default, '
                           'pass device="cpu" to build it on the CPU')
    if "gemma" in weights.lower():
        from rag_docvqa_tpu_torch.models import causal_lm as clm
        from rag_docvqa_tpu_torch.params import causal_lm_from_jax

        lm_cfg = clm.CausalLMConfig(
            vocab_size=tokenizer.vocab_size,
            d_model=c.get("reranker_d_model", 64),
            num_layers=c.get("reranker_num_layers", 2),
            num_heads=c.get("reranker_num_heads", 4),
            num_kv_heads=c.get("reranker_num_kv_heads", 1),
            d_ff=c.get("reranker_d_ff", 128),
            qkv_bias=False,
            arch="gemma",
            head_dim_override=c.get("reranker_head_dim", 0),
        )
        if os.path.isdir(weights):
            import json

            from rag_docvqa_tpu_torch.models.loader import read_state_dict

            cfg_path = os.path.join(weights, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    lm_cfg = clm.gemma_config_from_hf(json.load(f))
            params = causal_lm_from_jax(clm.convert_gemma_state_dict(read_state_dict(weights), lm_cfg), device)
        else:
            params = clm.init_causal_lm_params(torch.Generator(device=device).manual_seed(seed), lm_cfg)
        return FlagLLMReranker(rcfg, lm_cfg, params, tokenizer)
    bert_cfg = BertConfig(
        vocab_size=tokenizer.vocab_size,
        hidden_size=c.get("reranker_d_model", 64),
        num_layers=c.get("reranker_num_layers", 2),
        num_heads=c.get("reranker_num_heads", 4),
        intermediate_size=c.get("reranker_d_ff", 128),
        num_labels=1,
    )
    if weights and os.path.isdir(weights):
        from rag_docvqa_tpu_torch.models.bert import convert_bert_state_dict
        from rag_docvqa_tpu_torch.models.loader import read_state_dict
        from rag_docvqa_tpu_torch.params import bert_from_jax

        sd = read_state_dict(weights)
        # a sequence-classification checkpoint nests its encoder under the model's name
        prefix = next((p for p in ("roberta.", "bert.") if any(k.startswith(p) for k in sd)), "")
        return Reranker(rcfg, bert_cfg, bert_from_jax(convert_bert_state_dict(sd, bert_cfg, prefix), device))
    params = init_bert_params(torch.Generator(device=device).manual_seed(seed), bert_cfg)
    return Reranker(rcfg, bert_cfg, params)


QWEN_MODELS = ("qwen", "qwen2", "qwen2.5-vl", "ragqwen")


def build_qwen_config(c: Dict[str, Any], vocab_size: int):
    """The Qwen engine's causal LM from the JAX keys (`d_model`,
    `num_layers`, `num_heads`, `num_kv_heads`, `d_ff`) and the port's
    `mrope_section` (Qwen2.5-VL's M-RoPE sections; unset, 1-D RoPE as in
    JAX); the rest at the CausalLMConfig defaults (tied head, rope theta
    1e6)."""
    from rag_docvqa_tpu_torch.models.causal_lm import CausalLMConfig

    return CausalLMConfig(
        vocab_size=vocab_size,
        d_model=c.get("d_model", 1024),
        num_layers=c.get("num_layers", 12),
        num_heads=c.get("num_heads", 16),
        num_kv_heads=c.get("num_kv_heads", 4),
        d_ff=c.get("d_ff", 2816),
        mrope_section=tuple(c.get("mrope_section", ())),
    )


def build_qwen25_vision_config(c: Dict[str, Any], out_hidden_size: int):
    """The Qwen2.5-VL tower of a Qwen config: `Qwen25VisionConfig`'s fields
    from the engine dict's `vision` dict (its defaults, Qwen2.5-VL-7B's
    tower, where a field is absent; `image_size` the crop size the engine
    feeds), `out_hidden_size` the language model's width."""
    from rag_docvqa_tpu_torch.models.qwen25_vision import Qwen25VisionConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in (c.get("vision") or {}).items()}
    return Qwen25VisionConfig(**dict(kw, out_hidden_size=out_hidden_size))


def build_engine(c: Dict[str, Any], params, tokenizer):
    """The engine of a config: Hi-VT5 for `model_name: Hi-VT5` (params a
    `HiVT5Params`), RAG-Pix2Struct for `model_name: Pix2Struct` (params a
    `P2SParams`), RAG-Qwen for `model_name: Qwen` (params a `CausalLMParams`;
    with `use_visual` it carries the Qwen2.5-VL tower under `vision`, as
    JAX's tree does under `params["vision"]`, and the tower's config is
    `build_qwen25_vision_config`'s), else RAG-VT5 (params a `VT5Params`), with the
    rerank stage when `rerank` is set (its weights on the parameters' device,
    in their dtype) and the not-answerable classifier when
    `use_not_answerable_classifier` is: the parameters' own `nac`, else one
    initialised from `seed` + 1 (on their device, in their dtype), at
    `not_answerable_threshold`."""
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGVT5Engine

    name = str(c.get("model_name", "VT5")).lower()
    if name in ("hi-vt5", "hivt5"):
        from rag_docvqa_tpu_torch.engine.hivt5_engine import HiVT5Engine

        return HiVT5Engine(build_hivt5_config(c, tokenizer.vocab_size), params, tokenizer,
                           max_new_tokens=c.get("max_new_tokens", 32))
    if name in ("pix2struct", "ragpix2struct"):
        from rag_docvqa_tpu_torch.engine.rag_pix2struct import P2SRAGConfig, RAGPix2StructEngine

        return RAGPix2StructEngine(
            P2SRAGConfig(
                chunk_num=c.get("chunk_num", 10),
                include_surroundings=_scalar(c.get("include_surroundings", 0)),
                chunk_mode=c.get("chunk_mode", "horizontal"),
                max_new_tokens=c.get("max_new_tokens", 32),
                use_rag=c.get("page_retrieval", "concat") != "none",
            ),
            build_p2s_config(c, tokenizer.vocab_size), params, tokenizer)
    if name in QWEN_MODELS:
        from rag_docvqa_tpu_torch.engine.rag_qwen import QwenRAGConfig, RAGQwenEngine

        use_visual = bool(c.get("use_visual", False))
        # the head is tied or not as the parameters are (an untied tree carries `lm_head`)
        lm_cfg = dataclasses.replace(build_qwen_config(c, tokenizer.vocab_size),
                                     tie_word_embeddings=params.lm_head is None)
        vision_cfg = vision_params = None
        if use_visual:
            # F10 (ROADMAP Queue 3): the JAX branch calls build_qwen_vision_config, which the JAX package
            # defines nowhere (NameError there); the port builds the Qwen2.5-VL tower's config itself
            vision_params = getattr(params, "vision", None)
            if vision_params is None:
                raise ValueError("use_visual for the Qwen engine: the parameter tree carries no `vision` tower")
            vision_cfg = build_qwen25_vision_config(c, lm_cfg.d_model)
        return RAGQwenEngine(
            QwenRAGConfig(
                chunk_num=c.get("chunk_num", 10),
                include_surroundings=_scalar(c.get("include_surroundings", 0)),
                max_prompt_tokens=c.get("max_prompt_tokens", c.get("max_source_length", 512)),
                max_new_tokens=c.get("max_new_tokens", 16),
                use_visual=use_visual,
                max_crops=c.get("max_crops", 4),
            ),
            lm_cfg, params, tokenizer, vision_cfg=vision_cfg, vision_params=vision_params)
    if name not in ("vt5", "ragvt5", "rag-vt5"):
        raise NotImplementedError(f"engine {name!r}: the port has RAG-VT5, Hi-VT5, RAG-Pix2Struct and RAG-Qwen")
    shared = params.t5.shared
    reranker = nac = None
    if c.get("rerank", False):
        reranker = build_reranker(c, tokenizer, seed=c.get("seed", 0), device=shared.device)
        reranker.params.to(shared.dtype)
    if c.get("use_not_answerable_classifier", False):
        nac_params = params.nac
        if nac_params is None:
            import torch

            from rag_docvqa_tpu_torch.models.nac import NACConfig, init_nac_params

            g = torch.Generator(device=shared.device).manual_seed(c.get("seed", 0) + 1)
            nac_params = init_nac_params(g, NACConfig(emb_dim=c.get("d_model", 768))).to(shared.dtype)
        nac = (nac_params, float(c.get("not_answerable_threshold", 0.5)))
    return RAGVT5Engine(build_rag_config(c), build_vt5_config(c, tokenizer.vocab_size), params, tokenizer,
                        reranker=reranker, nac=nac)


def load_tokenizer(spec: Optional[str] = None) -> BaseTokenizer:
    """None or "hash" -> HashTokenizer() ("hash:N" sets its vocabulary size),
    "byte" -> ByteTokenizer(), anything else a local Hugging Face tokenizer
    directory (HFTokenizer)."""
    if spec is None or spec == "hash":
        return HashTokenizer()
    if spec.startswith("hash:"):
        return HashTokenizer(vocab_size=int(spec.split(":", 1)[1]))
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
