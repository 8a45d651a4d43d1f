"""Checkpoint loading from local files: Hugging Face weight directories and
the port's own training checkpoints.

Counterpart of `rag_docvqa_tpu/models/loader.py` (`read_state_dict`,
`strip_prefix`, `_merge`, `convert_vt5_checkpoint`, `load_vt5_params`,
`load_hivt5_params`, `load_params_for`). A checkpoint is read into a
`{name: np.ndarray}` state dict and converted into the JAX package's tree of
numpy arrays, which is merged over the tree of `params_like` (a port module:
`VT5Params`, `HiVT5Params`, `P2SParams` or `CausalLMParams`) so that the parts the checkpoint
lacks keep their initialisation, as a non-strict `load_state_dict` does; the
result is a module of `params_like`'s kind on its device in its dtype.
Without `params_like` the converted tree itself is returned, as in JAX.

Two differences from the reference. A Hi-VT5 checkpoint's page-retrieval
head lands in `page_head`, the key `page_retrieval_logits` reads; the JAX
loader writes it to `ret_head`, which nothing reads (ROADMAP Queue 3, F7).
And the port reads its own checkpoints (`training/checkpoint.py` files:
the best step, else the latest) where JAX restores Orbax directories.

Nothing here touches the network. `.safetensors` files are read by
`read_safetensors` below (the `safetensors` package is not needed): F32,
F16, BF16 and F64 into f32, the integer and bool types as they are.
`pytorch_model.bin` goes through `torch.load(weights_only=True)` and
`convert.py::torch_state_dict_to_numpy`, every floating tensor as f32, as
the JAX loader reads it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np

# safetensors dtype -> (numpy dtype the bytes hold, numpy dtype returned)
_ST_DTYPES = {
    "F64": (np.float64, np.float32), "F32": (np.float32, np.float32), "F16": (np.float16, np.float32),
    "BF16": (np.uint16, np.float32), "I64": (np.int64, np.int64), "I32": (np.int32, np.int32),
    "I16": (np.int16, np.int16), "I8": (np.int8, np.int8), "U8": (np.uint8, np.uint8), "BOOL": (np.bool_, np.bool_),
}


# --------------------------------------------------------------------------- #
# raw state-dict reading
# --------------------------------------------------------------------------- #
def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A `.safetensors` file: an 8-byte little-endian header length, a JSON
    header {name: {"dtype", "shape", "data_offsets"}} (and "__metadata__"),
    then the raw little-endian tensors. Floats come back as f32 (bf16 by
    widening its 16 bits into the top of an f32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the reader does not take")
        stored, returned = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        a = np.frombuffer(data[begin:end], dtype=np.dtype(stored).newbyteorder("<")).reshape(info["shape"])
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = np.ascontiguousarray(a, dtype=returned)
    return out


def _read_weights_file(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    from rag_docvqa_tpu_torch.models.convert import torch_state_dict_to_numpy

    return torch_state_dict_to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A Hugging Face checkpoint directory (or one weights file) -> {name:
    np.ndarray}: model.safetensors, a sharded model.safetensors.index.json
    (shard by shard), pytorch_model.bin or adapter_model.safetensors."""
    if os.path.isfile(path):
        return _read_weights_file(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint path not found: {path}")
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, np.ndarray] = {}
        for shard in shards:
            out.update(_read_weights_file(os.path.join(path, shard)))
        return out
    for name in ("model.safetensors", "pytorch_model.bin", "adapter_model.safetensors"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return _read_weights_file(p)
    raise FileNotFoundError(f"no weights file (model.safetensors / pytorch_model.bin) in {path}")


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).T)


def _merge(base: Any, update: Any) -> Any:
    """Recursively overlay `update` onto `base` (non-strict load)."""
    if isinstance(base, dict) and isinstance(update, dict):
        out = dict(base)
        for k, v in update.items():
            out[k] = _merge(base[k], v) if k in base else v
        return out
    return update


def _overlay(params_like, converted: Dict[str, Any]):
    """`converted` merged over `params_like`'s tree, back as a module of its
    kind on its device in its dtype; `converted` itself without one."""
    if params_like is None:
        return converted
    from rag_docvqa_tpu_torch import params as P
    from rag_docvqa_tpu_torch.models.causal_lm import CausalLMParams
    from rag_docvqa_tpu_torch.models.hivt5 import HiVT5Params
    from rag_docvqa_tpu_torch.models.pix2struct import P2SParams

    if isinstance(params_like, CausalLMParams):
        return P.causal_lm_from_jax(_merge(P.causal_lm_to_jax(params_like), converted),
                                    params_like.device).to(params_like.embed.dtype)
    if isinstance(params_like, HiVT5Params):
        to_tree, from_tree, shared = P.hivt5_to_jax, P.hivt5_from_jax, params_like.t5.shared
    elif isinstance(params_like, P2SParams):
        to_tree, from_tree, shared = P.p2s_to_jax, P.p2s_from_jax, params_like.text.shared
    else:
        to_tree, from_tree, shared = P.to_jax, P.from_jax, params_like.t5.shared
    return from_tree(_merge(to_tree(params_like), converted), shared.device).to(shared.dtype)


# --------------------------------------------------------------------------- #
# VT5 (rubentito/vt5-base-spdocvqa-style checkpoint)
# --------------------------------------------------------------------------- #
def convert_vt5_checkpoint(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """A VT5 state dict (modules language_backbone / spatial_embedding /
    visual_embedding [/ layout_embedding]) -> the VT5 tree. A bare T5 state
    dict (keys from "shared.weight") yields only the "t5" subtree."""
    from rag_docvqa_tpu_torch.models.convert import convert_t5_state_dict

    out: Dict[str, Any] = {}
    lb = strip_prefix(sd, "language_backbone.")
    if not lb and "shared.weight" in sd:
        lb = sd  # bare T5ForConditionalGeneration checkpoint
    if lb:
        out["t5"] = convert_t5_state_dict(lb, cfg.t5)

    sp = strip_prefix(sd, "spatial_embedding.")
    if sp:
        out["spatial"] = {
            "x_emb": np.asarray(sp["x_position_embeddings.weight"]),
            "y_emb": np.asarray(sp["y_position_embeddings.weight"]),
            "ln_w": np.asarray(sp["LayerNorm.weight"]),
            "ln_b": np.asarray(sp["LayerNorm.bias"]),
            "matcher": {"kernel": _t(sp["spatial_emb_matcher.layers.0.weight"]),
                        "bias": np.asarray(sp["spatial_emb_matcher.layers.0.bias"])},
        }

    vis = strip_prefix(sd, "visual_embedding.")
    if vis and getattr(cfg, "use_visual", False):
        from rag_docvqa_tpu_torch.models.vit import convert_vit_state_dict

        out["visual"] = {
            "vit": convert_vit_state_dict(strip_prefix(vis, "image_model."), cfg.vit),
            "matcher": {"kernel": _t(vis["visual_emb_matcher.layers.0.weight"]),
                        "bias": np.asarray(vis["visual_emb_matcher.layers.0.bias"])},
        }

    # LayoutT5 extras
    if "language_backbone.layout_classifier.weight" in sd:
        out["layout_head"] = {
            "ln_w": np.asarray(sd["language_backbone.layout_norm.weight"]),
            "ln_b": np.asarray(sd["language_backbone.layout_norm.bias"]),
            "kernel": _t(sd["language_backbone.layout_classifier.weight"]),
            "bias": np.asarray(sd["language_backbone.layout_classifier.bias"]),
        }
    if "layout_embedding.weight" in sd:
        out["layout_emb"] = np.asarray(sd["layout_embedding.weight"])
        if "layout_embedding_scale" in sd:
            out["layout_scale"] = np.asarray(sd["layout_embedding_scale"])
    return out


def load_vt5_params(path: str, cfg, params_like=None):
    """Read and convert a VT5 / T5 checkpoint; overlay it onto `params_like`
    (VT5Params) so the parts it lacks keep their initialisation (a
    LayoutT5 checkpoint's layout head lands in `layout_head`)."""
    return _overlay(params_like, convert_vt5_checkpoint(read_state_dict(path), cfg))


# --------------------------------------------------------------------------- #
# Hi-VT5 (rubentito/hivt5-base-mpdocvqa-style checkpoint)
# --------------------------------------------------------------------------- #
def convert_hivt5_checkpoint(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """The VT5 module layout plus the page-retrieval head
    (retrieval_module.page_retrieval.weight / .bias) into "page_head"."""
    out = convert_vt5_checkpoint(sd, cfg)
    rm = strip_prefix(sd, "retrieval_module.")
    if rm:
        key = "page_retrieval.weight" if "page_retrieval.weight" in rm else next(iter(rm))
        bias = key.replace("weight", "bias")
        out["page_head"] = {"kernel": _t(rm[key]),
                            "bias": np.asarray(rm[bias]) if bias in rm else np.zeros(rm[key].shape[0], np.float32)}
    return out


def load_hivt5_params(path: str, cfg, params_like=None):
    """Read and convert a Hi-VT5 checkpoint; overlay it onto `params_like`
    (HiVT5Params)."""
    return _overlay(params_like, convert_hivt5_checkpoint(read_state_dict(path), cfg))


def load_params_for(kind: str, path: str, cfg, params_like=None):
    """Checkpoint load by model kind: vt5 | hivt5 | pix2struct | qwen (an HF
    Qwen2ForCausalLM directory, `convert_qwen2_state_dict`). A directory
    the port's trainer wrote (it holds `checkpoints.json`) is read by
    `load_checkpoint_params` into `params_like` whatever the kind."""
    if os.path.isfile(os.path.join(path, "checkpoints.json")):
        return load_checkpoint_params(path, params_like)
    kind = kind.lower()
    if kind in ("vt5", "layoutt5"):
        return load_vt5_params(path, cfg, params_like)
    if kind in ("hivt5", "hi-vt5"):
        return load_hivt5_params(path, cfg, params_like)
    if kind.startswith("pix2struct"):
        from rag_docvqa_tpu_torch.models.pix2struct import convert_p2s_state_dict

        return _overlay(params_like, convert_p2s_state_dict(read_state_dict(path), cfg))
    if kind.startswith("qwen"):
        from rag_docvqa_tpu_torch.models.causal_lm import convert_qwen2_state_dict

        return _overlay(params_like, convert_qwen2_state_dict(read_state_dict(path), cfg))
    raise ValueError(f"unknown checkpoint kind: {kind}")


# --------------------------------------------------------------------------- #
# the port's own training checkpoints
# --------------------------------------------------------------------------- #
def load_checkpoint_params(path: str, params_like):
    """The parameters of a directory `training/checkpoint.py` wrote, loaded
    into `params_like` in place: the best step, else the latest."""
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager

    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory not found: {path}")
    mgr = CheckpointManager(path)
    step = mgr.best_step()
    return mgr.restore_params(params_like, step if step is not None else mgr.latest_step())
