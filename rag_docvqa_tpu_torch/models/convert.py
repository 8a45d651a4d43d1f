"""Hugging Face T5 state dict -> the JAX package's T5 tree of numpy arrays.

A jax-free copy of `rag_docvqa_tpu/models/convert.py` (`convert_t5_state_dict`,
`torch_state_dict_to_numpy`): pure numpy, so a `{name: np.ndarray}` state dict
from `models/loader.py::read_state_dict` converts without torch. The tree
keeps the JAX layout (per-layer weights stacked on a leading L axis, dense
kernels (in, out)); `params.t5_from_jax` turns it into `T5Params`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(x: np.ndarray) -> np.ndarray:
    """torch Linear stores (out, in); the tree holds (in, out)."""
    return np.ascontiguousarray(np.asarray(x).T)


def _stack(sd: Dict[str, np.ndarray], fmt: str, n: int, transpose: bool = True) -> np.ndarray:
    mats = [sd[fmt.format(i)] for i in range(n)]
    return np.stack([_t(m) for m in mats] if transpose else [np.asarray(m) for m in mats])


def convert_t5_state_dict(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """`T5ForConditionalGeneration.state_dict()` (as numpy) -> the T5 tree;
    `cfg` a T5Config (layer counts, `gated_ffn`, `tie_word_embeddings`)."""
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    e = "encoder.block.{}.layer."
    d = "decoder.block.{}.layer."

    def ffn(prefix_fmt: str, layer_idx_of_ffn: int, n: int) -> Dict:
        base = prefix_fmt + f"{layer_idx_of_ffn}.DenseReluDense."
        names = ("wi_0", "wi_1", "wo") if cfg.gated_ffn else ("wi", "wo")
        return {name: _stack(sd, base + f"{name}.weight", n) for name in names}

    def attn(base: str, n: int) -> Dict:
        return {name: _stack(sd, base + f"{name}.weight", n) for name in ("q", "k", "v", "o")}

    params = {
        "shared": np.asarray(sd["shared.weight"]),
        "encoder": {
            "rel_bias": np.asarray(sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]),
            "attn": attn(e + "0.SelfAttention.", Le),
            "ffn": ffn(e, 1, Le),
            "ln0": _stack(sd, e + "0.layer_norm.weight", Le, transpose=False),
            "ln1": _stack(sd, e + "1.layer_norm.weight", Le, transpose=False),
            "final_ln": np.asarray(sd["encoder.final_layer_norm.weight"]),
        },
        "decoder": {
            "rel_bias": np.asarray(sd["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]),
            "self_attn": attn(d + "0.SelfAttention.", Ld),
            "cross_attn": attn(d + "1.EncDecAttention.", Ld),
            "ffn": ffn(d, 2, Ld),
            "ln0": _stack(sd, d + "0.layer_norm.weight", Ld, transpose=False),
            "ln1": _stack(sd, d + "1.layer_norm.weight", Ld, transpose=False),
            "ln2": _stack(sd, d + "2.layer_norm.weight", Ld, transpose=False),
            "final_ln": np.asarray(sd["decoder.final_layer_norm.weight"]),
        },
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = _t(sd["lm_head.weight"])
    return params


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """A mapping of torch tensors (a module's `state_dict()`, or what
    `torch.load` gives) as numpy arrays on the host; floating tensors as f32
    (numpy has no bf16), the others in their own type."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().numpy()
            for k, v in state_dict.items()}
