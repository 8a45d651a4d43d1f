"""Conversion between the JAX package's parameter trees and the port's modules.

The only module that knows the JAX layouts: dense kernels are (in, out)
there and (out, in) here; the JAX layers are stacked on a leading (L, ...)
axis, here they are one module per layer; the rel-pos tables are
(buckets, H) in both. `from_jax` takes a tree of numpy arrays (or anything
`np.asarray` reads) as `init_vt5_params` or `init_t5_params` build it;
`to_jax` gives back the part of that tree the port holds (not the visual
tower nor the LayoutT5 head, which wait for their slices).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from rag_docvqa_tpu_torch.models.embeddings import SpatialEmbeddings
from rag_docvqa_tpu_torch.models.t5 import (
    T5Attention,
    T5DecoderLayer,
    T5EncoderLayer,
    T5FFN,
    T5Params,
    T5Stack,
)
from rag_docvqa_tpu_torch.models.vt5 import VT5Params

Tree = Dict[str, Any]


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _dense(a, device) -> torch.Tensor:
    """JAX (in, out) kernel -> (out, in)."""
    return _t(np.asarray(a, dtype=np.float32).T, device)


def _attn(tree: Tree, l: int, device) -> T5Attention:
    return T5Attention(*(_dense(tree[n][l], device) for n in ("q", "k", "v", "o")))


def _ffn(tree: Tree, l: int, device) -> T5FFN:
    wo = _dense(tree["wo"][l], device)
    if "wi_0" in tree:
        return T5FFN(wo, wi_0=_dense(tree["wi_0"][l], device), wi_1=_dense(tree["wi_1"][l], device))
    return T5FFN(wo, wi=_dense(tree["wi"][l], device))


def t5_from_jax(tree: Tree, device="cpu") -> T5Params:
    enc, dec = tree["encoder"], tree["decoder"]
    n_enc, n_dec = len(enc["ln0"]), len(dec["ln0"])
    encoder = T5Stack(
        _t(enc["rel_bias"], device),
        [T5EncoderLayer(_t(enc["ln0"][l], device), _t(enc["ln1"][l], device),
                        _attn(enc["attn"], l, device), _ffn(enc["ffn"], l, device))
         for l in range(n_enc)],
        _t(enc["final_ln"], device),
    )
    decoder = T5Stack(
        _t(dec["rel_bias"], device),
        [T5DecoderLayer(_t(dec["ln0"][l], device), _t(dec["ln1"][l], device), _t(dec["ln2"][l], device),
                        _attn(dec["self_attn"], l, device), _attn(dec["cross_attn"], l, device),
                        _ffn(dec["ffn"], l, device))
         for l in range(n_dec)],
        _t(dec["final_ln"], device),
    )
    lm_head = _dense(tree["lm_head"], device) if "lm_head" in tree else None
    return T5Params(_t(tree["shared"], device), encoder, decoder, lm_head)


def from_jax(tree: Tree, device="cpu") -> Union[VT5Params, T5Params]:
    """A VT5 tree ({"t5", "spatial", ...}) -> VT5Params; a T5 tree
    ({"shared", "encoder", "decoder"}) -> T5Params. f32 tensors on
    `device`; cast with `.to(dtype)` afterwards."""
    if "t5" not in tree:
        return t5_from_jax(tree, device)
    sp = tree["spatial"]
    spatial = SpatialEmbeddings(
        _t(sp["x_emb"], device), _t(sp["y_emb"], device), _t(sp["ln_w"], device),
        _t(sp["ln_b"], device), _dense(sp["matcher"]["kernel"], device),
        _t(sp["matcher"]["bias"], device))
    layout_emb = _t(tree["layout_emb"], device) if "layout_emb" in tree else None
    layout_scale = _t(tree["layout_scale"], device) if "layout_scale" in tree else None
    return VT5Params(t5_from_jax(tree["t5"], device), spatial, layout_emb, layout_scale)


# --------------------------------------------------------------------------- #
# back to the JAX layout
# --------------------------------------------------------------------------- #
def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _stack(layers, get) -> np.ndarray:
    return np.stack([get(layer) for layer in layers])


def _attn_tree(layers, name: str) -> Tree:
    return {n: _stack(layers, lambda L: _np(getattr(getattr(L, name), n)).T) for n in ("q", "k", "v", "o")}


def _ffn_tree(layers) -> Tree:
    names = ("wi_0", "wi_1", "wo") if layers[0].ffn.gated else ("wi", "wo")
    return {n: _stack(layers, lambda L: _np(getattr(L.ffn, n)).T) for n in names}


def t5_to_jax(p: T5Params) -> Tree:
    enc, dec = list(p.encoder.layers), list(p.decoder.layers)
    tree: Tree = {
        "shared": _np(p.shared),
        "encoder": {
            "rel_bias": _np(p.encoder.rel_bias),
            "attn": _attn_tree(enc, "attn"),
            "ffn": _ffn_tree(enc),
            "ln0": _stack(enc, lambda L: _np(L.ln0)),
            "ln1": _stack(enc, lambda L: _np(L.ln1)),
            "final_ln": _np(p.encoder.final_ln),
        },
        "decoder": {
            "rel_bias": _np(p.decoder.rel_bias),
            "self_attn": _attn_tree(dec, "self_attn"),
            "cross_attn": _attn_tree(dec, "cross_attn"),
            "ffn": _ffn_tree(dec),
            "ln0": _stack(dec, lambda L: _np(L.ln0)),
            "ln1": _stack(dec, lambda L: _np(L.ln1)),
            "ln2": _stack(dec, lambda L: _np(L.ln2)),
            "final_ln": _np(p.decoder.final_ln),
        },
    }
    if p.lm_head is not None:
        tree["lm_head"] = _np(p.lm_head).T
    return tree


def to_jax(p: Union[VT5Params, T5Params]) -> Tree:
    """The inverse of `from_jax`: a tree of f32 numpy arrays."""
    if isinstance(p, T5Params):
        return t5_to_jax(p)
    sp = p.spatial
    tree: Tree = {
        "t5": t5_to_jax(p.t5),
        "spatial": {
            "x_emb": _np(sp.x_emb), "y_emb": _np(sp.y_emb), "ln_w": _np(sp.ln_w), "ln_b": _np(sp.ln_b),
            "matcher": {"kernel": _np(sp.matcher_w).T, "bias": _np(sp.matcher_b)},
        },
    }
    if p.layout_emb is not None:
        tree["layout_emb"] = _np(p.layout_emb)
    if p.layout_scale is not None:
        tree["layout_scale"] = _np(p.layout_scale)
    return tree
