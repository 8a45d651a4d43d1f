"""Conversion between the JAX package's parameter trees and the port's modules.

The only module that knows the JAX layouts: dense kernels are (in, out)
there and (out, in) here; the JAX layers are stacked on a leading (L, ...)
axis, here they are one module per layer; the rel-pos tables are
(buckets, H) in both. `from_jax` takes a tree of numpy arrays (or anything
`np.asarray` reads) as `init_vt5_params` or `init_t5_params` build it;
`to_jax` gives back the part of that tree the port holds (the `visual`
subtree, ViT and matcher, and the `nac` subtree, the not-answerable
classifier's `mlp` list of {"kernel", "bias"}, included; not the LayoutT5
head, which is not ported yet). `nac_from_jax` / `nac_to_jax` convert the
`nac` subtree alone. `vit_from_jax` / `vit_to_jax` convert a ViT / BEiT tree
(`init_vit_params` or `convert_vit_state_dict`), `p2s_from_jax` /
`p2s_to_jax` a Pix2Struct tree (`init_p2s_params` or
`convert_p2s_state_dict`): the stacked vision tower and the decoder-only T5.
`hivt5_from_jax` / `hivt5_to_jax` a Hi-VT5 tree (`init_hivt5_params` or
`load_hivt5_params`): the T5, the spatial embeddings, `page_emb`,
`page_head` and, when present, the `visual` tower and matcher.
`index_from_numpy` carries a JAX `ShardedIndex`'s arrays into the port's.
`bert_from_jax` / `bert_to_jax` do the same for a BERT tree (`init_bert_params`
or `convert_bert_state_dict`): stacked (L, in, out) kernels <-> per-layer
(out, in), the biases, the two LayerNorm pairs and the classifier head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from rag_docvqa_tpu_torch.models.bert import BertLayer, BertParams
from rag_docvqa_tpu_torch.models.embeddings import SpatialEmbeddings
from rag_docvqa_tpu_torch.models.hivt5 import HiVT5Params, PageHead
from rag_docvqa_tpu_torch.models.nac import NACLayer, NACParams
from rag_docvqa_tpu_torch.models.pix2struct import P2SParams, P2SVision
from rag_docvqa_tpu_torch.models.t5 import (
    T5Attention,
    T5DecoderLayer,
    T5EncoderLayer,
    T5FFN,
    T5Params,
    T5Stack,
)
from rag_docvqa_tpu_torch.models.vit import ViTLayer, ViTParams
from rag_docvqa_tpu_torch.models.vt5 import LayoutHead, VisualParams, VT5Params
from rag_docvqa_tpu_torch.parallel.index import ShardedIndex

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


def _encoder_layers(enc: Tree, device):
    return [T5EncoderLayer(_t(enc["ln0"][l], device), _t(enc["ln1"][l], device),
                           _attn(enc["attn"], l, device), _ffn(enc["ffn"], l, device))
            for l in range(len(enc.get("ln0", ())))]


def t5_from_jax(tree: Tree, device="cpu") -> T5Params:
    """A T5 tree -> T5Params. A decoder-only tree (Pix2Struct's text model:
    "encoder" empty) gets an encoder stack with no layers."""
    enc, dec = tree["encoder"], tree["decoder"]
    n_dec = len(dec["ln0"])
    if enc:
        encoder = T5Stack(_t(enc["rel_bias"], device), _encoder_layers(enc, device), _t(enc["final_ln"], device))
    else:
        d = np.asarray(tree["shared"]).shape[1]
        encoder = T5Stack(torch.zeros((0, 0), device=device), [], torch.ones(d, device=device))
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
    layout_emb = _t(tree["layout_emb"], device) if "layout_emb" in tree else None
    layout_scale = _t(tree["layout_scale"], device) if "layout_scale" in tree else None
    nac = nac_from_jax(tree["nac"], device) if "nac" in tree else None
    head = None
    if "layout_head" in tree:
        h = tree["layout_head"]
        head = LayoutHead(_t(h["ln_w"], device), _t(h["ln_b"], device), _dense(h["kernel"], device),
                          _t(h["bias"], device))
    return VT5Params(t5_from_jax(tree["t5"], device), _spatial_from_jax(tree["spatial"], device), layout_emb,
                     layout_scale, visual=_visual_from_jax(tree, device), nac=nac, layout_head=head)


def _spatial_from_jax(sp: Tree, device) -> SpatialEmbeddings:
    return SpatialEmbeddings(_t(sp["x_emb"], device), _t(sp["y_emb"], device), _t(sp["ln_w"], device),
                             _t(sp["ln_b"], device), _dense(sp["matcher"]["kernel"], device),
                             _t(sp["matcher"]["bias"], device))


def _visual_from_jax(tree: Tree, device) -> Optional[VisualParams]:
    if "visual" not in tree:
        return None
    m = tree["visual"]["matcher"]
    return VisualParams(vit_from_jax(tree["visual"]["vit"], device), _dense(m["kernel"], device),
                        _t(m["bias"], device))


def hivt5_from_jax(tree: Tree, device="cpu") -> HiVT5Params:
    """A JAX Hi-VT5 tree ({"t5", "spatial", "page_emb", "page_head"[,
    "visual"]}) -> HiVT5Params: f32 tensors on `device`."""
    head = tree["page_head"]
    return HiVT5Params(t5_from_jax(tree["t5"], device), _spatial_from_jax(tree["spatial"], device),
                       _t(tree["page_emb"], device), PageHead(_dense(head["kernel"], device), _t(head["bias"], device)),
                       _visual_from_jax(tree, device))


def nac_from_jax(tree: Tree, device="cpu") -> NACParams:
    """A JAX NAC tree ({"mlp": [{"kernel", "bias"}, ...]}) -> NACParams."""
    return NACParams([NACLayer(_dense(l["kernel"], device), _t(l["bias"], device)) for l in tree["mlp"]])


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


def _encoder_tree(enc) -> Tree:
    return {"attn": _attn_tree(enc, "attn"), "ffn": _ffn_tree(enc),
            "ln0": _stack(enc, lambda L: _np(L.ln0)), "ln1": _stack(enc, lambda L: _np(L.ln1))}


def t5_to_jax(p: T5Params) -> Tree:
    enc, dec = list(p.encoder.layers), list(p.decoder.layers)
    tree: Tree = {
        "shared": _np(p.shared),
        # a decoder-only model (Pix2Struct's text part) has no encoder layers
        "encoder": {"rel_bias": _np(p.encoder.rel_bias), **(_encoder_tree(enc) if enc else {}),
                    "final_ln": _np(p.encoder.final_ln)},
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
    tree = _text_tree(p)
    if p.layout_emb is not None:
        tree["layout_emb"] = _np(p.layout_emb)
    if p.layout_scale is not None:
        tree["layout_scale"] = _np(p.layout_scale)
    if p.nac is not None:
        tree["nac"] = nac_to_jax(p.nac)
    if p.layout_head is not None:
        h = p.layout_head
        tree["layout_head"] = {"ln_w": _np(h.ln_w), "ln_b": _np(h.ln_b), "kernel": _np(h.weight).T,
                               "bias": _np(h.bias)}
    return tree


def _text_tree(p: Union[VT5Params, HiVT5Params]) -> Tree:
    """The "t5", "spatial" and (when present) "visual" subtrees."""
    sp = p.spatial
    tree: Tree = {
        "t5": t5_to_jax(p.t5),
        "spatial": {
            "x_emb": _np(sp.x_emb), "y_emb": _np(sp.y_emb), "ln_w": _np(sp.ln_w), "ln_b": _np(sp.ln_b),
            "matcher": {"kernel": _np(sp.matcher_w).T, "bias": _np(sp.matcher_b)},
        },
    }
    if p.visual is not None:
        tree["visual"] = {"vit": vit_to_jax(p.visual.vit),
                          "matcher": {"kernel": _np(p.visual.matcher_w).T, "bias": _np(p.visual.matcher_b)}}
    return tree


def hivt5_to_jax(p: HiVT5Params) -> Tree:
    """The inverse of `hivt5_from_jax`: a tree of f32 numpy arrays."""
    tree = _text_tree(p)
    tree["page_emb"] = _np(p.page_emb)
    tree["page_head"] = {"kernel": _np(p.page_head.weight).T, "bias": _np(p.page_head.bias)}
    return tree


def nac_to_jax(p: NACParams) -> Tree:
    return {"mlp": [{"kernel": _np(l.weight).T, "bias": _np(l.bias)} for l in p.mlp]}


# --------------------------------------------------------------------------- #
# ViT / BEiT
# --------------------------------------------------------------------------- #
_VIT_DENSE = ("q", "k", "v", "o", "fc1", "fc2")
_VIT_VECTORS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")
_VIT_OPTIONAL = ("rel_bias_table", "lambda_1", "lambda_2")


def vit_from_jax(tree: Tree, device="cpu") -> ViTParams:
    """A JAX ViT / BEiT tree -> ViTParams: f32 tensors on `device`."""
    blocks = tree["blocks"]
    layers = []
    for l in range(len(blocks["ln1_w"])):
        t = {n: _t(blocks[n][l], device) for n in _VIT_VECTORS}
        for n in _VIT_DENSE:
            t[f"{n}_w"] = _dense(blocks[n]["kernel"][l], device)
            t[f"{n}_b"] = _t(blocks[n]["bias"][l], device) if "bias" in blocks[n] else None
        for n in _VIT_OPTIONAL:
            t[n] = _t(blocks[n][l], device) if n in blocks else None
        layers.append(ViTLayer(**t))
    pe = tree["patch_embed"]
    pos = _t(tree["pos_embed"], device) if "pos_embed" in tree else None
    return ViTParams(_dense(pe["kernel"], device), _t(pe["bias"], device), _t(tree["cls_token"], device), pos,
                     layers, _t(tree["final_ln_w"], device), _t(tree["final_ln_b"], device))


def vit_to_jax(p: ViTParams) -> Tree:
    """The inverse of `vit_from_jax`: a tree of f32 numpy arrays."""
    layers = list(p.layers)
    blocks: Tree = {n: _stack(layers, lambda L: _np(getattr(L, n))) for n in _VIT_VECTORS}
    for n in _VIT_DENSE:
        blocks[n] = {"kernel": _stack(layers, lambda L: _np(getattr(L, f"{n}_w")).T)}
        if getattr(layers[0], f"{n}_b") is not None:
            blocks[n]["bias"] = _stack(layers, lambda L: _np(getattr(L, f"{n}_b")))
    for n in _VIT_OPTIONAL:
        if getattr(layers[0], n) is not None:
            blocks[n] = _stack(layers, lambda L: _np(getattr(L, n)))
    tree: Tree = {"patch_embed": {"kernel": _np(p.patch_w).T, "bias": _np(p.patch_b)},
                  "cls_token": _np(p.cls_token), "blocks": blocks,
                  "final_ln_w": _np(p.final_ln_w), "final_ln_b": _np(p.final_ln_b)}
    if p.pos_embed is not None:
        tree["pos_embed"] = _np(p.pos_embed)
    return tree


# --------------------------------------------------------------------------- #
# Pix2Struct
# --------------------------------------------------------------------------- #
def p2s_from_jax(tree: Tree, device="cpu") -> P2SParams:
    """A JAX Pix2Struct tree ({"vision", "text"}) -> P2SParams: f32 tensors
    on `device`; cast with `.to(dtype)` afterwards."""
    v = tree["vision"]
    vision = P2SVision(_dense(v["patch_proj"]["kernel"], device), _t(v["patch_proj"]["bias"], device),
                       _t(v["row_emb"], device), _t(v["col_emb"], device), _encoder_layers(v, device),
                       _t(v["final_ln"], device))
    return P2SParams(vision, t5_from_jax(tree["text"], device))


def p2s_to_jax(p: P2SParams) -> Tree:
    """The inverse of `p2s_from_jax`: a tree of f32 numpy arrays."""
    v = p.vision
    return {"vision": {"patch_proj": {"kernel": _np(v.patch_w).T, "bias": _np(v.patch_b)},
                       "row_emb": _np(v.row_emb), "col_emb": _np(v.col_emb), **_encoder_tree(list(v.layers)),
                       "final_ln": _np(v.final_ln)},
            "text": t5_to_jax(p.text)}


# --------------------------------------------------------------------------- #
# BERT
# --------------------------------------------------------------------------- #
_BERT_DENSE = ("q", "k", "v", "o", "fc1", "fc2")
_BERT_LN = ("attn_ln_w", "attn_ln_b", "out_ln_w", "out_ln_b")


def bert_from_jax(tree: Tree, device="cpu") -> BertParams:
    """A JAX BERT tree -> BertParams: f32 tensors on `device`; cast with
    `.to(dtype)` afterwards."""
    blocks = tree["blocks"]
    layers = []
    for l in range(len(blocks["attn_ln_w"])):
        t = {n: _t(blocks[n][l], device) for n in _BERT_LN}
        for n in _BERT_DENSE:
            t[f"{n}_w"], t[f"{n}_b"] = _dense(blocks[n]["kernel"][l], device), _t(blocks[n]["bias"][l], device)
        layers.append(BertLayer(**t))
    head = {}
    if "cls_dense" in tree:
        for n in ("cls_dense", "cls_out"):
            head[f"{n}_w"], head[f"{n}_b"] = _dense(tree[n]["kernel"], device), _t(tree[n]["bias"], device)
    return BertParams(*(_t(tree[n], device) for n in ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b")),
                      layers, **head)


def bert_to_jax(p: BertParams) -> Tree:
    """The inverse of `bert_from_jax`: a tree of f32 numpy arrays."""
    layers = list(p.layers)
    blocks: Tree = {n: _stack(layers, lambda L: _np(getattr(L, n))) for n in _BERT_LN}
    for n in _BERT_DENSE:
        blocks[n] = {"kernel": _stack(layers, lambda L: _np(getattr(L, f"{n}_w")).T),
                     "bias": _stack(layers, lambda L: _np(getattr(L, f"{n}_b")))}
    tree: Tree = {n: _np(getattr(p, n)) for n in ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b")}
    tree["blocks"] = blocks
    if p.has_head:
        for n in ("cls_dense", "cls_out"):
            tree[n] = {"kernel": _np(getattr(p, f"{n}_w")).T, "bias": _np(getattr(p, f"{n}_b"))}
    return tree


# --------------------------------------------------------------------------- #
# the corpus index
# --------------------------------------------------------------------------- #
def index_from_numpy(embeddings, scales=None, *, n_valid: int, dtype: str = "f32", n_shards: int = 1,
                     tile_n: int = 512, packed: Optional[bool] = None, host_rows=None, refine_kprime: int = 48,
                     use_kernel: bool = True, kernel: str = "merge", device="cpu") -> ShardedIndex:
    """The arrays of a built JAX `ShardedIndex`, as numpy, -> the port's.

    `embeddings` is its padded (N_pad, D) matrix (already normalized; int8
    values or packed nibbles in the quantized modes, where `scales` is its
    (N_pad, 1) f32 array), `host_rows` its normalized host copy when it was
    built with `refine=True`. bf16 rows may come as f32 numpy (numpy has no
    bf16): `dtype="bf16"` casts them back, which is exact. Nothing is
    quantized again, so both packages query one and the same index."""
    if dtype not in ("f32", "bf16", "int8", "int4"):
        raise ValueError(f"unknown index dtype {dtype!r}")
    emb = torch.from_numpy(np.ascontiguousarray(embeddings)).to(device)
    if dtype in ("int8", "int4"):
        if scales is None or emb.dtype != torch.int8:
            raise ValueError(f"a {dtype} index needs int8 rows and their scales")
        sc = torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)).to(device)
        return ShardedIndex(embeddings=emb, scales=sc, n_valid=int(n_valid), n_shards=n_shards, tile_n=tile_n,
                            use_kernel=False, packed=dtype == "int4" if packed is None else packed,
                            host_rows=None if host_rows is None else np.asarray(host_rows),
                            refine_kprime=refine_kprime)
    emb = emb.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return ShardedIndex(embeddings=emb, n_valid=int(n_valid), n_shards=n_shards, tile_n=tile_n,
                        use_kernel=use_kernel, kernel=kernel)
