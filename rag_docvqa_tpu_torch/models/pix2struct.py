"""Pix2Struct: the screenshot-parsing encoder-decoder of the OCR-free engine.

Counterpart of `rag_docvqa_tpu/models/pix2struct.py`: `P2SVisionConfig` and
`Pix2StructConfig` (the same fields, but for the vision tower's `flash_encoder`
switch: the tower has one route here), `init_p2s_params`, `vision_encode`,
`generate`, `forward_train` and `convert_p2s_state_dict` (numpy only; kept
as this package's own copy). The vision encoder takes flattened patches
whose first two columns are 1-based (row, col) ids (ops/patches.py):

  x = patch_projection(patches) + row_emb[row] + col_emb[col]
  layers: pre-RMSNorm attention without scaling or bias, pre-RMSNorm
  gated-GELU MLP; a final RMSNorm.

The text decoder is models/t5.py with no encoder layers, an untied lm_head
and the gated FFN.

The tower's layer is T5-shaped without a rel-pos bias, and it has one path:
a row of at most 1024 patches runs K1's bias-free form
(`fused_t5_layer_parts(bias=None)`), a longer one K13
(`fused_t5_layer_qtiled`), which is where the TPU pickers draw the line at
this width. On the card the two are the same launches (K1's RMSNorm and
GEMMs around K2 with no bias), bf16 or f32; on the CPU each runs its own
plain version. There is no `fused=` switch, no `flash_encoder` route and no
padding of the patch axis to a multiple of 8. Masked keys score -1e9 in
both, so a patch set with no valid token (a padded chunk slot) attends
uniformly, as in the TPU layer kernels; such rows are masked downstream by
`chunk_valid`.

`forward_train` is the teacher-forced loss. Its tower runs every layer
through the hand-written layer backward (`t5_layer_train` with no bias:
K1's bias-free form with `save_x1` forward, K7 with the gated FFN, K8 and K6
without a bias), at every row length: K13 has no backward, so a training
row above QTILED_ABOVE patches takes the same path. JAX trains the tower
through its plain blocks, a softmax that masks at -1e9, which is the value
K1 and K8 use. The decoder is `t5.decode_train`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models.layers import dense, frozen, masked_cross_entropy, normal_init, rms_norm
from rag_docvqa_tpu_torch.ops.decode import greedy_decode
from rag_docvqa_tpu_torch.ops.fused_encoder import (fuse_t5_blocks, fused_t5_layer_parts, fused_t5_layer_qtiled,
                                                    t5_layer_train)

QTILED_ABOVE = 1024  # patches per row above which the layer is K13 (the TPU pickers' line at this width)


@dataclass(frozen=True)
class P2SVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 2048
    patch_dim: int = 768  # 16*16*3
    max_rows: int = 4096
    max_cols: int = 4096
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class Pix2StructConfig:
    vision: P2SVisionConfig = field(default_factory=P2SVisionConfig)
    # the text decoder as a T5Config with 0 encoder layers
    text: t5m.T5Config = field(
        default_factory=lambda: t5m.T5Config(
            vocab_size=50244, d_model=768, d_kv=64, num_heads=12, d_ff=2048,
            num_encoder_layers=0, num_decoder_layers=12, gated_ffn=True,
            tie_word_embeddings=False,
        )
    )


class P2SVision(nn.Module):
    """patch_w (d, patch_dim) and patch_b, row_emb (max_rows, d), col_emb
    (max_cols, d), the layers (T5EncoderLayer with a gated FFN), final_ln."""

    def __init__(self, patch_w, patch_b, row_emb, col_emb, layers, final_ln):
        super().__init__()
        self.patch_w, self.patch_b = frozen(patch_w), frozen(patch_b)
        self.row_emb, self.col_emb = frozen(row_emb), frozen(col_emb)
        self.layers = nn.ModuleList(layers)
        self.final_ln = frozen(final_ln)


class P2SParams(nn.Module):
    def __init__(self, vision: P2SVision, text: t5m.T5Params):
        super().__init__()
        self.vision, self.text = vision, text


def init_p2s_params(generator: torch.Generator, cfg: Pix2StructConfig) -> P2SParams:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions (`init_p2s_params`)."""
    g, v, dev = generator, cfg.vision, generator.device
    d = v.hidden_size
    dk = d // v.num_heads
    inner = v.num_heads * dk
    layers = []
    for _ in range(v.num_layers):
        attn = t5m.T5Attention(q=normal_init(g, (inner, d), (d * dk) ** -0.5), k=normal_init(g, (inner, d), d ** -0.5),
                               v=normal_init(g, (inner, d), d ** -0.5), o=normal_init(g, (d, inner), inner ** -0.5))
        ffn = t5m.T5FFN(normal_init(g, (d, v.d_ff), v.d_ff ** -0.5), wi_0=normal_init(g, (v.d_ff, d), d ** -0.5),
                        wi_1=normal_init(g, (v.d_ff, d), d ** -0.5))
        layers.append(t5m.T5EncoderLayer(torch.ones(d, device=dev), torch.ones(d, device=dev), attn, ffn))
    vision = P2SVision(normal_init(g, (d, v.patch_dim), v.patch_dim ** -0.5), torch.zeros(d, device=dev),
                       normal_init(g, (v.max_rows, d), 0.02), normal_init(g, (v.max_cols, d), 0.02), layers,
                       torch.ones(d, device=dev))
    return P2SParams(vision, t5m.init_t5_params(g, cfg.text))


def vision_encode(params: P2SParams, cfg: Pix2StructConfig, flattened_patches: torch.Tensor,
                  attention_mask: torch.Tensor, train: bool = False) -> torch.Tensor:
    """flattened_patches (B, N, 2 + patch_dim) with the (row, col) ids in
    the first two columns, attention_mask (B, N) bool or 0/1 -> (B, N, d) in
    the parameters' dtype (the patches are cast to it before the
    projection). With train, differentiable through the hand-written layer
    backward at any N."""
    v, p = cfg.vision, params.vision
    rows = flattened_patches[:, :, 0].to(torch.int64).clamp(0, v.max_rows - 1)
    cols = flattened_patches[:, :, 1].to(torch.int64).clamp(0, v.max_cols - 1)
    x = dense(flattened_patches[:, :, 2:].to(p.patch_w.dtype), p.patch_w, p.patch_b)
    x = x + p.row_emb[rows] + p.col_emb[cols]
    key_mask = attention_mask.to(torch.bool)
    if train:
        layer_fn = lambda x, m, l, **kw: t5_layer_train(x, m, None, l, **kw)
    elif x.shape[1] > QTILED_ABOVE:
        layer_fn = fused_t5_layer_qtiled
    else:
        layer_fn = lambda x, m, l, **kw: fused_t5_layer_parts(x, m, None, l, **kw)
    for l in fuse_t5_blocks(p.layers, True):
        x = layer_fn(x, key_mask, l, num_heads=v.num_heads, eps=v.layer_norm_eps, gated=True)
    return rms_norm(x, p.final_ln, v.layer_norm_eps)


def generate(params: P2SParams, cfg: Pix2StructConfig, flattened_patches: torch.Tensor,
             attention_mask: torch.Tensor, max_new_tokens: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode conditioned on the vision encoding; returns (tokens,
    confidence) with the VT5 confidence product."""
    enc = vision_encode(params, cfg, flattened_patches, attention_mask)
    return greedy_decode(params.text, cfg.text, enc, attention_mask.to(torch.bool), max_new_tokens)


def forward_train(params: P2SParams, cfg: Pix2StructConfig, flattened_patches: torch.Tensor,
                  attention_mask: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels (B, Td) with -100 where ignored -> (scalar mean CE over the
    other positions, (B, Td, V) logits): the tower through the layer
    backward, then the teacher-forced decoder over its output."""
    enc = vision_encode(params, cfg, flattened_patches, attention_mask, train=True)
    dec_in = t5m.shift_tokens_right(labels, cfg.text.pad_id, cfg.text.decoder_start_token_id)
    logits = t5m.decode_train(params.text, cfg.text, dec_in, enc, attention_mask.to(torch.bool))
    return masked_cross_entropy(logits, labels, labels != -100), logits


def convert_p2s_state_dict(sd: Dict[str, Any], cfg: Pix2StructConfig) -> Dict[str, Any]:
    """HF Pix2StructForConditionalGeneration.state_dict() -> the JAX
    package's tree of numpy arrays, which `params.p2s_from_jax` turns into
    `P2SParams`."""
    L = cfg.vision.num_layers

    def t(name):
        return np.ascontiguousarray(np.asarray(sd[name]).T)

    def a(name):
        return np.asarray(sd[name])

    def stack(fmt, n, transpose=True):
        mats = [np.asarray(sd[fmt.format(i)]) for i in range(n)]
        if transpose:
            mats = [np.ascontiguousarray(m.T) for m in mats]
        return np.stack(mats)

    e = "encoder.encoder.layer.{}."
    vision = {
        "patch_proj": {"kernel": t("encoder.embeddings.patch_projection.weight"),
                       "bias": a("encoder.embeddings.patch_projection.bias")},
        "row_emb": a("encoder.embeddings.row_embedder.weight"),
        "col_emb": a("encoder.embeddings.column_embedder.weight"),
        "attn": {"q": stack(e + "attention.query.weight", L), "k": stack(e + "attention.key.weight", L),
                 "v": stack(e + "attention.value.weight", L), "o": stack(e + "attention.output.weight", L)},
        "ln0": stack(e + "pre_attention_layer_norm.weight", L, False),
        "ffn": {"wi_0": stack(e + "mlp.wi_0.weight", L), "wi_1": stack(e + "mlp.wi_1.weight", L),
                "wo": stack(e + "mlp.wo.weight", L)},
        "ln1": stack(e + "pre_mlp_layer_norm.weight", L, False),
        "final_ln": a("encoder.layernorm.weight"),
    }

    # text decoder: HF decoder.* names onto a T5 tree
    Ld = cfg.text.num_decoder_layers
    d = "decoder.layer.{}."
    sa, ca = d + "self_attention.attention.", d + "encoder_decoder_attention.attention."
    text = {
        "shared": a("decoder.embed_tokens.weight"),
        "encoder": {},  # no encoder layers
        "decoder": {
            "rel_bias": a("decoder.layer.0.self_attention.attention.relative_attention_bias.weight"),
            "self_attn": {n: stack(sa + f"{hf}.weight", Ld)
                          for n, hf in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "output"))},
            "cross_attn": {n: stack(ca + f"{hf}.weight", Ld)
                           for n, hf in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "output"))},
            "ffn": {n: stack(d + f"mlp.DenseReluDense.{n}.weight", Ld) for n in ("wi_0", "wi_1", "wo")},
            "ln0": stack(d + "self_attention.layer_norm.weight", Ld, False),
            "ln1": stack(d + "encoder_decoder_attention.layer_norm.weight", Ld, False),
            "ln2": stack(d + "mlp.layer_norm.weight", Ld, False),
            "final_ln": a("decoder.final_layer_norm.weight"),
        },
        "lm_head": t("decoder.lm_head.weight"),
    }
    return {"vision": vision, "text": text}
