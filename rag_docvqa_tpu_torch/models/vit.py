"""ViT / BEiT image encoder: the DiT visual tower of VT5.

Counterpart of `rag_docvqa_tpu/models/vit.py`: `ViTConfig` (the same
fields), `init_vit_params`, `beit_relative_position_index`,
`extract_patches`, `vit_encode` and `convert_vit_state_dict` (numpy only;
kept as this package's own copy). A page image becomes 1 + (image/patch)^2
tokens, 197 at 224 px. Parameters are `nn.Module`s holding per-layer
tensors, dense weights (out, in), created frozen.

The layer stack has one path: every layer through K14
(ops/fused_encoder.py::fused_vit_layer_parts), for `return_hidden_states`
too, which collects the same layers' outputs (the JAX package runs its XLA
blocks for that, and for the backward; the port has no ViT training yet).
There is no `fused=` switch, no eligibility gate and no padding of T to a
multiple of 8. The patch projection, the CLS token, the position embeddings
and the final LayerNorm are outside the TPU kernel and plain here as well.
The BEiT rel-pos bias is gathered per layer and cast to bf16 for every
compute dtype, as `fuse_vit_blocks` does for the TPU kernel (its XLA blocks
keep the table's dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from rag_docvqa_tpu_torch.models.layers import dense, frozen, layer_norm, normal_init
from rag_docvqa_tpu_torch.ops.fused_encoder import fuse_vit_blocks, fused_vit_layer_parts


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    layer_norm_eps: float = 1e-12
    # BEiT options (the DiT backbone is BEiT: no key bias, a per-layer
    # relative position bias, layer-scale residuals, optional abs-pos)
    arch: str = "vit"  # "vit" | "beit"
    use_abs_pos: bool = True
    use_rel_pos_bias: bool = False
    layer_scale_init: float = 0.0  # > 0 enables lambda_1/lambda_2
    use_final_layernorm: bool = True  # BEiT with mean pooling has none

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def num_relative_distance(self) -> int:
        g = self.grid
        return (2 * g - 1) * (2 * g - 1) + 3


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
LAYER_FIELDS = ("ln1_w", "ln1_b", "q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b", "ln2_w", "ln2_b",
                "fc1_w", "fc1_b", "fc2_w", "fc2_b")
OPTIONAL_LAYER_FIELDS = ("k_b", "rel_bias_table", "lambda_1", "lambda_2")


class ViTLayer(nn.Module):
    """q/k/v/o (d, d) with biases (no k bias in BEiT), the two LayerNorms,
    fc1 (mlp, d), fc2 (d, mlp); BEiT's rel_bias_table (n_dist, H) and
    lambda_1/lambda_2 (d,) where the config has them, else None."""

    def __init__(self, **tensors):
        super().__init__()
        for name in LAYER_FIELDS:
            setattr(self, name, frozen(tensors[name]))
        for name in OPTIONAL_LAYER_FIELDS:
            t = tensors.get(name)
            setattr(self, name, None if t is None else frozen(t))


class ViTParams(nn.Module):
    """patch_w (d, patch*patch*3) and patch_b, cls_token (1, 1, d), pos_embed
    (1, 1 + N, d) or None, the layers, the final LayerNorm."""

    def __init__(self, patch_w, patch_b, cls_token, pos_embed, layers, final_ln_w, final_ln_b):
        super().__init__()
        self.patch_w, self.patch_b, self.cls_token = frozen(patch_w), frozen(patch_b), frozen(cls_token)
        self.pos_embed = None if pos_embed is None else frozen(pos_embed)
        self.layers = nn.ModuleList(layers)
        self.final_ln_w, self.final_ln_b = frozen(final_ln_w), frozen(final_ln_b)


def init_vit_params(generator: torch.Generator, cfg: ViTConfig) -> ViTParams:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions (`init_vit_params`): N(0, 1/fan_in) kernels, zero biases,
    N(0, 0.02^2) CLS and position embeddings, a zero rel-pos table."""
    g, d, dev = generator, cfg.hidden_size, generator.device
    zeros = lambda *s: torch.zeros(s, device=dev)
    ones = lambda *s: torch.ones(s, device=dev)
    lin = lambda dout, din: (normal_init(g, (dout, din), din ** -0.5), zeros(dout))
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    beit = cfg.arch == "beit"
    layers = []
    for _ in range(cfg.num_layers):
        t: Dict[str, Any] = dict(ln1_w=ones(d), ln1_b=zeros(d), ln2_w=ones(d), ln2_b=zeros(d))
        for name, (dout, din) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                                  ("fc1", (cfg.mlp_dim, d)), ("fc2", (d, cfg.mlp_dim))):
            t[f"{name}_w"], t[f"{name}_b"] = lin(dout, din)
        if beit:
            t["k_b"] = None
            if cfg.use_rel_pos_bias:
                t["rel_bias_table"] = zeros(cfg.num_relative_distance, cfg.num_heads)
            if cfg.layer_scale_init > 0:
                t["lambda_1"], t["lambda_2"] = (torch.full((d,), cfg.layer_scale_init, device=dev) for _ in range(2))
        layers.append(ViTLayer(**t))
    patch_w, patch_b = lin(d, patch_dim)
    pos = normal_init(g, (1, cfg.seq_len, d), 0.02) if cfg.use_abs_pos else None
    return ViTParams(patch_w, patch_b, normal_init(g, (1, 1, d), 0.02), pos, layers, ones(d), zeros(d))


def beit_relative_position_index(grid: int) -> np.ndarray:
    """The relative position index with the CLS specials (HF
    BeitRelativePositionBias): (1 + grid^2, 1 + grid^2) int32."""
    num_rel = (2 * grid - 1) * (2 * grid - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    n = grid * grid
    index = np.zeros((n + 1, n + 1), np.int32)
    index[1:, 1:] = rel.sum(-1)
    index[0, :] = num_rel - 3
    index[:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


def extract_patches(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, patch*patch*3): patches in row-major order,
    each flattened (kh, kw, c)."""
    B, H, W, C = pixels.shape
    h, w = H // patch, W // patch
    x = pixels.reshape(B, h, patch, w, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * w, patch * patch * C)


def vit_encode(params: ViTParams, cfg: ViTConfig, pixels: torch.Tensor, return_hidden_states: bool = False):
    """(B, H, W, 3) normalized pixels -> (B, 1 + N, d) hidden states in the
    parameters' dtype (the pixels are cast to it before the patch
    projection). With return_hidden_states, also the raw output of every
    layer, (L, B, 1 + N, d)."""
    B = pixels.shape[0]
    patches = extract_patches(pixels, cfg.patch_size)
    x = dense(patches.to(params.patch_w.dtype), params.patch_w, params.patch_b)
    x = torch.cat([params.cls_token.to(x.dtype).expand(B, 1, cfg.hidden_size), x], dim=1)
    if cfg.use_abs_pos:
        x = x + params.pos_embed.to(x.dtype)
    rel_index = None
    if cfg.arch == "beit" and cfg.use_rel_pos_bias:
        rel_index = torch.from_numpy(beit_relative_position_index(cfg.grid)).long()
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    per_layer = []
    for l in fuse_vit_blocks(params.layers, rel_index):
        x = fused_vit_layer_parts(x, mask, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
        if return_hidden_states:
            per_layer.append(x)
    if cfg.use_final_layernorm:
        x = layer_norm(x, params.final_ln_w, params.final_ln_b, cfg.layer_norm_eps)
    if return_hidden_states:
        return x, torch.stack(per_layer)
    return x


# --------------------------------------------------------------------------- #
# HF conversion (ViTModel / BeitModel: the DiT checkpoints are BEiT)
# --------------------------------------------------------------------------- #
def convert_vit_state_dict(sd, cfg: ViTConfig):
    """HF ViTModel / BeitModel state dict -> the JAX package's tree of numpy
    arrays (stacked (L, in, out) kernels), which `params.vit_from_jax` turns
    into `ViTParams`."""
    L = cfg.num_layers
    beit = cfg.arch == "beit"
    lyr = "encoder.layer.{}."

    def a(name):
        return np.asarray(sd[name])

    def stack(fmt, transpose=True):
        mats = [np.asarray(sd[fmt.format(i)]) for i in range(L)]
        if transpose:
            mats = [np.ascontiguousarray(m.T) for m in mats]
        return np.stack(mats)

    # conv patch kernel (D, 3, ph, pw) -> (ph*pw*3, D), extract_patches' (kh, kw, c) order
    conv = a("embeddings.patch_embeddings.projection.weight")
    D = conv.shape[0]
    kernel = conv.transpose(2, 3, 1, 0).reshape(-1, D)

    attn = "attention.attention."
    params = {
        "patch_embed": {"kernel": kernel, "bias": a("embeddings.patch_embeddings.projection.bias")},
        "cls_token": a("embeddings.cls_token"),
        "blocks": {
            "ln1_w": stack(lyr + "layernorm_before.weight", False),
            "ln1_b": stack(lyr + "layernorm_before.bias", False),
            "q": {"kernel": stack(lyr + attn + "query.weight"), "bias": stack(lyr + attn + "query.bias", False)},
            "k": {"kernel": stack(lyr + attn + "key.weight")},
            "v": {"kernel": stack(lyr + attn + "value.weight"), "bias": stack(lyr + attn + "value.bias", False)},
            "o": {"kernel": stack(lyr + "attention.output.dense.weight"),
                  "bias": stack(lyr + "attention.output.dense.bias", False)},
            "ln2_w": stack(lyr + "layernorm_after.weight", False),
            "ln2_b": stack(lyr + "layernorm_after.bias", False),
            "fc1": {"kernel": stack(lyr + "intermediate.dense.weight"),
                    "bias": stack(lyr + "intermediate.dense.bias", False)},
            "fc2": {"kernel": stack(lyr + "output.dense.weight"), "bias": stack(lyr + "output.dense.bias", False)},
        },
        # BEiT with use_mean_pooling=True has an Identity final layernorm
        "final_ln_w": a("layernorm.weight") if "layernorm.weight" in sd else np.ones((D,), np.float32),
        "final_ln_b": a("layernorm.bias") if "layernorm.bias" in sd else np.zeros((D,), np.float32),
    }
    if not beit:
        params["blocks"]["k"]["bias"] = stack(lyr + attn + "key.bias", False)
    if cfg.use_abs_pos and "embeddings.position_embeddings" in sd:
        params["pos_embed"] = a("embeddings.position_embeddings")
    if beit and cfg.use_rel_pos_bias:
        params["blocks"]["rel_bias_table"] = stack(
            lyr + "attention.attention.relative_position_bias.relative_position_bias_table", False)
    if beit and cfg.layer_scale_init > 0:
        params["blocks"]["lambda_1"] = stack(lyr + "lambda_1", False)
        params["blocks"]["lambda_2"] = stack(lyr + "lambda_2", False)
    return params
