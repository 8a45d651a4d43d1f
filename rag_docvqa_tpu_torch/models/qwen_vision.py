"""The Qwen2-VL-shaped stand-in vision tower: ViT, then a 2x2 patch merger
to the language model's width.

Counterpart of `rag_docvqa_tpu/models/qwen_vision.py`: `QwenVisionConfig`
(the same fields), `init_qwen_vision_params` and `encode_images`. The
engine (engine/rag_qwen.py) dispatches to it for any vision config without
`fullatt_block_indexes`; models/qwen25_vision.py is the real tower. The ViT
runs through `vit_encode`, so every layer through K14 on the card; the
merger (LayerNorm, neighbouring 2x2 patches grouped, an exact-GELU MLP) is
plain, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch.models.layers import dense, frozen, layer_norm, normal_init
from rag_docvqa_tpu_torch.models.vit import ViTConfig, ViTParams, init_vit_params, vit_encode


@dataclass(frozen=True)
class QwenVisionConfig:
    vit: ViTConfig = field(default_factory=ViTConfig)
    out_dim: int = 1024  # the language model's d_model
    merge_size: int = 2  # Qwen2-VL spatial_merge_size

    @property
    def tokens_per_image(self) -> int:
        g = self.vit.image_size // self.vit.patch_size
        return (g // self.merge_size) ** 2


class QwenVisionParams(nn.Module):
    """The ViT and the merger: ln (vit width,), fc1 (d_in, d_in), fc2
    (out_dim, d_in) with biases, d_in = vit width * merge^2."""

    def __init__(self, vit: ViTParams, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b):
        super().__init__()
        self.vit = vit
        self.ln_w, self.ln_b = frozen(ln_w), frozen(ln_b)
        self.fc1_w, self.fc1_b, self.fc2_w, self.fc2_b = frozen(fc1_w), frozen(fc1_b), frozen(fc2_w), frozen(fc2_b)


def init_qwen_vision_params(generator: torch.Generator, cfg: QwenVisionConfig) -> QwenVisionParams:
    """Random f32 weights on the generator's device, the JAX distributions."""
    g, dev = generator, generator.device
    D = cfg.vit.hidden_size
    d_in = D * cfg.merge_size * cfg.merge_size
    vit = init_vit_params(g, cfg.vit)
    return QwenVisionParams(vit, torch.ones(D, device=dev), torch.zeros(D, device=dev),
                            normal_init(g, (d_in, d_in), d_in**-0.5), torch.zeros(d_in, device=dev),
                            normal_init(g, (cfg.out_dim, d_in), d_in**-0.5), torch.zeros(cfg.out_dim, device=dev))


def encode_images(params: QwenVisionParams, cfg: QwenVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) normalized pixels -> (N, tokens_per_image, out_dim): the
    ViT, CLS dropped, LayerNorm, 2x2 neighbouring patches grouped, the MLP."""
    hidden = vit_encode(params.vit, cfg.vit, images)  # (N, 1 + g*g, D)
    g = cfg.vit.image_size // cfg.vit.patch_size
    s = cfg.merge_size
    N, D = hidden.shape[0], hidden.shape[-1]
    x = layer_norm(hidden[:, 1:, :], params.ln_w, params.ln_b, cfg.vit.layer_norm_eps)
    x = x.reshape(N, g // s, s, g // s, s, D).permute(0, 1, 3, 2, 4, 5).reshape(N, (g // s) ** 2, s * s * D)
    x = F.gelu(dense(x, params.fc1_w, params.fc1_b))
    return dense(x, params.fc2_w, params.fc2_b)
