"""VT5: T5 + spatial (+ layout label) token embeddings + visual tokens.

Counterpart of `rag_docvqa_tpu/models/vt5.py` (`VT5Config`,
`init_vt5_params`, `visual_features`, `input_embeds`, `generate`,
`forward_train`):

  input_embeds = shared[ids] + spatial(boxes) [+ layout_emb[labels] * scale]
  input_embeds = concat([input_embeds, visual_tokens], axis=1)

`visual_features` is the DiT tower (models/vit.py, every layer through K14)
and the matcher that projects its 197 tokens to d_model. `use_visual`
defaults to False here (True in JAX): a config that wants the tower says so,
and parameters without one keep their size.

`forward_train` is the teacher-forced loss: the encoder through the
hand-written layer backward, the decoder in plain torch, and the mean
cross-entropy over the labels that are not -100. It takes no visual tokens:
training the visual branch waits in ROADMAP Queue 1 item 13, and the
LayoutT5 classifier head, which the JAX package trains whenever layout
labels are on, in Queue 1 item 11.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.data.contract import GeneratorInputs
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models.embeddings import (
    SpatialConfig,
    SpatialEmbeddings,
    init_spatial_params,
    spatial_embed,
)
from rag_docvqa_tpu_torch.models.layers import dense, frozen, normal_init
from rag_docvqa_tpu_torch.models.vit import ViTConfig, ViTParams, init_vit_params, vit_encode
from rag_docvqa_tpu_torch.ops.decode import greedy_decode


@dataclass(frozen=True)
class VT5Config:
    t5: t5m.T5Config = field(default_factory=t5m.T5Config)
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    vit: ViTConfig = field(default_factory=ViTConfig)
    use_layout_labels: str = "Default"  # "Default" | "Embed" | "Text"
    n_layout_labels: int = 5
    use_visual: bool = False


class VisualParams(nn.Module):
    """The DiT tower and the matcher (d_model, vit hidden) with its bias."""

    def __init__(self, vit: ViTParams, matcher_w: torch.Tensor, matcher_b: torch.Tensor):
        super().__init__()
        self.vit = vit
        self.matcher_w, self.matcher_b = frozen(matcher_w), frozen(matcher_b)


class VT5Params(nn.Module):
    def __init__(self, t5: t5m.T5Params, spatial: SpatialEmbeddings,
                 layout_emb: Optional[torch.Tensor] = None,
                 layout_scale: Optional[torch.Tensor] = None,
                 visual: Optional[VisualParams] = None):
        super().__init__()
        self.t5, self.spatial = t5, spatial
        self.layout_emb = None if layout_emb is None else frozen(layout_emb)
        self.layout_scale = None if layout_scale is None else frozen(layout_scale)
        self.visual = visual


def init_vt5_params(generator: torch.Generator, cfg: VT5Config) -> VT5Params:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions."""
    t5 = t5m.init_t5_params(generator, cfg.t5)
    spatial = init_spatial_params(generator, cfg.spatial)
    d = cfg.t5.d_model
    visual = None
    if cfg.use_visual:
        dv = cfg.vit.hidden_size
        visual = VisualParams(init_vit_params(generator, cfg.vit), normal_init(generator, (d, dv), dv ** -0.5),
                              torch.zeros(d, device=generator.device))
    if cfg.use_layout_labels == "Embed":
        return VT5Params(t5, spatial, normal_init(generator, (cfg.n_layout_labels, d), 0.02),
                         torch.ones((), device=generator.device), visual=visual)
    return VT5Params(t5, spatial, visual=visual)


def visual_features(params: VT5Params, cfg: VT5Config, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, 1 + N, d_model) visual tokens:
    the image tower, then the matcher."""
    hidden = vit_encode(params.visual.vit, cfg.vit, images)
    return dense(hidden, params.visual.matcher_w, params.visual.matcher_b)


def input_embeds(params: VT5Params, cfg: VT5Config, gen: GeneratorInputs,
                 visual: Optional[torch.Tensor] = None,
                 visual_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (embeds (B, S[+Tv], D), attention mask); `visual` (B, Tv, D)
    are precomputed visual tokens, appended after the text slots, with
    `visual_mask` (B, Tv) bool or all valid."""
    x = params.t5.shared[gen.input_ids] + spatial_embed(params.spatial, cfg.spatial, gen.input_boxes)
    if cfg.use_layout_labels == "Embed":
        x = x + params.layout_emb[gen.input_labels] * params.layout_scale
    mask = gen.attention_mask
    if visual is not None:
        x = torch.cat([x, visual.to(x.dtype)], dim=1)
        if visual_mask is None:
            visual_mask = torch.ones(visual.shape[:2], dtype=torch.bool, device=x.device)
        mask = torch.cat([mask, visual_mask], dim=1)
    return x, mask


def generate(params: VT5Params, cfg: VT5Config, gen: GeneratorInputs, visual: Optional[torch.Tensor] = None,
             visual_mask: Optional[torch.Tensor] = None, max_new_tokens: int = 100):
    """Greedy generation; returns (tokens (B, T), confidence (B,))."""
    embeds, mask = input_embeds(params, cfg, gen, visual, visual_mask)
    enc = t5m.encode(params.t5, cfg.t5, embeds, mask)
    return greedy_decode(params.t5, cfg.t5, enc, mask, max_new_tokens)


def forward_train(params: VT5Params, cfg: VT5Config, gen: GeneratorInputs,
                  labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels (B, Td) with -100 where ignored -> (scalar mean CE over the
    other positions, (B, Td, V) logits). Dropout is off, as in the JAX step,
    which passes no rng."""
    if cfg.use_layout_labels != "Default":
        raise NotImplementedError(
            "training with layout labels needs the LayoutT5 head, which waits in ROADMAP Queue 1 item 11")
    embeds, mask = input_embeds(params, cfg, gen)
    enc = t5m.encode(params.t5, cfg.t5, embeds, mask, train=True)
    dec_in = t5m.shift_tokens_right(labels, cfg.t5.pad_id, cfg.t5.decoder_start_token_id)
    logits = t5m.decode_train(params.t5, cfg.t5, dec_in, enc, mask)
    valid = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    loss = (nll * valid).sum() / valid.sum().clamp(min=1)
    return loss, logits
