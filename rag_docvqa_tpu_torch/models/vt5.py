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
cross-entropy over the labels that are not -100. Precomputed visual tokens
(`visual`, `visual_mask`) are appended after the text as in `input_embeds`;
the JAX train step passes none, and neither does the port's. With layout
labels on (`use_layout_labels` other than "Default") the parameters carry
the LayoutT5 head (`layout_head`: a LayerNorm and a Linear to
`n_layout_classes`), and the loss adds `layout_loss_weight` times its
per-token layout cross-entropy over the text positions of the encoder
output. The head is plain torch, as it is plain XLA in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
from rag_docvqa_tpu_torch.models.layers import dense, frozen, layer_norm, masked_cross_entropy, normal_init
from rag_docvqa_tpu_torch.models.vit import ViTConfig, ViTParams, init_vit_params, vit_encode
from rag_docvqa_tpu_torch.ops.decode import greedy_decode


@dataclass(frozen=True)
class VT5Config:
    t5: t5m.T5Config = field(default_factory=t5m.T5Config)
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    vit: ViTConfig = field(default_factory=ViTConfig)
    use_layout_labels: str = "Default"  # "Default" | "Embed" | "Text"
    n_layout_labels: int = 5
    n_layout_classes: int = 12  # the LayoutT5 head's width
    layout_loss_weight: float = 1.0
    use_visual: bool = False


class VisualParams(nn.Module):
    """The DiT tower and the matcher (d_model, vit hidden) with its bias."""

    def __init__(self, vit: ViTParams, matcher_w: torch.Tensor, matcher_b: torch.Tensor):
        super().__init__()
        self.vit = vit
        self.matcher_w, self.matcher_b = frozen(matcher_w), frozen(matcher_b)


class LayoutHead(nn.Module):
    """The LayoutT5 per-token layout classifier: LayerNorm weight and bias
    (d,), then a Linear of weight (n_layout_classes, d) (out, in) and bias."""

    def __init__(self, ln_w: torch.Tensor, ln_b: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.ln_w, self.ln_b = frozen(ln_w), frozen(ln_b)
        self.weight, self.bias = frozen(weight), frozen(bias)


class VT5Params(nn.Module):
    def __init__(self, t5: t5m.T5Params, spatial: SpatialEmbeddings,
                 layout_emb: Optional[torch.Tensor] = None,
                 layout_scale: Optional[torch.Tensor] = None,
                 visual: Optional[VisualParams] = None, nac: Optional[nn.Module] = None,
                 layout_head: Optional[LayoutHead] = None):
        super().__init__()
        self.t5, self.spatial = t5, spatial
        self.layout_emb = None if layout_emb is None else frozen(layout_emb)
        self.layout_scale = None if layout_scale is None else frozen(layout_scale)
        self.visual = visual
        self.nac = nac  # models/nac.py NACParams, when the model carries the not-answerable classifier
        self.layout_head = layout_head  # with layout labels on


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
    dev = generator.device
    layout_emb = layout_scale = head = None
    if cfg.use_layout_labels == "Embed":
        layout_emb, layout_scale = normal_init(generator, (cfg.n_layout_labels, d), 0.02), torch.ones((), device=dev)
    if cfg.use_layout_labels != "Default":  # Xavier-normal Linear, unit LayerNorm, as in JAX
        n = cfg.n_layout_classes
        head = LayoutHead(torch.ones(d, device=dev), torch.zeros(d, device=dev),
                          normal_init(generator, (n, d), (2.0 / (d + n)) ** 0.5), torch.zeros(n, device=dev))
    return VT5Params(t5, spatial, layout_emb, layout_scale, visual=visual, layout_head=head)


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


def forward_train(params: VT5Params, cfg: VT5Config, gen: GeneratorInputs, labels: torch.Tensor,
                  visual: Optional[torch.Tensor] = None, visual_mask: Optional[torch.Tensor] = None,
                  denominators: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels (B, Td) with -100 where ignored -> (scalar mean CE over the
    other positions, plus the LayoutT5 loss where the parameters carry its
    head; (B, Td, V) logits). `visual` (B, Tv, D) precomputed visual tokens
    and `visual_mask` as `input_embeds` takes them. Dropout is off, as in the
    JAX step, which passes no rng. `denominators` {"lm", "layout"}, when
    given, divide each CE's sum instead of its own count (the counts over a
    data-parallel step's global batch)."""
    denominators = denominators or {}
    embeds, mask = input_embeds(params, cfg, gen, visual, visual_mask)
    enc = t5m.encode(params.t5, cfg.t5, embeds, mask, train=True)
    dec_in = t5m.shift_tokens_right(labels, cfg.t5.pad_id, cfg.t5.decoder_start_token_id)
    logits = t5m.decode_train(params.t5, cfg.t5, dec_in, enc, mask)
    loss = masked_cross_entropy(logits, labels, labels != -100, denominators.get("lm"))
    if params.layout_head is not None:
        # the per-token layout CE over the encoder's text positions
        h, S = params.layout_head, gen.input_ids.shape[1]
        lay_logits = dense(layer_norm(enc[:, :S], h.ln_w, h.ln_b, 1e-12), h.weight, h.bias)
        lay_labels = gen.input_labels[:, :S].clamp(0, cfg.n_layout_classes - 1)
        loss = loss + cfg.layout_loss_weight * masked_cross_entropy(lay_logits, lay_labels, gen.attention_mask[:, :S],
                                                                    denominators.get("layout"))
    return loss, logits

