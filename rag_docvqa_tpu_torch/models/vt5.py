"""VT5: T5 + spatial (+ layout label) token embeddings.

Counterpart of `rag_docvqa_tpu/models/vt5.py` (`VT5Config`,
`init_vt5_params`, `input_embeds`, `forward_train`):

  input_embeds = shared[ids] + spatial(boxes) [+ layout_emb[labels] * scale]

`forward_train` is the teacher-forced loss: the encoder through the
hand-written layer backward, the decoder in plain torch, and the mean
cross-entropy over the labels that are not -100. The visual branch (DiT
tokens) waits for the visual-tower slice (ROADMAP Queue 1 item 13); the
LayoutT5 classifier head, which the JAX package trains whenever layout
labels are on, waits in Queue 1 item 11.
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
from rag_docvqa_tpu_torch.models.layers import frozen, normal_init


@dataclass(frozen=True)
class VT5Config:
    t5: t5m.T5Config = field(default_factory=t5m.T5Config)
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    use_layout_labels: str = "Default"  # "Default" | "Embed" | "Text"
    n_layout_labels: int = 5


class VT5Params(nn.Module):
    def __init__(self, t5: t5m.T5Params, spatial: SpatialEmbeddings,
                 layout_emb: Optional[torch.Tensor] = None,
                 layout_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.t5, self.spatial = t5, spatial
        self.layout_emb = None if layout_emb is None else frozen(layout_emb)
        self.layout_scale = None if layout_scale is None else frozen(layout_scale)


def init_vt5_params(generator: torch.Generator, cfg: VT5Config) -> VT5Params:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions."""
    t5 = t5m.init_t5_params(generator, cfg.t5)
    spatial = init_spatial_params(generator, cfg.spatial)
    if cfg.use_layout_labels == "Embed":
        return VT5Params(t5, spatial,
                         normal_init(generator, (cfg.n_layout_labels, cfg.t5.d_model), 0.02),
                         torch.ones((), device=generator.device))
    return VT5Params(t5, spatial)


def input_embeds(params: VT5Params, cfg: VT5Config,
                 gen: GeneratorInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (embeds (B, S, D), attention mask (B, S))."""
    x = params.t5.shared[gen.input_ids] + spatial_embed(params.spatial, cfg.spatial, gen.input_boxes)
    if cfg.use_layout_labels == "Embed":
        x = x + params.layout_emb[gen.input_labels] * params.layout_scale
    return x, gen.attention_mask


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
