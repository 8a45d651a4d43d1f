"""LoRA adapters: rank-r factors on the q and v projections.

Counterpart of `rag_docvqa_tpu/models/lora.py`: `init_lora`, `merge_lora`
and `lora_param_count`. The adapters live apart from the model, in a
`LoRAParams` module with one `LoRAPair` (a (in, r), b (r, out), the JAX
layout) for each targeted projection of each layer; `merge_lora` returns
the model with weight + scale * (a @ b)^T, cast to the weight's dtype, in
the targeted projections, so a training step differentiates through the
merge into the adapters only, with the base frozen (PEFT's semantics).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rag_docvqa_tpu_torch.models.causal_lm import CausalLMLayer, CausalLMParams, PROJ_NAMES, Proj
from rag_docvqa_tpu_torch.models.layers import normal_init


class LoRAPair(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a, self.b = nn.Parameter(a), nn.Parameter(b)


class LoRAParams(nn.Module):
    """`layers[l][target]`: the LoRAPair of that layer's projection."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleDict(pairs) for pairs in layers)


def init_lora(generator: torch.Generator, params: CausalLMParams, targets: Sequence[str] = ("q", "v"),
              rank: int = 8) -> LoRAParams:
    """A ~ N(0, 1/r), B = 0 (the adapter starts as the identity) for every
    `targets` projection of every layer, f32 on the generator's device.
    int8 projections take no adapter, as in JAX."""
    layers = []
    for layer in params.layers:
        pairs = {}
        for name in targets:
            p = getattr(layer, name)
            if p.weight is None:
                continue
            dout, din = p.weight.shape
            pairs[name] = LoRAPair(normal_init(generator, (din, rank), rank**-0.5),
                                   torch.zeros((rank, dout), device=generator.device))
        layers.append(pairs)
    return LoRAParams(layers)


def merge_lora(params: CausalLMParams, lora: LoRAParams, scale: float = 2.0) -> CausalLMParams:
    """The model with weight + (scale * a @ b)^T (cast to the weight's dtype)
    in every adapted projection; the other tensors are shared. scale 2.0 is
    alpha / r with alpha 16, r 8."""
    layers = []
    for layer, pairs in zip(params.layers, lora.layers):
        projs = {}
        for name in PROJ_NAMES:
            p = getattr(layer, name)
            if name in pairs:
                delta = (pairs[name].a @ pairs[name].b) * scale
                p = Proj(p.weight + delta.t().to(p.weight.dtype), p.bias)
            projs[name] = p
        layers.append(CausalLMLayer(layer.ln0, projs["q"], projs["k"], projs["v"], projs["o"], layer.ln1,
                                    projs["gate"], projs["up"], projs["down"]))
    return CausalLMParams(params.embed, layers, params.final_ln, params.lm_head, params.embed_scale,
                          params.lm_head_scale)


def lora_param_count(lora: LoRAParams) -> int:
    return sum(p.numel() for p in lora.parameters())
