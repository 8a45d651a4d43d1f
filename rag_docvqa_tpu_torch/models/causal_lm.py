"""Decoder-only causal LM (the Qwen2 and Gemma families, HF weight compatible).

Counterpart of `rag_docvqa_tpu/models/causal_lm.py`: `CausalLMConfig` (the
same fields), `init_causal_lm_params`, `rope_frequencies` (`apply_rope` is
`ops/lm_glue.py`'s), `_proj` (with int8 weights), `_embed_tokens`, `_lm_logits`,
`forward_hidden`, `forward`, `sft_loss`, `LMCache`, `prefill`,
`_attend_gqa_one`, `decode_step`, `generate`, `quantize_weights_int8`,
`init_causal_lm_params_int8` and the converters `convert_qwen2_state_dict`,
`convert_gemma_state_dict` (numpy only: they give the JAX-layout tree, which
`params.causal_lm_from_jax` carries over) and `gemma_config_from_hf`.

RoPE, pre-norm RMSNorm, grouped-query attention with the Qwen2 QKV biases,
the SwiGLU MLP and a tied or untied head. `arch="gemma"` takes the Gemma-1
conventions of the bge-reranker-v2-gemma backbone: the sqrt(d_model) input
scale, RMSNorm with (1 + w) weights, the tanh-GELU gated MLP, no QKV bias
and an explicit head_dim (MQA through num_kv_heads=1). Visual inputs enter
as embeddings spliced into the token sequence where `visual_mask` is set.

Qwen2.5-VL's multimodal RoPE (M-RoPE) is on when `mrope_section` is set (the
JAX config has no such field; its causal LM gives every token 1-D RoPE):
`prefill` and `generate` then take (3, B, T) (t, h, w) positions, and the
rotary frequencies are split into the three sections in order, each section
rotated by its own index (HF's `apply_multimodal_rotary_pos_emb`). A text
token's three indices are equal, so its angles are the 1-D ones; the cached
decode continues each row at its prompt's largest index + 1. Unset, or with
no positions given, every path is the 1-D one it was.

Parameters are `nn.Module`s holding per-layer tensors, projections (out,
in), created frozen; `Proj` holds either a weight or its int8 form (`q8`
(out, in) int8 and a per-output-channel `scale`). A projection given a
tensor that carries a graph (`models/lora.py::merge_lora` with adapters
that train) holds it as a plain attribute, so the gradient reaches the
adapters.

The causal self-attention of `forward_hidden` and `prefill` runs on the
port's flash attention, K2 forward and K6 backward (`ops/flash_attention.py`,
causal, GQA heads, the padding key mask), whatever `flash_prefill` says:
the field is kept so that configs carried from JAX load, and ignored. On
CPU tensors that is the kernels' plain version. A query row with no valid
key (left padding) gives zeros there, where the JAX XLA path's -1e9 mask
gives a uniform row; with right padding every row has key 0, and a padded
row never reaches a valid one. The decode step's single-query GQA attention
(`_attend_gqa_one`) is plain torch, as it is plain XLA in JAX.

The elementwise glue between a layer's GEMMs (the residual add with the
next RMSNorm, the q/k/v biases with the rotary, the gated MLP's product)
runs on the hand-written kernels of `ops/lm_glue.py` where its tensors are
on CUDA and no autograd graph is recorded (`generate`, the engines, the
reranker: `_glue_fused`), and as the plain ops otherwise (the CPU, LoRA's
`sft_loss`); the two round alike. With the tracer on, each layer of each
pass (the stack, a decode step) counts one `lm.glue_fused` or
`lm.glue_plain`.

A config with `moe_experts` set replaces every layer's dense feed-forward by
the dynamic-capacity expert layer of `models/moe.py` (routed experts chosen
by top-p under a top-k cap, null experts, shared experts; Uni-MoE-2.0-Omni's
language model): the layer then holds a `MoEBlock` under `moe` and no
gate/up/down projections, and `_stack` and `decode_step` call
`moe.expert_layer` where `_mlp` runs for a dense layer (the prefill's padding
takes no expert). Unset, every layer is dense and runs as before, bit for
bit. The JAX package has no such layer; the int8 forms and the JAX and HF
converters are dense only.

Cast points follow JAX's rounding: the rotary tables in f32 from an f32
`arange / head_dim`, the rotation in f32 then cast to x's dtype, Gemma's
input scale rounded to x's dtype, Gemma's norm weight 1 + w formed in the
weight's dtype, the int8 product in x's dtype then times the scale in x's
dtype, then the bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.models import moe
from rag_docvqa_tpu_torch.models.layers import dense, frozen, masked_cross_entropy, normal_init
from rag_docvqa_tpu_torch.ops import lm_glue
from rag_docvqa_tpu_torch.ops.flash_attention import flash_attention

MASKED = -1e9  # masked score of the decode step's attention, as in JAX


@dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    num_kv_heads: int = 4  # GQA
    d_ff: int = 2816
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    qkv_bias: bool = True  # Qwen2 style
    tie_word_embeddings: bool = True
    pad_id: int = 0
    eos_id: int = 1
    arch: str = "qwen2"  # "qwen2" | "gemma"
    head_dim_override: int = 0  # gemma sets head_dim independent of d_model
    flash_prefill: bool = False  # JAX's TPU gate; the port always runs K2 (see the module docstring)
    mrope_section: Tuple[int, ...] = ()  # M-RoPE's (t, h, w) frequency counts, summing to head_dim / 2; () is off
    # the expert layer (models/moe.py); moe_experts 0: every layer dense
    moe_experts: int = 0  # routed experts a layer
    moe_null_experts: int = 0  # experts that compute nothing, routed to like the others
    moe_top_k: int = 2  # the most experts a token takes
    moe_top_p: float = 1.0  # a token takes experts, most probable first, until their probabilities reach this
    moe_d_ff: int = 0  # a routed expert's SwiGLU width
    moe_shared_experts: int = 0  # experts every token takes, summed without a gate
    moe_shared_d_ff: int = 0  # a shared expert's SwiGLU width

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.num_heads


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _hold(t: Optional[torch.Tensor]):
    """A tensor as a module holds it: a frozen parameter, or as it is when it
    carries a graph (a merged LoRA weight) or already is a parameter."""
    if t is None or isinstance(t, nn.Parameter) or t.grad_fn is not None:
        return t
    return frozen(t)


class Proj(nn.Module):
    """y = x @ weight.T (+ bias): weight (out, in); or the int8 form, q8
    (out, in) int8 with `scale` (out,) per output channel."""

    def __init__(self, weight=None, bias=None, q8=None, scale=None):
        super().__init__()
        self.weight, self.bias, self.q8, self.scale = _hold(weight), _hold(bias), _hold(q8), _hold(scale)


class CausalLMLayer(nn.Module):
    """ln0, the q/k/v/o projections, ln1, the gate/up/down projections; or,
    for an expert layer, `moe` (a `moe.MoEBlock`) and no gate/up/down."""

    def __init__(self, ln0, q: Proj, k: Proj, v: Proj, o: Proj, ln1, gate: Optional[Proj] = None,
                 up: Optional[Proj] = None, down: Optional[Proj] = None, moe: Optional[nn.Module] = None):
        super().__init__()
        self.ln0, self.ln1 = _hold(ln0), _hold(ln1)
        self.q, self.k, self.v, self.o = q, k, v, o
        self.gate, self.up, self.down = gate, up, down
        self.moe = moe


PROJ_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


class CausalLMParams(nn.Module):
    """embed (V, d) (int8 with `embed_scale` (V,) per row), the layers,
    final_ln (d,), lm_head (V, d) (int8 with `lm_head_scale` (V,)) when
    the head is untied, and `vision`, a vision tower's parameters where the
    tree carries one (JAX's `params["vision"]`)."""

    def __init__(self, embed, layers, final_ln, lm_head=None, embed_scale=None, lm_head_scale=None,
                 vision: Optional[nn.Module] = None):
        super().__init__()
        self.embed, self.embed_scale = _hold(embed), _hold(embed_scale)
        self.layers = nn.ModuleList(layers)
        self.final_ln = _hold(final_ln)
        self.lm_head, self.lm_head_scale = _hold(lm_head), _hold(lm_head_scale)
        self.vision = vision

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_causal_lm_params(generator: torch.Generator, cfg: CausalLMConfig,
                          dtype: torch.dtype = torch.float32) -> CausalLMParams:
    """Random weights on the generator's device with the JAX package's
    distributions: N(0, 1/din) projections, N(0, 0.02^2) embeddings, an
    untied head N(0, 1/d), zero biases, unit norms. Each tensor is drawn in
    f32 and cast to `dtype` before the next is drawn, so the transient f32
    memory is one tensor. An expert layer's tensors: `moe.init_moe_block`
    (the router in f32)."""
    g, d, dev = generator, cfg.d_model, generator.device
    hd = cfg.head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    draw = lambda shape, std: normal_init(g, shape, std).to(dtype)

    def lin(din, dout, bias):
        return Proj(draw((dout, din), din**-0.5), torch.zeros(dout, dtype=dtype, device=dev) if bias else None)

    def ffn():
        if cfg.moe_experts:
            return dict(moe=moe.init_moe_block(lambda shape, std, dt: normal_init(g, shape, std).to(dt), cfg, dtype))
        return dict(gate=lin(d, cfg.d_ff, False), up=lin(d, cfg.d_ff, False), down=lin(cfg.d_ff, d, False))

    embed = draw((cfg.vocab_size, d), 0.02)
    layers = [CausalLMLayer(torch.ones(d, dtype=dtype, device=dev), lin(d, q_dim, cfg.qkv_bias),
                            lin(d, kv_dim, cfg.qkv_bias), lin(d, kv_dim, cfg.qkv_bias), lin(q_dim, d, False),
                            torch.ones(d, dtype=dtype, device=dev), **ffn())
              for _ in range(cfg.num_layers)]
    head = None if cfg.tie_word_embeddings else draw((cfg.vocab_size, d), d**-0.5)
    return CausalLMParams(embed, layers, torch.ones(d, dtype=dtype, device=dev), head)


# --------------------------------------------------------------------------- #
# int8 weights
# --------------------------------------------------------------------------- #
def _quantize_rows(w32: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row of an f32 (out, in) matrix: (q8, scale (out,)
    in `dtype`), scale = max|row| / 127 (at least 1e-12 / 127)."""
    scale = w32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q8, scale[..., 0].to(dtype)


def _quant_proj(p: Proj) -> Proj:
    q8, scale = _quantize_rows(p.weight.float(), p.weight.dtype)
    return Proj(bias=p.bias, q8=q8, scale=scale)


def quantize_weights_int8(params: CausalLMParams) -> CausalLMParams:
    """Symmetric per-output-channel int8 of every projection, the embedding
    table (a scale per row) and an untied head; norms and biases stay as
    they are. The JAX function's tree: its per-input-dim reduction of an
    (in, out) kernel is the per-row one of the (out, in) weight here. Dense
    layers only."""
    if any(l.moe is not None for l in params.layers):
        raise NotImplementedError("int8 weights of an expert layer: the port quantizes dense layers only")
    layers = [CausalLMLayer(l.ln0, *(_quant_proj(getattr(l, n)) for n in ("q", "k", "v", "o")), l.ln1,
                            *(_quant_proj(getattr(l, n)) for n in ("gate", "up", "down")))
              for l in params.layers]
    embed, embed_scale = _quantize_rows(params.embed.float(), params.embed.dtype)
    head = head_scale = None
    if params.lm_head is not None:
        head, head_scale = _quantize_rows(params.lm_head.float(), params.lm_head.dtype)
    return CausalLMParams(embed, layers, params.final_ln, head, embed_scale, head_scale)


def _largest_divisor_upto(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def init_causal_lm_params_int8(generator: torch.Generator, cfg: CausalLMConfig,
                               dtype: torch.dtype = torch.bfloat16) -> CausalLMParams:
    """Random int8 weights with a bounded transient: the tree of
    `quantize_weights_int8(init_causal_lm_params(...))`, but each projection
    is drawn in f32 and quantized one layer slice at a time, and the
    embedding table and an untied head one vocabulary block at a time (the
    largest divisor of V up to 16 blocks), as JAX's `lax.map` does; the f32
    transient is one slice. Norms and biases are made in `dtype`. Same
    distributions as `init_causal_lm_params`, other values. Dense only."""
    if cfg.moe_experts:
        raise NotImplementedError("int8 weights of an expert layer: the port quantizes dense layers only")
    g, d, dev = generator, cfg.d_model, generator.device
    hd = cfg.head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def qproj(din, dout, bias):
        q8, scale = _quantize_rows(normal_init(g, (dout, din), din**-0.5), dtype)
        return Proj(bias=torch.zeros(dout, dtype=dtype, device=dev) if bias else None, q8=q8, scale=scale)

    def qrows(std):
        nb = _largest_divisor_upto(cfg.vocab_size, 16)
        parts = [_quantize_rows(normal_init(g, (cfg.vocab_size // nb, d), std), dtype) for _ in range(nb)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    embed, embed_scale = qrows(0.02)
    ones = lambda: torch.ones(d, dtype=dtype, device=dev)
    layers = [CausalLMLayer(ones(), qproj(d, q_dim, cfg.qkv_bias), qproj(d, kv_dim, cfg.qkv_bias),
                            qproj(d, kv_dim, cfg.qkv_bias), qproj(q_dim, d, False), ones(),
                            qproj(d, cfg.d_ff, False), qproj(d, cfg.d_ff, False), qproj(cfg.d_ff, d, False))
              for _ in range(cfg.num_layers)]
    head = head_scale = None
    if not cfg.tie_word_embeddings:
        head, head_scale = qrows(d**-0.5)
    return CausalLMParams(embed, layers, ones(), head, embed_scale, head_scale)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_frequencies(cfg: CausalLMConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., head_dim / 2), f32."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def mrope_frequencies(cfg: CausalLMConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE: positions (3, ...) of (t, h, w) -> (cos, sin) of shape (...,
    head_dim / 2), f32, frequency j taking the index of its section of
    `cfg.mrope_section`."""
    cos, sin = rope_frequencies(cfg, positions)  # (3, ..., hd/2)
    if sum(cfg.mrope_section) != cos.shape[-1] or positions.shape[0] != 3:
        raise ValueError(f"mrope_section {cfg.mrope_section} over (3, ...) positions for head_dim {cfg.head_dim}")
    bounds = np.cumsum((0,) + tuple(cfg.mrope_section))
    pick = lambda t: torch.cat([t[i, ..., bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)
    return pick(cos), pick(sin)


# --------------------------------------------------------------------------- #
# the pieces
# --------------------------------------------------------------------------- #
def _proj(x: torch.Tensor, p: Proj, bias: bool = True) -> torch.Tensor:
    """x @ p^T, then p's bias unless `bias` is False (the glue kernel adds it)."""
    if p.q8 is not None:  # int8: the product in x's dtype, then the per-channel scale, then the bias
        y = torch.matmul(x, p.q8.to(x.dtype).t()) * p.scale.to(x.dtype)
        return y + p.bias.to(x.dtype) if bias and p.bias is not None else y
    return dense(x, p.weight, p.bias if bias else None)


def _embed_tokens(params: CausalLMParams, cfg: CausalLMConfig, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.long()
    if params.embed_scale is not None:  # int8 table: the per-row scales gather alongside
        x = params.embed[ids].to(params.embed_scale.dtype) * params.embed_scale[ids][..., None]
    else:
        x = params.embed[ids]
    if cfg.arch == "gemma":
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)  # rounded to x's dtype first
    return x


def _lm_logits(params: CausalLMParams, cfg: CausalLMConfig, x: torch.Tensor) -> torch.Tensor:
    """The LM head on (.., d) hidden states, tied or untied, int8 or not."""
    if cfg.tie_word_embeddings:
        w, scale = params.embed, params.embed_scale
    else:
        w, scale = params.lm_head, params.lm_head_scale
    y = torch.matmul(x, w.to(x.dtype).t())
    return y * scale.to(x.dtype) if scale is not None else y


def _records_graph(*held) -> bool:
    """Whether autograd records ops on `held` (tensors, None, or layers, all
    of whose tensors count): grad mode on and one of them requires a
    gradient."""
    if not torch.is_grad_enabled():
        return False
    for t in held:
        if isinstance(t, CausalLMLayer):
            ts = [t.ln0, t.ln1] + [getattr(getattr(t, n), a) for n in PROJ_NAMES if getattr(t, n) is not None
                                   for a in ("weight", "bias", "q8", "scale")]
            ts += list(t.moe.tensors()) if t.moe is not None else []
            if any(u is not None and u.requires_grad for u in ts):
                return True
        elif t is not None and t.requires_grad:
            return True
    return False


def _glue_fused(x: torch.Tensor, *held) -> bool:
    """Whether the glue over x (and `held`, as `_records_graph` reads it)
    takes its kernels (ops/lm_glue.py): x on CUDA and no autograd graph
    recorded. Otherwise the plain ops run, as on the CPU."""
    return x.is_cuda and not _records_graph(x, *held)


def _count_glue(fused: bool) -> None:
    profiling.count("lm.glue_fused" if fused else "lm.glue_plain", 1)


def _add_ln(x: torch.Tensor, d: Optional[torch.Tensor], w: torch.Tensor, cfg: CausalLMConfig,
            fused: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + d, its RMSNorm); d None: (x, the norm of x)."""
    w = 1 + w if cfg.arch == "gemma" else w  # Gemma: (1 + w) in w's dtype
    if fused:
        return lm_glue.add_rms_norm(x, d, w, cfg.rms_eps)
    return lm_glue.add_rms_norm_reference(x, d, w, cfg.rms_eps)


def _act_name(cfg: CausalLMConfig) -> str:
    return "gelu_tanh" if cfg.arch == "gemma" else "silu"


def _mlp(h: torch.Tensor, layer: CausalLMLayer, cfg: CausalLMConfig, fused: bool) -> torch.Tensor:
    glu = lm_glue.glu if fused else lm_glue.glu_reference  # gate and up are freed before the down product
    return _proj(glu(_proj(h, layer.gate), _proj(h, layer.up), _act_name(cfg)), layer.down)


def _ffn(h: torch.Tensor, layer: CausalLMLayer, cfg: CausalLMConfig, fused: bool,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's feed-forward: the expert layer (`moe.expert_layer`, the
    positions outside `valid` taking no expert) where the layer holds one,
    else the dense `_mlp` (`config.build_engine` holds the tree to the
    config)."""
    if layer.moe is not None:
        return moe.expert_layer(h, layer.moe, cfg, fused, valid)
    return _mlp(h, layer, cfg, fused)


def _splice(x, visual_embeds, visual_mask):
    if visual_embeds is not None and visual_mask is not None:
        x = torch.where(visual_mask[..., None], visual_embeds.to(x.dtype), x)
    return x


def _qkv(h, layer: CausalLMLayer, cfg: CausalLMConfig, cos, sin, fused: bool):
    """q (B, T, H, hd), k and v (B, T, Hkv, hd) of h (B, T, d): biased, q and
    k rotated."""
    B, T = h.shape[:2]
    q, k, v = (_proj(h, p, bias=False).reshape(B, T, n, -1)
               for p, n in ((layer.q, cfg.num_heads), (layer.k, cfg.num_kv_heads), (layer.v, cfg.num_kv_heads)))
    biases = (layer.q.bias, layer.k.bias, layer.v.bias)
    if fused:
        lm_glue.bias_rope_(q, k, v, *biases, cos, sin)
        return q, k, v
    return lm_glue.bias_rope_reference(q, k, v, *biases, cos, sin)


def _attend_causal(cfg: CausalLMConfig, q, k, v, key_mask):
    """Causal GQA self-attention over the whole sequence through K2 (K6 in
    the backward), the (B, T) padding mask as the key mask."""
    out = flash_attention(q, k, v, key_mask=key_mask.contiguous(), causal=True, scale=cfg.head_dim**-0.5)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _stack(params: CausalLMParams, cfg: CausalLMConfig, input_ids, attention_mask, visual_embeds, visual_mask,
           cache_len: int = 0, positions: Optional[torch.Tensor] = None):
    """The embedding and every layer; with `cache_len`, also each layer's
    K and V in cache layout (B, Hkv, cache_len, hd). `positions` (3, B, T)
    are M-RoPE's; without them the positions are 0 .. T-1."""
    B, T = input_ids.shape
    x = _splice(_embed_tokens(params, cfg, input_ids), visual_embeds, visual_mask)
    if positions is None:
        cos, sin = rope_frequencies(cfg, torch.arange(T, device=x.device))
    else:
        cos, sin = mrope_frequencies(cfg, positions.to(x.device))
    mask = attention_mask.bool()
    ks, vs = [], []
    d = None  # the last sublayer's output, added to x by the next norm
    for layer in params.layers:
        fused = _glue_fused(x, d, layer)
        _count_glue(fused)
        x, h = _add_ln(x, d, layer.ln0, cfg, fused)
        d = None  # not held through the layer
        q, k, v = _qkv(h, layer, cfg, cos, sin, fused)
        x, h = _add_ln(x, _proj(_attend_causal(cfg, q, k, v, mask), layer.o), layer.ln1, cfg, fused)
        d = _ffn(h, layer, cfg, fused, mask)
        if cache_len:
            ks.append(F.pad(k.transpose(1, 2), (0, 0, 0, cache_len - T)))
            vs.append(F.pad(v.transpose(1, 2), (0, 0, 0, cache_len - T)))
    return _add_ln(x, d, params.final_ln, cfg, _glue_fused(x, d, params.final_ln))[1], ks, vs


def forward_hidden(params: CausalLMParams, cfg: CausalLMConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, visual_embeds: Optional[torch.Tensor] = None,
                   visual_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-layer hidden states (B, T, d): `forward` without the LM head
    (the LLM reranker reads one position of them)."""
    return _stack(params, cfg, input_ids, attention_mask, visual_embeds, visual_mask)[0]


def forward(params: CausalLMParams, cfg: CausalLMConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            visual_embeds: Optional[torch.Tensor] = None, visual_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: (B, T, V) logits."""
    return _lm_logits(params, cfg, forward_hidden(params, cfg, input_ids, attention_mask, visual_embeds, visual_mask))


def sft_loss(params: CausalLMParams, cfg: CausalLMConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             labels: torch.Tensor, visual_embeds: Optional[torch.Tensor] = None,
             visual_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-label SFT loss: token t predicts t + 1, labels -100 on the
    prompt and padding, the f32 mean over the supervised positions."""
    logits = forward(params, cfg, input_ids, attention_mask, visual_embeds, visual_mask)[:, :-1]
    targets = labels[:, 1:].long()
    return masked_cross_entropy(logits, targets, targets != -100)


# --------------------------------------------------------------------------- #
# cached greedy decode
# --------------------------------------------------------------------------- #
@dataclass
class LMCache:
    k: torch.Tensor  # (L, B, Hkv, Tmax, hd)
    v: torch.Tensor


def prefill(params: CausalLMParams, cfg: CausalLMConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            max_len: int, visual_embeds: Optional[torch.Tensor] = None,
            visual_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, LMCache]:
    """Runs the prompt and fills the KV cache: (logits at each row's last
    valid position (B, V), the cache with max_len slots). `positions`: the
    (3, B, T) M-RoPE positions, or None for 0 .. T-1."""
    B = input_ids.shape[0]
    x, ks, vs = _stack(params, cfg, input_ids, attention_mask, visual_embeds, visual_mask, cache_len=max_len,
                       positions=positions)
    last = x[torch.arange(B, device=x.device), attention_mask.long().sum(dim=1) - 1]
    return _lm_logits(params, cfg, last), LMCache(k=torch.stack(ks), v=torch.stack(vs))


def _attend_gqa_one(q, kc, vc, mask, hd):
    """Single-position GQA attention in cache layout, no head repetition:
    q (B, H, hd), kc/vc (B, Hkv, T, hd), mask (B, 1, 1, T) -> (B, H*hd).
    f32 scores masked at -1e9, the softmax rounded to q's dtype, an f32
    product cast to q's dtype."""
    B, H, _ = q.shape
    Hkv = kc.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bgrd,bgtd->bgrt", qg.float(), kc.float()) * (hd**-0.5)
    s = torch.where(mask, s, MASKED)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bgrt,bgtd->bgrd", p.float(), vc.float()).to(q.dtype)
    return out.reshape(B, H * hd)


def decode_step(params: CausalLMParams, cfg: CausalLMConfig, cache: LMCache, token: torch.Tensor, step: int,
                attn_len_mask: torch.Tensor, rope_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, LMCache]:
    """One cached step: writes this token's K/V at cache slot `step` (in
    place) and returns (logits (B, V), the cache). With right-padded ragged
    prompts the slot (Tp + t) and the rotary position (prompt_len + t, per
    row: `rope_pos`) differ; `step` is the position when rope_pos is None."""
    hd = cfg.head_dim
    x = _embed_tokens(params, cfg, token)
    if rope_pos is None:
        cos, sin = rope_frequencies(cfg, torch.tensor([step], device=x.device))
    else:
        cos, sin = rope_frequencies(cfg, rope_pos[:, None])  # (B, 1, hd/2)
    mask = attn_len_mask[:, None, None, :]
    d = None
    for l, layer in enumerate(params.layers):
        fused = _glue_fused(x, d, layer)
        _count_glue(fused)
        x, h = _add_ln(x, d, layer.ln0, cfg, fused)
        d = None
        q, k_new, v_new = _qkv(h[:, None], layer, cfg, cos, sin, fused)
        cache.k[l, :, :, step] = k_new[:, 0]
        cache.v[l, :, :, step] = v_new[:, 0]
        x, h = _add_ln(x, _proj(_attend_gqa_one(q[:, 0], cache.k[l], cache.v[l], mask, hd), layer.o), layer.ln1,
                       cfg, fused)
        d = _ffn(h, layer, cfg, fused)
    h = _add_ln(x, d, params.final_ln, cfg, _glue_fused(x, d, params.final_ln))[1]
    return _lm_logits(params, cfg, h), cache


@torch.no_grad()
def generate(params: CausalLMParams, cfg: CausalLMConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             max_new_tokens: int = 16, visual_embeds: Optional[torch.Tensor] = None,
             visual_mask: Optional[torch.Tensor] = None, end_stage: Optional[Callable[[str], None]] = None,
             positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode: (tokens (B, max_new_tokens), confidence (B,)). The
    confidence is the product of each emitted token's max softmax
    probability, the prefill's first, then each step's until the row is done;
    the last step's is not counted (`t >= max_new_tokens - 2`, as in JAX).
    `positions`: the prompt's (3, B, Tp) M-RoPE positions, after which row b
    decodes from its largest valid index + 1 (HF's rope deltas); None for
    0 .. Tp-1. `end_stage`, when given, ends the engine's stages "prefill"
    and "decode" (`engine/stages.py`); with the tracer on, the spans
    `engine.prefill`, `engine.decode` and a `decode.step` a step."""
    B, Tp = input_ids.shape
    max_len = Tp + max_new_tokens
    with profiling.span("engine.prefill"):
        logits0, cache = prefill(params, cfg, input_ids, attention_mask, max_len, visual_embeds, visual_mask,
                                 positions)
        if end_stage is not None:
            end_stage("prefill")
    prompt_len = attention_mask.long().sum(dim=1)
    if positions is None:
        next_pos = prompt_len
    else:
        next_pos = positions.to(input_ids.device).masked_fill(~attention_mask.bool()[None], -1).amax(dim=(0, 2)) + 1
    tok0 = logits0.argmax(dim=-1)
    conf = torch.softmax(logits0.float(), dim=-1).amax(dim=-1)
    done = tok0 == cfg.eos_id
    token = torch.where(done, cfg.pad_id, tok0)
    tokens = [token]
    k_pos = torch.arange(max_len, device=input_ids.device)[None, :]
    with profiling.span("engine.decode"):
        for t in range(max_new_tokens - 1):
            # generated token t sits at cache slot Tp + t and rotary position
            # next_pos + t: ragged right-padded prompts decode as an unpadded batch
            with profiling.span("decode.step"):
                slot = Tp + t
                mask = (k_pos < prompt_len[:, None]) | ((k_pos >= Tp) & (k_pos <= slot))
                logits, cache = decode_step(params, cfg, cache, token, slot, mask, rope_pos=next_pos + t)
                next_tok = logits.argmax(dim=-1)
                max_prob = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
                emitted = torch.where(done, cfg.pad_id, next_tok)
                if t < max_new_tokens - 2:
                    conf = conf * torch.where(done, 1.0, max_prob)
                done = done | (emitted == cfg.eos_id)
                token = emitted
                tokens.append(emitted)
        tokens = torch.stack(tokens, dim=1).to(torch.int32)
        if end_stage is not None:
            end_stage("decode")
    return tokens, conf


# --------------------------------------------------------------------------- #
# Hugging Face conversion (numpy; the JAX-layout tree)
# --------------------------------------------------------------------------- #
def convert_qwen2_state_dict(sd: Dict[str, Any], cfg: CausalLMConfig) -> Dict[str, Any]:
    """HF Qwen2ForCausalLM (also the `model.language_model.*` naming of the
    VLM wrappers' re-saves) -> the JAX package's tree of numpy arrays, for
    `params.causal_lm_from_jax`."""
    if any(k.startswith("model.language_model.") for k in sd):
        sd = {("model." + k[len("model.language_model."):] if k.startswith("model.language_model.") else k): v
              for k, v in sd.items()}
    L = cfg.num_layers
    p = "model.layers.{}."

    def stack(fmt, transpose=True):
        mats = [np.asarray(sd[fmt.format(i)]) for i in range(L)]
        if transpose:
            mats = [np.ascontiguousarray(m.T) for m in mats]
        return np.stack(mats)

    def lin(base, bias):
        out = {"kernel": stack(base + ".weight")}
        if bias:
            out["bias"] = stack(base + ".bias", transpose=False)
        return out

    params = {
        "embed": np.asarray(sd["model.embed_tokens.weight"]),
        "blocks": {
            "ln0": stack(p + "input_layernorm.weight", False),
            "q": lin(p + "self_attn.q_proj", cfg.qkv_bias),
            "k": lin(p + "self_attn.k_proj", cfg.qkv_bias),
            "v": lin(p + "self_attn.v_proj", cfg.qkv_bias),
            "o": lin(p + "self_attn.o_proj", False),
            "ln1": stack(p + "post_attention_layernorm.weight", False),
            "gate": lin(p + "mlp.gate_proj", False),
            "up": lin(p + "mlp.up_proj", False),
            "down": lin(p + "mlp.down_proj", False),
        },
        "final_ln": np.asarray(sd["model.norm.weight"]),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = np.ascontiguousarray(np.asarray(sd["lm_head.weight"]).T)
    return params


def convert_gemma_state_dict(sd: Dict[str, Any], cfg: CausalLMConfig) -> Dict[str, Any]:
    """HF GemmaForCausalLM -> the same tree (the arch differences live in the
    forward through cfg.arch="gemma"). Covers bge-reranker-v2-gemma."""
    assert cfg.arch == "gemma" and not cfg.qkv_bias
    return convert_qwen2_state_dict(sd, cfg)


def gemma_config_from_hf(hf_cfg, **overrides) -> CausalLMConfig:
    """CausalLMConfig for an HF GemmaConfig or its config.json dict (gemma-1;
    gemma-2b: d 2048, 8 heads, head_dim 256, MQA)."""
    get = hf_cfg.get if isinstance(hf_cfg, dict) else lambda k, d=None: getattr(hf_cfg, k, d)
    kw = dict(
        vocab_size=get("vocab_size"),
        d_model=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads"),
        d_ff=get("intermediate_size"),
        rope_theta=get("rope_theta", 10000.0),
        rms_eps=get("rms_norm_eps", 1e-6),
        qkv_bias=False,
        tie_word_embeddings=True,
        arch="gemma",
        head_dim_override=get("head_dim", 0) or 0,
    )
    kw.update(overrides)
    return CausalLMConfig(**kw)
