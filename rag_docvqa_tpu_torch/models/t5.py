"""T5 encoder-decoder: encode, teacher-forced decoding, cached greedy steps.

Counterpart of `rag_docvqa_tpu/models/t5.py`: `T5Config` (the same fields),
`init_t5_params`, `relative_bias`, `encode`, `decode_train`,
`shift_tokens_right`, `init_decode_cache` (with the int8 quantizer),
`decode_step` and `lm_logits`. Parameters are `nn.Module`s holding
per-layer tensors; dense weights are (out, in). They are created frozen
(no gradient); a trainer turns `requires_grad` on where it trains. Attention
has no 1/sqrt(d_k) scale, as in T5.

`decode_train(..., return_cross_attn=True)` also returns every layer's
cross-attention probabilities. `encode(..., train=True)` runs every layer through `T5LayerTrain`, the
layer-level autograd Function whose backward is K7 then K8 (the JAX
`encode(fused="train")`); gradients reach every encoder weight, the input
embeddings and, through the bf16 cast and the bucket gather, the rel-pos
table. `decode_train` is plain torch, as the JAX package leaves it to XLA.
With `remat_layers` (the train step's `remat="layer"`), each encoder layer
of a train encode and each decoder layer of `decode_train` runs under
`torch.utils.checkpoint` (non-reentrant): the backward recomputes the
layer's forward from its input, so a layer keeps only its input between the
passes (the JAX `jax.checkpoint` of each scanned layer).

The encoder has one path: every layer through K1 (ops/fused_encoder.py,
whose attention is K2's kernel), with the rel-pos bias cast to bf16 even
for an f32 x, as the JAX `encode` does for the TPU layer kernel. There is
no eligibility gate: on CUDA tensors it always runs the kernels, so the
JAX package's plain-blocks and `flash_encoder` routes, its fall-backs for
when the TPU kernel does not fit, have no counterpart. Unlike the TPU
path, T is not padded to a multiple of 8 -- nothing here tiles by 8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.models.layers import dense, frozen, normal_init, rms_norm
from rag_docvqa_tpu_torch.ops.decode_attention import fused_cross_attention, pack_decode_kv
from rag_docvqa_tpu_torch.ops.fused_encoder import fuse_t5_blocks, fused_t5_layer_parts, t5_layer_train

MASKED = -1e9  # masked attention score of `_attend` and `_attend_one`, as in JAX


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 3072
    num_encoder_layers: int = 12
    num_decoder_layers: int = 12
    rel_buckets: int = 32
    rel_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    gated_ffn: bool = False  # t5-base uses the plain ReLU FFN
    tie_word_embeddings: bool = True
    pad_id: int = 0
    eos_id: int = 1
    decoder_start_token_id: int = 0
    flash_encoder: bool = False  # no effect here: encode always runs K1 (and K2 inside it)
    decode_kv_int8: bool = False  # int8 cross-KV cache, channel scales
    remat_layers: bool = False  # training: checkpoint each encoder and decoder layer
    # cross-attention of each decode step through K3 (ops/decode_attention.py)
    # over the packed cache. The TPU package also required 128-aligned dims
    # and a VMEM budget; on the card the option alone decides.
    fused_decode_attn: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
class T5Attention(nn.Module):
    """q, k, v (inner, d) and o (d, inner)."""

    def __init__(self, q, k, v, o):
        super().__init__()
        self.q, self.k, self.v, self.o = frozen(q), frozen(k), frozen(v), frozen(o)


class T5FFN(nn.Module):
    """wi (d_ff, d), or wi_0/wi_1 when gated; wo (d, d_ff)."""

    def __init__(self, wo, wi=None, wi_0=None, wi_1=None):
        super().__init__()
        self.wo = frozen(wo)
        self.gated = wi is None
        if self.gated:
            self.wi_0, self.wi_1 = frozen(wi_0), frozen(wi_1)
        else:
            self.wi = frozen(wi)


class T5EncoderLayer(nn.Module):
    def __init__(self, ln0, ln1, attn: T5Attention, ffn: T5FFN):
        super().__init__()
        self.ln0, self.ln1 = frozen(ln0), frozen(ln1)
        self.attn, self.ffn = attn, ffn


class T5DecoderLayer(nn.Module):
    def __init__(self, ln0, ln1, ln2, self_attn: T5Attention, cross_attn: T5Attention, ffn: T5FFN):
        super().__init__()
        self.ln0, self.ln1, self.ln2 = frozen(ln0), frozen(ln1), frozen(ln2)
        self.self_attn, self.cross_attn, self.ffn = self_attn, cross_attn, ffn


class T5Stack(nn.Module):
    """rel_bias (buckets, H), the layers, final_ln (d,)."""

    def __init__(self, rel_bias, layers, final_ln):
        super().__init__()
        self.rel_bias = frozen(rel_bias)
        self.layers = nn.ModuleList(layers)
        self.final_ln = frozen(final_ln)


class T5Params(nn.Module):
    """shared (V, d), encoder and decoder stacks, lm_head (V, d) when the
    word embeddings are not tied."""

    def __init__(self, shared, encoder: T5Stack, decoder: T5Stack, lm_head=None):
        super().__init__()
        self.shared = frozen(shared)
        self.encoder, self.decoder = encoder, decoder
        self.lm_head = None if lm_head is None else frozen(lm_head)


def _init_attn(g: torch.Generator, cfg: T5Config) -> T5Attention:
    d, inner = cfg.d_model, cfg.inner_dim
    return T5Attention(
        q=normal_init(g, (inner, d), (d * cfg.d_kv) ** -0.5),
        k=normal_init(g, (inner, d), d**-0.5),
        v=normal_init(g, (inner, d), d**-0.5),
        o=normal_init(g, (d, inner), inner**-0.5),
    )


def _init_ffn(g: torch.Generator, cfg: T5Config) -> T5FFN:
    d, f = cfg.d_model, cfg.d_ff
    wo = normal_init(g, (d, f), f**-0.5)
    if cfg.gated_ffn:
        return T5FFN(wo, wi_0=normal_init(g, (f, d), d**-0.5), wi_1=normal_init(g, (f, d), d**-0.5))
    return T5FFN(wo, wi=normal_init(g, (f, d), d**-0.5))


def init_t5_params(generator: torch.Generator, cfg: T5Config) -> T5Params:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions (`init_t5_params`); norms start at one."""
    g, d, dev = generator, cfg.d_model, generator.device
    ones = lambda: torch.ones(d, device=dev)
    rel_std = (cfg.d_model * cfg.d_kv) ** -0.5
    shared = normal_init(g, (cfg.vocab_size, d), 1.0)
    encoder = T5Stack(
        normal_init(g, (cfg.rel_buckets, cfg.num_heads), rel_std),
        [T5EncoderLayer(ones(), ones(), _init_attn(g, cfg), _init_ffn(g, cfg))
         for _ in range(cfg.num_encoder_layers)],
        ones(),
    )
    decoder = T5Stack(
        normal_init(g, (cfg.rel_buckets, cfg.num_heads), rel_std),
        [T5DecoderLayer(ones(), ones(), ones(), _init_attn(g, cfg), _init_attn(g, cfg), _init_ffn(g, cfg))
         for _ in range(cfg.num_decoder_layers)],
        ones(),
    )
    lm_head = None if cfg.tie_word_embeddings else normal_init(g, (cfg.vocab_size, d), d**-0.5)
    return T5Params(shared, encoder, decoder, lm_head)


# --------------------------------------------------------------------------- #
# relative position bias
# --------------------------------------------------------------------------- #
def _relative_position_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """The JAX bucket math: float32, 1e-9 inside the log, truncated to int."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(rel.dtype) * num_buckets
        n = rel.abs()
    else:
        n = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_bias(table: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                  bidirectional: bool, cfg: T5Config) -> torch.Tensor:
    """(buckets, H) table, (Tq,) and (Tk,) positions -> (1, H, Tq, Tk).

    The buckets are computed on the CPU, so every device sees the same
    ones, and moved to the table's device in one copy."""
    rel = k_pos.cpu()[None, :] - q_pos.cpu()[:, None]
    buckets = _relative_position_bucket(rel, bidirectional, cfg.rel_buckets, cfg.rel_max_distance)
    return table[buckets.to(table.device)].permute(2, 0, 1)[None]


# --------------------------------------------------------------------------- #
# attention / ffn primitives
# --------------------------------------------------------------------------- #
def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return x.view(x.shape[0], x.shape[1], n_heads, -1)


def _attend(q, k, v, bias, mask, return_probs: bool = False):
    """q (B, Tq, H, dk), k/v (B, Tk, H, dk), bias (1|B, H, Tq, Tk), mask
    broadcastable to (B, H, Tq, Tk) -> (B, Tq, H*dk) in q's dtype: f32
    scores, masked at -1e9, probabilities cast to q's dtype. With
    return_probs, also those (B, H, Tq, Tk) probabilities."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    return (out, probs) if return_probs else out


def _ffn(p: T5FFN, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    if cfg.gated_ffn:
        h = torch.nn.functional.gelu(dense(x, p.wi_0), approximate="tanh") * dense(x, p.wi_1)
    else:
        h = torch.relu(dense(x, p.wi))
    return dense(h, p.wo)


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
def encode(params: T5Params, cfg: T5Config, inputs_embeds: torch.Tensor,
           attention_mask: torch.Tensor, train: bool = False) -> torch.Tensor:
    """(B, T, D) embeds, (B, T) bool mask -> (B, T, D) hidden states. With
    train, differentiable through the hand-written layer backward."""
    enc = params.encoder
    T = inputs_embeds.shape[1]
    pos = torch.arange(T)
    bias = relative_bias(enc.rel_bias, pos, pos, bidirectional=True, cfg=cfg)[0].to(torch.bfloat16).contiguous()
    layer_fn = t5_layer_train if train else fused_t5_layer_parts
    if train and cfg.remat_layers:
        layer_fn = _checkpointed(layer_fn)
    x = inputs_embeds
    for l in fuse_t5_blocks(enc.layers, cfg.gated_ffn):
        x = layer_fn(x, attention_mask, bias, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps,
                     gated=cfg.gated_ffn)
    return rms_norm(x, enc.final_ln, cfg.layer_norm_eps)


def _checkpointed(fn):
    """`fn` under a non-reentrant `torch.utils.checkpoint`: its backward
    recomputes its forward instead of keeping what the forward saved."""
    from torch.utils.checkpoint import checkpoint

    return lambda *args, **kw: checkpoint(fn, *args, use_reentrant=False, **kw)


# --------------------------------------------------------------------------- #
# decoder, teacher-forced
# --------------------------------------------------------------------------- #
def decode_train(params: T5Params, cfg: T5Config, decoder_input_ids: torch.Tensor,
                 encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor, return_cross_attn: bool = False):
    """Full-sequence decoder forward: causal self-attention with the
    decoder's rel-pos bias, masked cross-attention over the encoder output,
    the FFN; returns (B, Td, V) logits. With return_cross_attn, also the
    cross-attention probabilities of every layer, (L, B, H, Td, Te) in the
    activations' dtype (Hi-VT5's `attention_viz` maps them back to pages)."""
    dec = params.decoder
    Td = decoder_input_ids.shape[1]
    x = params.shared[decoder_input_ids]
    pos = torch.arange(Td)
    bias = relative_bias(dec.rel_bias, pos, pos, bidirectional=False, cfg=cfg)
    causal = (pos[None, :] <= pos[:, None]).to(x.device)[None, None]
    cross_mask = encoder_mask[:, None, None, :]
    block = _checkpointed(_decoder_layer) if cfg.remat_layers and not return_cross_attn else _decoder_layer
    cross = []
    for layer in dec.layers:
        x, probs = block(x, layer, cfg, bias, causal, encoder_hidden, cross_mask)
        if return_cross_attn:
            cross.append(probs)
    x = rms_norm(x, dec.final_ln, cfg.layer_norm_eps)
    logits = lm_logits(params, cfg, x)
    return (logits, torch.stack(cross)) if return_cross_attn else logits


def _decoder_layer(x, layer: T5DecoderLayer, cfg: T5Config, bias, causal, encoder_hidden, cross_mask):
    """One teacher-forced decoder layer: (x, its cross-attention probabilities)."""
    H = cfg.num_heads
    sa, ca = layer.self_attn, layer.cross_attn
    h = rms_norm(x, layer.ln0, cfg.layer_norm_eps)
    q, k, v = (_split_heads(dense(h, w), H) for w in (sa.q, sa.k, sa.v))
    x = x + dense(_attend(q, k, v, bias, causal), sa.o)
    h = rms_norm(x, layer.ln1, cfg.layer_norm_eps)
    q = _split_heads(dense(h, ca.q), H)
    k, v = (_split_heads(dense(encoder_hidden, w), H) for w in (ca.k, ca.v))
    attended, probs = _attend(q, k, v, None, cross_mask, return_probs=True)
    x = x + dense(attended, ca.o)
    h = rms_norm(x, layer.ln2, cfg.layer_norm_eps)
    return x + _ffn(layer.ffn, cfg, h), probs


def shift_tokens_right(labels: torch.Tensor, pad_id: int, decoder_start_token_id: int) -> torch.Tensor:
    """Teacher-forcing shift: the start token, then labels[:, :-1]; -100
    (ignored positions) becomes pad."""
    shifted = torch.full_like(labels, decoder_start_token_id)
    shifted[:, 1:] = labels[:, :-1]
    return torch.where(shifted == -100, pad_id, shifted)


def lm_logits(params: T5Params, cfg: T5Config, hidden: torch.Tensor) -> torch.Tensor:
    """Tied head: scale by d^-0.5, then the product with the shared table.
    The scale is rounded to hidden's dtype first, as JAX rounds a weak-typed
    Python scalar (bf16: 768**-0.5 = 0.036084 becomes 0.036133)."""
    if cfg.tie_word_embeddings:
        hidden = hidden * torch.tensor(cfg.d_model**-0.5, dtype=hidden.dtype).item()
        return torch.matmul(hidden, params.shared.to(hidden.dtype).t())
    return dense(hidden, params.lm_head)


# --------------------------------------------------------------------------- #
# incremental decoding with a KV cache
# --------------------------------------------------------------------------- #
@dataclass
class DecodeCache:
    """Per-layer tensors stacked on a leading L axis. self_k/self_v
    (L, B, H, Tmax, dk) are written in place by `decode_step`. The cross
    cache is (L, B, H, Te, dk), or with cfg.fused_decode_attn the
    `pack_decode_kv` layouts (L, B, H*dk, Te) / (L, B, Te, H*dk); its ndim
    decides the path `decode_step` takes."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None  # (L, B, H, 1, dk) f32, int8 only
    cross_v_scale: Optional[torch.Tensor] = None


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, T, dk) -> int8 values + per-(B, H, dk) channel scales; amax
    floored at 1e-12, /127, round half to even (as jnp.round)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=2, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(x32 / scale).clamp(-127, 127).to(torch.int8), scale


def init_decode_cache(params: T5Params, cfg: T5Config, encoder_hidden: torch.Tensor,
                      max_decode_len: int) -> DecodeCache:
    """Cross-attention K/V of every decoder layer, computed once; zeroed
    self K/V for `max_decode_len` positions."""
    B, Te, _ = encoder_hidden.shape
    H, dk = cfg.num_heads, cfg.d_kv
    ks, vs, kss, vss = [], [], [], []
    for layer in params.decoder.layers:
        k = dense(encoder_hidden, layer.cross_attn.k).view(B, Te, H, dk).transpose(1, 2)
        v = dense(encoder_hidden, layer.cross_attn.v).view(B, Te, H, dk).transpose(1, 2)
        if cfg.decode_kv_int8:
            k, k_scale = _quantize_kv(k)
            v, v_scale = _quantize_kv(v)
            kss.append(k_scale)
            vss.append(v_scale)
        if cfg.fused_decode_attn:
            k, v = pack_decode_kv(k, v)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
    L = len(ks)
    self_shape = (L, B, H, max_decode_len, dk)
    return DecodeCache(
        self_k=torch.zeros(self_shape, dtype=encoder_hidden.dtype, device=encoder_hidden.device),
        self_v=torch.zeros(self_shape, dtype=encoder_hidden.dtype, device=encoder_hidden.device),
        cross_k=torch.stack(ks), cross_v=torch.stack(vs),
        cross_k_scale=torch.stack(kss) if kss else None,
        cross_v_scale=torch.stack(vss) if vss else None,
    )


def _attend_one(q, k, v, bias, mask):
    """q (B, H, dk), k/v (B, H, T, dk), bias (1|B, H, T), mask (1|B, 1|H, T)
    -> (B, H*dk) in q's dtype."""
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k.float())
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bht,bhtd->bhd", probs.float(), v.float()).to(q.dtype)
    return out.reshape(out.shape[0], -1)


def decode_step(params: T5Params, cfg: T5Config, cache: DecodeCache, token: torch.Tensor,
                step: int, encoder_mask: torch.Tensor,
                self_bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, DecodeCache]:
    """One greedy step at position `step` (a Python int: no host sync).
    Returns ((B, V) logits, cache); the self K/V of `step` is written into
    the cache in place, where JAX returns an updated copy. `self_bias`
    (1, H, Tmax) is this step's row of the decoder rel-pos bias; when None
    it is computed here."""
    dec = params.decoder
    B = token.shape[0]
    H, dk = cfg.num_heads, cfg.d_kv
    Tmax = cache.self_k.shape[3]
    x = params.shared[token]
    if self_bias is None:
        self_bias = relative_bias(dec.rel_bias, torch.tensor([step]), torch.arange(Tmax),
                                  bidirectional=False, cfg=cfg)[:, :, 0, :]
    self_mask = (torch.arange(Tmax, device=x.device) <= step)[None, None, :]
    cross_mask = encoder_mask[:, None, :]
    int8_kv = cache.cross_k_scale is not None
    use_fused = cache.cross_k.dim() == 4

    def split(h, w):
        return dense(h, w).view(B, H, dk)

    for i, layer in enumerate(dec.layers):
        sa, ca = layer.self_attn, layer.cross_attn
        h = rms_norm(x, layer.ln0, cfg.layer_norm_eps)
        q = split(h, sa.q)
        sk, sv = cache.self_k[i], cache.self_v[i]
        sk[:, :, step] = split(h, sa.k)
        sv[:, :, step] = split(h, sa.v)
        x = x + dense(_attend_one(q, sk, sv, self_bias, self_mask), sa.o)
        h = rms_norm(x, layer.ln1, cfg.layer_norm_eps)
        q = split(h, ca.q)
        ck, cv = cache.cross_k[i], cache.cross_v[i]
        if use_fused:
            a = fused_cross_attention(
                q, ck, cv, encoder_mask,
                k_scale=cache.cross_k_scale[i][:, :, 0, :] if int8_kv else None,
                v_scale=cache.cross_v_scale[i][:, :, 0, :] if int8_kv else None,
                out_dtype=q.dtype,
            )
        elif int8_kv:
            # channel scales fold into the query (scores) and the output (p@V)
            qs = q.float() * cache.cross_k_scale[i][:, :, 0, :]
            scores = torch.einsum("bhd,bhtd->bht", qs, ck.float())
            probs = torch.softmax(torch.where(cross_mask, scores, MASKED), dim=-1)
            out = torch.einsum("bht,bhtd->bhd", probs, cv.float()) * cache.cross_v_scale[i][:, :, 0, :]
            a = out.to(q.dtype).reshape(B, -1)
        else:
            a = _attend_one(q, ck, cv, None, cross_mask)
        x = x + dense(a, ca.o)
        h = rms_norm(x, layer.ln2, cfg.layer_norm_eps)
        x = x + _ffn(layer.ffn, cfg, h)
    x = rms_norm(x, dec.final_ln, cfg.layer_norm_eps)
    return lm_logits(params, cfg, x[:, None, :])[:, 0, :], cache


def decoder_self_bias(params: T5Params, cfg: T5Config, max_decode_len: int) -> torch.Tensor:
    """(1, H, Tmax, Tmax) decoder rel-pos bias; row t is step t's bias."""
    pos = torch.arange(max_decode_len)
    return relative_bias(params.decoder.rel_bias, pos, pos, bidirectional=False, cfg=cfg)

