"""BERT/RoBERTa-family encoder: the BGE bi-encoder and the cross-encoder
reranker.

Counterpart of `rag_docvqa_tpu/models/bert.py`: `BertConfig` (the same
fields), `init_bert_params`, `bert_encode` (embeddings with the RoBERTa
cumulative positions, embedding LayerNorm, the layer stack), `_alibi_bias`,
`bert_sentence_embed` (CLS or masked-mean pooling, L2 normalize, leading
batch dims), `cross_encoder_score` and `convert_bert_state_dict` (numpy
only; kept as this package's own copy). Parameters are `nn.Module`s holding
per-layer tensors, dense weights (out, in), created frozen; a trainer turns
`requires_grad` on where it trains.

The vanilla block has one path: every layer through K9
(ops/fused_encoder.py), and through `BertLayerTrain` (backward K10)
whenever a gradient is required. There is no `fused=` switch, no T % 8
padding and no eligibility gate: on CUDA tensors it always runs the kernels.
The JINA options (`use_alibi`, `glu_mlp`) are plain tensor code in the JAX
package too (`_xla_blocks`; its fused kernel raises for them), so they are
plain PyTorch here and launch no kernel; masked scores are -1e9 there and
-1e30 in the kernels, as in JAX. The embedding gathers and their LayerNorm,
the pooling and the classifier head are outside the TPU kernels and plain
here as well.

A sequence with no valid key (a padded chunk slot) comes out finite; its
values differ from the JAX package's (zero attention output here, a uniform
softmax there) and are masked downstream by `chunk_mask`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from rag_docvqa_tpu_torch.models.layers import dense, frozen, layer_norm, normal_init
from rag_docvqa_tpu_torch.ops.fused_encoder import bert_layer_train, fuse_bert_blocks, fused_bert_layer_parts


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384  # bge-small
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    position_offset: int = 0  # RoBERTa: pad_id + 1 (= 2)
    pad_id: int = 0
    num_labels: int = 0  # > 0 adds a classification head (reranker)
    # JinaBERT: ALiBi attention bias instead of position embeddings, GLU
    # feed-forward, mean pooling
    use_alibi: bool = False
    glu_mlp: bool = False
    pooling: str = "cls"  # "cls" | "mean"


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
LAYER_FIELDS = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b", "attn_ln_w", "attn_ln_b",
                "fc1_w", "fc1_b", "fc2_w", "fc2_b", "out_ln_w", "out_ln_b")


class BertLayer(nn.Module):
    """q/k/v/o (d, d) with biases, the attention LayerNorm, fc1 (d_ff, d)
    (or (2 d_ff, d) = [gate; up] for a GLU config), fc2 (d, d_ff), the output
    LayerNorm."""

    def __init__(self, **tensors):
        super().__init__()
        for name in LAYER_FIELDS:
            setattr(self, name, frozen(tensors[name]))


class BertParams(nn.Module):
    """word_emb (V, d), pos_emb (P, d), type_emb (types, d), the embedding
    LayerNorm, the layers, and the classification head (cls_dense (d, d),
    cls_out (labels, d)) when the config has labels."""

    def __init__(self, word_emb, pos_emb, type_emb, emb_ln_w, emb_ln_b, layers, cls_dense_w=None, cls_dense_b=None,
                 cls_out_w=None, cls_out_b=None):
        super().__init__()
        self.word_emb, self.pos_emb, self.type_emb = frozen(word_emb), frozen(pos_emb), frozen(type_emb)
        self.emb_ln_w, self.emb_ln_b = frozen(emb_ln_w), frozen(emb_ln_b)
        self.layers = nn.ModuleList(layers)
        self.has_head = cls_dense_w is not None
        if self.has_head:
            self.cls_dense_w, self.cls_dense_b = frozen(cls_dense_w), frozen(cls_dense_b)
            self.cls_out_w, self.cls_out_b = frozen(cls_out_w), frozen(cls_out_b)


def init_bert_params(generator: torch.Generator, cfg: BertConfig) -> BertParams:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions (`init_bert_params`): N(0, 0.02^2) tables and kernels, zero
    biases, LayerNorms at (1, 0)."""
    g, d, dev = generator, cfg.hidden_size, generator.device
    zeros = lambda n: torch.zeros(n, device=dev)
    ones = lambda n: torch.ones(n, device=dev)
    lin = lambda dout, din: (normal_init(g, (dout, din), 0.02), zeros(dout))
    f1 = cfg.intermediate_size * (2 if cfg.glu_mlp else 1)
    layers = []
    for _ in range(cfg.num_layers):
        t = {}
        for name, (dout, din) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)), ("fc1", (f1, d)),
                                  ("fc2", (d, cfg.intermediate_size))):
            t[f"{name}_w"], t[f"{name}_b"] = lin(dout, din)
        t.update(attn_ln_w=ones(d), attn_ln_b=zeros(d), out_ln_w=ones(d), out_ln_b=zeros(d))
        layers.append(BertLayer(**t))
    head = {}
    if cfg.num_labels > 0:  # RobertaClassificationHead: dense -> tanh -> out_proj
        head["cls_dense_w"], head["cls_dense_b"] = lin(d, d)
        head["cls_out_w"], head["cls_out_b"] = lin(cfg.num_labels, d)
    pos = torch.zeros((1, d), device=dev) if cfg.use_alibi else normal_init(g, (cfg.max_position_embeddings, d), 0.02)
    return BertParams(normal_init(g, (cfg.vocab_size, d), 0.02), pos,
                      normal_init(g, (max(cfg.type_vocab_size, 1), d), 0.02), ones(d), zeros(d), layers, **head)


# --------------------------------------------------------------------------- #
# the encoder
# --------------------------------------------------------------------------- #
def roberta_positions(attention_mask: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """RoBERTa position ids: the count of valid tokens up to and including
    each one, zero on padding, offset by pad_id + 1 and clipped to the table.
    Integer, exact."""
    m = attention_mask.to(torch.int64)
    pos = torch.cumsum(m, dim=1) * m + cfg.pad_id
    return (pos + cfg.position_offset - 1 - cfg.pad_id).clamp(0, cfg.max_position_embeddings - 1)


def bert_embed(params: BertParams, cfg: BertConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer stack's input: word + position + type embeddings through the
    embedding LayerNorm, (B, T, d) in the parameters' dtype."""
    B, T = input_ids.shape
    if cfg.use_alibi:
        x = params.word_emb[input_ids]  # positions come from the ALiBi bias
    else:
        if cfg.position_offset:
            pos = roberta_positions(attention_mask, cfg)
        else:
            pos = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = params.word_emb[input_ids] + params.pos_emb[pos]
    if token_type_ids is None:
        token_type_ids = torch.zeros((B, T), dtype=torch.int64, device=input_ids.device)
    x = x + params.type_emb[token_type_ids]
    return layer_norm(x, params.emb_ln_w, params.emb_ln_b, cfg.layer_norm_eps)


def bert_encode(params: BertParams, cfg: BertConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids (B, T) int, attention_mask (B, T) bool -> (B, T, d) in the
    parameters' dtype."""
    attention_mask = attention_mask.to(torch.bool)
    x = bert_embed(params, cfg, input_ids, attention_mask, token_type_ids)
    if cfg.use_alibi or cfg.glu_mlp:
        return _plain_blocks(params.layers, cfg, x, attention_mask)
    train = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params.layers.parameters()))
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    for l in fuse_bert_blocks(params.layers):
        x = bert_layer_train(x, attention_mask, l, **kw) if train else fused_bert_layer_parts(x, attention_mask, l,
                                                                                               **kw)
    return x


def _plain_blocks(layers, cfg: BertConfig, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """The JAX `_xla_blocks`: the layer in plain tensor code, for the ALiBi
    and GLU (JINA) configs. Scores in f32, masked at -1e9, probabilities cast
    to x's dtype before p.v."""
    B, T, _ = x.shape
    H, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    mask = attention_mask[:, None, None, :]
    alibi = _alibi_bias(H, T, x.device) if cfg.use_alibi else None
    for l in layers:
        q = dense(x, l.q_w, l.q_b).view(B, T, H, dh)
        k = dense(x, l.k_w, l.k_b).view(B, T, H, dh)
        v = dense(x, l.v_w, l.v_b).view(B, T, H, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
        if alibi is not None:
            s = s + alibi
        s = torch.where(mask, s, -1e9)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, cfg.hidden_size)
        x = layer_norm(x + dense(a, l.o_w, l.o_b), l.attn_ln_w, l.attn_ln_b, cfg.layer_norm_eps)
        h = dense(x, l.fc1_w, l.fc1_b)
        if cfg.glu_mlp:
            gate, up = h.chunk(2, dim=-1)
            h = nn.functional.gelu(gate) * up
        else:
            h = nn.functional.gelu(h)
        x = layer_norm(x + dense(h, l.fc2_w, l.fc2_b), l.out_ln_w, l.out_ln_b, cfg.layer_norm_eps)
    return x


def _alibi_bias(n_heads: int, T: int, device=None) -> torch.Tensor:
    """Symmetric (encoder) ALiBi: bias[h, i, j] = -slope_h * |i - j| with the
    standard geometric slopes 2^(-8h/H). (1, H, T, T) f32."""

    def slopes(n):
        if math.log2(n).is_integer():
            start = 2.0 ** (-8.0 / n)
            return [start ** (i + 1) for i in range(n)]
        p = 2 ** math.floor(math.log2(n))
        return slopes(p) + slopes(2 * p)[0::2][: n - p]

    m = torch.tensor(slopes(n_heads), dtype=torch.float32, device=device)[:, None, None]
    pos = torch.arange(T, device=device)
    dist = (pos[:, None] - pos[None, :]).abs().to(torch.float32)
    return (-m * dist)[None]


def bert_sentence_embed(params: BertParams, cfg: BertConfig, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
    """Sentence embedding + L2 normalize: the CLS token (BGE) or the masked
    mean (JINA), per cfg.pooling. Takes leading batch dims, e.g. (B, C, T)
    chunk batches -> (B, C, d)."""
    lead = input_ids.shape[:-1]
    T = input_ids.shape[-1]
    mask = attention_mask.reshape(-1, T)
    h = bert_encode(params, cfg, input_ids.reshape(-1, T), mask)
    if cfg.pooling == "mean":
        m = mask.to(h.dtype)[..., None]
        emb = (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    else:
        emb = h[:, 0, :]
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
    return emb.reshape(lead + (cfg.hidden_size,))


def cross_encoder_score(params: BertParams, cfg: BertConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                        token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pair relevance scores in [0, 1] for (N, T) [CLS] q [SEP] doc [SEP]
    rows: tanh head on the CLS token, sigmoid of the single logit."""
    h = bert_encode(params, cfg, input_ids, attention_mask, token_type_ids)
    cls = torch.tanh(dense(h[:, 0, :], params.cls_dense_w, params.cls_dense_b))
    logits = dense(cls, params.cls_out_w, params.cls_out_b)
    return torch.sigmoid(logits[..., 0])


# --------------------------------------------------------------------------- #
# HF conversion
# --------------------------------------------------------------------------- #
def convert_bert_state_dict(sd: Dict[str, Any], cfg: BertConfig, prefix: str = "") -> Dict[str, Any]:
    """Convert HF BertModel / XLMRobertaForSequenceClassification weights
    into the JAX package's tree of numpy arrays (stacked (L, in, out)
    kernels), which `params.bert_from_jax` turns into `BertParams`.

    `prefix` is "" for BertModel, "roberta." / "bert." for classifier models.
    """

    def t(name):
        return np.ascontiguousarray(np.asarray(sd[name]).T)

    def a(name):
        return np.asarray(sd[name])

    L = cfg.num_layers
    e = prefix + "embeddings."
    lyr = prefix + "encoder.layer.{}."

    def stack(fmt, transpose=True):
        mats = [sd[fmt.format(i)] for i in range(L)]
        mats = [np.asarray(m) for m in mats]
        if transpose:
            mats = [np.ascontiguousarray(m.T) for m in mats]
        return np.stack(mats)

    params = {
        "word_emb": a(e + "word_embeddings.weight"),
        "pos_emb": a(e + "position_embeddings.weight"),
        "type_emb": a(e + "token_type_embeddings.weight")
        if e + "token_type_embeddings.weight" in sd
        else np.zeros((1, cfg.hidden_size), np.float32),
        "emb_ln_w": a(e + "LayerNorm.weight"),
        "emb_ln_b": a(e + "LayerNorm.bias"),
        "blocks": {
            "q": {"kernel": stack(lyr + "attention.self.query.weight"), "bias": stack(lyr + "attention.self.query.bias", False)},
            "k": {"kernel": stack(lyr + "attention.self.key.weight"), "bias": stack(lyr + "attention.self.key.bias", False)},
            "v": {"kernel": stack(lyr + "attention.self.value.weight"), "bias": stack(lyr + "attention.self.value.bias", False)},
            "o": {"kernel": stack(lyr + "attention.output.dense.weight"), "bias": stack(lyr + "attention.output.dense.bias", False)},
            "attn_ln_w": stack(lyr + "attention.output.LayerNorm.weight", False),
            "attn_ln_b": stack(lyr + "attention.output.LayerNorm.bias", False),
            "fc1": {"kernel": stack(lyr + "intermediate.dense.weight"), "bias": stack(lyr + "intermediate.dense.bias", False)},
            "fc2": {"kernel": stack(lyr + "output.dense.weight"), "bias": stack(lyr + "output.dense.bias", False)},
            "out_ln_w": stack(lyr + "output.LayerNorm.weight", False),
            "out_ln_b": stack(lyr + "output.LayerNorm.bias", False),
        },
    }
    if cfg.num_labels > 0:
        params["cls_dense"] = {"kernel": t("classifier.dense.weight"), "bias": a("classifier.dense.bias")}
        params["cls_out"] = {"kernel": t("classifier.out_proj.weight"), "bias": a("classifier.out_proj.bias")}
    return params
