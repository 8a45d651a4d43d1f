"""Contrastive retriever fine-tuning.

Counterpart of `rag_docvqa_tpu/training/contrastive.py`:

  * Positive mining (`mine_positive_pairs`): run per-chunk inference, keep
    retrieved chunks whose own answer reaches ANLS > 0.8 as (question, chunk)
    pairs; pairs persist as JSONL (`save_pairs`, `load_pairs`). It takes any
    engine whose result carries one answer per retrieved chunk (the
    `anyconf` strategy; `python -m rag_docvqa_tpu_torch.train_cl mine`).
  * Losses: `multiple_negatives_ranking_loss`, in-batch InfoNCE over cosine
    similarities at scale 20, and `clip_style_loss`, the symmetric variant at
    temperature 0.07.
  * `train_contrastive`: the step over the BGE bi-encoder
    (`bert_sentence_embed`: forward K9, backward K10) or the VT5 shared-table
    embedder. The optimizer is `optax.adamw(lr)`'s: b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4, no clipping, no schedule.

bf16_compute is the JAX mixed precision: f32 master weights and, inside the
loss, a bf16 copy of every floating parameter made by a differentiable cast;
embeddings go back to f32 before the loss. The two embeds of a step share
the parameters, so their gradients add in autograd's accumulation, in f32.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.training.optimizer import Optimizer
from rag_docvqa_tpu_torch.training.train_step import cast_params


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
def _cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
    return a @ b.t()


def _diag_nll(logits: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def multiple_negatives_ranking_loss(anchors: torch.Tensor, positives: torch.Tensor, scale: float = 20.0
                                    ) -> torch.Tensor:
    """In-batch InfoNCE over (B, D) question and chunk embeddings: other
    rows' positives are negatives."""
    return _diag_nll(_cosine_matrix(anchors, positives) * scale)


def clip_style_loss(anchors: torch.Tensor, positives: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE."""
    logits = _cosine_matrix(anchors, positives) / temperature
    return (_diag_nll(logits) + _diag_nll(logits.t())) / 2


# --------------------------------------------------------------------------- #
# positive mining
# --------------------------------------------------------------------------- #
def mine_positive_pairs(engine, docs: Sequence, ingestor, anls_threshold: float = 0.8, batch_size: int = 8
                        ) -> List[Tuple[str, str]]:
    """Per-chunk inference -> (question, chunk) pairs where the chunk's own
    answer scores ANLS > threshold."""
    ev = Evaluator()
    pairs: List[Tuple[str, str]] = []
    for start in range(0, len(docs), batch_size):
        chunk_docs = list(docs[start: start + batch_size])
        batch, aux = ingestor.ingest(chunk_docs)
        out = engine.inference(batch, aux)
        texts = out["retrieval"].get("text", [])
        for b, doc in enumerate(chunk_docs):
            preds = out["pred_answers"][b]
            if preds is None or not isinstance(preds, list) or b >= len(texts):
                continue
            for chunk_text, pred in zip(texts[b], preds):
                anls = ev.get_metrics([doc.answers], [pred])["anls"][0]
                if anls > anls_threshold:
                    pairs.append((doc.question, chunk_text))
    return pairs


def save_pairs(path: str, pairs: Iterable[Tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for anchor, positive in pairs:
            f.write(json.dumps({"anchor": anchor, "positive": positive}) + "\n")


def load_pairs(path: str) -> List[Tuple[str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out.append((d["anchor"], d["positive"]))
    return out


# --------------------------------------------------------------------------- #
# trainer
# --------------------------------------------------------------------------- #
@dataclass
class ContrastiveConfig:
    lr: float = 2e-5
    epochs: int = 15
    batch_size: int = 32
    loss: str = "mnrl"  # "mnrl" | "clip"
    scale: float = 20.0
    temperature: float = 0.07
    max_tokens: int = 64
    seed: int = 0
    # bf16 compute with f32 master weights (losses and similarities stay
    # f32). Off by default to keep tiny-lr runs bit-stable.
    bf16_compute: bool = False


def contrastive_optimizer(lr: float) -> Optimizer:
    """`optax.adamw(lr)`: weight decay 1e-4, no clip, no schedule."""
    return Optimizer(lr=lr, clip_norm=None, weight_decay=1e-4, constant_lr=True)


def make_contrastive_step(embed_fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor],
                          opt: Optimizer, cfg: ContrastiveConfig):
    """Returns step(params, opt_state, a_ids, a_mask, p_ids, p_mask, mark=None)
    -> loss (0-d tensor): one update of `params` (the f32 masters, in place)
    and `opt_state`. `mark(name)`, when given, is called after "forward",
    "backward" and "update", for timing."""
    if cfg.loss == "mnrl":
        loss_fn = lambda a, b: multiple_negatives_ranking_loss(a, b, scale=cfg.scale)
    else:
        loss_fn = lambda a, b: clip_style_loss(a, b, temperature=cfg.temperature)

    def step(params: nn.Module, opt_state: dict, a_ids, a_mask, p_ids, p_mask,
             mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
        mark = mark or (lambda name: None)
        trainable = opt.trainable(params)
        p = cast_params(params, torch.bfloat16) if cfg.bf16_compute else params
        a = embed_fn(p, a_ids, a_mask).float()
        b = embed_fn(p, p_ids, p_mask).float()
        loss = loss_fn(a, b)
        mark("forward")
        grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
        mark("backward")
        opt.update(trainable, grads, opt_state)
        mark("update")
        return loss.detach()

    return step


def encode_texts(tokenizer, texts: Sequence[str], max_tokens: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, max_tokens) int32 ids, zero padded, and their bool mask."""
    ids = np.zeros((len(texts), max_tokens), np.int32)
    mask = np.zeros((len(texts), max_tokens), bool)
    for i, t in enumerate(texts):
        tok = tokenizer.encode(t)[:max_tokens]
        ids[i, : len(tok)] = tok
        mask[i, : len(tok)] = True
    return ids, mask


def train_contrastive(embed_fn: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor], params: nn.Module,
                      tokenizer, pairs: Sequence[Tuple[str, str]], cfg: ContrastiveConfig
                      ) -> Tuple[nn.Module, List[float]]:
    """Fine-tune an embedder on (anchor, positive) pairs, on the parameters'
    device. embed_fn(params, tokens (B, T), mask (B, T)) -> (B, D). Every
    parameter of `params` trains, in place. Returns (params, per-epoch mean
    losses); batches are drawn as the JAX trainer draws them
    (`np.random.RandomState(seed)` shuffles, the ragged tail dropped)."""
    rng = np.random.RandomState(cfg.seed)
    dev = next(params.parameters()).device
    opt = contrastive_optimizer(cfg.lr)
    opt_state = opt.init(params)
    step = make_contrastive_step(embed_fn, opt, cfg)
    on_dev = lambda arr: torch.from_numpy(arr).to(dev)

    losses: List[float] = []
    order = np.arange(len(pairs))
    for _ in range(cfg.epochs):
        rng.shuffle(order)
        epoch_losses = []
        for s in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
            idx = order[s: s + cfg.batch_size]
            a_ids, a_mask = encode_texts(tokenizer, [pairs[i][0] for i in idx], cfg.max_tokens)
            p_ids, p_mask = encode_texts(tokenizer, [pairs[i][1] for i in idx], cfg.max_tokens)
            loss = step(params, opt_state, on_dev(a_ids), on_dev(a_mask), on_dev(p_ids), on_dev(p_mask))
            epoch_losses.append(float(loss))
        losses.append(float(np.mean(epoch_losses)) if epoch_losses else 0.0)
    return params, losses
