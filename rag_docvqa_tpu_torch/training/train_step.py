"""The VT5 train step (retrieve -> assemble -> teacher-forced loss ->
backward -> update) and the Hi-VT5 one.

Counterpart of `rag_docvqa_tpu/training/train_step.py` (`TrainState`,
`make_train_step`, `make_hivt5_train_step`) on one device. Retrieval and
assembly run without gradient, as the JAX step stops the gradient at the
retrieval table; the encoder's backward is the hand-written K7/K8 pair
(`models/t5.py::encode` with train=True). With `use_nac` the step adds the
not-answerable classifier's weighted BCE: a greedy decode of
`nac_decode_len` tokens through the frozen parameters (no gradient; K3 on
the card where `fused_decode_attn` is set) gives the predicted answers, and
the NAC sees their embeddings beside the generator input's, so that only the
NAC MLP receives this term's gradient. `make_hivt5_train_step` is the Hi-VT5
step (LM and page cross-entropy). Remat is not ported yet and raises.

bf16_compute is the JAX mixed precision: f32 master weights, and inside
the loss a bf16 copy of every floating parameter made by a differentiable
cast, so the gradients come back to the f32 masters.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, to_device
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, retrieve
from rag_docvqa_tpu_torch.models import hivt5 as hivt5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embeddings import spatial_embed
from rag_docvqa_tpu_torch.models.nac import nac_bce_loss, nac_prob
from rag_docvqa_tpu_torch.ops.gather import assemble_concat
from rag_docvqa_tpu_torch.training.optimizer import Optimizer, global_norm


@dataclass
class TrainState:
    params: vt5m.VT5Params  # f32 masters, updated in place
    opt_state: dict
    step: int = 0

    @staticmethod
    def create(params: vt5m.VT5Params, opt: Optimizer) -> "TrainState":
        return TrainState(params=params, opt_state=opt.init(params), step=0)


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of the module tree whose floating parameters are `p.to(dtype)`:
    differentiable casts that share no storage with the masters."""
    out = copy.copy(module)
    out._parameters = {n: p if p is None or not p.is_floating_point() else p.to(dtype)
                       for n, p in module._parameters.items()}
    out._modules = {n: None if m is None else cast_params(m, dtype) for n, m in module._modules.items()}
    return out


def make_train_step(vt5_cfg: vt5m.VT5Config, rag_cfg: RAGConfig, opt: Optimizer, bf16_compute: bool = False,
                    use_nac: bool = False, nac_loss_weight: float = 1.0, nac_pos_weight: float = 1.0,
                    nac_decode_len: int = 16, remat=False
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch, labels, nac_labels=None, mark=None) ->
    (state, metrics).

    batch is a `ChunkedBatch` (numpy, or tensors on the parameters'
    device); labels (B, Td) int with -100 padding; with `use_nac`,
    nac_labels (B,) float, 1 for a not-answerable sample, and the
    parameters carry `nac`. metrics: "loss", "grad_norm" (all trainable
    gradients) and "grad_norm/<root>" for each trainable root, with
    `use_nac` "nac_loss" and "nac_accuracy" too, 0-d tensors. `mark(name)`,
    when given, is called after "forward", "backward" and "update", for
    timing."""
    if remat:
        raise NotImplementedError("remat waits in ROADMAP Queue 1 item 11")
    acfg = rag_cfg.assemble()
    oracle = rag_cfg.page_retrieval == "oracle"

    def step(state: TrainState, batch: ChunkedBatch, labels, nac_labels=None,
             mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state.params
        dev = params.t5.shared.device
        if not isinstance(batch.chunk_mask, torch.Tensor):
            batch = to_device(batch, dev)
        labels = torch.as_tensor(labels, device=dev).long()
        trainable = opt.trainable(params)
        p = cast_params(params, torch.bfloat16) if bf16_compute else params
        with torch.no_grad():
            ret = retrieve(p.t5.shared, batch, k=rag_cfg.chunk_num, oracle=oracle)
            gen, _ = assemble_concat(batch, ret.top_k_idx, ret.top_k_valid, acfg)
        loss, _ = vt5m.forward_train(p, vt5_cfg, gen, labels)
        aux = {}
        if use_nac:
            t5c = vt5_cfg.t5
            with torch.no_grad():
                tokens, _ = vt5m.generate(p, vt5_cfg, gen, max_new_tokens=nac_decode_len)
                shared = p.t5.shared
                input_emb = shared[gen.input_ids] + spatial_embed(p.spatial, vt5_cfg.spatial, gen.input_boxes)
                ans_emb, ans_mask = shared[tokens], (tokens != t5c.pad_id) & (tokens != t5c.eos_id)
            probs = nac_prob(p.nac, input_emb, ans_emb, input_mask=gen.attention_mask, answer_mask=ans_mask)
            nac_labels = torch.as_tensor(nac_labels, device=dev).float()
            aux["nac_loss"] = nac_bce_loss(probs, nac_labels, pos_weight=nac_pos_weight)
            loss = loss + nac_loss_weight * aux["nac_loss"]
            aux["nac_accuracy"] = ((probs > 0.5) == (nac_labels > 0.5)).float().mean()
        mark("forward")
        return _backward_update(state, opt, trainable, loss, aux, mark)

    return step


def _backward_update(state: TrainState, opt: Optimizer, trainable: Dict[str, torch.Tensor], loss: torch.Tensor,
                     aux: Dict[str, torch.Tensor], mark: Callable[[str], None]
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The gradients of the trainable parameters, the metrics ("loss", the
    `aux` scalars, "grad_norm" and "grad_norm/<root>") and the update."""
    grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    mark("backward")
    metrics = {"loss": loss.detach(), "grad_norm": global_norm(list(grads.values())),
               **{k: v.detach() for k, v in aux.items()}}
    for root in dict.fromkeys(n.split(".")[0] for n in grads):
        metrics[f"grad_norm/{root}"] = global_norm([g for n, g in grads.items() if n.split(".")[0] == root])
    opt.update(trainable, grads, state.opt_state)
    mark("update")
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_hivt5_train_step(hivt5_cfg, opt: Optimizer, remat=False, bf16_compute: bool = False
                          ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The Hi-VT5 step: returns step(state, batch, labels, mark=None) ->
    (state, metrics), the loss the LM cross-entropy plus
    retrieval_loss_weight times the page cross-entropy
    (`models/hivt5.py::forward_train`: the pages-in-batch encode through
    K7/K8 with K6, on B*P rows). metrics: "loss", "lm_loss", "ret_loss",
    "grad_norm" and "grad_norm/<root>", 0-d tensors; `mark` as in
    `make_train_step`. bf16_compute as there."""
    if remat:
        raise NotImplementedError("remat waits in ROADMAP Queue 1 item 11")

    def step(state: TrainState, batch: ChunkedBatch, labels, mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state.params
        dev = params.t5.shared.device
        if not isinstance(batch.chunk_mask, torch.Tensor):
            batch = to_device(batch, dev)
        labels = torch.as_tensor(labels, device=dev).long()
        trainable = opt.trainable(params)
        p = cast_params(params, torch.bfloat16) if bf16_compute else params
        loss, aux = hivt5m.forward_train(p, hivt5_cfg, batch, labels)
        mark("forward")
        return _backward_update(state, opt, trainable, loss, {k: aux[k] for k in ("lm_loss", "ret_loss")}, mark)

    return step
