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
step (LM and page cross-entropy).

`remat` trades recomputation for activation memory, with the JAX values:
"layer" checkpoints each encoder layer (around `T5LayerTrain`, whose own
backward already recomputes the attention and keeps only the layer's input
and x1) and each decoder layer (`T5Config.remat_layers`); True checkpoints
the whole loss forward. JAX's True keeps the outputs of the matrix products
(`dots_with_no_batch_dims_saveable`); the port's keeps the outputs of the
matrix products PyTorch runs (aten `mm`/`addmm`: the decoder's projections
and FFN, the heads) and recomputes the rest. The encoder layers' kernels
are ctypes launches inside an autograd Function that no such policy sees,
so their forward is run again in the backward, as a whole layer. Any other
value raises ValueError. Either way the loss and the gradients are those of
the plain step: every kernel gives the same bits on a second launch, so the
recomputed ReLU decisions are the first pass's.

bf16_compute is the JAX mixed precision: f32 master weights, and inside
the loss a bf16 copy of every floating parameter made by a differentiable
cast, so the gradients come back to the f32 masters.

With `mesh=` (`parallel/mesh.py`, axes "data" and "model") the steps run
the JAX `(data, model)` layout over `torch.distributed`:
  * each rank takes its B / data rows of the batch (`batch_spec`);
  * the leaves `vt5_param_spec` splits are stored as this rank's slices on
    the model axis (`parallel/mesh.py::shard_params`, before
    `TrainState.create`, so the AdamW moments are slices too). Before the
    forward they are all-gathered whole (bf16 first under bf16_compute), as
    the JAX partitioners of the Pallas-backed layers replicate the weights
    and split the batch only; the gather's backward keeps this rank's slice
    of the gradient unsummed, since every member of the model axis computed
    the whole gradient from the same rows;
  * the loss is the global batch's: each cross-entropy divides by its count
    over every rank's rows (all-reduced), the per-document and per-sample
    means by the global batch size, so the ranks' losses and gradients sum
    to the unsharded step's;
  * the gradients are all-reduced over the data axis (one flat buffer)
    before the norm, the clip and the update; `grad_norm` and each
    `grad_norm/<root>` count a split leaf's squares over the model axis and
    a whole leaf's once (`optimizer.global_norm`).
Every rank returns the same metrics.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, on_device
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, retrieve
from rag_docvqa_tpu_torch.models import hivt5 as hivt5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embeddings import spatial_embed
from rag_docvqa_tpu_torch.models.nac import nac_bce_loss, nac_prob
from rag_docvqa_tpu_torch.ops.gather import assemble_concat
from rag_docvqa_tpu_torch.parallel.mesh import Mesh, gathered_params, local_rows
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


# --------------------------------------------------------------------------- #
# the (data, model) layout
# --------------------------------------------------------------------------- #
# dense weights here are (out, in), the JAX package's (in, out)
_OUT_SPLIT = ("q", "k", "v", "wi", "wi_0", "wi_1", "fc1")  # JAX: split by their output columns
_IN_SPLIT = ("o", "wo", "fc2")  # JAX: split by their input rows
_TABLES = ("x_emb", "y_emb", "layout_emb", "pos_embed")  # with `shared`: split by their large dimension


def vt5_param_spec(params: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension the model axis splits it on, or None
    (whole on every rank)}: the counterpart of the JAX `vt5_param_spec` for
    the VT5 and Hi-VT5 trees. q/k/v/wi by their output dimension, o/wo by
    their input dimension, the word table and the 2-D position tables by
    their rows; everything else whole."""
    spec = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        leaf, dim = parts[-1], None
        if "shared" in parts or leaf in _TABLES:
            dim = 0 if p.ndim == 2 else None
        elif p.ndim == 2 and leaf in _OUT_SPLIT:
            dim = 0
        elif p.ndim == 2 and leaf in _IN_SPLIT:
            dim = 1
        spec[name] = dim
    return spec


def batch_spec(batch: ChunkedBatch) -> Dict[str, Optional[int]]:
    """{field: 0 (split by rows over the data axis) or None}, the JAX
    `batch_spec`: every field with a batch dimension is split."""
    return {f.name: 0 if getattr(getattr(batch, f.name), "ndim", 0) >= 1 else None
            for f in dataclasses.fields(batch)}


def local_batch(batch: ChunkedBatch, mesh: Mesh, *per_row):
    """This rank's rows of the batch (numpy or tensors) and of each
    per-row array in `per_row` (None stays None): (batch, [arrays])."""
    rows = local_rows(batch.batch_size, mesh)
    batch = dataclasses.replace(batch, **{n: getattr(batch, n)[rows] for n, d in batch_spec(batch).items() if d == 0})
    return batch, [None if x is None else x[rows] for x in per_row]


def _global_counts(mesh: Mesh, counts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each count summed over the data axis, at least 1: the denominators of
    the global batch's means."""
    names = list(counts)
    total = mesh.all_reduce(torch.stack([counts[n].to(torch.int64) for n in names]), "data")
    return {n: total[i].clamp(min=1) for i, n in enumerate(names)}


def _working_params(params: nn.Module, mesh: Optional[Mesh], spec, bf16_compute: bool) -> nn.Module:
    """The parameters the forward reads: the masters, a bf16 cast of them,
    or with a mesh the split leaves gathered whole (cast first)."""
    dtype = torch.bfloat16 if bf16_compute else None
    if mesh is not None:
        return gathered_params(params, spec, mesh, dtype)
    return cast_params(params, dtype) if bf16_compute else params


def make_train_step(vt5_cfg: vt5m.VT5Config, rag_cfg: RAGConfig, opt: Optimizer, bf16_compute: bool = False,
                    use_nac: bool = False, nac_loss_weight: float = 1.0, nac_pos_weight: float = 1.0,
                    nac_decode_len: int = 16, remat=False, mesh: Optional[Mesh] = None
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
    timing. With `mesh`, every rank passes the whole batch and takes its
    rows, and `state.params` holds this rank's slices (module docstring)."""
    vt5_cfg, whole = _remat_config(vt5_cfg, remat)
    fwd = _checkpoint_products(vt5m.forward_train) if whole else vt5m.forward_train
    acfg = rag_cfg.assemble()
    oracle = rag_cfg.page_retrieval == "oracle"

    def step(state: TrainState, batch: ChunkedBatch, labels, nac_labels=None,
             mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state.params
        dev = params.t5.shared.device
        spec, share = None, 1.0  # share: this rank's part of the global batch's per-sample means
        if mesh is not None:
            spec = vt5_param_spec(params)
            batch, (labels, nac_labels) = local_batch(batch, mesh, labels, nac_labels)
            share = 1.0 / mesh.size("data")
        batch = on_device(batch, dev)
        labels = torch.as_tensor(labels, device=dev).long()
        trainable = opt.trainable(params)
        p = _working_params(params, mesh, spec, bf16_compute)
        with torch.no_grad():
            ret = retrieve(p.t5.shared, batch, k=rag_cfg.chunk_num, oracle=oracle)
            gen, _ = assemble_concat(batch, ret.top_k_idx, ret.top_k_valid, acfg)
        denominators = None
        if mesh is not None:
            counts = {"lm": (labels != -100).sum()}
            if p.layout_head is not None:
                counts["layout"] = gen.attention_mask[:, :gen.input_ids.shape[1]].sum()
            denominators = _global_counts(mesh, counts)
        loss, _ = fwd(p, vt5_cfg, gen, labels, denominators=denominators)
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
            aux["nac_loss"] = nac_bce_loss(probs, nac_labels, pos_weight=nac_pos_weight) * share
            loss = loss + nac_loss_weight * aux["nac_loss"]
            aux["nac_accuracy"] = ((probs > 0.5) == (nac_labels > 0.5)).float().mean() * share
        mark("forward")
        return _backward_update(state, opt, trainable, loss, aux, mark, mesh)

    return step


def _remat_config(cfg, remat):
    """(cfg, whole forward?) for a `remat` value: "layer" sets the T5
    config's `remat_layers`; True asks for the whole-forward checkpoint."""
    import dataclasses

    if remat == "layer":
        return dataclasses.replace(cfg, t5=dataclasses.replace(cfg.t5, remat_layers=True)), False
    if remat not in (False, True):
        raise ValueError(f"remat must be False, True, or 'layer'; got {remat!r}")
    return cfg, bool(remat)


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _checkpoint_products(fn):
    """`fn` under a non-reentrant selective checkpoint that keeps the
    outputs of aten `mm` and `addmm` and recomputes everything else."""
    import functools

    from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE

    context = functools.partial(create_selective_checkpoint_contexts, policy)
    return lambda *args, **kw: checkpoint(fn, *args, use_reentrant=False, context_fn=context, **kw)


def _backward_update(state: TrainState, opt: Optimizer, trainable: Dict[str, torch.Tensor], loss: torch.Tensor,
                     aux: Dict[str, torch.Tensor], mark: Callable[[str], None], mesh: Optional[Mesh] = None
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The gradients of the trainable parameters, the metrics ("loss", the
    `aux` scalars, "grad_norm" and "grad_norm/<root>") and the update. With
    a mesh, the loss, the `aux` scalars and the gradients are this rank's
    shares: each is summed over the data axis first, and the norms count the
    split leaves over the model axis."""
    grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    split = dict.fromkeys(grads, False)
    if mesh is not None:
        _all_reduce_flat(list(grads.values()), mesh)
        scalars = mesh.all_reduce(torch.stack([loss.detach(), *(v.detach() for v in aux.values())]), "data")
        loss, aux = scalars[0], dict(zip(aux, scalars[1:]))
        spec = vt5_param_spec(state.params)
        split = {n: spec.get(n) is not None for n in grads}
    norm = lambda names: global_norm([grads[n] for n in names], [split[n] for n in names], mesh)
    mark("backward")
    total = norm(list(grads))
    metrics = {"loss": loss.detach(), "grad_norm": total, **{k: v.detach() for k, v in aux.items()}}
    for root in dict.fromkeys(n.split(".")[0] for n in grads):
        metrics[f"grad_norm/{root}"] = norm([n for n in grads if n.split(".")[0] == root])
    opt.update(trainable, grads, state.opt_state, norm=total)
    mark("update")
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def _all_reduce_flat(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """In place: each tensor summed over the data axis, through one flat
    buffer (one collective, not one a tensor)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce(flat, "data")
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_hivt5_train_step(hivt5_cfg, opt: Optimizer, remat=False, bf16_compute: bool = False,
                          mesh: Optional[Mesh] = None) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The Hi-VT5 step: returns step(state, batch, labels, mark=None) ->
    (state, metrics), the loss the LM cross-entropy plus
    retrieval_loss_weight times the page cross-entropy
    (`models/hivt5.py::forward_train`: the pages-in-batch encode through
    K7/K8 with K6, on B*P rows). metrics: "loss", "lm_loss", "ret_loss",
    "grad_norm" and "grad_norm/<root>", 0-d tensors; `mark` and `remat`
    as in `make_train_step`. bf16_compute and `mesh` as there: with a mesh
    the LM loss is the global batch's token mean and `ret_loss` the mean
    over the global batch's documents."""
    hivt5_cfg, whole = _remat_config(hivt5_cfg, remat)
    fwd = _checkpoint_products(hivt5m.forward_train) if whole else hivt5m.forward_train

    def step(state: TrainState, batch: ChunkedBatch, labels, mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state.params
        dev = params.t5.shared.device
        spec = denominators = None
        if mesh is not None:
            spec = vt5_param_spec(params)
            n_docs = batch.batch_size
            batch, (labels,) = local_batch(batch, mesh, labels)
        batch = on_device(batch, dev)
        labels = torch.as_tensor(labels, device=dev).long()
        if mesh is not None:
            denominators = _global_counts(mesh, {"lm": (labels != -100).sum()})
            denominators["docs"] = n_docs
        trainable = opt.trainable(params)
        p = _working_params(params, mesh, spec, bf16_compute)
        loss, aux = fwd(p, hivt5_cfg, batch, labels, denominators=denominators)
        mark("forward")
        return _backward_update(state, opt, trainable, loss, {k: aux[k] for k in ("lm_loss", "ret_loss")}, mark,
                                mesh)

    return step
