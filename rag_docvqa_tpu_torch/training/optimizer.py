"""Global-norm clipping, then AdamW with a linear warmup -> linear decay
schedule, on the trainable parameters only.

Counterpart of `rag_docvqa_tpu/training/optimizer.py`, whose optax chain is
`multi_transform({"train": chain(clip_by_global_norm(3.0), adamw(schedule,
0.9, 0.999, 1e-8, 0.01)), "freeze": set_to_zero()})`. Written by hand to
match optax where torch's own pieces differ:

  * the clip scales by max_norm / norm with no epsilon, only when the norm
    is at least max_norm, and the norm covers the trainable leaves only
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6);
  * the learning rate of update n (from 0) is schedule(n), so the first
    update uses schedule(0) = 0;
  * weight decay applies to every trainable tensor, norms included, and is
    added to the Adam direction before the learning rate scales it.

`clip_norm=None` leaves the gradients unclipped and `constant_lr=True` uses
`lr` at every update: together with weight_decay 1e-4 that is
`optax.adamw(lr)`, the contrastive trainer's optimizer.

The state is a dict of tensors, as an optax state is a tree of arrays:
{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}; `update`
changes the parameters and the state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8  # the JAX build_optimizer's Adam constants


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int):
    """count -> learning rate: 0 -> lr over max(warmup, 1) steps, then
    lr -> 0 over max(total - warmup, 1) steps (optax.join_schedules of two
    linear_schedules; get_linear_schedule_with_warmup semantics)."""
    w = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < w:
            return -lr * (1.0 - count / w) + lr
        return lr * (1.0 - min(count - w, decay) / decay)

    return schedule


def trainable_mask(params: nn.Module, trainable_roots: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable}: True under any of `trainable_roots`, the
    first component of the name (e.g. ("t5", "spatial"))."""
    return {name: name.split(".")[0] in trainable_roots for name, _ in params.named_parameters()}


def global_norm(tensors: Sequence[torch.Tensor], split: Optional[Sequence[bool]] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32. With a `mesh`
    (`parallel/mesh.py`), `split` marks the tensors that are this rank's
    slices over the model axis: their squares are summed over the axis, the
    whole tensors' counted once, so every rank reads the norm of the whole
    gradient. The leaves are added in their order either way, so a mesh
    whose model axis has one rank gives the unsharded norm bit for bit."""
    squares = [(t.float() * t.float()).sum() for t in tensors]
    sliced = [i for i, s in enumerate(split or ()) if s]
    if mesh is not None and sliced:  # one collective; the sum below keeps the leaves' order
        total = mesh.all_reduce(torch.stack([squares[i] for i in sliced]), "model")
        for j, i in enumerate(sliced):
            squares[i] = total[j]
    return torch.sqrt(sum(squares))


@dataclass
class Optimizer:
    lr: float = 2e-4
    warmup_steps: int = 1000
    total_steps: int = 100_000
    clip_norm: Optional[float] = 3.0  # None: no clipping
    weight_decay: float = 0.01
    mask: Optional[Dict[str, bool]] = None  # None: every parameter trains
    constant_lr: bool = False  # lr at every update, no warmup or decay

    def __post_init__(self):
        if self.constant_lr:
            self.schedule = lambda count: self.lr
        else:
            self.schedule = linear_warmup_decay(self.lr, self.warmup_steps, self.total_steps)

    def trainable(self, params: nn.Module) -> Dict[str, torch.Tensor]:
        """The parameters this optimizer updates, by name."""
        return {n: p for n, p in params.named_parameters() if self.mask is None or self.mask.get(n, False)}

    def init(self, params: nn.Module) -> dict:
        """Zero moments for the trainable parameters, which get
        `requires_grad`; every other parameter is frozen."""
        train = self.trainable(params)
        for n, p in params.named_parameters():
            p.requires_grad_(n in train)
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in train.items()},
                "nu": {n: torch.zeros_like(p) for n, p in train.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
               norm: Optional[torch.Tensor] = None) -> None:
        """One step on `params` (the trainable ones, by name) with their f32
        `grads`; parameters and state change in place. `norm`, when given, is
        the gradients' global norm the clip reads (a sharded step's, over
        every rank's slices), else it is computed here."""
        names = list(state["mu"])
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if self.clip_norm is not None:
            # optax: where(norm < max_norm, g, (g / norm) * max_norm), no host sync
            norm = global_norm(g) if norm is None else norm
            clipped = norm >= self.clip_norm
            g = torch._foreach_mul(torch._foreach_div(g, torch.where(clipped, norm, 1.0)),
                                   torch.where(clipped, self.clip_norm, 1.0))
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        count = state["count"]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        t = count + 1  # optax's bias correction counts this update
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** t
        u = torch._foreach_div(mu, bc1.item())
        denom = torch._foreach_div(nu, bc2.item())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_add_(p, u, alpha=-self.schedule(count))
        state["count"] = t


def build_optimizer(lr: float = 2e-4, warmup_steps: int = 1000, total_steps: int = 100_000,
                    clip_norm: float = 3.0, weight_decay: float = 0.01,
                    mask: Optional[Dict[str, bool]] = None) -> Optimizer:
    return Optimizer(lr=lr, warmup_steps=warmup_steps, total_steps=total_steps, clip_norm=clip_norm,
                     weight_decay=weight_decay, mask=mask)
