"""The not-answerable classifier (NAC).

Counterpart of `rag_docvqa_tpu/models/nac.py`: an MLP over [mean of the
generator's input embeddings; mean of the predicted answer's embeddings]
gives the sigmoid probability that the question cannot be answered from the
document; `update_results` blanks the answers above the threshold and zeroes
their confidence. Trained with a weighted BCE (`nac_bce_loss`). The layers
are an `nn.Module` (`NACParams`), a child `nac` of `VT5Params` where the
model carries one, so that "nac" is a root the optimizer can train.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.models.layers import frozen, mlp_relu_stack, normal_init


@dataclass(frozen=True)
class NACConfig:
    emb_dim: int = 768
    hidden_dim: int = 256
    num_layers: int = 2


class NACLayer(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight, self.bias = frozen(weight), frozen(bias)  # weight (out, in)


class NACParams(nn.Module):
    def __init__(self, layers: Sequence[NACLayer]):
        super().__init__()
        self.mlp = nn.ModuleList(layers)


def init_nac_params(generator: torch.Generator, cfg: NACConfig) -> NACParams:
    """f32 weights on the generator's device with the JAX package's
    distributions: N(0, 1/fan_in) kernels, zero biases."""
    dims = [cfg.emb_dim * 2] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [1]
    return NACParams([NACLayer(normal_init(generator, (dout, din), din ** -0.5),
                               torch.zeros(dout, device=generator.device))
                      for din, dout in zip(dims[:-1], dims[1:])])


def nac_prob(
    params: NACParams,
    input_embeddings: torch.Tensor,  # (B, S, D)
    answer_embeddings: torch.Tensor,  # (B, T, D)
    input_mask: Optional[torch.Tensor] = None,  # (B, S); None: the plain mean over every row
    answer_mask: Optional[torch.Tensor] = None,  # (B, T)
) -> torch.Tensor:
    """(B,) probability of "not answerable"."""
    def mean(x, mask):
        if mask is None:
            return x.mean(dim=1)
        m = mask.to(x.dtype)[..., None]
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)

    feats = torch.cat([mean(input_embeddings, input_mask), mean(answer_embeddings, answer_mask)], dim=-1)
    return torch.sigmoid(mlp_relu_stack(params.mlp, feats)[..., 0])


def nac_bce_loss(probs: torch.Tensor, labels: torch.Tensor, pos_weight: float = 1.0) -> torch.Tensor:
    """Weighted binary cross entropy: `pos_weight` on the not-answerable
    class, probabilities clipped to [1e-7, 1 - 1e-7]."""
    eps = 1e-7
    p = probs.clamp(eps, 1 - eps)
    return (-(pos_weight * labels * torch.log(p) + (1 - labels) * torch.log(1 - p))).mean()


def update_results(
    probs,  # (B,)
    pred_answers: List[Optional[str]],
    confidences: List[Optional[float]],
    threshold: float = 0.5,
) -> Tuple[List[Optional[str]], List[Optional[float]], List[float]]:
    """Blank the answers predicted not answerable (p > threshold) and zero
    their confidence; returns (answers, confidences, probabilities)."""
    probs_l = [float(p) for p in probs]
    answers, confs = [], []
    for p, a, c in zip(probs_l, pred_answers, confidences):
        if p > threshold:
            answers.append("")
            confs.append(0.0)
        else:
            answers.append(a)
            confs.append(c)
    return answers, confs, probs_l
