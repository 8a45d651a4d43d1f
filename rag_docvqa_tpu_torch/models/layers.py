"""Shared building blocks: norms, dense, init.

Counterpart of `rag_docvqa_tpu/models/layers.py` (`rms_norm`, `layer_norm`,
`dense`, `mlp_relu_stack`, `normal_init`) and the masked cross-entropy the
training losses share. Dense weights use the
`nn.Linear` layout (out, in); `params.from_jax` transposes the JAX (in, out)
kernels into it.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5-style LayerNorm: no mean subtraction, no bias, f32 accumulation;
    the result is cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Standard LayerNorm in f32, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def dense(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x @ weight.T (+ bias) with the product in x's dtype, as
    `layers.dense(preferred_element_type=x.dtype)` gives it in JAX.
    `weight` is (out, in)."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp_relu_stack(layers, x: torch.Tensor) -> torch.Tensor:
    """The reference's generic MLP: `dense` through each of `layers` (modules
    with `weight` (out, in) and `bias`), ReLU between them, none after the
    last."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = dense(x, layer.weight, layer.bias)
        if i < n - 1:
            x = torch.relu(x)
    return x


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32 over the `valid` positions (a zero loss when
    none is): the teacher-forced losses' `sum(nll * valid) / max(sum(valid), 1)`."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def normal_init(generator: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """f32 N(0, stddev^2) on the generator's device (the JAX package's
    `normal_init` distribution; the numbers differ from jax.random's)."""
    return torch.randn(shape, generator=generator, device=generator.device) * stddev


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """Inference parameter: registered on the module, no gradient."""
    return torch.nn.Parameter(t, requires_grad=False)
