"""Shared building blocks: norms, dense, init.

Counterpart of `rag_docvqa_tpu/models/layers.py`. Dense weights use the
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


def normal_init(generator: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """f32 N(0, stddev^2) on the generator's device (the JAX package's
    `normal_init` distribution; the numbers differ from jax.random's)."""
    return torch.randn(shape, generator=generator, device=generator.device) * stddev


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """Inference parameter: registered on the module, no gradient."""
    return torch.nn.Parameter(t, requires_grad=False)
