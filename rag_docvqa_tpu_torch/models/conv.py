"""Convolution building blocks of the layout detectors (`layout_seg.py`,
`yolo.py`).

The JAX package writes these inline in each detector, NHWC, with
`lax.conv_general_dilated` and HWIO kernels. Here activations are NCHW, the
layout `F.conv2d` and cuDNN take without a copy, and kernels are PyTorch's
(out, in, kh, kw); a ConvTranspose2d kernel is (in, out, kh, kw), as
Hugging Face stores it. `params.conv_tree_from_jax` carries the JAX trees
over. No Pallas kernel backs any of this in JAX: these are the library's
convolutions (cuDNN on the card), not ports of a TPU kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch.models.layers import frozen, normal_init


class Conv(nn.Module):
    """weight (out, in, kh, kw), or (in, out, kh, kw) for a transposed
    convolution; bias (out,) or None."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = frozen(weight)
        self.bias = None if bias is None else frozen(bias)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm: weight, bias, running mean and variance."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
        super().__init__()
        self.w, self.b, self.mean, self.var = frozen(w), frozen(b), frozen(mean), frozen(var)


class ConvBN(nn.Module):
    """A convolution without a bias followed by a BatchNorm."""

    def __init__(self, conv: Conv, bn: BatchNorm):
        super().__init__()
        self.conv, self.bn = conv, bn


def init_conv(g: torch.Generator, k: int, cin: int, cout: int, bias: bool = False, std: Optional[float] = None,
              bias_value: float = 0.0) -> Conv:
    """N(0, std^2) kernel (default 1/fan_in, the JAX package's), constant bias."""
    w = normal_init(g, (cout, cin, k, k), (k * k * cin) ** -0.5 if std is None else std)
    return Conv(w, torch.full((cout,), bias_value, device=g.device) if bias else None)


def init_bn(c: int, device) -> BatchNorm:
    return BatchNorm(torch.ones(c, device=device), torch.zeros(c, device=device), torch.zeros(c, device=device),
                     torch.ones(c, device=device))


def init_conv_bn(g: torch.Generator, k: int, cin: int, cout: int) -> ConvBN:
    return ConvBN(init_conv(g, k, cin, cout), init_bn(cout, g.device))


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (low, high), the odd pixel high."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p: Conv, stride: int = 1) -> torch.Tensor:
    """NCHW convolution with "SAME" padding as JAX computes it (a stride-2
    3x3 conv of an even input pads (0, 1)), kernel and bias cast to x's
    dtype."""
    kh, kw = p.weight.shape[2:]
    (t, b), (l, r) = same_padding(x.shape[2], kh, stride), same_padding(x.shape[3], kw, stride)
    if t == b and l == r:
        y = F.conv2d(x, p.weight.to(x.dtype), None, stride, (t, l))
    else:
        y = F.conv2d(F.pad(x, (l, r, t, b)), p.weight.to(x.dtype), None, stride)
    return y if p.bias is None else y + p.bias.to(y.dtype)[:, None, None]


def batch_norm(x: torch.Tensor, p: BatchNorm, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * w + b in f32 over the channel axis,
    cast back to x's dtype."""
    c = lambda t: t.float()[:, None, None]
    return ((x.float() - c(p.mean)) * torch.rsqrt(c(p.var) + eps) * c(p.w) + c(p.b)).to(x.dtype)
