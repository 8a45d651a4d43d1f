"""The causal LM's elementwise glue through hand-written kernels
(csrc/lm_glue.cu says how): what `models/causal_lm.py` runs between a
layer's GEMMs on the card.

  `add_rms_norm`  the residual add and the RMSNorm of the sum, (x + d, h);
  `bias_rope_`    the q/k/v biases and the rotary of q and k, in place on the
                  projections' outputs (the port may update in place where
                  that saves a copy: nothing else holds them);
  `glu`           the gated MLP's act(gate) * up, SiLU (Qwen2) or tanh-GELU
                  (Gemma).

No TPU kernel is replaced: the JAX package leaves this glue to XLA. Each
wrapper launches its kernel on CUDA tensors and runs its plain version on
CPU tensors (`add_rms_norm_reference`, `bias_rope_reference`,
`glu_reference`); the plain versions are the arithmetic `causal_lm` runs
where the kernels are not taken, and round where it rounds, so the rotary
and the gated product give the same bits and the norm the same up to one ulp
of the working dtype (its sum of squares is taken in another order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.models.layers import rms_norm

ACTS = {"silu": 0, "gelu_tanh": 1}  # kept in step with csrc/lm_glue.cu's GluAct
_FLOATS = (torch.float32, torch.bfloat16)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, hd); cos/sin (..., T, hd/2) -> rotated in f32 (HF's
    rotate_half convention), cast to x's dtype."""
    hd = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2:]
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def add_rms_norm_reference(x: torch.Tensor, d: Optional[torch.Tensor], w: torch.Tensor,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if d is not None:
        x = x + d
    return x, rms_norm(x, w, eps)


def bias_rope_reference(q, k, v, bq, bk, bv, cos, sin) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The biases added in the projections' dtype (`layers.dense`), then q and
    k rotated: q (B, T, H, hd), k and v (B, T, Hkv, hd), biases flat."""
    bias = lambda y, b: y if b is None else y + b.to(y.dtype).reshape(y.shape[-2:])
    return apply_rope(bias(q, bq), cos, sin), apply_rope(bias(k, bk), cos, sin), bias(v, bv)


def glu_reference(g: torch.Tensor, u: torch.Tensor, act_name: str) -> torch.Tensor:
    return (F.gelu(g, approximate="tanh") if act_name == "gelu_tanh" else F.silu(g)) * u


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #
def add_rms_norm(x: torch.Tensor, d: Optional[torch.Tensor], w: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + d, rms_norm(x + d, w)) over the last axis, in x's dtype; with d
    None, (x, rms_norm(x, w)). x and d contiguous, of one shape and dtype."""
    if not kernels.on_cuda(x, d, w):
        return add_rms_norm_reference(x, d, w, eps)
    dim = x.shape[-1]
    kernels.require(x.is_contiguous() and w.is_contiguous() and w.shape == (dim,),
                    f"add_rms_norm: need contiguous x and a ({dim},) weight, got {tuple(w.shape)}")
    kernels.require(d is None or (d.shape == x.shape and d.dtype == x.dtype and d.is_contiguous()),
                    "add_rms_norm: d must be contiguous, of x's shape and dtype")
    dtype = kernels.dtype_code(x, _FLOATS)
    h = torch.empty_like(x)
    xo = None if d is None else torch.empty_like(x)
    err = kernels.library().lm_add_rms_norm(
        x.data_ptr(), None if d is None else d.data_ptr(), w.data_ptr(), None if xo is None else xo.data_ptr(),
        h.data_ptr(), x.numel() // dim, dim, float(eps), dtype, kernels.dtype_code(w, _FLOATS), kernels.stream_ptr(x))
    kernels.check("lm_add_rms_norm", err)
    kernels.LAUNCHES["lm_add_rms_norm"] += 1
    return (x if xo is None else xo), h


def bias_rope_(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: Optional[torch.Tensor],
               bk: Optional[torch.Tensor], bv: Optional[torch.Tensor], cos: torch.Tensor,
               sin: torch.Tensor) -> None:
    """In place: q (B, T, H, hd) and k (B, T, Hkv, hd) get their biases and
    the rotary by cos/sin (broadcastable to (B, T, hd/2), f32), v (B, T, Hkv,
    hd) its bias; a bias is (heads * hd,) or None."""
    if not kernels.on_cuda(q, k, v, bq, bk, bv, cos, sin):
        for t, r in zip((q, k, v), bias_rope_reference(q, k, v, bq, bk, bv, cos, sin)):
            t.copy_(r)
        return
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    kernels.require(k.shape == (B, T, Hkv, hd) and v.shape == k.shape and q.dtype == k.dtype == v.dtype,
                    f"bias_rope_: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    kernels.require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(), "bias_rope_: need contiguous q, k, v")
    dtype = kernels.dtype_code(q, _FLOATS)
    biases = []
    for b, n in ((bq, H * hd), (bk, Hkv * hd), (bv, Hkv * hd)):
        if b is not None:
            b = b.to(q.dtype).contiguous()
            kernels.require(b.shape == (n,), f"bias_rope_: bias {tuple(b.shape)} for {n} columns")
        biases.append(b)
    tables = []
    for t in (cos, sin):
        kernels.require(t.dtype == torch.float32 and t.shape[-1] == hd // 2, "bias_rope_: need f32 (..., hd/2) tables")
        t = torch.broadcast_to(t, (B, T, hd // 2))
        kernels.require(t.stride(-1) == 1, "bias_rope_: the tables' last axis must be contiguous")
        tables.append(t)
    kernels.require(tables[0].stride() == tables[1].stride(), "bias_rope_: cos and sin strided alike")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = kernels.library().lm_bias_rope(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(ptr, biases), tables[0].data_ptr(), tables[1].data_ptr(),
        B * T, T, H, Hkv, hd, tables[0].stride(0), tables[0].stride(1), dtype, kernels.stream_ptr(q))
    kernels.check("lm_bias_rope", err)
    kernels.LAUNCHES["lm_bias_rope"] += 1


def glu(g: torch.Tensor, u: torch.Tensor, act_name: str) -> torch.Tensor:
    """act(g) * u (`ACTS`), each rounded to g's dtype as the plain ops round."""
    if not kernels.on_cuda(g, u):
        return glu_reference(g, u, act_name)
    kernels.require(g.shape == u.shape and g.dtype == u.dtype and g.is_contiguous() and u.is_contiguous(),
                    "glu: need contiguous gate and up of one shape and dtype")
    out = torch.empty_like(g)
    err = kernels.library().lm_glu(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), ACTS[act_name],
                                   kernels.dtype_code(g, _FLOATS), kernels.stream_ptr(g))
    kernels.check("lm_glu", err)
    kernels.LAUNCHES["lm_glu"] += 1
    return out
