"""The T5 encoder layer through hand-written kernels (K1).

Counterpart of the T5 part of `rag_docvqa_tpu/ops/fused_encoder.py`
(`fuse_t5_blocks`, `fused_t5_layer_parts`, `fused_t5_layer`). The TPU
kernel runs a whole layer for a block of rows in VMEM; here the layer is
three kernels with the TPU kernel's cast points (csrc/t5_layer.cu says how):

  (a) `rms_norm_rows`: row RMSNorm written in the compute dtype;
  (b) `gemm`: C = A @ W^T with f32 accumulation and an epilogue of none,
      ReLU, "+ residual" or "gelu_tanh(g) * u" -- every product is cast to
      the compute dtype before the residual add;
  (c) K2 (ops/flash_attention.py) with mask_value -1e9, the TPU kernel's.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors. `t5_layer_reference` is the same layer built only from the
plain versions, for checks on the card. The BERT (K9) and ViT (K14) layers,
`save_x1` (training) and the query-tiled form (K13) wait for later slices;
`ffn_chunk`, `attn_stream` and the row picker are VMEM artifacts with no
counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.models.layers import rms_norm
from rag_docvqa_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference

T5_MASK_VALUE = -1e9  # the TPU layer kernel's and _attend's masked score

EPILOGUES = {"none": 0, "relu": 1, "residual": 2, "gelu_mul": 3}


# --------------------------------------------------------------------------- #
# (a) RMSNorm
# --------------------------------------------------------------------------- #
def rms_norm_rows(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm over the last axis of a contiguous x, in x's dtype."""
    if not kernels.on_cuda(x, weight):
        return rms_norm(x, weight, eps)
    kernels.require(x.is_contiguous() and weight.is_contiguous(), "rms_norm_rows: need contiguous x and weight")
    d = x.shape[-1]
    kernels.require(weight.shape == (d,), f"rms_norm_rows: weight {tuple(weight.shape)} for width {d}")
    dtype = kernels.dtype_code(x, (torch.float32, torch.bfloat16))
    w_dtype = kernels.dtype_code(weight, (torch.float32, torch.bfloat16))
    out = torch.empty_like(x)
    err = kernels.library().t5_rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // d, d, float(eps),
        dtype, w_dtype, kernels.stream_ptr(x))
    kernels.check("t5_rms_norm", err)
    kernels.LAUNCHES["t5_rms_norm"] += 1
    return out


# --------------------------------------------------------------------------- #
# (b) GEMM with epilogue
# --------------------------------------------------------------------------- #
def gemm_reference(a: torch.Tensor, w: torch.Tensor, epilogue: str = "none",
                   aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the GEMM kernel: f32 product of a (M, K) and
    w (N, K), then the epilogue with the kernel's casts, in a's dtype."""
    cdt = a.dtype
    acc = torch.matmul(a.float(), w.float().t())
    if epilogue == "none":
        return acc.to(cdt)
    if epilogue == "relu":
        return acc.clamp(min=0).to(cdt)
    if epilogue == "residual":
        return (acc.to(cdt).float() + aux.float()).to(cdt)
    if epilogue == "gelu_mul":
        g = acc.to(cdt).float()
        f = (0.5 * g * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5 * (g + 0.044715 * g * g * g)))).to(cdt)
        return (f.float() * aux.float()).to(cdt)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def gemm(a: torch.Tensor, w: torch.Tensor, epilogue: str = "none",
         aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(a (M, K) @ w (N, K)^T) -> (M, N) in a's dtype; aux (M, N)
    is the residual ("residual") or the up-projection u ("gelu_mul")."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (aux is None) != (epilogue in ("none", "relu")):
        raise ValueError(f"epilogue {epilogue!r} {'needs' if aux is None else 'takes no'} aux")
    if not kernels.on_cuda(a, w, aux):
        return gemm_reference(a, w, epilogue, aux)
    M, K = a.shape
    N = w.shape[0]
    kernels.require(w.shape == (N, K), f"gemm: a {tuple(a.shape)} and w {tuple(w.shape)} do not fit")
    kernels.require(a.dtype == w.dtype, f"gemm: a is {a.dtype}, w is {w.dtype}")
    kernels.require(a.is_contiguous() and w.is_contiguous(), "gemm: need contiguous a and w")
    dtype = kernels.dtype_code(a, (torch.float32, torch.bfloat16))
    if dtype == kernels.DTYPE_CODES[torch.bfloat16]:
        kernels.require(K % 8 == 0 and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                        "gemm: the bf16 kernel loads 16-byte rows: K % 8 == 0, aligned a and w")
    if aux is not None:
        kernels.require(aux.shape == (M, N) and aux.dtype == a.dtype and aux.is_contiguous(),
                        f"gemm: aux must be contiguous {a.dtype} (M, N), got {tuple(aux.shape)}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    err = kernels.library().t5_gemm(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), aux.data_ptr() if aux is not None else None,
        M, N, K, dtype, EPILOGUES[epilogue], kernels.stream_ptr(a))
    kernels.check("t5_gemm", err)
    kernels.LAUNCHES["t5_gemm"] += 1
    return out


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
def fuse_t5_blocks(layers, gated: bool) -> List[Dict[str, torch.Tensor]]:
    """Per-layer weights in the kernels' form, built once per encode:
    wqkv (3*inner, d) = [q; k; v], wo (d, inner), ln0/ln1 (d,), and
    wi (d_ff, d) or wi_0/wi_1, wof (d, d_ff). `layers` are T5EncoderLayer
    modules (models/t5.py)."""
    out = []
    for layer in layers:
        a, f = layer.attn, layer.ffn
        l = {"wqkv": torch.cat([a.q, a.k, a.v], dim=0), "wo": a.o.contiguous(),
             "ln0": layer.ln0, "ln1": layer.ln1, "wof": f.wo.contiguous()}
        if gated:
            l.update(wi_0=f.wi_0.contiguous(), wi_1=f.wi_1.contiguous())
        else:
            l["wi"] = f.wi.contiguous()
        out.append(l)
    return out


def _t5_layer(x, key_mask, bias, l, num_heads, eps, gated, norm, matmul, attend):
    B, T, d = x.shape
    inner = l["wo"].shape[1]
    dk = inner // num_heads
    cdt = x.dtype
    x2 = x.reshape(B * T, d)
    h = norm(x2, l["ln0"].to(cdt), eps)
    qkv = matmul(h, l["wqkv"].to(cdt)).view(B, T, 3, num_heads, dk)
    attn, _ = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_mask,
                     None if bias is None else bias[None], 1.0, False, T5_MASK_VALUE)
    x1 = matmul(attn.reshape(B * T, inner), l["wo"].to(cdt), "residual", x2)
    h2 = norm(x1, l["ln1"].to(cdt), eps)
    if gated:
        u = matmul(h2, l["wi_1"].to(cdt))
        f = matmul(h2, l["wi_0"].to(cdt), "gelu_mul", u)
    else:
        f = matmul(h2, l["wi"].to(cdt), "relu")
    return matmul(f, l["wof"].to(cdt), "residual", x1).view(B, T, d)


def fused_t5_layer_parts(x: torch.Tensor, key_mask: torch.Tensor, bias: Optional[torch.Tensor],
                         l: Dict[str, torch.Tensor], *, num_heads: int, eps: float,
                         gated: bool) -> torch.Tensor:
    """One encoder layer from a `fuse_t5_blocks` entry: x (B, T, d),
    key_mask (B, T) bool, bias (H, T, T) batch-shared or None (the bias-free
    form). Kernels on CUDA, plain versions on the CPU."""
    return _t5_layer(x.contiguous(), key_mask.contiguous(), bias, l, num_heads, eps, gated,
                     rms_norm_rows, gemm, flash_attention_fwd)


def t5_layer_reference(x, key_mask, bias, l, *, num_heads: int, eps: float, gated: bool):
    """The layer from the plain versions only, on any device."""
    return _t5_layer(x.contiguous(), key_mask.contiguous(), bias, l, num_heads, eps, gated,
                     rms_norm, gemm_reference, flash_attention_reference)


def fused_t5_layer(x, key_mask, bias, layer, *, num_heads: int, eps: float, gated: bool):
    """`fused_t5_layer_parts` on one T5EncoderLayer module."""
    return fused_t5_layer_parts(x, key_mask, bias, fuse_t5_blocks([layer], gated)[0],
                                num_heads=num_heads, eps=eps, gated=gated)
