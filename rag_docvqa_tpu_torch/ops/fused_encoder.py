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

`save_x1=True` also returns x1 = x + attn, the attention-residual sum the
backward starts from (the train forward of `make_fused_t5_layer_train`).

The layer backward (`rag_docvqa_tpu/ops/fused_encoder_bwd.py`) is split at
x1 as on the TPU (csrc/t5_layer_bwd.cu says how):

  K7 `t5_ffn_bwd`: recomputes h2 = rms(x1) and the FFN; gives dx1 (with the
      residual), dln1 and the FFN weight gradients;
  K8 `t5_attn_bwd`: recomputes h = rms(x), qkv and the attention (K1 (a),
      (b) and K2), runs K6 (ops/flash_attention.py); gives dx (with the
      residual), dln0, dwqkv, dwo and the bias gradient;

from two more kernels: `gemm_bwd`, the products the forward GEMM's A.W^T
layout lacks (A.W for an input gradient, A^T.B in f32 for a weight
gradient, and A.W^T with the ReLU- and gelu_tanh-backward epilogues), and
`rms_norm_bwd`, the RMSNorm backward with the residual cotangent and the
norm weight's gradient summed over rows. `T5LayerTrain` is the layer-level
`torch.autograd.Function` (the JAX custom VJP): it saves only x and x1.
Weight gradients are f32 in the port's (out, in) layout.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors. `t5_layer_reference`, `t5_ffn_bwd_reference` and
`t5_attn_bwd_reference` are built only from the plain versions, for checks
on the card. The BERT (K9, K10) and ViT (K14) layers and the query-tiled
form (K13) wait for later slices; `ffn_chunk`, `attn_stream` and the row
picker are VMEM artifacts with no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.models.layers import rms_norm
from rag_docvqa_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
)

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


def _t5_layer(x, key_mask, bias, l, num_heads, eps, gated, norm, matmul, attend, save_x1=False):
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
    out = matmul(f, l["wof"].to(cdt), "residual", x1).view(B, T, d)
    return (out, x1.view(B, T, d)) if save_x1 else out


def fused_t5_layer_parts(x: torch.Tensor, key_mask: torch.Tensor, bias: Optional[torch.Tensor],
                         l: Dict[str, torch.Tensor], *, num_heads: int, eps: float,
                         gated: bool, save_x1: bool = False):
    """One encoder layer from a `fuse_t5_blocks` entry: x (B, T, d),
    key_mask (B, T) bool, bias (H, T, T) batch-shared or None (the bias-free
    form). Returns out, or (out, x1) with save_x1. Kernels on CUDA, plain
    versions on the CPU."""
    return _t5_layer(x.contiguous(), key_mask.contiguous(), bias, l, num_heads, eps, gated,
                     rms_norm_rows, gemm, flash_attention_fwd, save_x1)


def t5_layer_reference(x, key_mask, bias, l, *, num_heads: int, eps: float, gated: bool,
                       save_x1: bool = False):
    """The layer from the plain versions only, on any device."""
    return _t5_layer(x.contiguous(), key_mask.contiguous(), bias, l, num_heads, eps, gated,
                     rms_norm, gemm_reference, flash_attention_reference, save_x1)


def fused_t5_layer(x, key_mask, bias, layer, *, num_heads: int, eps: float, gated: bool):
    """`fused_t5_layer_parts` on one T5EncoderLayer module."""
    return fused_t5_layer_parts(x, key_mask, bias, fuse_t5_blocks([layer], gated)[0],
                                num_heads=num_heads, eps=eps, gated=gated)


# --------------------------------------------------------------------------- #
# the backward's products: A.W, A^T.B (f32) and the FFN-backward epilogues
# --------------------------------------------------------------------------- #
LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}
BWD_EPILOGUES = {"store": 0, "store_f32": 1, "acc_f32": 2, "relu_bwd": 3, "gelu_bwd": 4}
# (layout, epilogue) pairs the kernel takes, and how many outputs each gives
BWD_PAIRS = {("nt", "relu_bwd"): 2, ("nt", "gelu_bwd"): 3, ("nn", "store"): 1, ("nn", "store_f32"): 1,
             ("nn", "acc_f32"): 1, ("tn", "store_f32"): 1}


def _gelu_tanh_and_grad(g):
    """gelu_new (tanh form) and its derivative, f32 (fused_encoder_bwd.py)."""
    c, a = (2.0 / torch.pi) ** 0.5, 0.044715
    t = torch.tanh(c * (g + a * g * g * g))
    return 0.5 * g * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c * (1.0 + 3.0 * a * g * g)


def gemm_bwd_reference(a, b, layout: str, epilogue: str, aux0=None, aux1=None, acc=None):
    """Plain version of the backward GEMM kernel: the f32 product of
    a (M, K) . b (N, K)^T ("nt"), a (M, K) . b (K, N) ("nn") or
    a (K, M)^T . b (K, N) ("tn"), then the epilogue with the kernel's casts
    (csrc/t5_layer_bwd.cu lists them): "store" -> a's dtype, "store_f32",
    "acc_f32" (adds into `acc` in place and returns it), "relu_bwd"
    (aux0 = df) -> (dpre, f), "gelu_bwd" (aux0 = u, aux1 = df) -> (f, du, dgl)."""
    cdt = a.dtype
    p = torch.matmul(a.float().t() if layout == "tn" else a.float(), b.float().t() if layout == "nt" else b.float())
    if epilogue == "store":
        return p.to(cdt)
    if epilogue == "store_f32":
        return p
    if epilogue == "acc_f32":
        return acc.add_(p)
    if epilogue == "relu_bwd":
        return torch.where(p > 0, aux0.float(), 0.0).to(cdt), p.clamp(min=0).to(cdt)
    if epilogue == "gelu_bwd":
        ge, dge = _gelu_tanh_and_grad(p.to(cdt).float())
        u, df = aux0.float(), aux1.float()
        return (ge.to(cdt).float() * u).to(cdt), (df * ge).to(cdt), (df * u * dge).to(cdt)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def gemm_bwd(a: torch.Tensor, b: torch.Tensor, layout: str, epilogue: str,
             aux0: Optional[torch.Tensor] = None, aux1: Optional[torch.Tensor] = None,
             acc: Optional[torch.Tensor] = None):
    """The products of the layer backward (see `gemm_bwd_reference` for the
    layouts and epilogues). Outputs are (M, N): in a's dtype, or f32 for the
    _f32 epilogues."""
    n_out = BWD_PAIRS.get((layout, epilogue))
    if n_out is None:
        raise ValueError(f"gemm_bwd: no kernel for layout {layout!r} with epilogue {epilogue!r}")
    n_aux = {"relu_bwd": 1, "gelu_bwd": 2}.get(epilogue, 0)
    if (aux0 is not None, aux1 is not None) != (n_aux >= 1, n_aux >= 2) or (acc is None) != (epilogue != "acc_f32"):
        raise ValueError(f"gemm_bwd: wrong aux/acc operands for epilogue {epilogue!r}")
    if not kernels.on_cuda(a, b, aux0, aux1, acc):
        return gemm_bwd_reference(a, b, layout, epilogue, aux0, aux1, acc)
    kernels.require(a.dim() == 2 and b.dim() == 2, "gemm_bwd: a and b must be 2-D")
    kernels.require(a.dtype == b.dtype, f"gemm_bwd: a is {a.dtype}, b is {b.dtype}")
    kernels.require(a.is_contiguous() and b.is_contiguous(), "gemm_bwd: need contiguous a and b")
    M, K = (a.shape[1], a.shape[0]) if layout == "tn" else a.shape
    N = b.shape[0] if layout == "nt" else b.shape[1]
    kernels.require(b.shape == ((N, K) if layout == "nt" else (K, N)),
                    f"gemm_bwd {layout}: a {tuple(a.shape)} and b {tuple(b.shape)} do not fit")
    dtype = kernels.dtype_code(a, (torch.float32, torch.bfloat16))
    if a.dtype == torch.bfloat16:
        vec = {"nt": (K,), "nn": (K, N), "tn": (M, N)}[layout]
        kernels.require(all(n % 8 == 0 for n in vec) and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                        "gemm_bwd: the bf16 kernel loads 16-byte rows: contiguous dims % 8 == 0, aligned a and b")
    for t in (aux0, aux1):
        if t is not None:
            kernels.require(t.shape == (M, N) and t.dtype == a.dtype and t.is_contiguous(),
                            f"gemm_bwd: aux must be contiguous {a.dtype} (M, N)")
    if acc is not None:
        kernels.require(acc.shape == (M, N) and acc.dtype == torch.float32 and acc.is_contiguous(),
                        "gemm_bwd: acc must be contiguous f32 (M, N)")
        outs = [acc]
    else:
        out_dtype = torch.float32 if epilogue == "store_f32" else a.dtype
        outs = [torch.empty((M, N), dtype=out_dtype, device=a.device) for _ in range(n_out)]
    ptrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
    err = kernels.library().t5_gemm_bwd(
        a.data_ptr(), b.data_ptr(), *ptrs, aux0.data_ptr() if aux0 is not None else None,
        aux1.data_ptr() if aux1 is not None else None, M, N, K, LAYOUTS[layout], dtype,
        BWD_EPILOGUES[epilogue], kernels.stream_ptr(a))
    kernels.check("t5_gemm_bwd", err)
    kernels.LAUNCHES["t5_gemm_bwd"] += 1
    return outs[0] if n_out == 1 else tuple(outs)


# --------------------------------------------------------------------------- #
# RMSNorm backward
# --------------------------------------------------------------------------- #
def rms_norm_bwd_reference(x, dh, weight, resid, eps: float):
    """Plain version of the RMSNorm-backward kernel (`_rms_bwd`): for
    h = x * rstd * w, dx = rstd*dn - x*rstd^3 * sum(dn*x)/d with dn = dh*w.
    Returns (cast(resid + dx) in x's dtype, dw = sum_rows(dh * x * rstd) f32)."""
    x32 = x.float()
    d = x.shape[-1]
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    dn = dh * weight.float()
    s = (dn * x32).sum(dim=-1, keepdim=True)
    dx = rstd * dn - x32 * (rstd * rstd * rstd) * (s * (1.0 / d))
    return (resid.float() + dx).to(x.dtype), (dh * (x32 * rstd)).sum(dim=0)


def rms_norm_bwd(x: torch.Tensor, dh: torch.Tensor, weight: torch.Tensor, resid: torch.Tensor,
                 eps: float):
    """RMSNorm backward over rows: x and resid (R, d) in the compute dtype,
    dh (R, d) f32 (the cotangent at the norm's output), weight (d,). Returns
    (cast(resid + dx), dweight f32 (d,)); the row sum runs in a fixed order."""
    if not kernels.on_cuda(x, dh, weight, resid):
        return rms_norm_bwd_reference(x, dh, weight, resid, eps)
    R, d = x.shape
    kernels.require(d <= 4096, f"rms_norm_bwd: width {d} > 4096")
    kernels.require(dh.shape == x.shape and dh.dtype == torch.float32 and resid.shape == x.shape
                    and resid.dtype == x.dtype and weight.shape == (d,),
                    "rms_norm_bwd: dh f32 and resid like x (R, d), weight (d,)")
    kernels.require(all(t.is_contiguous() for t in (x, dh, weight, resid)), "rms_norm_bwd: need contiguous operands")
    dtype = kernels.dtype_code(x, (torch.float32, torch.bfloat16))
    w_dtype = kernels.dtype_code(weight, (torch.float32, torch.bfloat16))
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    part = torch.empty(((R + 31) // 32, d), dtype=torch.float32, device=x.device)
    err = kernels.library().t5_rms_bwd(
        x.data_ptr(), dh.data_ptr(), weight.data_ptr(), resid.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        part.data_ptr(), R, d, float(eps), dtype, w_dtype, kernels.stream_ptr(x))
    kernels.check("t5_rms_bwd", err)
    kernels.LAUNCHES["t5_rms_bwd"] += 1
    return dx, dw


# --------------------------------------------------------------------------- #
# K7 and K8
# --------------------------------------------------------------------------- #
def _ffn_bwd(x1, g, ln1, ffn_ws, eps, gated, norm, matmul, mm_bwd, n_bwd):
    B, T, d = x1.shape
    cdt = x1.dtype
    x2, g2 = x1.reshape(B * T, d), g.reshape(B * T, d)
    ws = [w.to(cdt) for w in ffn_ws]
    ln1 = ln1.to(cdt)
    h2 = norm(x2, ln1, eps)
    df = mm_bwd(g2, ws[-1], "nn", "store")
    if gated:
        wi0, wi1 = ws[0], ws[1]
        u = matmul(h2, wi1)
        f, du, dgl = mm_bwd(h2, wi0, "nt", "gelu_bwd", u, df)
        dwi = (mm_bwd(dgl, h2, "tn", "store_f32"), mm_bwd(du, h2, "tn", "store_f32"))
        dh2 = mm_bwd(du, wi1, "nn", "acc_f32", acc=mm_bwd(dgl, wi0, "nn", "store_f32"))
    else:
        dpre, f = mm_bwd(h2, ws[0], "nt", "relu_bwd", df)
        dwi = (mm_bwd(dpre, h2, "tn", "store_f32"),)
        dh2 = mm_bwd(dpre, ws[0], "nn", "store_f32")
    dwof = mm_bwd(g2, f, "tn", "store_f32")
    dx1, dln1 = n_bwd(x2, dh2, ln1, g2, eps)
    return dx1.view(B, T, d), dln1, (*dwi, dwof)


def t5_ffn_bwd(x1: torch.Tensor, g: torch.Tensor, ln1: torch.Tensor, ffn_ws, *, eps: float, gated: bool):
    """K7, FFN + LN1 backward (`fused_encoder_bwd.py::t5_ffn_bwd`): x1 the
    saved attention-residual sum and g the cotangent at the layer output,
    both (B, T, d); ffn_ws (wi, wof) or (wi_0, wi_1, wof) in the (out, in)
    layout. Returns (dx1 with the residual path, dln1 f32, the FFN weight
    gradients f32 in ffn_ws's order and layout)."""
    return _ffn_bwd(x1.contiguous(), g.contiguous(), ln1, ffn_ws, eps, gated, rms_norm_rows, gemm, gemm_bwd,
                    rms_norm_bwd)


def t5_ffn_bwd_reference(x1, g, ln1, ffn_ws, *, eps: float, gated: bool):
    """K7 from the plain versions only, on any device."""
    return _ffn_bwd(x1.contiguous(), g.contiguous(), ln1, ffn_ws, eps, gated, rms_norm, gemm_reference,
                    gemm_bwd_reference, rms_norm_bwd_reference)


def _attn_bwd(x, dy, key_mask, bias, wqkv, wo, ln0, num_heads, eps, norm, matmul, attend, attend_bwd,
              mm_bwd, n_bwd):
    B, T, d = x.shape
    inner = wo.shape[1]
    dk = inner // num_heads
    cdt = x.dtype
    x2, dy2 = x.reshape(B * T, d), dy.reshape(B * T, d)
    wqkv, wo, ln0 = wqkv.to(cdt), wo.to(cdt), ln0.to(cdt)
    bias4 = None if bias is None else bias[None]
    # recompute: h, qkv and the attention (K1 (a), (b), K2)
    h = norm(x2, ln0, eps)
    qkv = matmul(h, wqkv).view(B, T, 3, num_heads, dk)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    a, lse = attend(q, k, v, key_mask, bias4, 1.0, False, T5_MASK_VALUE)
    # x1 = x + a . Wo^T: the cotangent at the projection's output is dy
    dwo = mm_bwd(dy2, a.reshape(B * T, inner), "tn", "store_f32")
    da = mm_bwd(dy2, wo, "nn", "store").view(B, T, num_heads, dk)
    dqkv = torch.empty((B, T, 3, num_heads, dk), dtype=cdt, device=x.device)
    _, _, _, dbias = attend_bwd(q, k, v, a, lse, da, key_mask, bias4, 1.0, False, T5_MASK_VALUE,
                                grads=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
    dqkv = dqkv.view(B * T, 3 * inner)
    dwqkv = mm_bwd(dqkv, h, "tn", "store_f32")
    dh = mm_bwd(dqkv, wqkv, "nn", "store_f32")
    dx, dln0 = n_bwd(x2, dh, ln0, dy2, eps)
    return dx.view(B, T, d), dln0, dwqkv, dwo, None if dbias is None else dbias[0]


def t5_attn_bwd(x: torch.Tensor, dy: torch.Tensor, key_mask: torch.Tensor, bias: Optional[torch.Tensor],
                wqkv: torch.Tensor, wo: torch.Tensor, ln0: torch.Tensor, *, num_heads: int, eps: float):
    """K8, attention + LN0 backward (`fused_encoder_bwd.py::t5_attn_bwd`):
    x the saved layer input and dy the cotangent at x1, both (B, T, d);
    key_mask (B, T) bool; bias (H, T, T) or None; wqkv (3*inner, d),
    wo (d, inner). Returns (dx with the residual path, dln0 f32, dwqkv f32,
    dwo f32, dbias (H, T, T) f32 or None)."""
    return _attn_bwd(x.contiguous(), dy.contiguous(), key_mask.contiguous(), bias, wqkv, wo, ln0, num_heads, eps,
                     rms_norm_rows, gemm, flash_attention_fwd, flash_attention_bwd, gemm_bwd, rms_norm_bwd)


def t5_attn_bwd_reference(x, dy, key_mask, bias, wqkv, wo, ln0, *, num_heads: int, eps: float):
    """K8 from the plain versions only, on any device."""
    return _attn_bwd(x.contiguous(), dy.contiguous(), key_mask.contiguous(), bias, wqkv, wo, ln0, num_heads, eps,
                     rms_norm, gemm_reference, flash_attention_reference, flash_attention_bwd_reference,
                     gemm_bwd_reference, rms_norm_bwd_reference)


# --------------------------------------------------------------------------- #
# the layer-level autograd Function
# --------------------------------------------------------------------------- #
def layer_keys(gated: bool):
    """The order of a `fuse_t5_blocks` entry's tensors in `T5LayerTrain`."""
    return ("wqkv", "wo", "ln0", "ln1") + (("wi_0", "wi_1") if gated else ("wi",)) + ("wof",)


class T5LayerTrain(torch.autograd.Function):
    """One encoder layer with the hand-written backward: forward K1 with
    save_x1, backward K7 then K8 (`make_fused_t5_layer_train`). Gradients
    reach x, the bias and every weight, each in its own dtype."""

    @staticmethod
    def forward(ctx, x, key_mask, bias, num_heads, eps, gated, *ws):
        l = dict(zip(layer_keys(gated), ws))
        out, x1 = fused_t5_layer_parts(x, key_mask, bias, l, num_heads=num_heads, eps=eps, gated=gated,
                                       save_x1=True)
        ctx.save_for_backward(x.contiguous(), x1, key_mask, bias, *ws)
        ctx.cfg = (num_heads, eps, gated)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, gated = ctx.cfg
        x, x1, key_mask, bias, *ws = ctx.saved_tensors
        l = dict(zip(layer_keys(gated), ws))
        ffn_ws = tuple(l[k] for k in layer_keys(gated)[4:])
        dx1, dln1, dffn = t5_ffn_bwd(x1, g, l["ln1"], ffn_ws, eps=eps, gated=gated)
        dx, dln0, dwqkv, dwo, dbias = t5_attn_bwd(x, dx1, key_mask, bias, l["wqkv"], l["wo"], l["ln0"],
                                                  num_heads=num_heads, eps=eps)
        grads = dict(zip(layer_keys(gated), (dwqkv, dwo, dln0, dln1, *dffn)))
        dws = [grads[k].to(w.dtype) for k, w in zip(layer_keys(gated), ws)]
        dbias = dbias.to(bias.dtype) if ctx.needs_input_grad[2] else None
        return (dx, None, dbias, None, None, None, *dws)


def t5_layer_train(x, key_mask, bias, l: Dict[str, torch.Tensor], *, num_heads: int, eps: float, gated: bool):
    """`T5LayerTrain` on a `fuse_t5_blocks` entry."""
    return T5LayerTrain.apply(x, key_mask, bias, num_heads, eps, gated, *(l[k] for k in layer_keys(gated)))
