"""The T5 (K1, K7, K8) and BERT (K9, K10) encoder layers through hand-written
kernels. The T5 layer first; the BERT layer at the end of this docstring.

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
on the card. The ViT layer (K14) and the query-tiled form (K13) wait for
later slices; `ffn_chunk`, `attn_stream` and the row pickers are VMEM
artifacts with no counterpart.

The post-LN BERT layer (K9; the BERT part of the JAX `ops/fused_encoder.py`:
`_erf32`, `fuse_bert_blocks`, `fused_bert_layer_parts`, `fused_bert_layer`)
is the same GEMM with three more epilogues (csrc/bert_layer.cu says how),

  "bias"               cast(a.W^T + b)                       (QKV)
  "bias_gelu"          cast(gelu_erf(a.W^T + b)), GELU in f32 (fc1)
  "bias_residual_f32"  aux + (a.W^T + b), kept in f32        (O and fc2),

`layer_norm_rows`, a row LayerNorm that reads that f32 sum and writes the
compute dtype, and K2 with mask_value -1e30 and scale dh^-0.5. erf is the
rational polynomial the TPU kernel spells out (`_erf32`). Its backward (K10;
the JAX `ops/fused_encoder_bwd.py`: `bert_ffn_bwd`, `bert_attn_bwd`,
`make_fused_bert_layer_train`) splits at x1, the post-LN1 activation
(csrc/bert_layer_bwd.cu says how), from `gemm_bwd` with three more
epilogues, `layer_norm_bwd` and `col_sum` (the bias gradients, summed over
rows in a fixed order) and K6. `BertLayerTrain` is the layer-level
`torch.autograd.Function`: it saves x and x1 only.

Two places where K9/K10 keep the port's K2/K6 cast points and not the TPU
BERT kernels': the probabilities are rounded to the compute dtype before
normalisation (the TPU kernel rounds p / sum), and the score gradient is
rounded before the scale (the TPU kernel rounds p * (dp - srow) * scale). In
f32 the two agree to rounding; a sequence with no valid key gives a zero
attention output and a zero gradient here, a uniform softmax on the TPU.
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

BERT_MASK_VALUE = -1e30  # the TPU BERT kernel's masked score

# the codes of csrc/gemm_fwd.cuh; 4 and above take a bias and launch `bert_gemm`
EPILOGUES = {"none": 0, "relu": 1, "residual": 2, "gelu_mul": 3, "bias": 4, "bias_gelu": 5, "bias_residual_f32": 6}
_AUX_EPILOGUES = ("residual", "gelu_mul", "bias_residual_f32")

_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06, -5.69250639462346e-05,
              -7.34990630326855e-04, -2.95459980854025e-03, -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03, -7.37332916720468e-03,
             -1.42647390514189e-02)


def _erf32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf in Eigen's rational form: the polynomial XLA lowers
    `jax.lax.erf` to and the TPU BERT kernels spell out; csrc/common.cuh has
    the same one. `torch.erf` differs from it in the last bits."""
    x = x.clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, _ERF_ALPHA[0])
    for a in _ERF_ALPHA[1:]:
        p = p * x2 + a
    p = p * x
    q = torch.full_like(x, _ERF_BETA[0])
    for b in _ERF_BETA[1:]:
        q = q * x2 + b
    return p / q


def _gelu_erf_and_grad(h: torch.Tensor):
    """Exact-erf GELU and its derivative, f32: cdf from `_erf32`, pdf from
    exp (`fused_encoder_bwd.py::_gelu_erf_and_grad`)."""
    cdf = 0.5 * (1.0 + _erf32(h * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * h * h) * (2.0 * torch.pi) ** -0.5
    return h * cdf, cdf + h * pdf


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
                   aux: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the GEMM kernel: f32 product of a (M, K) and
    w (N, K), then the epilogue with the kernel's casts, in a's dtype (f32
    for "bias_residual_f32")."""
    cdt = a.dtype
    acc = torch.matmul(a.float(), w.float().t())
    if bias is not None:
        acc = acc + bias.float()
    if epilogue == "bias":
        return acc.to(cdt)
    if epilogue == "bias_gelu":
        return (0.5 * acc * (1.0 + _erf32(acc * 2.0 ** -0.5))).to(cdt)
    if epilogue == "bias_residual_f32":
        return aux.float() + acc
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
         aux: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(a (M, K) @ w (N, K)^T) -> (M, N) in a's dtype (f32 for
    "bias_residual_f32"); aux (M, N) is the residual or the up-projection u
    ("gelu_mul"), bias (N,) the dense bias of the "bias*" epilogues."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (aux is None) != (epilogue not in _AUX_EPILOGUES):
        raise ValueError(f"epilogue {epilogue!r} {'needs' if aux is None else 'takes no'} aux")
    if (bias is None) != (not epilogue.startswith("bias")):
        raise ValueError(f"epilogue {epilogue!r} {'needs' if bias is None else 'takes no'} bias")
    if not kernels.on_cuda(a, w, aux, bias):
        return gemm_reference(a, w, epilogue, aux, bias)
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
    out_dtype = torch.float32 if epilogue == "bias_residual_f32" else a.dtype
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    aux_ptr = aux.data_ptr() if aux is not None else None
    if bias is None:
        err = kernels.library().t5_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), aux_ptr, M, N, K, dtype,
                                        EPILOGUES[epilogue], kernels.stream_ptr(a))
        name = "t5_gemm"
    else:
        kernels.require(bias.shape == (N,) and bias.dtype == a.dtype and bias.is_contiguous(),
                        f"gemm: bias must be contiguous {a.dtype} (N,), got {tuple(bias.shape)} {bias.dtype}")
        err = kernels.library().bert_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), aux_ptr, bias.data_ptr(),
                                          M, N, K, dtype, EPILOGUES[epilogue], kernels.stream_ptr(a))
        name = "bert_gemm"
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
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
# the codes of csrc/gemm_bwd.cuh; 5 and above launch `bert_gemm_bwd`
BWD_EPILOGUES = {"store": 0, "store_f32": 1, "acc_f32": 2, "relu_bwd": 3, "gelu_bwd": 4,
                 "bias_gelu_grad": 5, "mul_f32": 6, "add_f32_store": 7}
# (layout, epilogue) pairs the kernels take -> (outputs, aux operands): "c" is
# (M, N) in the compute dtype, "f" (M, N) f32, "b" a bias (N,) in the compute dtype
BWD_PAIRS = {("nt", "relu_bwd"): ("cc", "c"), ("nt", "gelu_bwd"): ("ccc", "cc"), ("nn", "store"): ("c", ""),
             ("nn", "store_f32"): ("f", ""), ("nn", "acc_f32"): ("f", ""), ("tn", "store_f32"): ("f", ""),
             ("nt", "bias_gelu_grad"): ("cf", "b"), ("nn", "mul_f32"): ("fc", "f"),
             ("nn", "add_f32_store"): ("c", "f")}


def _gelu_tanh_and_grad(g):
    """gelu_new (tanh form) and its derivative, f32 (fused_encoder_bwd.py)."""
    c, a = (2.0 / torch.pi) ** 0.5, 0.044715
    t = torch.tanh(c * (g + a * g * g * g))
    return 0.5 * g * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c * (1.0 + 3.0 * a * g * g)


def gemm_bwd_reference(a, b, layout: str, epilogue: str, aux0=None, aux1=None, acc=None):
    """Plain version of the backward GEMM kernel: the f32 product of
    a (M, K) . b (N, K)^T ("nt"), a (M, K) . b (K, N) ("nn") or
    a (K, M)^T . b (K, N) ("tn"), then the epilogue with the kernel's casts
    (csrc/gemm_bwd.cuh lists them): "store" -> a's dtype, "store_f32",
    "acc_f32" (adds into `acc` in place and returns it), "relu_bwd"
    (aux0 = df) -> (dpre, f), "gelu_bwd" (aux0 = u, aux1 = df) -> (f, du, dgl),
    "bias_gelu_grad" (aux0 = bias (N,)) -> (gelu(p + bias) in a's dtype,
    gelu'(p + bias) f32), "mul_f32" (aux0 f32) -> (p * aux0 f32, its cast),
    "add_f32_store" (aux0 f32) -> cast(aux0 + p)."""
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
    if epilogue == "bias_gelu_grad":
        ge, dge = _gelu_erf_and_grad(p + aux0.float())
        return ge.to(cdt), dge
    if epilogue == "mul_f32":
        v = p * aux0
        return v, v.to(cdt)
    if epilogue == "add_f32_store":
        return (aux0 + p).to(cdt)
    raise ValueError(f"unknown epilogue {epilogue!r}")


SM_COUNT = 132  # H100 SXM; only sizes the split below, any value is correct


def tn_splits(M: int, N: int, K: int, bf16: bool) -> int:
    """Into how many row ranges a weight gradient a^T . b is cut: 1 when its
    (M, N) output already has a tile for every SM or few rows, else enough
    ranges of at least 512 rows for about two tiles per SM, at most 32. The
    partial products are summed in range order, so the result does not depend
    on timing; it depends on this number only in the order of an f32 sum."""
    tile = 128 if bf16 else 64
    tiles = -(-M // tile) * -(-N // tile)
    if tiles >= SM_COUNT or K < 1024:
        return 1
    return max(1, min(-(-2 * SM_COUNT // tiles), K // 512, 32))


def gemm_bwd(a: torch.Tensor, b: torch.Tensor, layout: str, epilogue: str,
             aux0: Optional[torch.Tensor] = None, aux1: Optional[torch.Tensor] = None,
             acc: Optional[torch.Tensor] = None):
    """The products of the layer backward (see `gemm_bwd_reference` for the
    layouts and epilogues). Outputs are (M, N), in a's dtype or f32 as
    `BWD_PAIRS` says."""
    spec = BWD_PAIRS.get((layout, epilogue))
    if spec is None:
        raise ValueError(f"gemm_bwd: no kernel for layout {layout!r} with epilogue {epilogue!r}")
    out_kinds, aux_kinds = spec
    if (aux0 is not None, aux1 is not None) != (len(aux_kinds) >= 1, len(aux_kinds) >= 2) \
            or (acc is None) != (epilogue != "acc_f32"):
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
    kind_dtype = {"c": a.dtype, "f": torch.float32, "b": a.dtype}
    for t, kind in zip((aux0, aux1), aux_kinds):
        kernels.require(t.shape == ((N,) if kind == "b" else (M, N)) and t.dtype == kind_dtype[kind]
                        and t.is_contiguous(), f"gemm_bwd {epilogue}: aux must be contiguous {kind_dtype[kind]} "
                        f"{'(N,)' if kind == 'b' else '(M, N)'}, got {tuple(t.shape)} {t.dtype}")
    if acc is not None:
        kernels.require(acc.shape == (M, N) and acc.dtype == torch.float32 and acc.is_contiguous(),
                        "gemm_bwd: acc must be contiguous f32 (M, N)")
        outs = [acc]
    else:
        outs = [torch.empty((M, N), dtype=kind_dtype[kind], device=a.device) for kind in out_kinds]
    ptr = lambda t: t.data_ptr() if t is not None else None
    if BWD_EPILOGUES[epilogue] < 5:
        name = "t5_gemm_bwd"
        ptrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
        splits = tn_splits(M, N, K, a.dtype == torch.bfloat16) if layout == "tn" else 1
        scratch = torch.empty((splits, M, N), dtype=torch.float32, device=a.device) if splits > 1 else None
        err = kernels.library().t5_gemm_bwd(a.data_ptr(), b.data_ptr(), *ptrs, ptr(aux0), ptr(aux1), M, N, K,
                                            LAYOUTS[layout], dtype, BWD_EPILOGUES[epilogue], ptr(scratch), splits,
                                            kernels.stream_ptr(a))
    else:
        name = "bert_gemm_bwd"
        ptrs = [t.data_ptr() for t in outs] + [None] * (2 - len(outs))
        err = kernels.library().bert_gemm_bwd(a.data_ptr(), b.data_ptr(), *ptrs, ptr(aux0), M, N, K,
                                              LAYOUTS[layout], dtype, BWD_EPILOGUES[epilogue],
                                              kernels.stream_ptr(a))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


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


# --------------------------------------------------------------------------- #
# K9: the post-LN BERT layer
# --------------------------------------------------------------------------- #
BERT_KEYS = ("wqkv", "bqkv", "wo", "bo", "ln1", "w1", "b1", "w2", "b2", "ln2")


def layer_norm_reference(y: torch.Tensor, ln: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the LayerNorm kernel: y (R, d) f32, ln (2, d) =
    [scale; bias]; mean and variance in f32, the result cast to `dtype`."""
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    n = (y - mean) * torch.rsqrt(var + eps)
    return (n * ln[0].float() + ln[1].float()).to(dtype)


def layer_norm_rows(y: torch.Tensor, ln: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the rows of the f32 sum y (R, d) with ln (2, d) in
    `dtype`; the result is in `dtype`."""
    if not kernels.on_cuda(y, ln):
        return layer_norm_reference(y, ln, eps, dtype)
    R, d = y.shape
    kernels.require(y.dtype == torch.float32 and y.is_contiguous(), "layer_norm_rows: y must be contiguous f32")
    kernels.require(ln.shape == (2, d) and ln.dtype == dtype and ln.is_contiguous(),
                    f"layer_norm_rows: ln must be contiguous {dtype} (2, {d}), got {tuple(ln.shape)} {ln.dtype}")
    code = kernels.dtype_code(ln, (torch.float32, torch.bfloat16))
    out = torch.empty((R, d), dtype=dtype, device=y.device)
    err = kernels.library().bert_layer_norm(y.data_ptr(), ln.data_ptr(), out.data_ptr(), R, d, float(eps), code,
                                            kernels.stream_ptr(y))
    kernels.check("bert_layer_norm", err)
    kernels.LAUNCHES["bert_layer_norm"] += 1
    return out


def fuse_bert_blocks(layers) -> List[Dict[str, torch.Tensor]]:
    """Per-layer weights in the kernels' form, built once per encode from
    BertLayer modules (models/bert.py): wqkv (3d, d) = [q; k; v] and bqkv
    (3d,), wo (d, d), w1 (d_ff, d), w2 (d, d_ff) with their biases, and
    ln1/ln2 (2, d) = [scale; bias]. Differentiable: gradients reach the
    modules' tensors through the concats."""
    return [{"wqkv": torch.cat([l.q_w, l.k_w, l.v_w], dim=0), "bqkv": torch.cat([l.q_b, l.k_b, l.v_b], dim=0),
             "wo": l.o_w, "bo": l.o_b, "ln1": torch.stack([l.attn_ln_w, l.attn_ln_b]),
             "w1": l.fc1_w, "b1": l.fc1_b, "w2": l.fc2_w, "b2": l.fc2_b,
             "ln2": torch.stack([l.out_ln_w, l.out_ln_b])} for l in layers]


def _bert_layer(x, key_mask, l, num_heads, eps, matmul, norm, attend, save_x1=False):
    B, T, d = x.shape
    dh = d // num_heads
    cdt = x.dtype
    w = {k: l[k].to(cdt).contiguous() for k in BERT_KEYS}
    x2 = x.reshape(B * T, d)
    qkv = matmul(x2, w["wqkv"], "bias", bias=w["bqkv"]).view(B, T, 3, num_heads, dh)
    attn, _ = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_mask, None, dh ** -0.5, False, BERT_MASK_VALUE)
    y1 = matmul(attn.reshape(B * T, d), w["wo"], "bias_residual_f32", x2, w["bo"])
    x1 = norm(y1, w["ln1"], eps, cdt)
    h = matmul(x1, w["w1"], "bias_gelu", bias=w["b1"])
    y2 = matmul(h, w["w2"], "bias_residual_f32", x1, w["b2"])
    out = norm(y2, w["ln2"], eps, cdt).view(B, T, d)
    return (out, x1.view(B, T, d)) if save_x1 else out


def fused_bert_layer_parts(x: torch.Tensor, key_mask: torch.Tensor, l: Dict[str, torch.Tensor], *,
                           num_heads: int, eps: float, save_x1: bool = False):
    """One post-LN BERT layer from a `fuse_bert_blocks` entry: x (B, T, d),
    key_mask (B, T) bool. Returns out, or (out, x1) with save_x1, x1 the
    post-LN1 activation the backward starts from. Kernels on CUDA, plain
    versions on the CPU. Finite everywhere; a sequence with no valid key has
    a zero attention output (see the module docstring)."""
    return _bert_layer(x.contiguous(), key_mask.contiguous(), l, num_heads, eps, gemm, layer_norm_rows,
                       flash_attention_fwd, save_x1)


def bert_layer_reference(x, key_mask, l, *, num_heads: int, eps: float, save_x1: bool = False):
    """The BERT layer from the plain versions only, on any device."""
    return _bert_layer(x.contiguous(), key_mask.contiguous(), l, num_heads, eps, gemm_reference,
                       layer_norm_reference, flash_attention_reference, save_x1)


def fused_bert_layer(x, key_mask, layer, *, num_heads: int, eps: float):
    """`fused_bert_layer_parts` on one BertLayer module."""
    return fused_bert_layer_parts(x, key_mask, fuse_bert_blocks([layer])[0], num_heads=num_heads, eps=eps)


# --------------------------------------------------------------------------- #
# K10: the BERT layer backward
# --------------------------------------------------------------------------- #
def layer_norm_bwd_reference(y: torch.Tensor, g: torch.Tensor, ln: torch.Tensor, eps: float):
    """Plain version of the LayerNorm-backward kernel (`_ln_bwd`): for
    out = n * w + b with n = (y - mean) * rstd and g the cotangent at out,
    dy = rstd * (dn - mean(dn) - n * mean(dn * n)) with dn = g * w. Returns
    (dy f32, dy in g's dtype, dln (2, d) f32 = [sum_rows(g * n); sum_rows(g)],
    sum_rows(dy) f32)."""
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    n = (y - mean) * rstd
    g32 = g.float()
    dn = g32 * ln[0].float()
    dy = rstd * (dn - dn.mean(dim=-1, keepdim=True) - n * (dn * n).mean(dim=-1, keepdim=True))
    return dy, dy.to(g.dtype), torch.stack([(g32 * n).sum(dim=0), g32.sum(dim=0)]), dy.sum(dim=0)


def layer_norm_bwd(y: torch.Tensor, g: torch.Tensor, ln: torch.Tensor, eps: float):
    """LayerNorm backward over rows: y (R, d) f32 the sum the norm read,
    g (R, d) the cotangent at its output and ln (2, d), both in the compute
    dtype. Returns (dy f32, dy cast, dln (2, d) f32, sum_rows(dy) (d,) f32);
    the row sums run in a fixed order."""
    if not kernels.on_cuda(y, g, ln):
        return layer_norm_bwd_reference(y, g, ln, eps)
    R, d = y.shape
    kernels.require(d <= 4096, f"layer_norm_bwd: width {d} > 4096")
    kernels.require(y.dtype == torch.float32 and g.shape == y.shape and ln.shape == (2, d) and ln.dtype == g.dtype,
                    "layer_norm_bwd: y f32 (R, d), g (R, d) and ln (2, d) in one dtype")
    kernels.require(all(t.is_contiguous() for t in (y, g, ln)), "layer_norm_bwd: need contiguous operands")
    dtype = kernels.dtype_code(g, (torch.float32, torch.bfloat16))
    dy32 = torch.empty_like(y)
    dyc = torch.empty_like(g)
    sums = torch.empty((3, d), dtype=torch.float32, device=y.device)
    part = torch.empty(((R + 31) // 32, 3, d), dtype=torch.float32, device=y.device)
    err = kernels.library().bert_ln_bwd(y.data_ptr(), g.data_ptr(), ln.data_ptr(), dy32.data_ptr(), dyc.data_ptr(),
                                        sums.data_ptr(), part.data_ptr(), R, d, float(eps), dtype,
                                        kernels.stream_ptr(y))
    kernels.check("bert_ln_bwd", err)
    kernels.LAUNCHES["bert_ln_bwd"] += 1
    return dy32, dyc, sums[:2], sums[2]


def col_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the column-sum kernel: sum over rows, f32."""
    return x.float().sum(dim=0)


def col_sum(x: torch.Tensor) -> torch.Tensor:
    """(n,) f32 = sum over the rows of x (R, n), f32 or bf16, in a fixed
    order: a bias gradient."""
    if not kernels.on_cuda(x):
        return col_sum_reference(x)
    R, n = x.shape
    kernels.require(x.is_contiguous() and R <= 64 * 65535, "col_sum: need contiguous x of at most 4,194,240 rows")
    dtype = kernels.dtype_code(x, (torch.float32, torch.bfloat16))
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    part = torch.empty(((R + 63) // 64, n), dtype=torch.float32, device=x.device)
    err = kernels.library().bert_col_sum(x.data_ptr(), out.data_ptr(), part.data_ptr(), R, n, dtype,
                                         kernels.stream_ptr(x))
    kernels.check("bert_col_sum", err)
    kernels.LAUNCHES["bert_col_sum"] += 1
    return out


def _bert_ffn_bwd(x1, g, ln2, w1, b1, w2, b2, eps, matmul, mm_bwd, n_bwd, csum):
    B, T, d = x1.shape
    cdt = x1.dtype
    x2, g2 = x1.reshape(B * T, d), g.reshape(B * T, d)
    ln2, w1, b1, w2, b2 = (t.to(cdt).contiguous() for t in (ln2, w1, b1, w2, b2))
    # recompute: the GELU and its derivative on the f32 pre-activation, then y2
    ge, dge = mm_bwd(x2, w1, "nt", "bias_gelu_grad", b1)
    y2 = matmul(ge, w2, "bias_residual_f32", x2, b2)
    dy2, dy2_c, dln2, db2 = n_bwd(y2, g2, ln2, eps)
    dw2 = mm_bwd(dy2_c, ge, "tn", "store_f32")
    dpre32, dpre = mm_bwd(dy2_c, w2, "nn", "mul_f32", dge)
    db1 = csum(dpre32)
    dw1 = mm_bwd(dpre, x2, "tn", "store_f32")
    dx1 = mm_bwd(dpre, w1, "nn", "add_f32_store", dy2)
    return dx1.view(B, T, d), dln2, dw1, db1, dw2, db2


def bert_ffn_bwd(x1: torch.Tensor, g: torch.Tensor, ln2, w1, b1, w2, b2, *, eps: float):
    """K10, FFN + LN2 backward (`fused_encoder_bwd.py::bert_ffn_bwd`): x1 the
    saved post-LN1 activation and g the cotangent at the layer output, both
    (B, T, d); w1 (d_ff, d) and w2 (d, d_ff) in the (out, in) layout. Returns
    (dx1 with the residual path, dln2 (2, d), dw1, db1, dw2, db2), all but
    dx1 f32."""
    return _bert_ffn_bwd(x1.contiguous(), g.contiguous(), ln2, w1, b1, w2, b2, eps, gemm, gemm_bwd, layer_norm_bwd,
                         col_sum)


def bert_ffn_bwd_reference(x1, g, ln2, w1, b1, w2, b2, *, eps: float):
    """`bert_ffn_bwd` from the plain versions only, on any device."""
    return _bert_ffn_bwd(x1.contiguous(), g.contiguous(), ln2, w1, b1, w2, b2, eps, gemm_reference,
                         gemm_bwd_reference, layer_norm_bwd_reference, col_sum_reference)


def _bert_attn_bwd(x, dy, key_mask, wqkv, bqkv, wo, bo, ln1, num_heads, eps, matmul, attend, attend_bwd, mm_bwd,
                   n_bwd, csum):
    B, T, d = x.shape
    dh = d // num_heads
    cdt = x.dtype
    scale = dh ** -0.5
    x2, dy2 = x.reshape(B * T, d), dy.reshape(B * T, d)
    wqkv, bqkv, wo, bo, ln1 = (t.to(cdt).contiguous() for t in (wqkv, bqkv, wo, bo, ln1))
    # recompute: qkv, the attention (K2) and the sum LN1 read
    qkv = matmul(x2, wqkv, "bias", bias=bqkv).view(B, T, 3, num_heads, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    a, lse = attend(q, k, v, key_mask, None, scale, False, BERT_MASK_VALUE)
    a2 = a.reshape(B * T, d)
    y1 = matmul(a2, wo, "bias_residual_f32", x2, bo)
    dy1, dao, dln1, dbo = n_bwd(y1, dy2, ln1, eps)
    dwo = mm_bwd(dao, a2, "tn", "store_f32")
    da = mm_bwd(dao, wo, "nn", "store").view(B, T, num_heads, dh)
    dqkv = torch.empty((B, T, 3, num_heads, dh), dtype=cdt, device=x.device)
    attend_bwd(q, k, v, a, lse, da, key_mask, None, scale, False, BERT_MASK_VALUE,
               grads=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
    dqkv = dqkv.view(B * T, 3 * d)
    dwqkv = mm_bwd(dqkv, x2, "tn", "store_f32")
    dbqkv = csum(dqkv)
    dx = mm_bwd(dqkv, wqkv, "nn", "add_f32_store", dy1)
    return dx.view(B, T, d), dln1, dwqkv, dbqkv, dwo, dbo


def bert_attn_bwd(x: torch.Tensor, dy: torch.Tensor, key_mask: torch.Tensor, wqkv, bqkv, wo, bo, ln1, *,
                  num_heads: int, eps: float):
    """K10, attention + LN1 backward (`fused_encoder_bwd.py::bert_attn_bwd`):
    x the saved layer input and dy the cotangent at x1, both (B, T, d);
    key_mask (B, T) bool; wqkv (3d, d), wo (d, d). Returns (dx with the
    residual path, dln1 (2, d), dwqkv, dbqkv, dwo, dbo), all but dx f32. A
    sequence with no valid key gets a zero attention gradient."""
    return _bert_attn_bwd(x.contiguous(), dy.contiguous(), key_mask.contiguous(), wqkv, bqkv, wo, bo, ln1, num_heads,
                          eps, gemm, flash_attention_fwd, flash_attention_bwd, gemm_bwd, layer_norm_bwd, col_sum)


def bert_attn_bwd_reference(x, dy, key_mask, wqkv, bqkv, wo, bo, ln1, *, num_heads: int, eps: float):
    """`bert_attn_bwd` from the plain versions only, on any device."""
    return _bert_attn_bwd(x.contiguous(), dy.contiguous(), key_mask.contiguous(), wqkv, bqkv, wo, bo, ln1, num_heads,
                          eps, gemm_reference, flash_attention_reference, flash_attention_bwd_reference,
                          gemm_bwd_reference, layer_norm_bwd_reference, col_sum_reference)


class BertLayerTrain(torch.autograd.Function):
    """One BERT layer with the hand-written backward: forward K9 with
    save_x1, backward `bert_ffn_bwd` then `bert_attn_bwd`
    (`make_fused_bert_layer_train`). Saves x and x1 only; gradients reach x
    and every weight, each in its own dtype."""

    @staticmethod
    def forward(ctx, x, key_mask, num_heads, eps, *ws):
        out, x1 = fused_bert_layer_parts(x, key_mask, dict(zip(BERT_KEYS, ws)), num_heads=num_heads, eps=eps,
                                         save_x1=True)
        ctx.save_for_backward(x.contiguous(), x1, key_mask, *ws)
        ctx.cfg = (num_heads, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        num_heads, eps = ctx.cfg
        x, x1, key_mask, *ws = ctx.saved_tensors
        l = dict(zip(BERT_KEYS, ws))
        dx1, dln2, dw1, db1, dw2, db2 = bert_ffn_bwd(x1, g, l["ln2"], l["w1"], l["b1"], l["w2"], l["b2"], eps=eps)
        dx, dln1, dwqkv, dbqkv, dwo, dbo = bert_attn_bwd(x, dx1, key_mask, l["wqkv"], l["bqkv"], l["wo"], l["bo"],
                                                         l["ln1"], num_heads=num_heads, eps=eps)
        grads = dict(wqkv=dwqkv, bqkv=dbqkv, wo=dwo, bo=dbo, ln1=dln1, w1=dw1, b1=db1, w2=dw2, b2=db2, ln2=dln2)
        return (dx, None, None, None, *(grads[k].to(l[k].dtype) for k in BERT_KEYS))


def bert_layer_train(x, key_mask, l: Dict[str, torch.Tensor], *, num_heads: int, eps: float):
    """`BertLayerTrain` on a `fuse_bert_blocks` entry."""
    return BertLayerTrain.apply(x, key_mask, num_heads, eps, *(l[k] for k in BERT_KEYS))
