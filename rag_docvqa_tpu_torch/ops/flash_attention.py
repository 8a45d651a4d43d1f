"""Flash attention forward (K2) and its plain version.

Counterpart of `rag_docvqa_tpu/ops/flash_attention.py`: `flash_attention`
keeps the JAX layout, q (B, Tq, H, dh) and k/v (B, Tk, Hkv, dh), with a key
mask, an additive bias (1|B, H, Tq, Tk) that is batch-shared or per batch,
`scale`, `causal` and GQA (H a multiple of Hkv). `attention_reference` ports
the JAX oracle of the same name.

`flash_attention_fwd` also returns the per-row log-sum-exp (B, H, Tq) and
takes `mask_value`: the score given to a masked key. With the flash default,
-1e30, a row with no valid key gives zeros (and lse -1e30); the T5 layer
(ops/fused_encoder.py) passes -1e9, with which such a row gives the uniform
softmax of the TPU whole-layer kernel and of `models/t5.py::_attend`.

`flash_attention_bwd` (K6) is the recompute-based backward: from q, k, v,
the forward's output and lse and the output cotangent it gives dq, dk, dv
and the bias gradient in f32, summed over the batch for a (1, H, Tq, Tk)
bias and per batch for a (B, H, Tq, Tk) one. `FlashAttention` is the
`torch.autograd.Function` whose forward is K2 and whose backward is K6, the
counterpart of the JAX `_flash_core` custom VJP.

K2 takes head dims up to 256 (`MAX_HEAD_DIM`; the LLM reranker's Gemma
backbone has dh 256), K6 up to 128 (`MAX_BWD_HEAD_DIM`). A K2 launch at a
head dim above 128 counts under `kernels.FORM_LAUNCHES["flash_fwd_dh256"]`
as well as "flash_fwd".

On CUDA tensors the wrappers launch csrc/flash_fwd.cu and csrc/flash_bwd.cu;
on CPU tensors they run `flash_attention_reference` and
`flash_attention_bwd_reference`, the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_docvqa_tpu_torch import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # K2: 64-, 128- and 256-wide instantiations (dh 256: the Gemma rerankers)
MAX_BWD_HEAD_DIM = 128  # K6: 64- and 128-wide


def _valid_mask(key_mask, B, Tq, Tk, causal, device):
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=device)
    if key_mask is not None:
        valid = valid & key_mask[:, None, None, :]
    if causal:
        valid = valid & (torch.arange(Tk, device=device)[None, :] <= torch.arange(Tq, device=device)[:, None])
    return valid.expand(B, 1, Tq, Tk)


def _repeat_kv(q, k, v):
    if k.shape[2] != q.shape[2]:  # GQA
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def attention_reference(q, k, v, key_mask=None, bias=None, scale=1.0, causal=False):
    """The JAX oracle: plain softmax attention, zeros on rows with no valid
    key. Returns (B, Tq, H, dh) in q's dtype."""
    k, v = _repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    valid = _valid_mask(key_mask, q.shape[0], q.shape[1], k.shape[1], causal, q.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = torch.where(valid.any(dim=-1, keepdim=True), p, 0).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def flash_attention_reference(q, k, v, key_mask=None, bias=None, scale=1.0, causal=False,
                              mask_value=NEG_INF) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the K2 kernel, same numerics in one pass: f32
    scores, masked keys at `mask_value`, a row is alive when its max is above
    NEG_INF/2, probabilities rounded to v's dtype before p@v, f32 sums.
    Returns (out (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32)."""
    k, v = _repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    valid = _valid_mask(key_mask, q.shape[0], q.shape[1], k.shape[1], causal, q.device)
    s = torch.where(valid, s, mask_value)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG_INF / 2
    p = torch.where(alive, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / l).to(q.dtype).transpose(1, 2)
    lse = torch.where(alive, m + torch.log(l), NEG_INF)[..., 0]
    return out, lse


def _check_heads_contiguous(name, t, dh):
    kernels.require(t.dim() == 4, f"{name}: want (B, T, H, dh), got {tuple(t.shape)}")
    kernels.require(t.stride(3) == 1 and t.stride(2) == dh,
                    f"{name}: heads and dh must be contiguous, strides {t.stride()}")


def _check_inputs(q, k, v, key_mask, bias, max_dh=MAX_HEAD_DIM):
    """The checks both kernels make on their shared inputs (`max_dh` the
    kernel's widest head); returns (dtype code, bias_batched, bias dtype
    code)."""
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    kernels.require(dh <= max_dh, f"head dim {dh} > {max_dh}")
    kernels.require(H % Hkv == 0, f"query heads {H} not a multiple of kv heads {Hkv}")
    kernels.require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == dh,
                    f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    kernels.require(q.dtype == k.dtype == v.dtype, "q, k and v must share one dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_contiguous(name, t, dh)
    dtype = kernels.dtype_code(q, (torch.float32, torch.bfloat16))
    if key_mask is not None:
        kernels.require(key_mask.dtype == torch.bool and key_mask.shape == (B, Tk)
                        and key_mask.is_contiguous(), "key_mask must be contiguous bool (B, Tk)")
    if bias is None:
        return dtype, 0, dtype
    kernels.require(bias.dim() == 4 and bias.shape[0] in (1, B) and bias.shape[1:] == (H, Tq, Tk)
                    and bias.is_contiguous(), f"bias must be contiguous (1|B, H, Tq, Tk), got {tuple(bias.shape)}")
    return dtype, int(bias.shape[0] == B), kernels.dtype_code(bias, (torch.float32, torch.bfloat16))


def _launch(q, k, v, key_mask, bias, scale, causal, mask_value):
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dtype, bias_batched, bias_dtype = _check_inputs(q, k, v, key_mask, bias)
    out = torch.empty((B, Tq, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = kernels.library()
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_mask.data_ptr() if key_mask is not None else None,
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tk, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        bias_batched, dtype, bias_dtype, float(scale), int(causal), float(mask_value),
        kernels.stream_ptr(q))
    kernels.check("flash_fwd", err)
    kernels.LAUNCHES["flash_fwd"] += 1
    if dh > 128:
        kernels.FORM_LAUNCHES["flash_fwd_dh256"] += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,  # (B, Tq, H, dh)
    k: torch.Tensor,  # (B, Tk, Hkv, dh)
    v: torch.Tensor,  # (B, Tk, Hkv, dh)
    key_mask: Optional[torch.Tensor] = None,  # (B, Tk) bool, True = attend
    bias: Optional[torch.Tensor] = None,  # (1|B, H, Tq, Tk) additive, f32 or bf16
    scale: float = 1.0,
    causal: bool = False,
    mask_value: float = NEG_INF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32)."""
    if kernels.on_cuda(q, k, v, key_mask, bias):
        return _launch(q, k, v, key_mask, bias, scale, causal, mask_value)
    return flash_attention_reference(q, k, v, key_mask, bias, scale, causal, mask_value)


def flash_attention(q, k, v, key_mask=None, bias=None, scale: float = 1.0, causal: bool = False,
                    mask_value: float = NEG_INF):
    """(B, Tq, H, dh) in q's dtype; semantics of `attention_reference` (with
    the default mask_value). Differentiable in q, k, v and bias through K6."""
    return FlashAttention.apply(q, k, v, key_mask, bias, scale, causal, mask_value)


# --------------------------------------------------------------------------- #
# K6: the backward
# --------------------------------------------------------------------------- #
def flash_attention_bwd_reference(q, k, v, out, lse, do, key_mask=None, bias=None, scale=1.0,
                                  causal=False, mask_value=NEG_INF, grads=None):
    """Plain version of the K6 kernels, same numerics: p = exp(s - lse) on
    alive rows (s at `mask_value` on masked keys; 1/Tk on a row with no
    valid key under mask_value -1e9), gs = p * (dp - D) on valid pairs, p
    and gs rounded to the value dtype before their products, f32 sums. Returns (dq, dk, dv in their inputs' dtypes, dbias f32 shaped
    like bias, or None); dq, dk, dv are copied into `grads` when given."""
    B, Tq, H, dh = q.shape
    Hkv = k.shape[2]
    kr, vr = _repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if bias is not None:
        s = s + bias.float()
    valid = _valid_mask(key_mask, B, Tq, k.shape[1], causal, q.device)
    s = torch.where(valid, s, mask_value)
    lse4 = lse[..., None]
    # a row whose every key carries mask_value (> NEG_INF/2) is uniform; its
    # lse = mask_value + log(Tk) rounds to mask_value in f32, so 1/Tk is explicit
    p = torch.where(lse4 < mask_value / 2, 1.0 / k.shape[1], torch.exp(s - lse4))
    p = torch.where(lse4 > NEG_INF / 2, p, 0.0)
    D = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, Tq, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    gs = torch.where(valid, p * (dp - D), 0.0)
    gs_r = gs.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", gs_r, kr.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", gs_r, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do.float())
    if Hkv != H:  # GQA: a kv head's gradient sums over its group's query heads
        dk = dk.reshape(B, -1, Hkv, H // Hkv, dh).sum(3)
        dv = dv.reshape(B, -1, Hkv, H // Hkv, dh).sum(3)
    dbias = None
    if bias is not None:
        dbias = gs.sum(0, keepdim=True) if bias.shape[0] != B else gs
    dq, dk, dv = dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)
    if grads is not None:
        for dst, src in zip(grads, (dq, dk, dv)):
            dst.copy_(src)
        dq, dk, dv = grads
    return dq, dk, dv, dbias


def _launch_bwd(q, k, v, out, lse, do, key_mask, bias, scale, causal, mask_value, grads):
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dtype, bias_batched, bias_dtype = _check_inputs(q, k, v, key_mask, bias, MAX_BWD_HEAD_DIM)
    kernels.require(out.dtype == do.dtype == q.dtype and out.shape == do.shape == q.shape
                    and out.is_contiguous() and do.is_contiguous(), "out and do must be contiguous and like q")
    kernels.require(lse.shape == (B, H, Tq) and lse.dtype == torch.float32 and lse.is_contiguous(),
                    "lse must be contiguous f32 (B, H, Tq)")
    dq, dk, dv = grads if grads is not None else (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    for name, t, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        _check_heads_contiguous(name, t, dh)
        kernels.require(t.shape == like.shape and t.dtype == like.dtype, f"{name} does not fit its input")
    dbias = scratch = None
    if bias is not None:
        dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
        if not bias_batched and q.dtype == torch.float32:  # the SIMT kernels' per-batch rows, then a batch sum
            scratch = torch.empty((B, H, Tq, Tk), dtype=torch.float32, device=q.device)
    dd = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = kernels.library().flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        ptr(key_mask), ptr(bias), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(dbias), ptr(scratch),
        dd.data_ptr(), B, H, Hkv, Tq, Tk, dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1), dv.stride(0), dv.stride(1),
        bias_batched, dtype, bias_dtype, float(scale), int(causal), float(mask_value), kernels.stream_ptr(q))
    kernels.check("flash_bwd", err)
    kernels.LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv, dbias


def flash_attention_bwd(q, k, v, out, lse, do, key_mask=None, bias=None, scale: float = 1.0,
                        causal: bool = False, mask_value: float = NEG_INF, grads=None):
    """K6: (dq, dk, dv, dbias) for `flash_attention_fwd`'s (out, lse) and
    the output cotangent `do`. dbias is f32, (1, H, Tq, Tk) summed over the
    batch for a shared bias, (B, H, Tq, Tk) for a per-batch one, None
    without a bias. `grads`, when given, is a (dq, dk, dv) triple of tensors
    to write and return, shaped like q, k and v (on CUDA: heads and dh
    contiguous, any batch and token strides)."""
    if kernels.on_cuda(q, k, v, out, lse, do, key_mask, bias):
        return _launch_bwd(q, k, v, out.contiguous(), lse, do.contiguous(), key_mask, bias, scale, causal, mask_value,
                           grads)
    return flash_attention_bwd_reference(q, k, v, out, lse, do, key_mask, bias, scale, causal, mask_value, grads)


class FlashAttention(torch.autograd.Function):
    """K2 forward, K6 backward (the JAX `_flash_core` custom VJP). Saves
    only q, k, v, the output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bias, scale, causal, mask_value):
        out, lse = flash_attention_fwd(q, k, v, key_mask, bias, scale, causal, mask_value)
        ctx.save_for_backward(q, k, v, out, lse, key_mask, bias)
        ctx.args = (scale, causal, mask_value)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_mask, bias = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, out, lse, dout, key_mask, bias, *ctx.args)
        dbias = dbias.to(bias.dtype) if ctx.needs_input_grad[4] else None
        return dq, dk, dv, None, dbias, None, None, None
