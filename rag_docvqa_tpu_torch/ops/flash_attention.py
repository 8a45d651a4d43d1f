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

On a CUDA tensor the wrapper launches csrc/flash_fwd.cu; on CPU tensors it
runs `flash_attention_reference`, the kernel's plain version. The backward
(K6) waits for the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_docvqa_tpu_torch import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 128


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


def _launch(q, k, v, key_mask, bias, scale, causal, mask_value):
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    kernels.require(dh <= MAX_HEAD_DIM, f"head dim {dh} > {MAX_HEAD_DIM}")
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
    bias_batched, bias_dtype = 0, dtype
    if bias is not None:
        kernels.require(bias.dim() == 4 and bias.shape[0] in (1, B) and bias.shape[1:] == (H, Tq, Tk)
                        and bias.is_contiguous(), f"bias must be contiguous (1|B, H, Tq, Tk), got {tuple(bias.shape)}")
        bias_batched = int(bias.shape[0] == B and B > 1)
        bias_dtype = kernels.dtype_code(bias, (torch.float32, torch.bfloat16))
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


def flash_attention(q, k, v, key_mask=None, bias=None, scale: float = 1.0, causal: bool = False):
    """(B, Tq, H, dh) in q's dtype; semantics of `attention_reference`."""
    return flash_attention_fwd(q, k, v, key_mask, bias, scale, causal)[0]
