"""Single-query cross-attention over a packed decode cache (K3).

Counterpart of `rag_docvqa_tpu/ops/decode_attention.py` (`pack_decode_kv`,
`fused_cross_attention`). The cache is packed once at build time into
K2 (B, H*dk, Te) and V2 (B, Te, H*dk), stored int8, bf16 or f32. Channel
scales of an int8 cache fold outside the kernel: the k-scale into the query,
the v-scale into the output. On a CUDA tensor the wrapper launches
csrc/decode_attention.cu, whose f32 math is JAX's `exact=True` mode; on CPU
tensors it runs `cross_attention_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_docvqa_tpu_torch import kernels

MASKED = -1e9


def pack_decode_kv(k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Te, dk) K/V -> K2 (B, H*dk, Te), V2 (B, Te, H*dk), contiguous."""
    B, H, Te, dk = k.shape
    k2 = k.transpose(2, 3).reshape(B, H * dk, Te)
    v2 = v.transpose(1, 2).reshape(B, Te, H * dk)
    return k2.contiguous(), v2.contiguous()


def cross_attention_reference(qs: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: qs (B, H, dk) f32 (already times the
    k-scale), packed K2/V2, mask (B, Te) -> (B, H*dk) f32, before the v-scale."""
    B, H, dk = qs.shape
    Te = k2.shape[2]
    k = k2.float().view(B, H, dk, Te)
    v = v2.float().view(B, Te, H, dk)
    s = torch.einsum("bhd,bhdt->bht", qs, k)
    p = torch.softmax(torch.where(mask[:, None, :], s, MASKED), dim=-1)
    return torch.einsum("bht,bthd->bhd", p, v).reshape(B, H * dk)


def _launch(qs, k2, v2, mask):
    B, H, dk = qs.shape
    Te = k2.shape[2]
    kernels.require(dk <= 128, f"decode attention takes dk <= 128, got {dk}")
    kernels.require(k2.shape == (B, H * dk, Te) and v2.shape == (B, Te, H * dk),
                    f"k2 {tuple(k2.shape)} / v2 {tuple(v2.shape)} do not fit q (B={B}, H={H}, dk={dk})")
    kernels.require(k2.dtype == v2.dtype, "k2 and v2 must share one dtype")
    kernels.require(k2.is_contiguous() and v2.is_contiguous(), "k2 and v2 must be contiguous")
    kernels.require(mask.dtype == torch.bool and mask.shape == (B, Te), "mask must be bool (B, Te)")
    kv_dtype = kernels.dtype_code(k2, (torch.float32, torch.bfloat16, torch.int8))
    qs, mask = qs.contiguous(), mask.contiguous()
    out = torch.empty((B, H * dk), dtype=torch.float32, device=qs.device)
    err = kernels.library().decode_cross_attention(
        qs.data_ptr(), k2.data_ptr(), v2.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, H, dk, Te, kv_dtype, kernels.stream_ptr(qs))
    kernels.check("decode_cross_attention", err)
    kernels.LAUNCHES["decode_cross_attention"] += 1
    return out


def fused_cross_attention(
    q: torch.Tensor,  # (B, H, dk) query at one decode position
    k2: torch.Tensor,  # (B, H*dk, Te) int8 | bf16 | f32
    v2: torch.Tensor,  # (B, Te, H*dk)
    mask: torch.Tensor,  # (B, Te) bool, True = attend
    k_scale: Optional[torch.Tensor] = None,  # (B, H, dk) channel scales (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (B, H*dk) f32: `_attend_one` with a key mask, no bias."""
    B, H, dk = q.shape
    qs = q.float()
    if k_scale is not None:
        qs = qs * k_scale.float()
    if kernels.on_cuda(qs, k2, v2, mask):
        out = _launch(qs, k2, v2, mask)
    else:
        out = cross_attention_reference(qs, k2, v2, mask)
    if v_scale is not None:
        out = (out.view(B, H, dk) * v_scale.float()).reshape(B, H * dk)
    return out
