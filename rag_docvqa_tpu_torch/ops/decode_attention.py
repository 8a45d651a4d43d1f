"""Single-query cross-attention over a packed decode cache (K3).

Counterpart of `rag_docvqa_tpu/ops/decode_attention.py` (`pack_decode_kv`,
`fused_cross_attention`). The cache is packed once at build time into
K2 (B, H*dk, Te) and V2 (B, Te, H*dk), stored int8, bf16 or f32. The
channel scales of an int8 cache (the k-scale on the query, the v-scale on the
output) and the output's cast happen inside the kernel, where JAX applies
them around its kernel. On a CUDA tensor the wrapper launches
csrc/decode_attention.cu (split over the cache: one or two kernels a call),
whose f32 math is JAX's `exact=True` mode; on CPU tensors it runs
`cross_attention_reference`.
"""

from __future__ import annotations

import functools
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


def cross_attention_reference(q: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, mask: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernel: q (B, H, dk), packed K2/V2, mask (B, Te),
    optional (B, H, dk) channel scales -> (B, H*dk) in `out_dtype`; f32 math
    on the stored values, cast at the end."""
    B, H, dk = q.shape
    Te = k2.shape[2]
    qs = q.float()
    if k_scale is not None:
        qs = qs * k_scale.float()
    k = k2.float().view(B, H, dk, Te)
    v = v2.float().view(B, Te, H, dk)
    s = torch.einsum("bhd,bhdt->bht", qs, k)
    p = torch.softmax(torch.where(mask[:, None, :], s, MASKED), dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, v)
    if v_scale is not None:
        out = out * v_scale.float()
    return out.reshape(B, H * dk).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_len(B: int, H: int, Te: int, itemsize: int, sms: int = 132) -> int:
    """Keys a block of the kernel takes: 512 bytes of each K2 row where those
    blocks make one to three an SM (a 512-byte block takes 66 KB of shared
    memory at dk 64: three are resident; the B 32 Te 512 int8 cache then needs
    no second kernel to merge splits), else 256 bytes, or 128 where 256 would
    give fewer than two blocks an SM."""
    blocks = lambda nbytes: B * H * -(-Te // (nbytes // itemsize))
    if sms <= blocks(512) <= 3 * sms:
        return 512 // itemsize
    return 256 // itemsize if blocks(256) >= 2 * sms else 128 // itemsize


def _launch(q, k2, v2, mask, k_scale, v_scale, out_dtype, split):
    B, H, dk = q.shape
    Te = k2.shape[2]
    kernels.require(dk <= 128, f"decode attention takes dk <= 128, got {dk}")
    kernels.require(k2.shape == (B, H * dk, Te) and v2.shape == (B, Te, H * dk),
                    f"k2 {tuple(k2.shape)} / v2 {tuple(v2.shape)} do not fit q (B={B}, H={H}, dk={dk})")
    kernels.require(k2.dtype == v2.dtype, "k2 and v2 must share one dtype")
    kernels.require(k2.is_contiguous() and v2.is_contiguous(), "k2 and v2 must be contiguous")
    kernels.require(mask.dtype == torch.bool and mask.shape == (B, Te), "mask must be bool (B, Te)")
    for scale in (k_scale, v_scale):
        kernels.require(scale is None or (scale.dtype == torch.float32 and scale.shape == (B, H, dk)),
                        "channel scales must be f32 (B, H, dk)")
    kernels.require(split * k2.element_size() in (128, 256, 512),
                    f"a split of {split} keys is not 128, 256 or 512 bytes of K2")
    q, mask = q.contiguous(), mask.contiguous()
    k_scale, v_scale = (None if t is None else t.contiguous() for t in (k_scale, v_scale))
    kv_dtype = kernels.dtype_code(k2, (torch.float32, torch.bfloat16, torch.int8))
    q_dtype = kernels.dtype_code(q, (torch.float32, torch.bfloat16))
    kernels.require(out_dtype in (torch.float32, torch.bfloat16), f"output f32 or bf16, got {out_dtype}")
    splits = -(-Te // split)
    ws = torch.empty(B * H * splits * (dk + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    out = torch.empty((B, H * dk), dtype=out_dtype, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = kernels.library().decode_cross_attention(
        q.data_ptr(), ptr(k_scale), k2.data_ptr(), v2.data_ptr(), mask.data_ptr(), ptr(v_scale), out.data_ptr(),
        ptr(ws), B, H, dk, Te, kv_dtype, q_dtype, kernels.DTYPE_CODES[out_dtype], split, kernels.stream_ptr(q))
    kernels.check("decode_cross_attention", err)
    kernels.LAUNCHES["decode_cross_attention"] += 1
    return out


def fused_cross_attention(
    q: torch.Tensor,  # (B, H, dk) query at one decode position, f32 or bf16
    k2: torch.Tensor,  # (B, H*dk, Te) int8 | bf16 | f32
    v2: torch.Tensor,  # (B, Te, H*dk)
    mask: torch.Tensor,  # (B, Te) bool, True = attend
    k_scale: Optional[torch.Tensor] = None,  # (B, H, dk) f32 channel scales (int8)
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Returns (B, H*dk) in `out_dtype` (f32 by default, as the JAX function
    returns): `_attend_one` with a key mask, no bias, the scales applied and
    the cast made inside the kernel."""
    if not kernels.on_cuda(q, k2, v2, mask, k_scale, v_scale):
        return cross_attention_reference(q, k2, v2, mask, k_scale, v_scale, out_dtype)
    B, H, _ = q.shape
    split = split_len(B, H, k2.shape[2], k2.element_size(), _sm_count(q.device))
    return _launch(q, k2, v2, mask, k_scale, v_scale, out_dtype, split)
