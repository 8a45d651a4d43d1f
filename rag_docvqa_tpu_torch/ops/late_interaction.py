"""ColBERT-style late-interaction (MaxSim) scoring (K15).

Counterpart of `rag_docvqa_tpu/ops/late_interaction.py`: L2-normalise the
query and patch token embeddings in f32 as x / (|x| + 1e-12), take each
query token's largest cosine over the valid tokens of a patch set, and sum
over the query tokens. The JAX package has a batched jnp function with both
masks (`late_interaction`, what its engine calls) and a Pallas kernel for
one query (`late_interaction_pallas`); the port keeps one function,
`late_interaction`, for both forms. It normalises in f32 outside the kernel,
as the TPU kernel takes pre-normalised rows, and hands the rows to `maxsim`,
which on CUDA tensors launches csrc/maxsim.cu and on CPU tensors runs
`maxsim_reference`. Like the TPU kernel, the CUDA kernel never writes the
(B, N, Tq, Tp) similarities to device memory. It scores on the tensor cores
with six exact bf16 products of each f32 pair (the query tokens as their
three bf16 terms, `ops/topk.py::split_bf16x3`, made here; the patch rows
split in registers), so its scores are the f32 products' up to the order of
the sums.

Masks: a masked patch token never wins the max; a patch set with no valid
token scores 0; the query mask multiplies each query token's maximum (a
float mask is a weight, as in the JAX function).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops.topk import _QUERY_TILES, split_bf16x3

_D_MULT = 16  # csrc/maxsim.cu takes D % 16 == 0 (its 16-deep products); the wrapper zero-pads D to it


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def maxsim_reference(q: torch.Tensor, p: torch.Tensor, query_weight: Optional[torch.Tensor] = None,
                     patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K15 on rows already normalised: q (Tq, D) or
    (B, Tq, D), p (N, Tp, D) or (B, N, Tp, D), query_weight (..., Tq),
    patch_mask (..., N, Tp) -> (N,) or (B, N) f32."""
    sims = torch.einsum("...qd,...ntd->...nqt", q, p)
    if patch_mask is not None:
        sims = torch.where(patch_mask.to(torch.bool)[..., None, :], sims, float("-inf"))
    max_sim = sims.amax(dim=-1)  # (..., N, Tq)
    max_sim = torch.where(torch.isfinite(max_sim), max_sim, 0.0)  # patch sets with no valid token
    if query_weight is not None:
        max_sim = max_sim * query_weight.to(max_sim.dtype)[..., None, :]
    return max_sim.sum(dim=-1)


def late_interaction_reference(query: torch.Tensor, patches: torch.Tensor,
                               query_mask: Optional[torch.Tensor] = None,
                               patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `late_interaction`: query (Tq, D) or (B, Tq, D),
    patches (N, Tp, D) or (B, N, Tp, D), query_mask (..., Tq), patch_mask
    (..., N, Tp) -> (N,) or (B, N) f32."""
    return maxsim_reference(_normalize(query.float()), _normalize(patches.float()), query_mask, patch_mask)


def maxsim_launch(q: torch.Tensor, p: torch.Tensor, query_weight: Optional[torch.Tensor] = None,
                  patch_mask: Optional[torch.Tensor] = None) -> Tuple[Callable[[], None], torch.Tensor]:
    """What `maxsim` hands csrc/maxsim.cu for normalised f32 rows q (B, Tq, D)
    and p (B, N, Tp, D): D zero-padded to a multiple of 16 where it is not
    (zeros add nothing to a product), the query tokens' three bf16 terms as
    (3, B * Tq, D), the query weights as f32 and the patch mask as bytes, and
    the query tile: the narrowest of `_QUERY_TILES` that holds Tq, else the
    widest, whose strips the C entry point sums in order. Returns (launch,
    out): `launch()` runs the kernel into `out` (B, N) and counts nothing."""
    kernels.require(q.dim() == 3 and p.dim() == 4 and q.dtype == p.dtype == torch.float32,
                    f"maxsim: q (B, Tq, D) and p (B, N, Tp, D) f32, got {q.dtype} {tuple(q.shape)} and "
                    f"{p.dtype} {tuple(p.shape)}")
    B, Tq, D = q.shape
    N, Tp = p.shape[1], p.shape[2]
    kernels.require(p.shape == (B, N, Tp, D), f"maxsim: patches {tuple(p.shape)} for query {tuple(q.shape)}")
    pad = -D % _D_MULT
    if pad:
        q, p = F.pad(q, (0, pad)), F.pad(p, (0, pad))
    qt = split_bf16x3(q.reshape(B * Tq, D + pad))
    p = p.contiguous()
    kernels.require(p.data_ptr() % 16 == 0, "maxsim: the patch rows must be 16-byte aligned (the kernel copies them "
                                            "16 bytes at a time)")
    qw = None if query_weight is None else query_weight.to(torch.float32).reshape(B, Tq).contiguous()
    pm = None if patch_mask is None else (patch_mask != 0).reshape(B, N, Tp).contiguous()
    tq = min((t for t in _QUERY_TILES if t >= Tq), default=max(_QUERY_TILES))
    strips = -(-Tq // tq)
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    part = torch.empty((B, N, strips), dtype=torch.float32, device=q.device) if strips > 1 else None

    def launch() -> None:
        kernels.check("maxsim", kernels.library().maxsim(
            qt.data_ptr(), p.data_ptr(), _ptr(qw), _ptr(pm), out.data_ptr(), _ptr(part), B, N, Tq, Tp, D + pad, tq,
            kernels.stream_ptr(q)))

    return launch, out


def maxsim(q: torch.Tensor, p: torch.Tensor, query_weight: Optional[torch.Tensor] = None,
           patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15 on rows already normalised, batched: q (B, Tq, D), p (B, N, Tp, D)
    f32, query_weight (B, Tq), patch_mask (B, N, Tp) -> (B, N) f32. The kernel
    on CUDA tensors, `maxsim_reference` on CPU tensors."""
    if not kernels.on_cuda(q, p, query_weight, patch_mask):
        return maxsim_reference(q, p, query_weight, patch_mask)
    launch, out = maxsim_launch(q, p, query_weight, patch_mask)
    launch()
    kernels.LAUNCHES["maxsim"] += 1
    return out


def late_interaction(query: torch.Tensor, patches: torch.Tensor, query_mask: Optional[torch.Tensor] = None,
                     patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MaxSim scores over the patch axis: (N,) for one query (Tq, D) against
    (N, Tp, D), (B, N) for the batched form. The normalisation runs outside
    the kernel, in f32."""
    if not kernels.on_cuda(query, patches, query_mask, patch_mask):
        return late_interaction_reference(query, patches, query_mask, patch_mask)
    single = query.dim() == 2
    kernels.require(patches.dim() == query.dim() + 1 and query.dim() in (2, 3),
                    f"late_interaction: query {tuple(query.shape)} and patches {tuple(patches.shape)} do not fit")
    q = _normalize(query.float())
    p = _normalize(patches.float())
    if single:
        q, p = q[None], p[None]
    out = maxsim(q, p, query_mask, patch_mask)
    return out[0] if single else out
