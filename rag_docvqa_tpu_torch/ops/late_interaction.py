"""ColBERT-style late-interaction (MaxSim) scoring (K15).

Counterpart of `rag_docvqa_tpu/ops/late_interaction.py`: L2-normalise the
query and patch token embeddings in f32 as x / (|x| + 1e-12), take each
query token's largest cosine over the valid tokens of a patch set, and sum
over the query tokens. The JAX package has a batched jnp function with both
masks (`late_interaction`, what its engine calls) and a Pallas kernel for
one query (`late_interaction_pallas`); the port keeps one function,
`late_interaction`, which on CUDA tensors launches csrc/maxsim.cu for both
forms and on CPU tensors runs `late_interaction_reference`. Like the TPU
kernel, the CUDA kernel never writes the (B, N, Tq, Tp) similarities to
device memory.

Masks: a masked patch token never wins the max; a patch set with no valid
token scores 0; the query mask multiplies each query token's maximum (a
float mask is a weight, as in the JAX function).
"""

from __future__ import annotations

from typing import Optional

import torch

from rag_docvqa_tpu_torch import kernels


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def late_interaction_reference(query: torch.Tensor, patches: torch.Tensor,
                               query_mask: Optional[torch.Tensor] = None,
                               patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K15: query (Tq, D) or (B, Tq, D), patches (N, Tp, D)
    or (B, N, Tp, D), query_mask (..., Tq), patch_mask (..., N, Tp) ->
    (N,) or (B, N) f32."""
    q = _normalize(query.float())
    p = _normalize(patches.float())
    sims = torch.einsum("...qd,...ntd->...nqt", q, p)
    if patch_mask is not None:
        sims = torch.where(patch_mask.to(torch.bool)[..., None, :], sims, float("-inf"))
    max_sim = sims.amax(dim=-1)  # (..., N, Tq)
    max_sim = torch.where(torch.isfinite(max_sim), max_sim, 0.0)  # patch sets with no valid token
    if query_mask is not None:
        max_sim = max_sim * query_mask.to(max_sim.dtype)[..., None, :]
    return max_sim.sum(dim=-1)


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
    q, p = q.contiguous(), p.contiguous()
    B, Tq, D = q.shape
    N, Tp = p.shape[1], p.shape[2]
    kernels.require(p.shape == (B, N, Tp, D), f"late_interaction: patches {tuple(patches.shape)} for query "
                                             f"{tuple(query.shape)}")
    qw = pm = None
    if query_mask is not None:
        qw = query_mask.to(torch.float32).reshape(B, Tq).contiguous()
    if patch_mask is not None:
        pm = (patch_mask != 0).reshape(B, N, Tp).contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    strips = -(-Tq // 64)  # the kernel cuts the query tokens into strips of 64 and adds their sums in order
    part = torch.empty((B, N, strips), dtype=torch.float32, device=q.device) if strips > 1 else None
    err = kernels.library().maxsim(q.data_ptr(), p.data_ptr(), qw.data_ptr() if qw is not None else None,
                                   pm.data_ptr() if pm is not None else None, out.data_ptr(),
                                   part.data_ptr() if part is not None else None, B, N, Tq, Tp, D,
                                   kernels.stream_ptr(q))
    kernels.check("maxsim", err)
    kernels.LAUNCHES["maxsim"] += 1
    return out[0] if single else out
