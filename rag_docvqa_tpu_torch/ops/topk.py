"""Similarity scoring + top-k selection over a resident embedding index.

Counterpart of `rag_docvqa_tpu/ops/topk.py`. Scores are cosine
similarities; the index is pre-normalized once at build time, the queries
are normalized here and stay f32 whatever the index's dtype.

  * `masked_topk`, `l2_normalize`  -- as there;
  * `cosine_topk_flat`     -- JAX `cosine_topk_xla`: one matmul + masked
                              top-k over the whole (B, N) score matrix;
  * `cosine_topk_fused`    -- JAX `cosine_topk_pallas` (kernel K4): scoring
                              and a running top-k in one pass, the score
                              matrix never in device memory;
  * `cosine_topk_twophase` -- as there (kernel K5 + phases 2 and 3): segment
                              maxima, selection of k segments, exact re-score;
  * `cosine_topk_auto`, `pad_index` -- as there.

On CUDA tensors the two kernel wrappers (`fused_topk`, `segment_max`)
launch csrc/topk_fused.cu and csrc/topk_segmax.cu; on CPU tensors they run
the plain versions beside them (`fused_topk_reference`,
`segment_max_reference`). Phases 2 and 3 are torch ops on both.

Tie order: `lax.top_k` breaks ties to the lowest index; `torch.topk`
promises no order. Here the scores are sorted descending with a stable sort,
which keeps equal scores in ascending index order, and the first k are taken.
Indices come back int32 from the `cosine_topk_*` functions, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rag_docvqa_tpu_torch import kernels

NEG_INF = -1e30

# B <= this: the running-merge kernel (K4); above it the two-phase kernels.
# This is the JAX package's value, chosen there from TPU times; it has not
# been chosen on this card (PERF.md has both sides' times at B 8 and B 256).
KERNEL_BATCH_CROSSOVER = 16

_KERNEL_TILE = 128  # index rows per block tile in csrc/topk_common.cuh
_FUSED_MAX_K = 64


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """The reference's eps placement: x / (||x|| + eps) (not F.normalize's
    x / max(||x||, eps))."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def masked_topk(
    scores: torch.Tensor,  # (..., N) float
    mask: Optional[torch.Tensor],  # (..., N) bool, True = valid
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k over the last axis ignoring masked entries; ties go to the
    lowest index. Returns (values, indices, valid)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return vals, idx, vals > NEG_INF / 2


def _valid_rows(n: int, n_valid, device) -> torch.Tensor:
    return torch.arange(n, device=device) < n_valid


def cosine_topk_flat(
    index: torch.Tensor,  # (N, D) pre-normalized
    queries: torch.Tensor,  # (B, D) unnormalized
    k: int,
    index_mask: Optional[torch.Tensor] = None,  # (N,) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX `cosine_topk_xla`: one matmul + masked top-k."""
    q = l2_normalize(queries.float())
    scores = q @ index.float().t()  # (B, N)
    mask = None if index_mask is None else index_mask[None, :].expand_as(scores)
    vals, idx, valid = masked_topk(scores, mask, k)
    return vals, idx.to(torch.int32), valid


# --------------------------------------------------------------------------- #
# K4: fused scoring + running top-k
# --------------------------------------------------------------------------- #
def fused_topk_reference(index: torch.Tensor, q: torch.Tensor, n_valid: int, k: int):
    """Plain version of K4: q (B, D) f32 unit rows -> (vals (B, k) f32,
    idx (B, k) i32); slots without a valid row hold (NEG_INF, 0)."""
    scores = q @ index.float().t()
    vals, idx, valid = masked_topk(scores, _valid_rows(index.shape[0], n_valid, index.device)[None, :], k)
    return vals, torch.where(valid, idx, 0).to(torch.int32)


def fused_topk(index: torch.Tensor, q: torch.Tensor, n_valid: int, k: int):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if not kernels.on_cuda(index, q):
        return fused_topk_reference(index, q, n_valid, k)
    N, D = index.shape
    B = q.shape[0]
    kernels.require(q.dtype == torch.float32 and q.shape == (B, D), f"q must be f32 (B, {D}), got {tuple(q.shape)}")
    kernels.require(D % 16 == 0, f"the top-k kernels take D % 16 == 0, got {D}")
    kernels.require(1 <= k <= _FUSED_MAX_K, f"the fused top-k kernel takes 1 <= k <= {_FUSED_MAX_K}, got {k}")
    kernels.require(0 <= n_valid <= N, f"n_valid {n_valid} outside [0, {N}]")
    kernels.require(index.is_contiguous(), "index must be contiguous")
    code = kernels.dtype_code(index, (torch.float32, torch.bfloat16))
    q = q.contiguous()
    # enough row blocks to fill the card about four times over, each a
    # contiguous run of tiles
    n_tiles = -(-N // _KERNEL_TILE)
    n_qb = -(-B // (16 if B <= 16 else 64))
    tiles_per_block = max(1, n_tiles * n_qb // 528)
    n_rb = -(-n_tiles // tiles_per_block)
    cand_v = torch.empty((n_rb, B, k), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((n_rb, B, k), dtype=torch.int32, device=q.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=q.device)
    err = kernels.library().topk_fused(
        index.data_ptr(), q.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        N, D, B, n_valid, k, tiles_per_block, code, kernels.stream_ptr(q))
    kernels.check("topk_fused", err)
    kernels.LAUNCHES["topk_fused"] += 1
    return vals, idx


def cosine_topk_fused(
    index: torch.Tensor,  # (N, D) pre-normalized, N % tile_n == 0 (pad upstream)
    queries: torch.Tensor,  # (B, D)
    n_valid: int,  # rows >= n_valid are padding
    k: int,
    tile_n: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX `cosine_topk_pallas`: fused scoring + top-k; (values, indices,
    valid) like `masked_topk`."""
    N = index.shape[0]
    kernels.require(N % tile_n == 0, f"pad index length {N} to a multiple of tile_n={tile_n}")
    q = l2_normalize(queries.float())
    vals, idx = fused_topk(index, q, int(n_valid), k)
    return vals, idx, vals > NEG_INF / 2


# --------------------------------------------------------------------------- #
# K5: segment maxima, and the exact two-phase top-k built on them
# --------------------------------------------------------------------------- #
def group_max(scores: torch.Tensor, group: int) -> torch.Tensor:
    """(B, N) -> (B, N/group): maxima of consecutive runs of `group`."""
    B, N = scores.shape
    return scores.view(B, N // group, group).amax(dim=2)


def segment_max_reference(index: torch.Tensor, q: torch.Tensor, n_valid: int, group: int, sgroups: int = 1):
    """Plain version of K5: q (B, D) f32 unit rows -> (segmax (B, N/group),
    supermax (B, N/(group*sgroups)) or None), rows >= n_valid at NEG_INF."""
    scores = q @ index.float().t()
    scores = torch.where(_valid_rows(index.shape[0], n_valid, index.device)[None, :], scores,
                         torch.full_like(scores, NEG_INF))
    segmax = group_max(scores, group)
    return segmax, (group_max(segmax, sgroups) if sgroups > 1 else None)


def require_segmax_shapes(N: int, D: int, d_mult: int, n_valid: int, group: int) -> None:
    """What csrc/topk_segmax.cu takes (shared by K5, K11 and K12)."""
    kernels.require(D % d_mult == 0, f"this top-k kernel takes D % {d_mult} == 0, got {D}")
    kernels.require(group >= 1 and _KERNEL_TILE % group == 0 and N % group == 0,
                    f"group must divide {_KERNEL_TILE} and N={N}, got {group}")
    kernels.require(0 <= n_valid <= N, f"n_valid {n_valid} outside [0, {N}]")


def segment_max(index: torch.Tensor, q: torch.Tensor, n_valid: int, group: int, sgroups: int = 1):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if not kernels.on_cuda(index, q):
        return segment_max_reference(index, q, n_valid, group, sgroups)
    N, D = index.shape
    B = q.shape[0]
    kernels.require(q.dtype == torch.float32 and q.shape == (B, D), f"q must be f32 (B, {D}), got {tuple(q.shape)}")
    require_segmax_shapes(N, D, 16, n_valid, group)
    kernels.require(sgroups >= 1 and (N // group) % sgroups == 0, f"sgroups {sgroups} must divide N/group")
    kernels.require(index.is_contiguous(), "index must be contiguous")
    code = kernels.dtype_code(index, (torch.float32, torch.bfloat16))
    q = q.contiguous()
    S = N // group
    segmax = torch.empty((B, S), dtype=torch.float32, device=q.device)
    supermax = torch.empty((B, S // sgroups), dtype=torch.float32, device=q.device) if sgroups > 1 else None
    err = kernels.library().topk_segmax(
        index.data_ptr(), q.data_ptr(), segmax.data_ptr(), None if supermax is None else supermax.data_ptr(),
        N, D, B, n_valid, group, sgroups, code, kernels.stream_ptr(q))
    kernels.check("topk_segmax", err)
    kernels.LAUNCHES["topk_segmax"] += 1
    return segmax, supermax


def topk_lowest(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int64) of the k largest along the last axis, ties to the
    lowest index, in ascending index order (the order phase 3 needs)."""
    return torch.sort(masked_topk(scores, None, k)[1], dim=-1)[0]


def select_segments(segmax: torch.Tensor, supermax: Optional[torch.Tensor], k: int, sgroups: int) -> torch.Tensor:
    """Phase 2: the k winning segments per query, ascending (B, k) int64.
    With `supermax`, first k supergroups, then the k best of their k*sgroups
    segments; exact at both levels by the covering argument of the JAX
    docstring, ties to the lowest index at both."""
    if supermax is None:
        return topk_lowest(segmax, k)
    B = segmax.shape[0]
    sup_idx = topk_lowest(supermax, k)  # (B, k) ascending
    g_flat = (sup_idx[:, :, None] * sgroups + torch.arange(sgroups, device=segmax.device)).reshape(B, k * sgroups)
    pos2 = topk_lowest(torch.gather(segmax, 1, g_flat), k)
    return torch.gather(g_flat, 1, pos2)  # g_flat ascends, so this does too


def segment_candidates(seg_idx: torch.Tensor, group: int) -> torch.Tensor:
    """(B, k) segments -> (B, k*group) row indices, ascending."""
    B, k = seg_idx.shape
    return (seg_idx[:, :, None] * group + torch.arange(group, device=seg_idx.device)).reshape(B, k * group)


def final_topk(flat_idx: torch.Tensor, cand_scores: torch.Tensor, n_valid: int, k: int):
    """Phase 3's end: mask the padding rows, top-k over the candidates."""
    flat = torch.where(flat_idx < n_valid, cand_scores, torch.full_like(cand_scores, NEG_INF))
    vals, pos, valid = masked_topk(flat, None, k)
    return vals, torch.gather(flat_idx, 1, pos).to(torch.int32), valid


def cosine_topk_twophase(
    index: torch.Tensor,  # (N, D) pre-normalized, N % tile_n == 0
    queries: torch.Tensor,  # (B, D)
    n_valid: int,
    k: int,
    tile_n: int = 2048,
    group: int = 8,
    sgroups: int = 16,  # groups per supergroup (1 disables the hierarchy)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k via (hierarchical) segment-max pre-selection, as the JAX
    function of the same name.

    Phase 1 (K5): scores reduced to per-`group` maxima and per-supergroup
    maxima. Phase 2: k supergroups, then k segments (`select_segments`).
    Phase 3: exact re-score of the k*group surviving rows, final top-k.
    `tile_n` keeps the JAX meaning for the padding rule and the hierarchy
    rule; the CUDA kernel's own tile is fixed.

    Phase 3 accumulates in another order than phase 1 and than the flat
    matmul, so on the card adjacent ranks whose scores differ by less than
    f32 rounding (~1e-6) may swap against `cosine_topk_flat`; the selected
    set is the same. On the CPU the results are identical.
    """
    N, D = index.shape
    B = queries.shape[0]
    n_valid = int(n_valid)
    kernels.require(N % tile_n == 0 and tile_n % group == 0, f"N={N} % tile_n={tile_n} and tile_n % group={group}")
    if k * group >= N:  # tiny index: selection saves nothing
        return cosine_topk_flat(index, queries, k, index_mask=_valid_rows(N, n_valid, index.device))
    S2 = N // (group * sgroups)
    # the JAX rule, Mosaic's block constraint included, so that both packages
    # take the same route on the same arguments
    hier = (sgroups > 1 and tile_n % (group * sgroups) == 0
            and (tile_n // (group * sgroups)) % 8 == 0 and S2 > 2 * k)

    q = l2_normalize(queries.float())
    segmax, supermax = segment_max(index, q, n_valid, group, sgroups if hier else 1)
    flat_idx = segment_candidates(select_segments(segmax, supermax, k, sgroups), group)  # (B, k*G)
    cand_vecs = index[flat_idx]  # (B, k*G, D)
    cand_scores = torch.einsum("bnd,bd->bn", cand_vecs.float(), q)
    return final_topk(flat_idx, cand_scores, n_valid, k)


def cosine_topk_auto(
    index: torch.Tensor,  # (N, D) pre-normalized, padded to tile_n
    queries: torch.Tensor,  # (B, D)
    n_valid: int,
    k: int,
    tile_n: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the implementation by device and batch size. CPU tensors: the
    flat version (the JAX rule "not on a TPU"). CUDA tensors: K4 up to
    `KERNEL_BATCH_CROSSOVER` queries, the two-phase kernel above; an index
    that is not padded to `tile_n` raises there (pad with `pad_index`)."""
    N = index.shape[0]
    if not kernels.on_cuda(index, queries):
        return cosine_topk_flat(index, queries, k, index_mask=_valid_rows(N, n_valid, index.device))
    if queries.shape[0] <= KERNEL_BATCH_CROSSOVER:
        return cosine_topk_fused(index, queries, n_valid, k, tile_n=tile_n)
    two_tile = max(tile_n, 2048)
    if N % two_tile != 0:
        two_tile = tile_n
    return cosine_topk_twophase(index, queries, n_valid, k, tile_n=two_tile)


def pad_index(embeddings: torch.Tensor, tile_n: int = 512) -> Tuple[torch.Tensor, int]:
    """Pad an (N, D) index to a tile multiple; returns (padded, n_valid)."""
    N = embeddings.shape[0]
    target = -(-N // tile_n) * tile_n
    if target != N:
        pad = torch.zeros((target - N, embeddings.shape[1]), dtype=embeddings.dtype, device=embeddings.device)
        embeddings = torch.cat([embeddings, pad], dim=0)
    return embeddings, N
