"""Int8- and int4-quantized retrieval index.

Counterpart of `rag_docvqa_tpu/ops/quant.py`, function for function.
Symmetric per-row quantization of the pre-normalized chunk embedding
matrix: int8 takes a quarter of f32's device memory, int4 (two nibbles a
byte, element d with element d + D/2) an eighth. Queries quantize to int8
per row at query time. Scores are int8 x int8 -> int32 dots, exact and
order-free, rescaled as `(acc * query_scale) * index_scale` everywhere, so
the flat and the two-phase functions agree bit for bit.

Kernels: `segment_max_int8` (K11) and `segment_max_int4` (K12) launch
csrc/topk_segmax.cu on CUDA tensors and run the plain versions beside them
(`segment_max_int8_reference`, `segment_max_int4_reference`) on CPU
tensors. The flat functions and phase 3 run the integer dots as f32 matrix
products: every partial sum is an integer below 2**24 while
127 * 127 * D < 2**24, so they are exact in any order; `_require_exact`
holds that bound.

The refined int4 tier (`cosine_topk_int4_refined`,
`refined_query_batches`) keeps only the int4 stream on the device, takes the
exact int4 top-k' there and rescores those k' rows per query on the host
against the full-precision rows kept at build time (`_rescore_host`, numpy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops.topk import (
    NEG_INF,
    _valid_rows,
    final_topk,
    group_max,
    l2_normalize,
    masked_topk,
    require_segmax_shapes,
    segment_candidates,
    topk_lowest,
)


def _true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor as an IEEE division. `x / 127.0` with a Python scalar is
    x * (1 / 127.0) in PyTorch, which differs from XLA's division in the
    last bit of one scale in sixteen."""
    return x / torch.full_like(x, divisor)


def _percentile99(x: torch.Tensor) -> torch.Tensor:
    """99th percentile along the last axis with `jnp.percentile`'s linear
    interpolation and its f32 arithmetic for the position and the weights
    (`torch.quantile` takes them in f64 and lands ~5e-6 away)."""
    n = x.shape[-1]
    # XLA folds (99 / 100) * (n - 1) into 99 * ((n - 1) / 100)
    pos = np.float32(99.0) * np.float32(np.float32(n - 1) / np.float32(100.0))
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    high_w = np.float32(pos - np.float32(low))
    low_w = np.float32(np.float32(1.0) - high_w)
    srt = torch.sort(x, dim=-1)[0]
    return srt[..., low:low + 1] * float(low_w) + srt[..., high:high + 1] * float(high_w)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) f32 -> (int8 values, (N, 1) f32 scales); symmetric per-row.
    `torch.round` rounds half to even, as `jnp.round`."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = _true_divide(amax.clamp(min=1e-12), 127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def build_int8_index(embeddings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize + quantize a raw (N, D) embedding matrix."""
    return quantize_rows(l2_normalize(embeddings.float()))


def _require_exact(d: int, amax: int = 127) -> None:
    """The f32 matrix products that stand in for int8 x int8 -> int32 dots
    are exact only while every partial sum stays below 2**24."""
    kernels.require(127 * amax * d < 2 ** 24,
                    f"D={d}: an f32 accumulation of int8 products is exact only for 127*{amax}*D < 2**24")


def _int_dot(q8: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D) int8 -> (B, N) f32 holding the exact int32 dots."""
    return q8.float() @ rows.float().t()


def _mask_rows(scores: torch.Tensor, n_valid: int) -> torch.Tensor:
    valid = _valid_rows(scores.shape[1], n_valid, scores.device)[None, :]
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF))


def _flat_topk(acc: torch.Tensor, qs: torch.Tensor, index_scale: torch.Tensor, n_valid: int, k: int):
    scores = _mask_rows(acc * qs * index_scale[:, 0][None, :], n_valid)
    vals, idx, valid = masked_topk(scores, None, k)
    return vals, idx.to(torch.int32), valid


def cosine_topk_int8(
    index_q: torch.Tensor,  # (N, D) int8
    index_scale: torch.Tensor,  # (N, 1) f32
    queries: torch.Tensor,  # (B, D) f32 unnormalized
    n_valid: int,
    k: int,
):
    """Masked top-k cosine over an int8 index, flat: integer dots + rescale."""
    _require_exact(index_q.shape[1])
    q8, qs = quantize_rows(l2_normalize(queries.float()))
    return _flat_topk(_int_dot(q8, index_q), qs, index_scale, int(n_valid), k)


# --------------------------------------------------------------------------- #
# K11: int8 segment maxima, and the two-phase int8 top-k
# --------------------------------------------------------------------------- #
def segment_max_int8_reference(index_q: torch.Tensor, index_scale: torch.Tensor, q8: torch.Tensor, n_valid: int,
                               group: int) -> torch.Tensor:
    """Plain version of K11: float(int32 dot) * the row's scale, rows >=
    n_valid at NEG_INF, maxima of `group` rows -> (B, N/group). The query's
    own positive scale is applied outside: it cannot reorder a row."""
    _require_exact(index_q.shape[1])
    scores = _int_dot(q8, index_q) * index_scale[:, 0][None, :]
    return group_max(_mask_rows(scores, n_valid), group)


def _launch_segmax_quant(name: str, index: torch.Tensor, index_scale: torch.Tensor, q8: torch.Tensor, n_valid: int,
                         group: int, d_mult: int) -> torch.Tensor:
    N = index.shape[0]
    B, D = q8.shape
    require_segmax_shapes(N, D, d_mult, n_valid, group)
    kernels.require(index.dtype == torch.int8 and q8.dtype == torch.int8, "index and q8 must be int8")
    kernels.require(index_scale.dtype == torch.float32 and index_scale.numel() == N, "index_scale must be f32 (N, 1)")
    kernels.require(index.is_contiguous(), "index must be contiguous")
    q8, index_scale = q8.contiguous(), index_scale.contiguous()
    segmax = torch.empty((B, N // group), dtype=torch.float32, device=q8.device)
    err = getattr(kernels.library(), name)(
        index.data_ptr(), q8.data_ptr(), index_scale.data_ptr(), segmax.data_ptr(), N, D, B, n_valid, group,
        kernels.stream_ptr(q8))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return segmax


def segment_max_int8(index_q, index_scale, q8, n_valid: int, group: int) -> torch.Tensor:
    """K11 on CUDA tensors, its plain version on CPU tensors."""
    if not kernels.on_cuda(index_q, index_scale, q8):
        return segment_max_int8_reference(index_q, index_scale, q8, n_valid, group)
    kernels.require(index_q.shape[1] == q8.shape[1], "index_q and q8 must share D")
    return _launch_segmax_quant("topk_segmax_int8", index_q, index_scale, q8, n_valid, group, 16)


def _rescore_quant(acc: torch.Tensor, qs: torch.Tensor, index_scale: torch.Tensor, flat_idx: torch.Tensor,
                   n_valid: int, k: int):
    """Phase 3's end for the integer indexes: the scales in the flat
    function's order, (acc * qs) * index_scale, so final values and ties
    match it; slots without a valid row keep the raw NEG_INF, not scaled by
    qs (the sharded merge's `> -1e29` validity test depends on it)."""
    cand_scores = (acc * qs) * index_scale[:, 0][flat_idx]
    vals, idx, valid = final_topk(flat_idx, cand_scores, n_valid, k)
    return torch.where(valid, vals, torch.full_like(vals, NEG_INF)), idx, valid


def cosine_topk_int8_twophase(
    index_q: torch.Tensor,  # (N, D) int8, N % tile_n == 0 (pad upstream)
    index_scale: torch.Tensor,  # (N, 1) f32
    queries: torch.Tensor,  # (B, D) f32 unnormalized
    n_valid: int,
    k: int,
    tile_n: int = 2048,
    group: int = 16,
):
    """Exact int8 top-k without the (B, N) matrix: segment maxima (K11),
    the k best segments, integer re-score of their rows. Equal to
    `cosine_topk_int8` bit for bit."""
    N, D = index_q.shape
    n_valid = int(n_valid)
    kernels.require(N % tile_n == 0 and tile_n % group == 0, f"N={N} % tile_n={tile_n} and tile_n % group={group}")
    if k * group >= N:
        return cosine_topk_int8(index_q, index_scale, queries, n_valid, k)
    _require_exact(D)
    q8, qs = quantize_rows(l2_normalize(queries.float()))
    segmax = segment_max_int8(index_q, index_scale, q8, n_valid, group)
    flat_idx = segment_candidates(topk_lowest(segmax, k), group)  # (B, k*G)
    acc = torch.einsum("bnd,bd->bn", index_q[flat_idx].float(), q8.float())
    return _rescore_quant(acc, qs, index_scale, flat_idx, n_valid, k)


def _twophase_tile(n: int, tile_n: int) -> int:
    """The tile the two-phase functions are given on the card: `tile_n`, or
    512 (what `ShardedIndex.build` pads shards to) when `n` is no multiple."""
    for t in (tile_n, 512):
        if n % t == 0:
            return t
    raise ValueError(f"index length {n} is a multiple of neither {tile_n} nor 512: pad it (ops.topk.pad_index)")


def cosine_topk_int8_auto(index_q, index_scale, queries, n_valid, k: int, tile_n: int = 2048):
    """CPU tensors: the flat function (the JAX rule "not on a TPU"). CUDA
    tensors: the two-phase function and its kernel at every batch size (the
    flat one only through the tiny-index rule inside it). Both give the
    same result bit for bit."""
    if not kernels.on_cuda(index_q, index_scale, queries):
        return cosine_topk_int8(index_q, index_scale, queries, n_valid, k)
    return cosine_topk_int8_twophase(index_q, index_scale, queries, n_valid, k,
                                     tile_n=_twophase_tile(index_q.shape[0], tile_n))


# --------------------------------------------------------------------------- #
# int4-packed index
# --------------------------------------------------------------------------- #
# Packing layout: element d pairs with element d + D/2 in one byte (lo nibble
# = x[:, :D/2], hi nibble = x[:, D/2:]). Unpacking yields two contiguous
# (N, D/2) halves and the cosine numerator is lo @ q[:, :D/2] + hi @ q[:, D/2:].


def quantize_rows_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) f32 (D even) -> ((N, D/2) int8 packed nibbles, (N, 1) f32
    scales). Symmetric per-row, values in [-7, 7], scale clipped at the 99th
    |x| percentile (linear interpolation, as `jnp.percentile`): with only 15
    levels, spending them on the outlier tail costs more recall than
    clipping it. The interpolation agrees with `jnp.percentile` to the last
    bit of the scale only (XLA may fuse its multiply-add), so an x/scale
    within that of a half may round to the neighbouring level."""
    N, D = x.shape
    kernels.require(D % 2 == 0, "int4 packing needs an even feature dim")
    clip = _percentile99(x.abs())
    scale = _true_divide(clip.clamp(min=1e-12), 7.0)
    q = torch.round(x / scale).clamp(-7, 7).to(torch.int32)
    lo = q[:, : D // 2] & 0xF
    hi = q[:, D // 2:] & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8)
    return packed.view(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D/2) int8 -> (lo, hi) int8 halves, sign-extended: arithmetic
    shifts of the widened byte."""
    b32 = packed.to(torch.int32)
    lo = (b32 << 28) >> 28
    hi = (b32 << 24) >> 28
    return lo.to(torch.int8), hi.to(torch.int8)


def build_int4_index(embeddings: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize + int4-quantize a raw (N, D) embedding matrix."""
    return quantize_rows_int4(l2_normalize(embeddings.float()))


def _int4_dot(q8: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D/2) packed -> (B, N) f32 holding the exact dots."""
    Dh = packed.shape[1]
    lo, hi = unpack_int4(packed)
    return _int_dot(q8[:, :Dh], lo) + _int_dot(q8[:, Dh:], hi)


def cosine_topk_int4(
    index_p: torch.Tensor,  # (N, D/2) int8 packed nibbles
    index_scale: torch.Tensor,  # (N, 1) f32
    queries: torch.Tensor,  # (B, D) f32 unnormalized
    n_valid: int,
    k: int,
):
    """Masked top-k cosine over an int4-packed index, flat."""
    _require_exact(queries.shape[1], amax=8)
    q8, qs = quantize_rows(l2_normalize(queries.float()))
    return _flat_topk(_int4_dot(q8, index_p), qs, index_scale, int(n_valid), k)


def segment_max_int4_reference(index_p: torch.Tensor, index_scale: torch.Tensor, q8: torch.Tensor, n_valid: int,
                               group: int) -> torch.Tensor:
    """Plain version of K12: unpack, two integer dots, the row's scale,
    masked maxima of `group` rows -> (B, N/group)."""
    _require_exact(q8.shape[1], amax=8)
    scores = _int4_dot(q8, index_p) * index_scale[:, 0][None, :]
    return group_max(_mask_rows(scores, n_valid), group)


def segment_max_int4(index_p, index_scale, q8, n_valid: int, group: int) -> torch.Tensor:
    """K12 on CUDA tensors, its plain version on CPU tensors."""
    if not kernels.on_cuda(index_p, index_scale, q8):
        return segment_max_int4_reference(index_p, index_scale, q8, n_valid, group)
    kernels.require(2 * index_p.shape[1] == q8.shape[1], "index_p must be (N, D/2) for q8 (B, D)")
    return _launch_segmax_quant("topk_segmax_int4", index_p, index_scale, q8, n_valid, group, 32)


def cosine_topk_int4_twophase(
    index_p: torch.Tensor,  # (N, D/2) int8 packed, N % tile_n == 0
    index_scale: torch.Tensor,
    queries: torch.Tensor,  # (B, D) f32
    n_valid: int,
    k: int,
    tile_n: int = 2048,
    group: int = 16,
):
    """Exact int4 top-k: unpack + segment maxima (K12), then integer
    re-score of the k winning segments (same structure and tie handling as
    the int8 two-phase function)."""
    N, Dh = index_p.shape
    D = queries.shape[1]
    n_valid = int(n_valid)
    kernels.require(N % tile_n == 0 and tile_n % group == 0, f"N={N} % tile_n={tile_n} and tile_n % group={group}")
    if k * group >= N:
        return cosine_topk_int4(index_p, index_scale, queries, n_valid, k)
    _require_exact(D, amax=8)
    q8, qs = quantize_rows(l2_normalize(queries.float()))
    segmax = segment_max_int4(index_p, index_scale, q8, n_valid, group)
    flat_idx = segment_candidates(topk_lowest(segmax, k), group)
    lo, hi = unpack_int4(index_p[flat_idx])  # (B, k*G, D/2) each
    acc = (torch.einsum("bnd,bd->bn", lo.float(), q8[:, :Dh].float())
           + torch.einsum("bnd,bd->bn", hi.float(), q8[:, Dh:].float()))
    return _rescore_quant(acc, qs, index_scale, flat_idx, n_valid, k)


def cosine_topk_int4_auto(index_p, index_scale, queries, n_valid, k: int, tile_n: int = 2048):
    """As `cosine_topk_int8_auto`: flat on CPU tensors, two-phase (K12) on
    CUDA tensors."""
    if not kernels.on_cuda(index_p, index_scale, queries):
        return cosine_topk_int4(index_p, index_scale, queries, n_valid, k)
    return cosine_topk_int4_twophase(index_p, index_scale, queries, n_valid, k,
                                     tile_n=_twophase_tile(index_p.shape[0], tile_n))


# --------------------------------------------------------------------------- #
# refined int4: device shortlist + host full-precision rescore
# --------------------------------------------------------------------------- #
# Fifteen levels cannot order the top-10 of a large random index, but the
# true top-10 sits inside the int4 top-k' for a modest k'. The refined query
# keeps the int4 index on the device for the corpus stream, takes the exact
# int4 top-k' there, and rescores those k' candidates per query on the host
# against the full-precision matrix kept at build time, which costs k'/N of its bytes
# per query. `refined_query_batches` overlaps the host rescore of batch i
# with the device shortlist of batch i+1.


def normalize_host_rows(host_rows: np.ndarray) -> np.ndarray:
    """Pre-normalize the rescore source once at build time, as f32, so the
    per-query work is a gather and a small product."""
    rows = np.asarray(host_rows, np.float32)
    return rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_device(queries, device) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        return queries.to(device)
    return torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(device)


def cosine_topk_int4_refined(
    index_p: torch.Tensor,  # (N, D/2) int8 packed nibbles (device)
    index_scale: torch.Tensor,  # (N, 1) f32 (device)
    queries,  # (B, D) f32 unnormalized, tensor or numpy
    n_valid,
    k: int,
    host_rows: np.ndarray,  # (N, D) float: full-precision rescore source
    kprime: int = 48,
    rows_normalized: bool = False,
):
    """Two-stage top-k: exact-int4 shortlist of k' candidates on the device,
    then exact cosine rescore of the gathered candidates on the host.
    Returns numpy (vals, idx, valid)."""
    _, idx, valid = cosine_topk_int4_auto(index_p, index_scale, _to_device(queries, index_p.device), n_valid, kprime)
    return _rescore_host(_to_numpy(idx), _to_numpy(valid), _to_numpy(queries), host_rows, k,
                         rows_normalized=rows_normalized)


def _rescore_host(idx, valid, queries, host_rows, k: int, rows_normalized: bool = False):
    """Host stage: gather (B, k') candidate rows, exact cosine, final top-k.
    Ties break toward the lower index (matching masked_topk's stable order
    after candidates are index-sorted)."""
    B, kprime = idx.shape
    qn = queries.astype(np.float32)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)
    # sort candidates by index so equal scores resolve to the lower index,
    # like the flat path's stable top-k over an index-ordered score row
    order = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    valid = np.take_along_axis(valid, order, axis=1)
    rows = host_rows[idx.reshape(-1)]
    if rows.dtype != np.float32:
        rows = rows.astype(np.float32)
    rows = rows.reshape(B, kprime, -1)
    if not rows_normalized:
        rows = rows / np.maximum(np.linalg.norm(rows, axis=2, keepdims=True), 1e-12)
    scores = np.matmul(rows, qn[:, :, None])[..., 0]
    scores = np.where(valid, scores, NEG_INF)
    part = np.argpartition(-scores, min(k, kprime - 1), axis=1)[:, :k]
    pvals = np.take_along_axis(scores, part, axis=1)
    order2 = np.argsort(-pvals, axis=1, kind="stable")
    pos = np.take_along_axis(part, order2, axis=1)
    out_vals = np.take_along_axis(scores, pos, axis=1)
    out_idx = np.take_along_axis(idx, pos, axis=1)
    out_valid = out_vals > NEG_INF / 2
    return (out_vals.astype(np.float32),
            out_idx.astype(np.int32),
            out_valid)


def refined_query_batches(
    index_p: torch.Tensor,
    index_scale: torch.Tensor,
    query_batches,  # iterable of (B, D) f32 host arrays, or (device tensor, host array) pairs
    n_valid,
    k: int,
    host_rows: np.ndarray,
    kprime: int = 48,
    rows_normalized: bool = False,
):
    """Pipelined refined queries: the device shortlist for batch i+1 is
    launched before the host rescores batch i, so the host gather and
    product hide under the device stream. Yields numpy (vals, idx, valid)
    per batch, equal to the serial `cosine_topk_int4_refined`.

    On a CUDA index the shortlist runs on the current stream, `idx` and
    `valid` are copied into pinned host buffers with `non_blocking=True`
    behind it, and an event recorded after the copies is waited on only when
    that batch is rescored. Pass (device tensor, host array) pairs when the
    queries are already on the device."""
    device = index_p.device

    def _dispatch(q_dev):
        _, idx, valid = cosine_topk_int4_auto(index_p, index_scale, q_dev, n_valid, kprime)
        if not idx.is_cuda:
            return idx.numpy(), valid.numpy(), None
        idx_h = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
        valid_h = torch.empty(valid.shape, dtype=valid.dtype, pin_memory=True)
        idx_h.copy_(idx, non_blocking=True)
        valid_h.copy_(valid, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return idx_h.numpy(), valid_h.numpy(), event

    def _rescore(pending):
        (idx, valid, event), q_np = pending
        if event is not None:
            event.synchronize()
        return _rescore_host(idx, valid, q_np, host_rows, k, rows_normalized=rows_normalized)

    pending = None  # ((idx, valid, event), host queries)
    for q in query_batches:
        q_dev, q_np = q if isinstance(q, tuple) else (q, None)
        handles = _dispatch(_to_device(q_dev, device))
        if pending is not None:
            yield _rescore(pending)
        pending = (handles, _to_numpy(q_dev) if q_np is None else q_np)
    if pending is not None:
        yield _rescore(pending)
