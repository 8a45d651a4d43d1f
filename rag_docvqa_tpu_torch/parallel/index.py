"""Device-resident, sharded embedding index with global top-k queries.

Counterpart of `ShardedIndex`, `single_device_query` and
`sharded_maxsim_topk` in `rag_docvqa_tpu/parallel/index.py`. There the chunk
embedding matrix is laid out over a mesh axis, every chip scores its shard,
and an all-gather of k candidates per shard feeds one merge. Here the index
takes one of two forms, with the same shard arithmetic and the same merge:

  * `n_shards` row ranges of one tensor on one device, scored one after the
    other;
  * with `mesh=` (`parallel/mesh.py`), one shard per rank of the mesh's data
    axis: a rank keeps only its own `shard_len` rows on its device, scores
    them with the same per-shard kernels, and all-gathers its (B, k) values
    and global ids over the axis.

Either way: pad to `n_shards * tile_n` rows, `local_valid` per shard,
`gidx = idx + sid * shard_len`, candidates concatenated in ascending shard
(rank) order, one top-k with ties to the lowest position, so ties resolve
to the lowest global row as in an unsharded top-k. `sharded_maxsim_topk` is
the same scheme over a patch-token index scored by MaxSim (K15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from rag_docvqa_tpu_torch.ops.late_interaction import late_interaction
from rag_docvqa_tpu_torch.parallel.mesh import Mesh
from rag_docvqa_tpu_torch.ops.quant import (
    _rescore_host,
    _to_numpy,
    cosine_topk_int4_auto,
    cosine_topk_int8_auto,
    normalize_host_rows,
    quantize_rows,
    quantize_rows_int4,
)
from rag_docvqa_tpu_torch.ops.topk import (
    _valid_rows,
    cosine_topk_auto,
    cosine_topk_flat,
    cosine_topk_fused,
    cosine_topk_twophase,
    l2_normalize,
    masked_topk,
)


def _pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    if x.shape[0] == n_pad:
        return x.contiguous()
    out = torch.zeros((n_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


@dataclass
class ShardedIndex:
    """A pre-normalized (N_pad, D) embedding matrix in `n_shards` shards:
    row ranges of one tensor, or with `mesh` one shard a rank of its data
    axis, `embeddings` then holding this rank's (shard_len, D) rows alone.

    dtype options: "f32" / "bf16" (half the device memory) / "int8" (a
    quarter, symmetric per-row quantization) / "int4" (an eighth, packed
    nibbles: the capacity extreme, see ops/quant.py::quantize_rows_int4).
    """

    embeddings: torch.Tensor  # (N_pad, D) or this rank's (shard_len, D); D/2 packed for int4
    n_valid: int  # true number of rows, over every shard
    n_shards: int = 1
    tile_n: int = 512
    use_kernel: bool = True  # JAX `use_pallas`; False = the flat version
    scales: Optional[torch.Tensor] = None  # (rows, 1) f32, int8/int4 modes
    packed: bool = False  # int4 mode: embeddings hold packed nibble pairs
    # per-shard function of the f32/bf16 modes: "merge" = the running-merge
    # kernel K4 (`cosine_topk_fused`), "twophase" = the segment-max kernel K5
    # (`cosine_topk_twophase`), "auto" = `cosine_topk_auto`'s choice by batch
    # size (not in the JAX class, whose callers pick one of the two)
    kernel: str = "merge"
    # refined tier: full-precision rows in host memory; the device takes the
    # exact quantized top-k' and the host rescores it (ops/quant.py). Every
    # rank of a mesh keeps all n_valid rows: the merged shortlist names rows
    # of every shard
    host_rows: Optional[np.ndarray] = None  # (n_valid, D) float
    refine_kprime: int = 48
    mesh: Optional[Mesh] = None  # one shard a rank of the data axis, else row ranges of one tensor

    # ------------------------------------------------------------------ #
    @staticmethod
    def build(
        embeddings,  # (N, D) raw (unnormalized) chunk embeddings, tensor or numpy
        n_shards: int = 1,
        tile_n: int = 512,
        use_kernel: bool = True,
        dtype: str = "f32",  # "f32" | "bf16" | "int8" | "int4"
        refine: bool = False,  # int4/int8: keep host rows + rescore queries
        refine_dtype: str = "float32",  # host-copy precision
        refine_kprime: int = 48,
        device=None,  # where the index lives; default: the mesh's device, else the embeddings'
        kernel: str = "merge",
        mesh: Optional[Mesh] = None,
    ) -> "ShardedIndex":
        """Normalize once, pad to shard x tile multiples, keep on `device`.
        With `mesh`, the shards are the ranks of its data axis (`n_shards` is
        ignored) and each rank keeps only its own rows of `embeddings`."""
        if dtype not in ("f32", "bf16", "int8", "int4"):
            raise ValueError(f"unknown index dtype {dtype!r}")
        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.from_numpy(np.ascontiguousarray(embeddings))
        n = embeddings.shape[0]
        if mesh is not None:
            n_shards, device = mesh.size("data"), device or mesh.device
        mult = n_shards * tile_n
        n_pad = -(-n // mult) * mult
        rows, n_rows = embeddings, n_pad
        if mesh is not None:  # this rank's rows alone reach its device
            n_rows = n_pad // n_shards
            lo = mesh.index("data") * n_rows
            rows = embeddings[min(lo, n):min(lo + n_rows, n)]
        if device is not None:
            rows = rows.to(device)
        x = l2_normalize(rows.float())
        form = dict(n_valid=n, n_shards=n_shards, tile_n=tile_n, mesh=mesh)

        if dtype in ("int8", "int4"):
            q, s = (quantize_rows_int4 if dtype == "int4" else quantize_rows)(x)
            host_rows = None
            if refine:
                host_rows = normalize_host_rows(_to_numpy(embeddings)).astype(refine_dtype)
            return ShardedIndex(embeddings=_pad_rows(q, n_rows), scales=_pad_rows(s, n_rows), use_kernel=False,
                                packed=dtype == "int4", host_rows=host_rows, refine_kprime=refine_kprime, **form)

        x = x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
        return ShardedIndex(embeddings=_pad_rows(x, n_rows), use_kernel=use_kernel, kernel=kernel, **form)

    @property
    def resident_bytes(self) -> int:
        """Bytes the index holds on its device (rows and scales): with a
        mesh, this rank's shard."""
        n = self.embeddings.numel() * self.embeddings.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    @property
    def shard_len(self) -> int:
        return self.embeddings.shape[0] if self.mesh is not None else self.embeddings.shape[0] // self.n_shards

    # ------------------------------------------------------------------ #
    def query(self, queries, k: int):
        """Global top-k for a (B, D) query batch (with a mesh: the same batch
        on every rank of the axis).

        Returns (values, indices, valid) with indices into the original
        (unpadded) row space, sorted descending: tensors on the index's
        device, or numpy arrays from the refined tier; every rank of a mesh
        returns the same."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
        queries = queries.to(self.embeddings.device)
        if self.scales is None:
            return self._sharded_query(queries, k)
        if self.host_rows is None:
            return self._sharded_query_quant(queries, k)
        # per-shard top-k' caps at the shard length (the merge then covers
        # the global top-k' by the usual per-shard argument)
        kprime = max(min(self.refine_kprime, self.n_valid, self.shard_len), k)
        _, si, sok = self._sharded_query_quant(queries, kprime)
        return _rescore_host(_to_numpy(si), _to_numpy(sok), _to_numpy(queries), self.host_rows, k,
                             rows_normalized=True)

    def _shards(self):
        """(shard id, rows of `embeddings`, rows valid on it) for each shard
        held here, ascending: every shard, or with a mesh this rank's."""
        shard_len = self.shard_len
        sids = [self.mesh.index("data")] if self.mesh is not None else range(self.n_shards)
        for sid in sids:
            local_valid = min(max(self.n_valid - sid * shard_len, 0), shard_len)
            rows = slice(0, shard_len) if self.mesh is not None else slice(sid * shard_len, (sid + 1) * shard_len)
            yield sid, rows, local_valid

    def _merge(self, cands, k: int):
        """One top-k over the shards' candidates, concatenated in ascending
        shard order so ties resolve to the lowest global index; with a mesh
        the candidates are this rank's, all-gathered over the axis first."""
        shard_len = self.shard_len
        vals = [v for _, v, _ in cands]
        gidx = [i.to(torch.int64) + sid * shard_len for sid, _, i in cands]
        if self.mesh is not None:  # members in the axis's order: ascending shard id
            vals, gidx = _gather_candidates(self.mesh, vals[0], gidx[0])
        cand_vals, cand_idx = torch.cat(vals, dim=1), torch.cat(gidx, dim=1)  # (B, n_shards * k)
        out_vals, pos, _ = masked_topk(cand_vals, None, k)
        return out_vals, torch.gather(cand_idx, 1, pos).to(torch.int32), out_vals > -1e29

    def _sharded_query(self, queries: torch.Tensor, k: int):
        cands = []
        for sid, rows, local_valid in self._shards():
            shard = self.embeddings[rows]
            if not self.use_kernel:
                vals, idx, _ = cosine_topk_flat(shard, queries, k,
                                                index_mask=_valid_rows(shard.shape[0], local_valid, shard.device))
            elif self.kernel == "twophase":
                vals, idx, _ = cosine_topk_twophase(shard, queries, local_valid, k, tile_n=self.tile_n)
            elif self.kernel == "auto":
                vals, idx, _ = cosine_topk_auto(shard, queries, local_valid, k, tile_n=self.tile_n)
            elif self.kernel == "merge":
                vals, idx, _ = cosine_topk_fused(shard, queries, local_valid, k, tile_n=self.tile_n)
            else:
                raise ValueError(f"unknown per-shard kernel {self.kernel!r}")
            cands.append((sid, vals, idx))
        return self._merge(cands, k)

    def _sharded_query_quant(self, queries: torch.Tensor, k: int):
        # one dispatch policy shared with the single-device functions
        score_auto = cosine_topk_int4_auto if self.packed else cosine_topk_int8_auto
        cands = []
        for sid, rows, local_valid in self._shards():
            vals, idx, _ = score_auto(self.embeddings[rows], self.scales[rows], queries, local_valid, k)
            cands.append((sid, vals, idx))
        return self._merge(cands, k)


def _gather_candidates(mesh: Mesh, vals: torch.Tensor, idx: torch.Tensor):
    """Every member's candidates over the data axis, in its order, through one
    all-gather: the f32 values and the integer ids (below 2**53) travel
    side by side as f64, which holds both exactly. Returns (values, ids)
    lists, one entry a member, in the inputs' dtypes."""
    k = vals.shape[-1]
    parts = mesh.all_gather(torch.cat([vals.double(), idx.double()], dim=-1), "data")
    return [p[..., :k].to(vals.dtype) for p in parts], [p[..., k:].to(idx.dtype) for p in parts]


def single_device_query(
    embeddings: torch.Tensor,  # (N, D) unnormalized
    queries: torch.Tensor,
    k: int,
    index_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unsharded reference: normalize + matmul + top-k."""
    return cosine_topk_flat(l2_normalize(embeddings.float()), queries, k, index_mask=index_mask)


def sharded_maxsim_topk(patches: torch.Tensor, patch_mask: torch.Tensor, query: torch.Tensor, *, n_valid: int,
                        k: int, n_shards: Optional[int] = None,
                        mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MaxSim late interaction over a patch index in shards: patches
    (N, Tp, D), patch_mask (N, Tp) bool, query (Tq, D). Either `n_shards`
    row ranges of N (N a multiple of n_shards), or with `mesh` one shard a
    rank of its data axis, `patches` and `patch_mask` then this rank's
    (shard_len, ...) rows (`parallel/mesh.py::local_rows`). Each shard is
    scored by `late_interaction` (K15) and gives a local top-k over its
    valid rows; the candidates, concatenated in ascending shard order (with
    a mesh, all-gathered over the axis), feed one top-k, so ties resolve to
    the lowest global row as in an unsharded top-k. Returns (vals (k,), idx
    (k,) int64, valid (k,)), the same on every rank."""
    if (n_shards is None) == (mesh is None):
        raise ValueError("give exactly one of n_shards and mesh")
    N = patches.shape[0]
    if mesh is None and N % n_shards:
        raise ValueError(f"{N} rows do not divide into {n_shards} shards")
    shard_len = N if mesh is not None else N // n_shards
    sids = [mesh.index("data")] if mesh is not None else range(n_shards)
    cand_vals, cand_idx = [], []
    for sid in sids:
        rows = slice(0, N) if mesh is not None else slice(sid * shard_len, (sid + 1) * shard_len)
        scores = late_interaction(query, patches[rows], patch_mask=patch_mask[rows])  # (shard_len,)
        local_valid = min(max(n_valid - sid * shard_len, 0), shard_len)
        scores = torch.where(_valid_rows(shard_len, local_valid, scores.device), scores, float("-inf"))
        vals, idx = torch.sort(scores, descending=True, stable=True)
        kk = min(k, shard_len)
        cand_vals.append(vals[:kk])
        cand_idx.append(idx[:kk] + sid * shard_len)
    if mesh is not None:  # members in the axis's order: ascending shard id
        cand_vals, cand_idx = _gather_candidates(mesh, cand_vals[0], cand_idx[0])
    cand_vals, cand_idx = torch.cat(cand_vals), torch.cat(cand_idx)
    out_vals, pos = torch.sort(cand_vals, descending=True, stable=True)
    out_vals, pos = out_vals[:k], pos[:k]
    return out_vals, cand_idx[pos], torch.isfinite(out_vals)
