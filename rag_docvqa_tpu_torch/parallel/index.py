"""Device-resident, logically sharded embedding index with global top-k
queries.

Counterpart of `ShardedIndex` and `single_device_query` in
`rag_docvqa_tpu/parallel/index.py`. There the chunk embedding matrix is laid
out over a mesh axis, every chip scores its shard, and an all-gather of k
candidates per shard feeds one merge. Here the matrix is one tensor on one
device and the `n_shards` shards are contiguous row ranges of it, scored one
after the other, so the shard arithmetic and the merge with its tie rule are
the same code as they will be across GPUs: pad to `n_shards * tile_n` rows,
`local_valid` per shard, `gidx = idx + sid * shard_len`, candidates
concatenated in ascending shard order, one top-k with ties to the lowest
position. The collectives over several GPUs and `sharded_maxsim_topk` are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

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
    """A pre-normalized (N_pad, D) embedding matrix in `n_shards` row ranges.

    dtype options: "f32" / "bf16" (half the device memory) / "int8" (a
    quarter, symmetric per-row quantization) / "int4" (an eighth, packed
    nibbles: the capacity extreme, see ops/quant.py::quantize_rows_int4).
    """

    embeddings: torch.Tensor  # (N_pad, D); (N_pad, D/2) packed for int4
    n_valid: int  # true number of rows
    n_shards: int = 1
    tile_n: int = 512
    use_kernel: bool = True  # JAX `use_pallas`; False = the flat version
    scales: Optional[torch.Tensor] = None  # (N_pad, 1) f32, int8/int4 modes
    packed: bool = False  # int4 mode: embeddings hold packed nibble pairs
    # per-shard function of the f32/bf16 modes: "merge" = the running-merge
    # kernel K4 (`cosine_topk_fused`), "twophase" = the segment-max kernel K5
    # (`cosine_topk_twophase`), "auto" = `cosine_topk_auto`'s choice by batch
    # size (not in the JAX class, whose callers pick one of the two)
    kernel: str = "merge"
    # refined tier: full-precision rows in host memory; the device takes the
    # exact quantized top-k' and the host rescores it (ops/quant.py)
    host_rows: Optional[np.ndarray] = None  # (n_valid, D) float
    refine_kprime: int = 48

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
        device=None,  # where the index lives; default: the embeddings' device
        kernel: str = "merge",
    ) -> "ShardedIndex":
        """Normalize once, pad to shard x tile multiples, keep on `device`."""
        if dtype not in ("f32", "bf16", "int8", "int4"):
            raise ValueError(f"unknown index dtype {dtype!r}")
        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.from_numpy(np.ascontiguousarray(embeddings))
        if device is not None:
            embeddings = embeddings.to(device)
        n = embeddings.shape[0]
        mult = n_shards * tile_n
        n_pad = -(-n // mult) * mult
        x = l2_normalize(embeddings.float())

        if dtype in ("int8", "int4"):
            q, s = (quantize_rows_int4 if dtype == "int4" else quantize_rows)(x)
            host_rows = None
            if refine:
                host_rows = normalize_host_rows(_to_numpy(embeddings)).astype(refine_dtype)
            return ShardedIndex(
                embeddings=_pad_rows(q, n_pad), scales=_pad_rows(s, n_pad), n_valid=n, n_shards=n_shards,
                tile_n=tile_n, use_kernel=False, packed=dtype == "int4", host_rows=host_rows,
                refine_kprime=refine_kprime)

        x = x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
        return ShardedIndex(embeddings=_pad_rows(x, n_pad), n_valid=n, n_shards=n_shards, tile_n=tile_n,
                            use_kernel=use_kernel, kernel=kernel)

    @property
    def resident_bytes(self) -> int:
        """Bytes the index holds on its device (rows and scales)."""
        n = self.embeddings.numel() * self.embeddings.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    # ------------------------------------------------------------------ #
    def query(self, queries, k: int):
        """Global top-k for a (B, D) query batch.

        Returns (values, indices, valid) with indices into the original
        (unpadded) row space, sorted descending: tensors on the index's
        device, or numpy arrays from the refined tier."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
        queries = queries.to(self.embeddings.device)
        if self.scales is None:
            return self._sharded_query(queries, k)
        if self.host_rows is None:
            return self._sharded_query_quant(queries, k)
        # per-shard top-k' caps at the shard length (the merge then covers
        # the global top-k' by the usual per-shard argument)
        shard_len = self.embeddings.shape[0] // self.n_shards
        kprime = max(min(self.refine_kprime, self.n_valid, shard_len), k)
        _, si, sok = self._sharded_query_quant(queries, kprime)
        return _rescore_host(_to_numpy(si), _to_numpy(sok), _to_numpy(queries), self.host_rows, k,
                             rows_normalized=True)

    def _shards(self):
        """(shard id, row range, rows valid on it) per shard, ascending."""
        shard_len = self.embeddings.shape[0] // self.n_shards
        for sid in range(self.n_shards):
            local_valid = min(max(self.n_valid - sid * shard_len, 0), shard_len)
            yield sid, slice(sid * shard_len, (sid + 1) * shard_len), local_valid

    def _merge(self, cands, k: int):
        """One top-k over the shards' candidates, concatenated in ascending
        shard order so ties resolve to the lowest global index."""
        shard_len = self.embeddings.shape[0] // self.n_shards
        cand_vals = torch.cat([v for _, v, _ in cands], dim=1)  # (B, n_shards * k)
        cand_idx = torch.cat([i.to(torch.int64) + sid * shard_len for sid, _, i in cands], dim=1)
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


def single_device_query(
    embeddings: torch.Tensor,  # (N, D) unnormalized
    queries: torch.Tensor,
    k: int,
    index_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unsharded reference: normalize + matmul + top-k."""
    return cosine_topk_flat(l2_normalize(embeddings.float()), queries, k, index_mask=index_mask)
