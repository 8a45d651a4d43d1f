#!/usr/bin/env python3
"""Drive the PyTorch port's RAG-VT5 serving and training paths, its corpus
index and its BERT family once on one CUDA card.

    python3 chip_smoke.py            # every phase, the report and the result line
    python3 chip_smoke.py 8          # phases 1-2 and the named ones (3-8) alone, for work on them: no report

Eight phases; any failure raises and the script exits non-zero:

  1. a CUDA device is required; prints the card's name and power limit and
     turns TF32 off, so f32 products are full f32;
  2. builds the hand-written kernels (rag_docvqa_tpu_torch/csrc) with nvcc,
     one process per source, into build/torch_kernels/ and prints the build
     time;
  3. checks each serving kernel against its plain PyTorch version on the
     card, on a small ragged shape and at the main path's t5-base shape, in
     f32 (max abs error <= 1e-4) and bf16 (max abs error <= 2e-2 of the
     largest reference value, at least 1); the decode-attention kernel does
     f32 math on every cache dtype and is held to 1e-4 on each. Times both
     with CUDA events after a warmup;
  4. runs the full-width f32 t5-base stack at B 8: encode through the
     kernels against the plain stack (<= 1e-4), and greedy decode with the
     decode-attention kernel on and off (identical ids, f32, bf16 and int8
     caches);
  5. serves two batches of 32 synthetic documents through
     RAGVT5Engine.inference with the configs/RAGVT5.yml values, bf16 random
     weights, an int8 cross cache and the decode-attention kernel; checks
     that every kernel of the serving path was launched and that every
     confidence is finite;
  6. the training path, outside inference mode:
     a. the flash backward (K6) against its plain version on small ragged
        shapes (shared, per-batch and no bias; causal; GQA; mask values
        -1e9 and -1e30) and at the training shape B8 H12 T512 dk64 with a
        shared bf16 bias: dq, dk, dv and dbias within 1e-4 (f32) and 2e-2
        (bf16) of max(1, max|ref|);
     b. the T5 layer backward halves K7 (FFN) and K8 (attention) against
        their plain versions at t5-base B8 T512 in f32 and bf16, and the
        whole-layer gradient of T5LayerTrain against autograd through the
        plain layer (f32);
     c. the full-width f32 12-layer encoder gradient at B2 T512 against
        autograd of the plain stack, within 1e-4 of each gradient's largest
        value (the rel-pos table's, which both take through bf16, within
        2e-2);
     d. eight train steps of t5-base VT5 at B 8 through make_train_step with
        the configs/RAGVT5.yml values, bf16 compute and f32 masters, on one
        repeated batch of synthetic documents (8 pages x 120 words): every
        loss and grad norm finite, the loss falls, every kernel of the
        training path launched; prints ms per step split into forward,
        backward and update. Cut: warmup 2 steps instead of 1000, so the
        learning rate is not zero;
  7. the corpus index, TF32 still off:
     a. the top-k kernels K4 (fused scoring + running top-k), K5 (segment
        maxima), K11 (int8) and K12 (int4) against their plain versions on
        a small ragged case (N 1536 with 1100 valid rows, D 64, B 3 and 20,
        k 5, duplicated rows that tie) and at the path's shape, N 524,288 x
        D 768, B 256 and B 8, k 10, f32 and bf16 index. Float kernels:
        values and maxima within 1e-4, and every returned index is checked
        by gathering its score from the plain score matrix (on the card
        the kernels and the flat product sum in another order, so ranks
        closer than f32 rounding may swap: index-for-index equality is not
        demanded). Integer kernels: maxima equal bit for bit, and the
        two-phase functions' indices and values equal the flat ones
        exactly. Times by CUDA events, beside torch.matmul + torch.topk on
        the same index (whose tie order is not the contract);
     b. ShardedIndex.build and query at that size in f32, bf16, int8, int4
        and int4 with the host rescore (k' 48, f32 host rows), as 1 and as
        4 row ranges: both give identical results; top-10 agreement with
        the plain f32 query is printed (int8 >= 0.9, refined int4 >= 0.95),
        resident bytes and queries per second at B 256 per precision;
        `refined_query_batches` over four batches equals the serial refined
        query, and both are timed;
     c. the entry point: `precompute index` on the synthetic corpus at
        t5-base width (configs/RAGVT5.yml, 256 documents of 8 pages) into a
        temporary file, then `precompute query` in every precision, with
        and without --refine; every rank line parses and the f32 ranks are
        those of single_device_query. Every kernel of the index path was
        launched in b and c;
  8. the BERT family (post-LN layer K9, its backward K10), TF32 still off:
     a. K9's parts (the GEMM's bias, bias + erf-GELU and bias + residual-in-
        f32 epilogues, the row LayerNorm at eps 1e-12 with a constant row, K2
        at dh 32 and 64 with no bias and mask value -1e30) and the whole
        layer against their plain versions: a small ragged case (B 7, T 24,
        d 64, one sequence with no valid key: finite) and both path shapes,
        bge-small B 1024 T 64 and XLM-R-base width B 320 T 192, f32 <= 1e-4
        and bf16 <= 2e-2 of max(1, max|ref|), with and without save_x1;
     b. the full-width f32 12-layer bge-small `bert_encode` at B 64 against
        the plain stack (<= 1e-4);
     c. path 1, embed -> index: 16,384 synthetic chunks of T 64 (some padded
        slots with no valid token) through `embed_batch("BGE")` in bf16 in
        batches of 1,024, a bf16 ShardedIndex of the embeddings, 64 embedded
        questions, k 10; embeddings finite and of unit norm, every returned
        score equal to its row's in the plain product, every K9 kernel
        launched; chunks per second;
     d. path 2, reranked serving: two batches of 32 documents through
        RAGVT5Engine.inference as in phase 5 with the cross-encoder reranker
        at XLM-R-base width (12 layers, d 768, RoBERTa positions, one label;
        320 pairs of T 192 per batch; threshold 0.4, at most 5 and at least 1
        rank); 1 to 5 valid ranks per document with scores sorted descending,
        finite confidences, every kernel of K1-K3 and K9 launched; ms per
        batch and the reranker call alone between two synchronizes;
     e. K10's parts (the backward GEMM's three BERT epilogues, the weight-
        gradient product cut into row ranges, the LayerNorm backward, the
        column sums), `bert_ffn_bwd` and `bert_attn_bwd` at bge-small B 256
        T 64 in f32 and bf16, a sequence with no valid key (finite, equal to
        the plain version), BertLayerTrain's whole-layer gradient and the
        full-width f32 12-layer encoder gradient (B 16) against autograd of
        the plain stack, within 1e-4 of each gradient's largest value;
     f. path 3: eight contrastive steps (MultipleNegativesRankingLoss at
        scale 20, optax.adamw's constants, lr 2e-5) of the bge-small
        bi-encoder at B 256 pairs, T 64, bf16 compute on f32 masters, one
        repeated batch: loss finite and falling, every K9/K10 kernel
        launched, ms per step split into forward, backward and update by
        CUDA events; the eight losses of a second run from the same seed are
        compared digit for digit and the result printed.

The line before the last is a JSON object with every kernel's launches in
its path's run (phase 5 for serving, 6d for training, 7b-c for the index,
8c for the BERT forward kernels, 8f for the backward ones; every path's
counts of every kernel under "launches_by_path"),
its worst error over its own checks, and, at its path's shape, its time,
the plain version's, the time of one PyTorch call that computes the same
function where there is one ("library_ms", else null; timed here, used
nowhere in the port) and the least time the card could take ("bound_ms":
the larger of the bytes moved once over 3.35 TB/s and the operations over
the peak rate of their type, "bound_by" saying which; every timed case
under "cases"); the whole K1 layer's error
and times under "t5_layer", K7's and K8's under "t5_ffn_bwd" and
"t5_attn_bwd", the train steps under "train_step", the whole K9 layer
under "bert_layer", K10's halves under "bert_ffn_bwd" and "bert_attn_bwd",
and paths 1-3 under "embed_index", "rerank_serve" and "contrastive_step".
The last line is
{"ok": true, "device": {...}}. Weights are random, made from a seed.

Nothing here imports jax or flax, nor any module of the JAX package: the
port keeps its own copies of the plain-Python chunker (ops/chunking.py) and
metrics (metrics/).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
F32_TOL = 1e-4
BF16_REL_TOL = 2e-2

# NVIDIA's H100 SXM data sheet, dense rates: what `bound_ms` divides by
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

# kernel -> (source, TPU kernel it replaces, the path it runs in, the timed
# case whose times the report's "ms"/"plain_ms" give: the shape and dtype
# that path runs it at)
KERNELS = {
    "t5_rms_norm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                    "serve", "B32 T512 d768 bf16"),
    "t5_gemm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                "serve", "ffn-out 16384x768x3072 residual bf16"),
    "flash_fwd": ("rag_docvqa_tpu_torch/csrc/flash_fwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:155",
                  "serve", "B32 H12 T512 dk64 shared bias bf16"),
    "decode_cross_attention": ("rag_docvqa_tpu_torch/csrc/decode_attention.cu",
                               "rag_docvqa_tpu/ops/decode_attention.py:81", "serve", "B32 H12 dk64 Te512 int8 cache"),
    "flash_bwd": ("rag_docvqa_tpu_torch/csrc/flash_bwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:417",
                  "train", "B8 H12 T512 dk64 shared bias t5-mask bf16"),
    "t5_gemm_bwd": ("rag_docvqa_tpu_torch/csrc/t5_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:102",
                    "train", "tn dWi 3072x768 over 4096 rows bf16"),
    "t5_rms_bwd": ("rag_docvqa_tpu_torch/csrc/t5_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:243",
                   "train", "4096x768 bf16"),
    "topk_fused": ("rag_docvqa_tpu_torch/csrc/topk_fused.cu", "rag_docvqa_tpu/ops/topk.py:110",
                   "index", "N524288 D768 B8 k10 bf16"),
    "topk_segmax": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/topk.py:200",
                    "index", "N524288 D768 B256 g8 sg16 bf16"),
    "topk_segmax_int8": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/quant.py:68",
                         "index", "N524288 D768 B256 g16"),
    "topk_segmax_int4": ("rag_docvqa_tpu_torch/csrc/topk_segmax.cu", "rag_docvqa_tpu/ops/quant.py:246",
                         "index", "N524288 D768 B256 g16"),
    "bert_gemm": ("rag_docvqa_tpu_torch/csrc/bert_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:67",
                  "embed", "fc1 65536x1536x384 bias_gelu bf16"),
    "bert_layer_norm": ("rag_docvqa_tpu_torch/csrc/bert_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:67",
                        "embed", "65536x384 bf16"),
    "bert_gemm_bwd": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:679",
                      "contrastive", "nn mul_f32 16384x1536x384 bf16"),
    "bert_ln_bwd": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:679",
                    "contrastive", "16384x384 bf16"),
    "bert_col_sum": ("rag_docvqa_tpu_torch/csrc/bert_layer_bwd.cu", "rag_docvqa_tpu/ops/fused_encoder_bwd.py:800",
                     "contrastive", "16384x1536 f32"),
}
# the kernels each path launches
SERVE_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "decode_cross_attention")
TRAIN_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "flash_bwd", "t5_gemm_bwd", "t5_rms_bwd")
INDEX_KERNELS = ("topk_fused", "topk_segmax", "topk_segmax_int8", "topk_segmax_int4")
EMBED_KERNELS = ("bert_gemm", "bert_layer_norm", "flash_fwd")  # K9
CONTRASTIVE_KERNELS = EMBED_KERNELS + ("flash_bwd", "t5_gemm_bwd", "bert_gemm_bwd", "bert_ln_bwd", "bert_col_sum")  # + K10


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    """Bytes of the given tensors, each counted once (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(io_bytes: float, ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its peak rate for their type."""
    by_bytes, by_ops = io_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def op_type(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}[dtype]


def tol(dtype: torch.dtype, want: torch.Tensor) -> float:
    """The limit on max abs error: F32_TOL for f32 math, BF16_REL_TOL of the
    largest reference value (at least 1) for bf16."""
    if dtype == torch.float32:
        return F32_TOL
    return BF16_REL_TOL * max(want.float().abs().max().item(), 1.0)


def rel_tol(dtype: torch.dtype, want: torch.Tensor) -> float:
    """F32_TOL (f32) or BF16_REL_TOL (bf16) times max(1, max|ref|): the
    training checks, whose gradients sum over thousands of rows."""
    return (F32_TOL if dtype == torch.float32 else BF16_REL_TOL) * max(want.float().abs().max().item(), 1.0)


def check_launched(launches: dict, names, path: str) -> None:
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the {path} path never launched: {missing}")


class Checks:
    """Worst error per checked unit (each kernel, and `t5_layer`, the whole
    layer K1 composes from three of them) and every timed case."""

    def __init__(self):
        self.err = {}
        self.times = {}  # unit -> {case label: {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}}

    def compare(self, unit: str, label: str, got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{unit} {label}: non-finite values")
        err = (got - want).abs().max().item()
        log(f"  {unit:24s} {label:44s} max_abs_err {err:.3e}  (limit {limit:.1e}, max|ref| {want.abs().max().item():.3g})")
        if not err <= limit:
            raise AssertionError(f"{unit} {label}: max abs error {err} above {limit}")
        self.err[unit] = max(self.err.get(unit, 0.0), err)
        return err

    def timed(self, unit: str, label: str, fn, plain, iters: int = 10, library=None, io_bytes=None, ops=0.0,
              ops_in: str = "f32") -> None:
        """Times `fn` against `plain` and, when given, against `library`
        (one PyTorch call for the same function); `io_bytes` (every input
        read once, every output written once) and `ops` of type `ops_in`
        give the bound."""
        row = {"ms": time_ms(fn, iters), "plain_ms": time_ms(plain, iters),
               "library_ms": None if library is None else time_ms(library, iters)}
        text = f"kernel {row['ms']:.4f} ms   plain {row['plain_ms']:.4f} ms"
        if library is not None:
            text += f"   library {row['library_ms']:.4f} ms"
        if io_bytes is not None:
            row["bound_ms"], row["bound_by"] = bound(io_bytes, ops, ops_in)
            text += f"   bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        self.times.setdefault(unit, {})[label] = row
        log(f"  {unit:24s} {label:44s} {text}")


# --------------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #
def check_kernels(checks: Checks, g: torch.Generator) -> None:
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.ops import decode_attention as da
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    # ---- K2 flash attention ----
    def flash_case(B, T, H, Hkv, dh, dtype, bias_kind, causal, scale, mask_value, lens, label, timed=False):
        q = randn(B, T, H, dh).to(dtype)
        k, v = randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
        mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias = None
        if bias_kind:
            bias = randn(B if bias_kind == "batched" else 1, H, T, T).to(torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
        got, glse = fa.flash_attention_fwd(q, k, v, mask, bias, scale, causal, mask_value)
        want, wlse = fa.flash_attention_reference(q, k, v, mask, bias, scale, causal, mask_value)
        checks.compare("flash_fwd", f"{label} out", got, want, tol(dtype, want))
        alive = wlse > mask_value / 2  # rows with a valid key; the out check covers the rest
        # lse is f32 in both; its bf16 limit scales with the bf16 inputs' scores
        checks.compare("flash_fwd", f"{label} lse", glse[alive], wlse[alive], tol(dtype, wlse[alive]))
        if timed:
            # the one library call: SDPA with the bias and the key mask summed
            # into one additive (B, H, T, T) mask beforehand (the kernel
            # streams the shared bias instead); it returns no lse
            add = (bias.float() + torch.where(mask, 0.0, mask_value)[:, None, None, :]).to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            checks.timed("flash_fwd", label, lambda: fa.flash_attention_fwd(q, k, v, mask, bias, scale, causal, mask_value),
                         lambda: fa.flash_attention_reference(q, k, v, mask, bias, scale, causal, mask_value),
                         library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale),
                         io_bytes=nbytes(q, k, v, mask, bias, got, glse), ops=4.0 * B * H * T * T * dh,
                         ops_in=op_type(dtype))

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        flash_case(3, 77, 4, 2, 40, dtype, "batched", True, 0.5, fa.NEG_INF, [77, 50, 0], f"ragged gqa causal {tag}")
        flash_case(3, 77, 4, 4, 128, dtype, "shared", False, 1.0, fe.T5_MASK_VALUE, [77, 30, 0], f"ragged dh128 t5-mask {tag}")
        flash_case(32, 512, 12, 12, 64, dtype, "shared", False, 1.0, fe.T5_MASK_VALUE,
                   [512 - 13 * i for i in range(32)], f"B32 H12 T512 dk64 shared bias {tag}", timed=dtype == torch.bfloat16)

    # ---- K1 parts and the whole layer ----
    cfg = t5m.T5Config()
    d, inner, dff = cfg.d_model, cfg.inner_dim, cfg.d_ff
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for M, label in ((77, "ragged"), (32 * 512, "B32 T512")):
            x = randn(M, d).to(dtype)
            w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
            got, want = fe.rms_norm_rows(x, w, cfg.layer_norm_eps), rms_norm(x, w, cfg.layer_norm_eps)
            checks.compare("t5_rms_norm", f"{label} d768 {tag}", got, want, tol(dtype, want))
            if M > 77 and dtype == torch.bfloat16:
                checks.timed("t5_rms_norm", f"{label} d768 {tag}", lambda: fe.rms_norm_rows(x, w, 1e-6),
                             lambda: rms_norm(x, w, 1e-6), library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                             io_bytes=nbytes(x, w, got), ops=4.0 * M * d)
        for (M, N, K, epi), label in (((77, 100, 72, "relu"), "ragged 77x100x72 relu"),
                                      ((77, 96, 64, "gelu_mul"), "ragged 77x96x64 gelu_mul"),
                                      ((16384, 3 * inner, d, "none"), "qkv 16384x2304x768"),
                                      ((16384, dff, d, "relu"), "ffn-in 16384x3072x768 relu"),
                                      ((16384, d, dff, "residual"), "ffn-out 16384x768x3072 residual")):
            a = randn(M, K).to(dtype)
            w = (randn(N, K) * K**-0.5).to(dtype)
            aux = randn(M, N).to(dtype) if epi in ("residual", "gelu_mul") else None
            got, want = fe.gemm(a, w, epi, aux), fe.gemm_reference(a, w, epi, aux)
            checks.compare("t5_gemm", f"{label} {tag}", got, want, tol(dtype, want))
            if M == 16384 and dtype == torch.bfloat16:
                library = {"none": lambda: torch.matmul(a, w.t()),
                           "residual": lambda: torch.addmm(aux, a, w.t())}.get(epi)  # relu: no single call
                checks.timed("t5_gemm", f"{label} {tag}", lambda: fe.gemm(a, w, epi, aux),
                             lambda: fe.gemm_reference(a, w, epi, aux), library=library,
                             io_bytes=nbytes(a, w, aux, got), ops=2.0 * M * N * K, ops_in=op_type(dtype))

    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = fe.fuse_t5_blocks(params.encoder.layers, False)[0]
    pos = torch.arange(512)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    lens = torch.tensor([512 - 13 * i for i in range(32)], device=dev)
    mask = torch.arange(512, device=dev)[None, :] < lens[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.to(dtype) for k, v in layer.items()}
        x = randn(32, 512, d).to(dtype)
        kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
        got = fe.fused_t5_layer_parts(x, mask, bias, l, **kw)
        want = fe.t5_layer_reference(x, mask, bias, l, **kw)
        # K1 = rms_norm + gemm + flash_fwd, against the plain layer
        checks.compare("t5_layer", f"B32 T512 t5-base {tag}", got, want, tol(dtype, want))
        if dtype == torch.bfloat16:
            checks.timed("t5_layer", f"B32 T512 t5-base {tag}", lambda: fe.fused_t5_layer_parts(x, mask, bias, l, **kw),
                         lambda: fe.t5_layer_reference(x, mask, bias, l, **kw), iters=5)
    del params

    # ---- K3 decode cross-attention ----
    for kv_dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.int8, "int8")):
        for B, H, dk, Te, label in ((3, 4, 40, 77, "ragged"), (32, 12, 64, 512, "B32 H12 dk64 Te512")):
            q = randn(B, H, dk)
            k, v = randn(B, H, Te, dk), randn(B, H, Te, dk)
            ks = vs = None
            if kv_dtype == torch.int8:
                k, ks = t5m._quantize_kv(k)
                v, vs = t5m._quantize_kv(v)
                ks, vs = ks[:, :, 0, :], vs[:, :, 0, :]
            else:
                k, v = k.to(kv_dtype), v.to(kv_dtype)
            k2, v2 = da.pack_decode_kv(k, v)
            m = torch.arange(Te, device=dev)[None, :] < torch.randint(1, Te + 1, (B,), generator=g, device=dev)[:, None]
            got = da.fused_cross_attention(q, k2, v2, m, ks, vs)
            qs = q if ks is None else q * ks
            want = da.cross_attention_reference(qs, k2, v2, m)
            if vs is not None:
                want = (want.view(B, H, dk) * vs).reshape(B, H * dk)
            # f32 math on the stored values in both: the f32 limit holds for every cache dtype
            checks.compare("decode_cross_attention", f"{label} {tag} cache", got, want, F32_TOL)
            if B == 32 and kv_dtype != torch.float32:
                checks.timed("decode_cross_attention", f"{label} {tag} cache",
                             lambda: da.fused_cross_attention(q, k2, v2, m, ks, vs),
                             lambda: da.cross_attention_reference(qs, k2, v2, m),
                             io_bytes=nbytes(q, k2, v2, m, ks, vs, got), ops=4.0 * B * H * Te * dk)


# --------------------------------------------------------------------------- #
# phase 4: the full-width f32 stack
# --------------------------------------------------------------------------- #
def check_stack(g: torch.Generator) -> None:
    from dataclasses import replace

    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe
    from rag_docvqa_tpu_torch.ops.decode import greedy_decode

    dev = g.device
    cfg = t5m.T5Config()
    params = t5m.init_t5_params(g, cfg)
    B, T = 8, 512
    x = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512, 500, 431, 300, 257, 128, 64, 9], device=dev)[:, None]
    t0 = time.perf_counter()
    enc = t5m.encode(params, cfg, x, mask)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    ref = x
    for l in fe.fuse_t5_blocks(params.encoder.layers, False):
        ref = fe.t5_layer_reference(ref, mask, bias, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    ref = rms_norm(ref, params.encoder.final_ln, cfg.layer_norm_eps)
    err = (enc - ref).abs().max().item()
    log(f"  encode f32 t5-base B8 T512 (12 layers) kernels vs plain stack: max_abs_err {err:.3e} "
        f"(limit {F32_TOL:.0e}), max|ref| {ref.abs().max().item():.3g}, {enc_s * 1e3:.1f} ms")
    if not err <= F32_TOL:
        raise AssertionError(f"full-width encode differs from the plain stack by {err}")
    # the bf16 cache: the encoder output in bf16 under the f32 weights, so the
    # cache (and K3's loads) are bf16 while the attention math stays f32
    for cache, hidden in (("f32", enc), ("bf16", enc.bfloat16()), ("int8", enc)):
        ids = {}
        for fused in (False, True):
            c = replace(cfg, decode_kv_int8=cache == "int8", fused_decode_attn=fused)
            toks, conf = greedy_decode(params, c, hidden, mask, max_new_tokens=16)
            if not torch.isfinite(conf).all():
                raise AssertionError("non-finite confidence")
            ids[fused] = toks.cpu()
        same = torch.equal(ids[False], ids[True])
        log(f"  greedy decode 16 steps, {cache} cache: ids identical with the decode kernel "
            f"on and off: {same}")
        if not same:
            raise AssertionError("decoded ids differ with fused_decode_attn on and off")


# --------------------------------------------------------------------------- #
# phase 5: the main path through the engine
# --------------------------------------------------------------------------- #
def serve(g: torch.Generator):
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.metrics.anls import anls
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    # configs/RAGVT5.yml: t5-base widths, chunk_num 10, chunk_size 60,
    # overlap 10, max_source_length 512; 16 new tokens here
    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    t0 = time.perf_counter()
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    log(f"  host ingest of 3 x 32 docs (8 pages x 120 words): {time.perf_counter() - t0:.3f} s, caps {ingestor.caps}")
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok)
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        wall = time.perf_counter() - t0
        results.append((out, aux, wall))
    launches = dict(kernels.LAUNCHES)

    for i, (out, aux, wall) in enumerate(results):
        t = out["timings"]
        conf = out["confidences"]
        if len(out["pred_answers"]) != 32 or not all(math.isfinite(c) and 0.0 < c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"batch {i}: bad answers or confidences {conf}")
        score = sum(max(anls(a, p) for a in gold) for gold, p in zip(aux["answers"], out["pred_answers"])) / 32
        log(f"  batch {i}: {wall * 1e3:.1f} ms wall incl. host->device copy and detokenize; "
            f"retrieve+assemble {t['retrieve_assemble_s'] * 1e3:.2f} ms, encode {t['encode_s'] * 1e3:.2f} ms, "
            f"decode {t['decode_s'] * 1e3:.2f} ms; ANLS {score:.4f} (random weights)")
    log(f"  launches in the two served batches: {launches}")
    check_launched(launches, SERVE_KERNELS, "serving")
    return launches


# --------------------------------------------------------------------------- #
# phase 6: the training path
# --------------------------------------------------------------------------- #
def kernel_relu_masks(x1s, ln1s, wis, eps):
    """The ReLU decisions the kernels' backward takes in each layer: the
    sign of the pre-activation rms(x1) . Wi^T as csrc/t5_layer_bwd.cu
    recomputes it. ReLU's derivative is a step, so where the kernel and a
    plain f32 GEMM, summing in another order, round a pre-activation within
    ~1e-6 of zero to opposite signs, a gradient differs by a whole term; the
    gradient checks give the plain reference these decisions, so they measure
    the arithmetic, and count the positions where the plain signs differ."""
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    masks = []
    for x1, ln1, wi in zip(x1s, ln1s, wis):
        h2 = fe.rms_norm_rows(x1.reshape(-1, x1.shape[-1]).contiguous(), ln1.to(x1.dtype), eps)
        zeros = torch.zeros((h2.shape[0], wi.shape[0]), dtype=h2.dtype, device=h2.device)
        masks.append(fe.gemm_bwd(h2, wi.to(h2.dtype), "nt", "relu_bwd", zeros)[1] > 0)
    return masks


class MaskedRelu:
    """Plain GEMMs whose ReLU takes the given decisions, one mask per layer
    in order; counts where the plain pre-activation's sign differs."""

    def __init__(self, masks):
        self.masks, self.flips = iter(masks), 0

    def _mask(self, pre):
        m = next(self.masks)
        self.flips += int(((pre > 0) != m).sum())
        return m

    def gemm(self, a, w, epilogue="none", aux=None):
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        if epilogue != "relu":
            return fe.gemm_reference(a, w, epilogue, aux)
        pre = torch.matmul(a.float(), w.float().t())
        return torch.where(self._mask(pre), pre, 0.0).to(a.dtype)

    def gemm_bwd(self, a, b, layout, epilogue, aux0=None, aux1=None, acc=None):
        from rag_docvqa_tpu_torch.ops import fused_encoder as fe

        if epilogue != "relu_bwd":
            return fe.gemm_bwd_reference(a, b, layout, epilogue, aux0, aux1, acc)
        pre = torch.matmul(a.float(), b.float().t())
        m = self._mask(pre)
        return torch.where(m, aux0.float(), 0.0).to(a.dtype), torch.where(m, pre, 0.0).to(a.dtype)


def check_flash_bwd(checks: Checks, g: torch.Generator) -> None:
    """6a: K6 against its plain version, both from the same forward."""
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    def case(B, T, H, Hkv, dh, dtype, bias_kind, causal, scale, mask_value, lens, label, timed=False):
        q, do = randn(B, T, H, dh).to(dtype), randn(B, T, H, dh).to(dtype)
        k, v = randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
        mask = torch.arange(T, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias = None
        if bias_kind:
            bias = randn(B if bias_kind == "per-batch" else 1, H, T, T).to(
                torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
        args = (mask, bias, scale, causal, mask_value)
        out, lse = fa.flash_attention_reference(q, k, v, *args)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args)
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            if b is not None:
                checks.compare("flash_bwd", f"{label} {name}", a, b, rel_tol(dtype, b))
        if timed:  # five products of 2*T*T*dh each per head
            checks.timed("flash_bwd", label, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *args),
                         lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args),
                         io_bytes=nbytes(q, k, v, out, lse, do, mask, bias, *got), ops=10.0 * B * H * T * T * dh,
                         ops_in=op_type(dtype))

    t5m = fe.T5_MASK_VALUE
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        case(3, 77, 4, 2, 40, dtype, "per-batch", True, 0.5, fa.NEG_INF, [77, 50, 0], f"ragged gqa causal per-batch {tag}")
        case(3, 77, 4, 4, 128, dtype, "shared", False, 1.0, t5m, [77, 30, 0], f"ragged dh128 shared t5-mask {tag}")
        case(2, 45, 4, 1, 64, dtype, None, False, 1.0, fa.NEG_INF, [45, 0], f"ragged gqa4 no bias {tag}")
        case(2, 45, 4, 4, 64, dtype, None, True, 1.0, t5m, [45, 20], f"ragged causal t5-mask no bias {tag}")
        case(8, 512, 12, 12, 64, dtype, "shared", False, 1.0, t5m, [512 - 40 * i for i in range(8)],
             f"B8 H12 T512 dk64 shared bias t5-mask {tag}", timed=dtype == torch.bfloat16)


def check_layer_bwd(checks: Checks, g: torch.Generator) -> None:
    """6b: the backward GEMM and norm kernels, K7 and K8 against their plain
    versions, and T5LayerTrain's whole-layer gradient against autograd."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    cfg = t5m.T5Config()
    d, dff, H, eps = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.layer_norm_eps
    R = 8 * 512
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for (layout, epi, M, N, K), label in (
                (("nt", "relu_bwd", 77, 96, 64), "ragged nt relu_bwd 77x96x64"),
                (("nt", "gelu_bwd", 77, 96, 64), "ragged nt gelu_bwd 77x96x64"),
                (("nn", "store", 77, 96, 64), "ragged nn 77x96x64"),
                (("nn", "acc_f32", 77, 96, 64), "ragged nn acc_f32 77x96x64"),
                (("tn", "store_f32", 96, 64, 77), "ragged tn 96x64 over 77 rows"),
                (("nt", "relu_bwd", R, dff, d), f"nt relu_bwd {R}x{dff}x{d}"),
                (("nn", "store_f32", R, d, dff), f"nn dh2 {R}x{d}x{dff} f32-out"),
                (("tn", "store_f32", dff, d, R), f"tn dWi {dff}x{d} over {R} rows")):
            a = randn(K, M) if layout == "tn" else randn(M, K)
            b = randn(N, K) if layout == "nt" else randn(K, N)
            a, b = a.to(dtype), (b * K**-0.5).to(dtype)
            n_aux = {"relu_bwd": 1, "gelu_bwd": 2}.get(epi, 0)
            aux = [randn(M, N).to(dtype) for _ in range(n_aux)]
            acc0 = randn(M, N) if epi == "acc_f32" else None  # both add into a copy of one f32 start
            got = fe.gemm_bwd(a, b, layout, epi, *aux, acc=None if acc0 is None else acc0.clone())
            outs = got if isinstance(got, tuple) else (got,)
            want = fe.gemm_bwd_reference(a, b, layout, epi, *aux, acc=None if acc0 is None else acc0.clone())
            if epi == "relu_bwd":
                # dpre follows the kernel's own sign decision (see kernel_relu_masks)
                checks.compare("t5_gemm_bwd", f"{label} {tag} dpre", got[0],
                               torch.where(got[1] > 0, aux[0], torch.zeros_like(aux[0])), 0.0)
                got, want = got[1], want[1]
            for i, (x, y) in enumerate(zip(got, want) if isinstance(got, tuple) else [(got, want)]):
                checks.compare("t5_gemm_bwd", f"{label} {tag} out{i}", x, y, tol(dtype, y))
            if not label.startswith("ragged") and dtype == torch.bfloat16:
                # the bare products have a library call (its output is bf16, the kernel's f32)
                library = {("nn", "store_f32"): lambda: torch.matmul(a, b),
                           ("tn", "store_f32"): lambda: torch.matmul(a.t(), b)}.get((layout, epi))
                checks.timed("t5_gemm_bwd", f"{label} {tag}", lambda: fe.gemm_bwd(a, b, layout, epi, *aux),
                             lambda: fe.gemm_bwd_reference(a, b, layout, epi, *aux), library=library,
                             io_bytes=nbytes(a, b, *aux, *outs), ops=2.0 * M * N * K, ops_in=op_type(dtype))
        for rows, label in ((77, "77x768"), (R, f"{R}x768")):
            x, resid, dh = randn(rows, d).to(dtype), randn(rows, d).to(dtype), randn(rows, d)
            w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
            got, want = fe.rms_norm_bwd(x, dh, w, resid, eps), fe.rms_norm_bwd_reference(x, dh, w, resid, eps)
            checks.compare("t5_rms_bwd", f"{label} {tag} dx", got[0], want[0], tol(dtype, want[0]))
            checks.compare("t5_rms_bwd", f"{label} {tag} dw", got[1], want[1], rel_tol(dtype, want[1]))
            if rows == R and dtype == torch.bfloat16:
                checks.timed("t5_rms_bwd", f"{label} {tag}", lambda: fe.rms_norm_bwd(x, dh, w, resid, eps),
                             lambda: fe.rms_norm_bwd_reference(x, dh, w, resid, eps),
                             io_bytes=nbytes(x, dh, w, resid, *got), ops=10.0 * rows * d)

    params = t5m.init_t5_params(g, t5m.T5Config(num_encoder_layers=1, num_decoder_layers=1))
    layer = fe.fuse_t5_blocks(params.encoder.layers, False)[0]
    layer["ln0"] = torch.rand(d, generator=g, device=dev) + 0.5
    layer["ln1"] = torch.rand(d, generator=g, device=dev) + 0.5
    B, T = 8, 512
    pos = torch.arange(T)
    bias = t5m.relative_bias(params.encoder.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512 - 40 * i for i in range(B)], device=dev)[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.detach().to(dtype) for k, v in layer.items()}
        x, x1, dy = randn(B, T, d).to(dtype), randn(B, T, d).to(dtype), randn(B, T, d).to(dtype)
        ffn = (x1, dy, l["ln1"], (l["wi"], l["wof"]))
        got = fe.t5_ffn_bwd(*ffn, eps=eps, gated=False)
        relu = MaskedRelu(kernel_relu_masks([x1], [l["ln1"]], [l["wi"]], eps))
        want = fe._ffn_bwd(*ffn, eps, False, rms_norm, fe.gemm_reference, relu.gemm_bwd, fe.rms_norm_bwd_reference)
        log(f"  ReLU signs where the plain f32 GEMM and the kernel differ, K7 {tag}: {relu.flips}")
        for name, a, b in zip(("dx1", "dln1", "dwi", "dwof"), (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
            checks.compare("t5_ffn_bwd", f"B8 T512 t5-base {tag} {name}", a, b, rel_tol(dtype, b))
        att = (x, dy, mask, bias, l["wqkv"], l["wo"], l["ln0"])
        got, want = fe.t5_attn_bwd(*att, num_heads=H, eps=eps), fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps)
        for name, a, b in zip(("dx", "dln0", "dwqkv", "dwo", "dbias"), got, want):
            checks.compare("t5_attn_bwd", f"B8 T512 t5-base {tag} {name}", a, b, rel_tol(dtype, b))
        if dtype == torch.bfloat16:
            checks.timed("t5_ffn_bwd", f"B8 T512 t5-base {tag}", lambda: fe.t5_ffn_bwd(*ffn, eps=eps, gated=False),
                         lambda: fe.t5_ffn_bwd_reference(*ffn, eps=eps, gated=False), iters=5)
            checks.timed("t5_attn_bwd", f"B8 T512 t5-base {tag}", lambda: fe.t5_attn_bwd(*att, num_heads=H, eps=eps),
                         lambda: fe.t5_attn_bwd_reference(*att, num_heads=H, eps=eps), iters=5)

    # the whole layer, f32 with an f32 bias: T5LayerTrain against autograd
    l = {k: v.detach().float().requires_grad_() for k, v in layer.items()}
    b32 = bias.float().requires_grad_()
    x = randn(B, T, d).requires_grad_()
    cot = randn(B, T, d)
    kw = dict(num_heads=H, eps=eps, gated=False)
    ins = [x, b32] + [l[k] for k in fe.layer_keys(False)]
    got = torch.autograd.grad(fe.t5_layer_train(x, mask, b32, l, **kw), ins, cot)
    with torch.no_grad():
        _, x1 = fe.fused_t5_layer_parts(x, mask, b32, l, **kw, save_x1=True)
    relu = MaskedRelu(kernel_relu_masks([x1], [l["ln1"]], [l["wi"]], eps))
    ref = fe._t5_layer(x, mask, b32, l, H, eps, False, rms_norm, relu.gemm, fa.flash_attention_reference)
    want = torch.autograd.grad(ref, ins, cot)
    log(f"  ReLU signs where the plain f32 GEMM and the kernel differ, whole layer: {relu.flips}")
    for name, a, b in zip(["x", "bias", *fe.layer_keys(False)], got, want):
        checks.compare("t5_layer_train", f"B8 T512 t5-base f32 d{name}", a, b, rel_tol(torch.float32, b))


def check_encoder_grad(g: torch.Generator) -> float:
    """6c: the full-width f32 12-layer encoder gradient through the kernels
    against autograd of the plain stack; returns the worst error relative
    to each gradient's largest value."""
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models.layers import rms_norm
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    cfg = t5m.T5Config(num_decoder_layers=1)
    params = t5m.init_t5_params(g, cfg)
    enc = params.encoder
    enc.requires_grad_(True)
    B, T = 2, 512
    x = torch.randn((B, T, cfg.d_model), generator=g, device=dev).requires_grad_()
    cot = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < torch.tensor([512, 300], device=dev)[:, None]
    names = ["x"] + [n for n, _ in enc.named_parameters()]
    ins = [x] + list(enc.parameters())
    t0 = time.perf_counter()
    got = torch.autograd.grad(t5m.encode(params, cfg, x, mask, train=True), ins, cot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3

    pos = torch.arange(T)
    bias = t5m.relative_bias(enc.rel_bias, pos, pos, True, cfg)[0].to(torch.bfloat16).contiguous()
    layers = fe.fuse_t5_blocks(enc.layers, False)
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, gated=False)
    x1s, h = [], x.detach()
    with torch.no_grad():  # the kernels' forward, for their ReLU decisions
        for l in layers:
            h, x1 = fe.fused_t5_layer_parts(h, mask, bias.detach(), l, **kw, save_x1=True)
            x1s.append(x1)
    relu = MaskedRelu(kernel_relu_masks(x1s, [l["ln1"] for l in layers], [l["wi"] for l in layers],
                                        cfg.layer_norm_eps))
    del x1s
    h = x
    for l in layers:
        h = fe._t5_layer(h, mask, bias, l, cfg.num_heads, cfg.layer_norm_eps, False, rms_norm, relu.gemm,
                         fa.flash_attention_reference)
    want = torch.autograd.grad(rms_norm(h, enc.final_ln, cfg.layer_norm_eps), ins, cot)
    log(f"  ReLU signs where the plain f32 GEMM and the kernels differ, 12 layers: {relu.flips}")
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, got, want):
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        # the rel-pos table's gradient comes through the bf16 bias in both
        limit = BF16_REL_TOL if name == "rel_bias" else F32_TOL
        if not (math.isfinite(rel) and rel <= limit):
            raise AssertionError(f"encoder gradient {name}: {rel:.3e} of its largest value, above {limit}")
        if name != "rel_bias" and rel > worst:
            worst, worst_name = rel, name
    log(f"  encoder gradient f32 t5-base B2 T512 (12 layers) kernels vs autograd of the plain stack: worst "
        f"{worst:.3e} of the largest value ({worst_name}; limit {F32_TOL:.0e}), {ms:.1f} ms forward+backward")
    return worst


def train(g: torch.Generator, steps: int = 8):
    """6d: t5-base VT5 train steps on one repeated batch, bf16 compute."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps, to_device
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    dev = g.device
    # configs/RAGVT5.yml: t5-base widths, chunk_num 10, chunk_size 60,
    # overlap 10, max_source_length 512, lr 2e-4, batch_size 8
    ingestor = DocVQAIngestor(HashTokenizer(32128), ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(8, n_pages=8, words_per_page=120, seed=SEED)
    ingestor.caps = ingestor.plan_caps(docs)
    batch, aux = ingestor.ingest(docs)
    batch = to_device(batch, dev)
    labels = torch.from_numpy(ingestor.answer_labels(aux["answers"], max_len=32, seed=SEED)).to(dev)
    vt5_cfg = vt5m.VT5Config()
    params = vt5m.init_vt5_params(g, vt5_cfg)  # f32 masters
    rag = RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0, max_source_length=512)
    # one batch an epoch for the yml's 10 epochs; warmup 2 steps, not 1000
    opt = build_optimizer(lr=2e-4, warmup_steps=2, total_steps=10 * steps,
                          mask=trainable_mask(params, ("t5", "spatial")))
    state = TrainState.create(params, opt)
    step = make_train_step(vt5_cfg, rag, opt, bf16_compute=True)

    kernels.reset_launch_counts()
    rows = []
    for i in range(steps):
        ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
        t0 = time.perf_counter()
        ev["start"].record()
        state, m = step(state, batch, labels, mark=lambda n: ev[n].record())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        row = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "wall_ms": wall,
               "forward_ms": ev["start"].elapsed_time(ev["forward"]),
               "backward_ms": ev["forward"].elapsed_time(ev["backward"]),
               "update_ms": ev["backward"].elapsed_time(ev["update"])}
        rows.append(row)
        log(f"  step {i + 1}: loss {row['loss']:.4f}, grad norm {row['grad_norm']:.4f}, {wall:.1f} ms "
            f"(forward {row['forward_ms']:.1f}, backward {row['backward_ms']:.1f}, update {row['update_ms']:.1f})")
    launches = dict(kernels.LAUNCHES)
    log(f"  launches in the {steps} train steps: {launches}")
    check_launched(launches, TRAIN_KERNELS, "training")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError("non-finite loss or grad norm")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"the loss did not fall on the repeated batch: {[r['loss'] for r in rows]}")
    steady = rows[1:]  # the first step also warms the allocator
    mean = lambda k: sum(r[k] for r in steady) / len(steady)
    summary = {"ms": mean("wall_ms"), "forward_ms": mean("forward_ms"), "backward_ms": mean("backward_ms"),
               "update_ms": mean("update_ms"), "losses": [r["loss"] for r in rows],
               "case": f"t5-base VT5 B8 T512 bf16 compute, mean of steps 2-{steps}"}
    log(f"  mean of steps 2-{steps}: {summary['ms']:.1f} ms per step (forward {summary['forward_ms']:.1f}, "
        f"backward {summary['backward_ms']:.1f}, update {summary['update_ms']:.1f})")
    return launches, summary

# --------------------------------------------------------------------------- #
# phase 7: the corpus index
# --------------------------------------------------------------------------- #
INDEX_N, INDEX_D, INDEX_B, INDEX_K = 524288, 768, 256, 10  # the path's shape


def check_index_kernels(checks: Checks, g: torch.Generator) -> dict:
    """7a: K4, K5, K11 and K12 against their plain versions; returns the
    whole-function times on both sides of the batch crossover."""
    from rag_docvqa_tpu_torch.ops import quant, topk

    dev = g.device
    whole = {}

    def case(N, n_valid, D, B, k, label, dups=(), timed=False, int_kernels=True, dtypes=("f32", "bf16")):
        x = torch.randn((N, D), generator=g, device=dev)
        for src, dst in dups:
            x[dst] = x[src]
        x = topk.l2_normalize(x)
        x[n_valid:] = 0.0
        q = torch.randn((B, D), generator=g, device=dev)
        if dups:
            q[0] = x[dups[0][0]]
        q = topk.l2_normalize(q)
        valid_rows = torch.arange(N, device=dev)[None, :] < n_valid
        flops = 2.0 * N * D * B

        for tag in dtypes:
            index = x if tag == "f32" else x.bfloat16()
            name = f"{label} {tag}"
            scores = torch.where(valid_rows, q @ index.float().t(), topk.NEG_INF)  # the plain (B, N) matrix
            # ---- K4
            vals, idx = topk.fused_topk(index, q, n_valid, k)
            want_v, want_i = topk.fused_topk_reference(index, q, n_valid, k)
            checks.compare("topk_fused", f"{name} values", vals, want_v, F32_TOL)
            live = want_v > topk.NEG_INF / 2
            if not bool(((idx >= 0) & (idx < max(n_valid, 1)))[live].all()):
                raise AssertionError(f"topk_fused {name}: an index outside the valid rows")
            srt = torch.sort(torch.where(live, idx, -1 - torch.arange(k, device=dev)[None, :].expand_as(idx)), dim=1)[0]
            if bool((srt[:, 1:] == srt[:, :-1]).any()):
                raise AssertionError(f"topk_fused {name}: a row returned twice")
            checks.compare("topk_fused", f"{name} scores at returned rows",
                           torch.where(live, scores.gather(1, idx.long()), vals), vals, F32_TOL)
            same = (idx == want_i)[live].float().mean().item() if bool(live.any()) else 1.0
            log(f"  {'topk_fused':24s} {name:44s} indices equal to the plain version's: {same:.6f}")
            # ---- K5
            for group, sgroups in ((8, 16), (16, 1)):
                seg, sup = topk.segment_max(index, q, n_valid, group, sgroups)
                want_seg, want_sup = topk.segment_max_reference(index, q, n_valid, group, sgroups)
                checks.compare("topk_segmax", f"{name} g{group} sg{sgroups} maxima", seg, want_seg, F32_TOL)
                if sgroups > 1:
                    checks.compare("topk_segmax", f"{name} g{group} sg{sgroups} supermaxima", sup, want_sup, F32_TOL)
            # the whole two-phase function: its values are exact scores of the rows it returns
            tv, ti, tok = topk.cosine_topk_twophase(index, q, n_valid, k, tile_n=512 if N % 2048 else 2048)
            checks.compare("topk_segmax", f"{name} two-phase values", tv, want_v, F32_TOL)
            checks.compare("topk_segmax", f"{name} two-phase scores at returned rows",
                           torch.where(tok, scores.gather(1, ti.long()), tv), tv, F32_TOL)
            if timed:
                elt = index.element_size()
                qd = q.to(index.dtype)
                library = lambda: torch.matmul(qd, index.t()).topk(k)  # its tie order is not the contract
                checks.timed("topk_fused", f"N{N} D{D} B{B} k{k} {tag}", lambda: topk.fused_topk(index, q, n_valid, k),
                             lambda: topk.fused_topk_reference(index, q, n_valid, k), library=library,
                             io_bytes=n_valid * D * elt + nbytes(q, vals, idx), ops=2.0 * n_valid * D * B)
                seg, sup = topk.segment_max(index, q, n_valid, 8, 16)
                checks.timed("topk_segmax", f"N{N} D{D} B{B} g8 sg16 {tag}",
                             lambda: topk.segment_max(index, q, n_valid, 8, 16),
                             lambda: topk.segment_max_reference(index, q, n_valid, 8, 16), library=library,
                             io_bytes=nbytes(index, q, seg, sup), ops=flops)
                whole[f"B{B} {tag}"] = {
                    "fused_ms": time_ms(lambda: topk.cosine_topk_fused(index, q, n_valid, k)),
                    "twophase_ms": time_ms(lambda: topk.cosine_topk_twophase(index, q, n_valid, k)),
                    "matmul_topk_ms": checks.times["topk_fused"][f"N{N} D{D} B{B} k{k} {tag}"]["library_ms"]}
                log(f"  whole functions at {name}: {whole[f'B{B} {tag}']}")
            del scores, index
        if not int_kernels:
            return
        # ---- K11, K12: exact
        q8, _ = quant.quantize_rows(q)
        for unit, build, segmax, segmax_ref, two, flat in (
                ("topk_segmax_int8", quant.quantize_rows, quant.segment_max_int8, quant.segment_max_int8_reference,
                 quant.cosine_topk_int8_twophase, quant.cosine_topk_int8),
                ("topk_segmax_int4", quant.quantize_rows_int4, quant.segment_max_int4,
                 quant.segment_max_int4_reference, quant.cosine_topk_int4_twophase, quant.cosine_topk_int4)):
            rows, scale = build(x)
            got = segmax(rows, scale, q8, n_valid, 16)
            checks.compare(unit, f"{label} g16 maxima (exact)", got, segmax_ref(rows, scale, q8, n_valid, 16), 0.0)
            gv, gi, gok = two(rows, scale, q, n_valid, k, tile_n=512 if N % 2048 else 2048)
            wv, wi, wok = flat(rows, scale, q, n_valid, k)
            checks.compare(unit, f"{label} two-phase values against flat (exact)", gv, wv, 0.0)
            if not (torch.equal(gi[wok], wi[wok]) and torch.equal(gok, wok)):
                raise AssertionError(f"{unit} {label}: two-phase indices differ from the flat function's")
            if timed:
                extra = {}
                if unit == "topk_segmax_int8" and B > 16:  # the library's int8 product alone, for scale
                    extra["int_mm_ms"] = time_ms(lambda: torch._int_mm(q8, rows.t()))
                    log(f"  {unit:24s} torch._int_mm of the same operands alone: {extra['int_mm_ms']:.4f} ms")
                checks.timed(unit, f"N{N} D{D} B{B} g16", lambda: segmax(rows, scale, q8, n_valid, 16),
                             lambda: segmax_ref(rows, scale, q8, n_valid, 16),
                             io_bytes=nbytes(rows, scale, q8, got), ops=flops, ops_in="int8")
                checks.times[unit][f"N{N} D{D} B{B} g16"].update(extra)
                whole.setdefault(f"B{B} {unit[12:]}", {})["twophase_ms"] = time_ms(
                    lambda: two(rows, scale, q, n_valid, k))
            del rows, scale

    dups = ((3, 7), (3, 130), (3, 1029))
    for B in (3, 20):
        case(1536, 1100, 64, B, 5, f"ragged N1536 valid1100 D64 B{B} k5", dups)
    case(1536, 0, 64, 20, 5, "ragged N1536 valid0 D64 B20 k5")
    case(1024, 1024, 32, 40, 48, "N1024 D32 B40 k48", dups[:2], int_kernels=False)
    N, D, k = INDEX_N, INDEX_D, INDEX_K
    case(N, N, D, INDEX_B, k, f"N{N} D{D} B{INDEX_B} k{k}", timed=True)
    torch.cuda.empty_cache()
    case(N, N, D, 8, k, f"N{N} D{D} B8 k{k}", timed=True)
    torch.cuda.empty_cache()
    return whole


def agreement(idx, want) -> float:
    """Mean share of each query's top-k rows that the reference also holds."""
    idx, want = torch.as_tensor(idx).cpu().long(), want.cpu().long()
    return (idx[:, :, None] == want[:, None, :]).any(dim=2).float().mean().item()


def refined_pipeline(index, batches) -> dict:
    """`refined_query_batches` over a few B 256 batches against the serial
    `cosine_topk_int4_refined` on each: equal results, and ms per batch of
    both on the host's clock (the pipelined one rescores batch i on the host
    while the device shortlists batch i+1)."""
    import numpy as np

    from rag_docvqa_tpu_torch.ops import quant

    k, kprime = INDEX_K, index.refine_kprime
    pairs = [(b, b.cpu().numpy()) for b in batches]
    common = dict(host_rows=index.host_rows, kprime=kprime, rows_normalized=True)

    def serial():
        return [quant.cosine_topk_int4_refined(index.embeddings, index.scales, b, index.n_valid, k, **common)
                for b, _ in pairs]

    def piped():
        return list(quant.refined_query_batches(index.embeddings, index.scales, pairs, index.n_valid, k, **common))

    want, got = serial(), piped()
    if len(got) != len(want):
        raise AssertionError(f"refined_query_batches gave {len(got)} results for {len(want)} batches")
    for i, (w, p) in enumerate(zip(want, got)):
        if not all(np.array_equal(a, b) for a, b in zip(w, p)):
            raise AssertionError(f"refined_query_batches: batch {i} differs from the serial refined query")
    times = {}
    for name, fn in (("serial", serial), ("pipelined", piped), ("pipelined", piped), ("serial", serial)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) / len(pairs) * 1e3)
    res = {"refined_serial_ms_per_batch": min(times["serial"]), "refined_pipelined_ms_per_batch": min(times["pipelined"])}
    log(f"  refined_query_batches over {len(pairs)} batches of {len(batches[0])}: equal to the serial refined query; "
        f"ms per batch serial {times['serial']}, pipelined {times['pipelined']}")
    return res


def index_path(g: torch.Generator) -> dict:
    """7b: build and query the resident index in every precision, as 1 and
    as 4 row ranges."""
    from rag_docvqa_tpu_torch.ops import topk
    from rag_docvqa_tpu_torch.parallel import ShardedIndex, single_device_query

    dev = g.device
    N, D, B, k = INDEX_N, INDEX_D, INDEX_B, INDEX_K
    emb = torch.randn((N, D), generator=g, device=dev)  # raw rows, as ShardedIndex.build takes them
    queries = torch.randn((B, D), generator=g, device=dev)
    want_v, want_i, _ = single_device_query(emb, queries, k)  # the plain f32 query
    scores = topk.l2_normalize(queries) @ topk.l2_normalize(emb).t()
    out = {}
    for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int4", True)):
        name = dtype + ("_refine" if refine else "")
        results = {}
        for n_shards in (1, 4):
            t0 = time.perf_counter()
            index = ShardedIndex.build(emb, n_shards=n_shards, dtype=dtype, refine=refine, kernel="auto")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            results[n_shards] = tuple(torch.as_tensor(a).to(dev) for a in index.query(queries, k))
        for a, b in zip(results[1], results[4]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: 1 and 4 row ranges give different results")
        vals, idx, valid = results[1]
        if not (bool(valid.all()) and bool(torch.isfinite(vals).all()) and vals.shape == (B, k)):
            raise AssertionError(f"{name}: bad values or validity")
        agree = agreement(idx, want_i)
        if dtype == "f32":
            err_v = (vals - want_v).abs().max().item()
            err_s = (scores.gather(1, idx.long()) - vals).abs().max().item()
            if not (err_v <= F32_TOL and err_s <= F32_TOL):
                raise AssertionError(f"f32 index: values off the plain query by {err_v}, from their rows' scores by {err_s}")
            log(f"  f32 index against the plain query: values max_abs_err {err_v:.3e}, returned rows' scores {err_s:.3e}")
        # queries per second at B 256, the host rescore included where there is one
        index.query(queries, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            index.query(queries, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        small = None
        if dtype in ("f32", "bf16"):  # at B 8 the dispatch takes the running-merge kernel
            sv = index.query(queries[:8], k)[0]
            if not (sv - vals[:8]).abs().max().item() <= F32_TOL:
                raise AssertionError(f"{name}: B 8 and B 256 disagree on the same queries")
            small = time_ms(lambda: index.query(queries[:8], k))
        out[name] = {"top10_agreement_with_f32": agree, "resident_bytes": index.resident_bytes, "build_s": build_s,
                     "query_ms_b256": ms, "queries_per_s_b256": B / ms * 1e3, "query_ms_b8": small}
        log(f"  {name:12s} resident {index.resident_bytes / 1e6:8.1f} MB, build {build_s:.2f} s, top-{k} agreement "
            f"with f32 {agree:.4f}, B{B} query {ms:.3f} ms = {B / ms * 1e3:.0f} queries/s"
            + ("" if small is None else f", B8 query {small:.3f} ms") + "; 1 and 4 row ranges identical")
        if refine:
            out[name].update(refined_pipeline(index, [torch.randn((B, D), generator=g, device=dev) for _ in range(4)]))
        del index
    if not out["f32"]["top10_agreement_with_f32"] >= 0.999:
        raise AssertionError("the f32 index disagrees with the plain f32 query")
    if not (out["int8"]["top10_agreement_with_f32"] >= 0.9 and out["int4_refine"]["top10_agreement_with_f32"] >= 0.95):
        raise AssertionError(f"agreement below the limits (int8 0.9, refined int4 0.95): {out}")
    return out


def index_cli() -> dict:
    """7c: `precompute index` then `precompute query`, the entry points."""
    import argparse
    import contextlib
    import io
    import tempfile

    import numpy as np

    from rag_docvqa_tpu_torch import precompute
    from rag_docvqa_tpu_torch.parallel import single_device_query

    model, dataset = os.path.join(REPO, "configs", "RAGVT5.yml"), os.path.join(REPO, "configs", "Synthetic.yml")
    question, k = "what is the invoice total?", 5

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            precompute.main(argv)
        return buf.getvalue().strip().splitlines()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus_index.npz")
        info = json.loads(run(["index", "-m", model, "-d", dataset, "--out", path, "n_val_docs=256", "n_pages=8",
                               "words_per_page=120"])[-1])
        log(f"  precompute index: {info}")
        data = np.load(path, allow_pickle=True)
        emb, meta = data["embeddings"], json.loads(str(data["meta"]))
        if not (emb.shape == (info["n_chunks"], 768) and len(meta) == len(emb) > 2048 and np.isfinite(emb).all()):
            raise AssertionError(f"bad index file: embeddings {emb.shape}, {len(meta)} meta rows")
        ranks = {}
        for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int8", True),
                              ("int4", True)):
            rows = [json.loads(l) for l in run(["query", "--index", path, "-m", model, "-q", question, "--k", str(k),
                                                "--index-dtype", dtype] + (["--refine"] if refine else []))]
            name = dtype + ("_refine" if refine else "")
            if [r["rank"] for r in rows] != list(range(k)) or not all(
                    math.isfinite(r["score"]) and {"question_id", "doc_idx", "page", "text"} <= set(r) for r in rows):
                raise AssertionError(f"precompute query {name}: bad rank lines {rows}")
            ranks[name] = [{f: r[f] for f in ("question_id", "doc_idx", "page", "text")} for r in rows]
        # the f32 ranks are those of the plain unsharded query with the same weights
        device, _, tokenizer, _, params = precompute._setup(argparse.Namespace(device="cuda", model=model, overrides=[]))
        with torch.inference_mode():
            q = precompute.embed_question(params.t5.shared, tokenizer, question, device)
            _, idx, _ = single_device_query(torch.from_numpy(emb).to(device), q, k)
        if ranks["f32"] != [meta[int(i)] for i in idx[0]]:
            raise AssertionError("precompute query f32: ranks differ from single_device_query")
        same = {name: sum(a == b for a, b in zip(r, ranks["f32"])) for name, r in ranks.items()}
        log(f"  precompute query, {len(emb)} chunks: every rank line parses; f32 ranks are single_device_query's; "
            f"ranks of {k} equal to f32's: {same}")
    return {"n_chunks": info["n_chunks"], "chunks_per_sec": info["chunks_per_sec"], "ranks_equal_to_f32_of_5": same}


# --------------------------------------------------------------------------- #
# phase 8: the BERT family
# --------------------------------------------------------------------------- #
BGE = dict(vocab_size=30522, hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536)  # bge-small
# the XLM-R-base cross-encoder width; the vocabulary is the engine tokenizer's
XLMR = dict(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, max_position_embeddings=514,
            type_vocab_size=1, position_offset=2, pad_id=1, num_labels=1)
# (tag, B, T, d, heads, d_ff): the shapes paths 1 and 2 give the layer
BERT_SHAPES = (("bge-small B1024 T64", 1024, 64, 384, 12, 1536), ("xlmr-base B320 T192", 320, 192, 768, 12, 3072))
EMBED_N, EMBED_B, BERT_T = 16384, 1024, 64  # path 1: chunks, chunks per batch, tokens per chunk
CONTRASTIVE_B = 256  # path 3: pairs per step


def random_bert_layer(g: torch.Generator, d: int, dff: int) -> dict:
    """One layer in the kernels' form with weights of unit-variance outputs,
    random biases and LayerNorm pairs (f32)."""
    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    ln = lambda: torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d) * 0.1])
    return {"wqkv": randn(3 * d, d) * d**-0.5, "bqkv": randn(3 * d) * 0.1, "wo": randn(d, d) * d**-0.5,
            "bo": randn(d) * 0.1, "ln1": ln(), "w1": randn(dff, d) * d**-0.5, "b1": randn(dff) * 0.1,
            "w2": randn(d, dff) * dff**-0.5, "b2": randn(d) * 0.1, "ln2": ln()}


def ragged_mask(B: int, T: int, dev) -> torch.Tensor:
    """Lengths from T down to 1 over the batch."""
    lens = torch.tensor([max(1, T - (i * 7) % T) for i in range(B)], device=dev)
    return torch.arange(T, device=dev)[None, :] < lens[:, None]


def check_bert_kernels(checks: Checks, g: torch.Generator) -> None:
    """8a: K9's parts and the whole layer against their plain versions."""
    import torch.nn.functional as F

    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        timed = dtype == torch.bfloat16
        gemm_cases = [((77, 100, 72, "bias"), "ragged 77x100x72 bias"),
                      ((77, 96, 64, "bias_gelu"), "ragged 77x96x64 bias_gelu"),
                      ((77, 96, 64, "bias_residual_f32"), "ragged 77x96x64 bias_residual_f32")]
        for _, B, T, d, _, dff in BERT_SHAPES:
            R = B * T
            gemm_cases += [((R, 3 * d, d, "bias"), f"qkv {R}x{3 * d}x{d} bias"),
                           ((R, dff, d, "bias_gelu"), f"fc1 {R}x{dff}x{d} bias_gelu"),
                           ((R, d, dff, "bias_residual_f32"), f"fc2 {R}x{d}x{dff} bias_residual_f32")]
        for (M, N, K, epi), label in gemm_cases:
            a, w, bias = randn(M, K).to(dtype), (randn(N, K) * K**-0.5).to(dtype), (randn(N) * 0.5).to(dtype)
            aux = randn(M, N).to(dtype) if epi == "bias_residual_f32" else None
            got, want = fe.gemm(a, w, epi, aux, bias), fe.gemm_reference(a, w, epi, aux, bias)
            checks.compare("bert_gemm", f"{label} {tag}", got, want, tol(dtype, want))
            if timed and M > 77:
                library = (lambda: torch.addmm(bias, a, w.t())) if epi == "bias" else None  # the others: no single call
                checks.timed("bert_gemm", f"{label} {tag}", lambda: fe.gemm(a, w, epi, aux, bias),
                             lambda: fe.gemm_reference(a, w, epi, aux, bias), library=library,
                             io_bytes=nbytes(a, w, bias, aux, got), ops=2.0 * M * N * K, ops_in=op_type(dtype))
            del a, w, aux, got, want
        for R, d in [(77, 64)] + [(B * T, d) for _, B, T, d, _, _ in BERT_SHAPES]:
            y, ln = randn(R, d) * 3.0 + 0.5, torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(dtype)
            y[0] = 2.0  # a constant row: variance 0 under eps 1e-12
            got, want = fe.layer_norm_rows(y, ln, 1e-12, dtype), fe.layer_norm_reference(y, ln, 1e-12, dtype)
            checks.compare("bert_layer_norm", f"{R}x{d} {tag}", got, want, tol(dtype, want))
            if timed and R > 77:
                w32, b32 = ln[0].float(), ln[1].float()
                checks.timed("bert_layer_norm", f"{R}x{d} {tag}", lambda: fe.layer_norm_rows(y, ln, 1e-12, dtype),
                             lambda: fe.layer_norm_reference(y, ln, 1e-12, dtype),
                             library=lambda: F.layer_norm(y, (d,), w32, b32, 1e-12).to(dtype),
                             io_bytes=nbytes(y, ln, got), ops=8.0 * R * d)
        # K2 at the BERT shapes: no bias, scale dh^-0.5, mask value -1e30
        for label, B, T, d, H, _ in BERT_SHAPES:
            dh = d // H
            qkv = randn(B, T, 3, H, dh).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            mask = ragged_mask(B, T, dev)
            args = (mask, None, dh**-0.5, False, fe.BERT_MASK_VALUE)
            (got, glse), (want, wlse) = fa.flash_attention_fwd(q, k, v, *args), fa.flash_attention_reference(q, k, v, *args)
            checks.compare("flash_fwd", f"{label} dh{dh} no bias {tag} out", got, want, tol(dtype, want))
            checks.compare("flash_fwd", f"{label} dh{dh} no bias {tag} lse", glse, wlse, tol(dtype, wlse))
            if timed:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                pad = mask[:, None, None, :]
                checks.timed("flash_fwd", f"{label} dh{dh} no bias {tag}", lambda: fa.flash_attention_fwd(q, k, v, *args),
                             lambda: fa.flash_attention_reference(q, k, v, *args),
                             library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pad, scale=dh**-0.5),
                             io_bytes=nbytes(qkv, mask, got, glse), ops=4.0 * B * H * T * T * dh, ops_in=op_type(dtype))
            del qkv, got, want

    # the whole layer: the small ragged case with one sequence of no valid key, then both path shapes
    small = random_bert_layer(g, 64, 128)
    lens = torch.tensor([24, 17, 9, 3, 1, 24, 0], device=dev)
    mask = torch.arange(24, device=dev)[None, :] < lens[:, None]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        l = {k: v.to(dtype) for k, v in small.items()}
        x = randn(7, 24, 64).to(dtype)
        got = fe.fused_bert_layer_parts(x, mask, l, num_heads=4, eps=1e-12, save_x1=True)
        want = fe.bert_layer_reference(x, mask, l, num_heads=4, eps=1e-12, save_x1=True)
        for name, a, b in zip(("out", "x1"), got, want):  # compare also fails on a non-finite value
            checks.compare("bert_layer", f"ragged B7 T24 d64, one row without keys {tag} {name}", a, b, tol(dtype, b))
        for label, B, T, d, H, dff in BERT_SHAPES:
            l = {k: v.to(dtype) for k, v in random_bert_layer(g, d, dff).items()}
            x, m = randn(B, T, d).to(dtype), ragged_mask(B, T, dev)
            kw = dict(num_heads=H, eps=1e-12)
            out = fe.fused_bert_layer_parts(x, m, l, **kw)
            got = fe.fused_bert_layer_parts(x, m, l, **kw, save_x1=True)
            want = fe.bert_layer_reference(x, m, l, **kw, save_x1=True)
            if not torch.equal(out, got[0]):
                raise AssertionError(f"bert_layer {label} {tag}: save_x1 changes the output")
            for name, a, b in zip(("out", "x1"), got, want):
                checks.compare("bert_layer", f"{label} {tag} {name}", a, b, tol(dtype, b))
            if dtype == torch.bfloat16:
                checks.timed("bert_layer", f"{label} {tag}", lambda: fe.fused_bert_layer_parts(x, m, l, **kw),
                             lambda: fe.bert_layer_reference(x, m, l, **kw), iters=5)
            del l, x, out, got, want
    torch.cuda.empty_cache()


def plain_bert_stack(params, cfg, ids, mask):
    """`bert_encode` from the plain layer only."""
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    x = bert.bert_embed(params, cfg, ids, mask)
    for l in fe.fuse_bert_blocks(params.layers):
        x = fe.bert_layer_reference(x, mask, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    return x


def bert_tokens(g: torch.Generator, n: int, T: int, vocab: int, empty_every: int = 0):
    """Synthetic chunks: random ids, lengths 8..T, and every `empty_every`-th
    row a padded slot with no valid token."""
    dev = g.device
    ids = torch.randint(0, vocab, (n, T), generator=g, device=dev)
    lens = torch.randint(8, T + 1, (n,), generator=g, device=dev)
    if empty_every:
        lens[empty_every - 1::empty_every] = 0
    return ids, torch.arange(T, device=dev)[None, :] < lens[:, None]


def check_bert_stack(g: torch.Generator) -> None:
    """8b: the full-width f32 bge-small encoder against the plain stack."""
    from rag_docvqa_tpu_torch.models import bert

    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg)
    ids, mask = bert_tokens(g, 64, 64, cfg.vocab_size)
    t0 = time.perf_counter()
    got = bert.bert_encode(params, cfg, ids, mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = plain_bert_stack(params, cfg, ids, mask)
    err = (got - want).abs().max().item()
    log(f"  bert_encode f32 bge-small B64 T64 (12 layers) kernels vs plain stack: max_abs_err {err:.3e} "
        f"(limit {F32_TOL:.0e}), max|ref| {want.abs().max().item():.3g}, {ms:.1f} ms")
    if not (math.isfinite(err) and err <= F32_TOL):
        raise AssertionError(f"full-width bert_encode differs from the plain stack by {err}")


def embed_index_path(g: torch.Generator):
    """8c, path 1: embed synthetic chunks with the bge-small bi-encoder in
    bf16, build the bf16 index, query it."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.models.embedder import embed_batch
    from rag_docvqa_tpu_torch.ops import topk
    from rag_docvqa_tpu_torch.parallel import ShardedIndex

    N, B, T, NQ, k = EMBED_N, EMBED_B, BERT_T, 64, 10
    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg).to(torch.bfloat16)
    ids, mask = bert_tokens(g, N, T, cfg.vocab_size, empty_every=97)  # padded slots among the chunks
    q_ids, q_mask = bert_tokens(g, NQ, T, cfg.vocab_size)
    embed_batch(params, "BGE", ids[:B], mask[:B], cfg)  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    emb = torch.cat([embed_batch(params, "BGE", ids[i:i + B], mask[i:i + B], cfg) for i in range(0, N, B)])
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    index = ShardedIndex.build(emb.float(), dtype="bf16", kernel="auto")
    queries = embed_batch(params, "BGE", q_ids, q_mask, cfg).float()
    vals, idx, valid = (torch.as_tensor(a).to(g.device) for a in index.query(queries, k))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    norms = torch.linalg.vector_norm(emb.float(), dim=-1)
    if not (emb.shape == (N, cfg.hidden_size) and bool(torch.isfinite(emb.float()).all())
            and (norms - 1.0).abs().max().item() <= 2e-2):
        raise AssertionError(f"bad embeddings: shape {tuple(emb.shape)}, norms {norms.min().item()}..{norms.max().item()}")
    # every returned value is the score of its row in the plain product over the resident rows
    scores = topk.l2_normalize(queries) @ index.embeddings.float()[:N].t()
    err = (scores.gather(1, idx.long()) - vals).abs().max().item()
    best = (scores.max(dim=1).values - vals[:, 0]).abs().max().item()
    if not (bool(valid.all()) and vals.shape == (NQ, k) and err <= 1e-3 and best <= 1e-3):
        raise AssertionError(f"index query over the embeddings: returned rows' scores off by {err}, best score by {best}")
    log(f"  embedded {N} chunks (T {T}, bf16, batches of {B}, {int((~mask.any(dim=1)).sum())} padded slots: finite) "
        f"in {embed_s * 1e3:.1f} ms = {N / embed_s:.0f} chunks/s; bf16 index built; {NQ} queries k {k}: returned rows' "
        f"scores within {err:.2e}, best score within {best:.2e} of the plain product")
    log(f"  launches in the embed -> index path: {launches}")
    check_launched(launches, EMBED_KERNELS, "embed -> index")
    if launches["topk_fused"] + launches["topk_segmax"] <= 0:
        raise AssertionError("the index query launched no top-k kernel")
    return launches, {"chunks": N, "batch": B, "T": T, "embed_ms": embed_s * 1e3, "chunks_per_s": N / embed_s,
                      "ms_per_batch": embed_s * 1e3 / (N // B)}


def serve_reranked(g: torch.Generator):
    """8d, path 2: RAGVT5Engine.inference with the cross-encoder reranker."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.engine.reranker import Reranker, RerankerConfig
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(32128)
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=60, overlap=10), Caps())
    docs = make_corpus(96, n_pages=8, words_per_page=120, seed=SEED + 1)
    ingestor.caps = ingestor.plan_caps(docs)
    batches = [ingestor.ingest(docs[i:i + 32]) for i in range(0, 96, 32)]
    vt5_cfg = vt5m.VT5Config(t5=t5m.T5Config(decode_kv_int8=True, fused_decode_attn=True))
    params = vt5m.init_vt5_params(g, vt5_cfg).to(torch.bfloat16)
    bert_cfg = bert.BertConfig(vocab_size=tok.vocab_size, **XLMR)
    rcfg = RerankerConfig()  # thresh 0.4, at most 5, at least 1, pair_len 192
    reranker = Reranker(rcfg, bert_cfg, bert.init_bert_params(g, bert_cfg).to(torch.bfloat16))
    engine = RAGVT5Engine(RAGConfig(page_retrieval="concat", chunk_num=10, include_surroundings=0,
                                    max_source_length=512, max_new_tokens=16), vt5_cfg, params, tok, reranker=reranker)
    engine.inference(*batches[0])  # warmup, not counted
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch, aux in batches[1:]:
        t0 = time.perf_counter()
        out = engine.inference(batch, aux)
        results.append((out, (time.perf_counter() - t0) * 1e3))
    launches = dict(kernels.LAUNCHES)

    rows = []
    for i, (out, wall) in enumerate(results):
        conf, sims = out["confidences"], torch.as_tensor(out["retrieval"]["similarities"])
        if len(out["pred_answers"]) != 32 or not all(math.isfinite(c) and 0.0 < c <= 1.0 + 1e-6 for c in conf):
            raise AssertionError(f"reranked batch {i}: bad answers or confidences {conf}")
        for b, pages in enumerate(out["pred_answer_pages"]):
            n, s = len(pages), sims[b]
            if not (rcfg.min_chunk_num <= n <= rcfg.max_chunk_num and bool(torch.isfinite(s[:n]).all())
                    and bool((s[:n - 1] >= s[1:n]).all()) and bool((s[:n] >= 0).all()) and bool((s[:n] <= 1).all())):
                raise AssertionError(f"reranked batch {i} doc {b}: {n} valid ranks with scores {s.tolist()}")
        t = out["timings"]
        rerank_ms = out["retrieval"]["rerank_time"] * 1e3
        rows.append({"wall_ms": wall, "rerank_ms": rerank_ms})
        kept = [len(p) for p in out["pred_answer_pages"]]
        log(f"  batch {i}: {wall:.1f} ms wall; retrieve+rerank+assemble {t['retrieve_assemble_s'] * 1e3:.2f} ms of which "
            f"the reranker (320 pairs x T192, 12 layers) {rerank_ms:.2f} ms, encode {t['encode_s'] * 1e3:.2f} ms, "
            f"decode {t['decode_s'] * 1e3:.2f} ms; ranks kept per document {min(kept)}..{max(kept)}, scores sorted")
    log(f"  launches in the two reranked batches: {launches}")
    check_launched(launches, SERVE_KERNELS + EMBED_KERNELS, "reranked serving")
    return launches, {"ms_per_batch": sum(r["wall_ms"] for r in rows) / len(rows),
                      "rerank_ms_per_batch": sum(r["rerank_ms"] for r in rows) / len(rows), "batches": rows}


def check_bert_bwd(checks: Checks, g: torch.Generator) -> float:
    """8e: K10's parts and halves against their plain versions, the whole
    layer and the full-width encoder gradient against autograd of the plain
    stack; returns the encoder gradient's worst relative error."""
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

    dev = g.device
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    # bge-small at the contrastive step's shape
    B, T, d, H, dff, eps = CONTRASTIVE_B, BERT_T, BGE["hidden_size"], BGE["num_heads"], BGE["intermediate_size"], 1e-12
    R = B * T
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        timed = dtype == torch.bfloat16
        for (layout, epi, M, N, K), label in (
                (("nt", "bias_gelu_grad", 77, 96, 64), "ragged nt bias_gelu_grad 77x96x64"),
                (("nn", "mul_f32", 77, 96, 64), "ragged nn mul_f32 77x96x64"),
                (("nn", "add_f32_store", 77, 96, 64), "ragged nn add_f32_store 77x96x64"),
                (("nt", "bias_gelu_grad", R, dff, d), f"nt bias_gelu_grad {R}x{dff}x{d}"),
                (("nn", "mul_f32", R, dff, d), f"nn mul_f32 {R}x{dff}x{d}"),
                (("nn", "add_f32_store", R, d, dff), f"nn add_f32_store {R}x{d}x{dff}")):
            a = randn(M, K).to(dtype)
            b = ((randn(N, K) if layout == "nt" else randn(K, N)) * K**-0.5).to(dtype)
            aux = (randn(N) * 0.5).to(dtype) if epi == "bias_gelu_grad" else randn(M, N)
            got, want = fe.gemm_bwd(a, b, layout, epi, aux), fe.gemm_bwd_reference(a, b, layout, epi, aux)
            outs = got if isinstance(got, tuple) else (got,)
            for i, (x, y) in enumerate(zip(outs, want if isinstance(want, tuple) else (want,))):
                checks.compare("bert_gemm_bwd", f"{label} {tag} out{i}", x, y, tol(dtype, y))
            if timed and M > 77:
                checks.timed("bert_gemm_bwd", f"{label} {tag}", lambda: fe.gemm_bwd(a, b, layout, epi, aux),
                             lambda: fe.gemm_bwd_reference(a, b, layout, epi, aux),
                             io_bytes=nbytes(a, b, aux, *outs), ops=2.0 * M * N * K, ops_in=op_type(dtype))
            del a, b, aux, got, want, outs
        # the weight-gradient products at this shape: few output tiles, so the rows are cut into ranges
        for M, N, label in ((dff, d, "dW1"), (d, d, "dWo")):
            a, b = randn(R, M).to(dtype), randn(R, N).to(dtype)
            got, want = fe.gemm_bwd(a, b, "tn", "store_f32"), fe.gemm_bwd_reference(a, b, "tn", "store_f32")
            label = f"tn {label} {M}x{N} over {R} rows in {fe.tn_splits(M, N, R, timed)} ranges {tag}"
            checks.compare("t5_gemm_bwd", label, got, want, rel_tol(dtype, want))
            if timed:
                checks.timed("t5_gemm_bwd", label, lambda: fe.gemm_bwd(a, b, "tn", "store_f32"),
                             lambda: fe.gemm_bwd_reference(a, b, "tn", "store_f32"),
                             library=lambda: torch.matmul(a.t(), b),  # its output is bf16, the kernel's f32
                             io_bytes=nbytes(a, b, got), ops=2.0 * M * N * R, ops_in=op_type(dtype))
            del a, b, got, want
        for rows in (77, R):
            y, gg = randn(rows, d) * 3.0 + 0.5, randn(rows, d).to(dtype)
            ln = torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(dtype)
            got, want = fe.layer_norm_bwd(y, gg, ln, eps), fe.layer_norm_bwd_reference(y, gg, ln, eps)
            for name, x, w in zip(("dy", "dy cast", "dln", "dsum"), got, want):
                limit = tol(dtype, w) if name.startswith("dy") else rel_tol(dtype, w)
                checks.compare("bert_ln_bwd", f"{rows}x{d} {tag} {name}", x, w, limit)
            if timed and rows == R:
                w32, b32 = ln[0].float(), ln[1].float()

                def library():  # autograd of the one library LayerNorm call
                    yy = y.detach().requires_grad_()
                    return torch.autograd.grad(torch.nn.functional.layer_norm(yy, (d,), w32, b32, eps), yy, gg.float())

                checks.timed("bert_ln_bwd", f"{rows}x{d} {tag}", lambda: fe.layer_norm_bwd(y, gg, ln, eps),
                             lambda: fe.layer_norm_bwd_reference(y, gg, ln, eps), library=library,
                             io_bytes=nbytes(y, gg, ln, *got), ops=16.0 * rows * d)
        for rows, n, in_dtype in ((77, 100, dtype), (R, dff, torch.float32), (R, 3 * d, dtype)):
            x = randn(rows, n).to(in_dtype)
            got, want = fe.col_sum(x), fe.col_sum_reference(x)
            label = f"{rows}x{n} {op_type(in_dtype)}"
            checks.compare("bert_col_sum", label, got, want, rel_tol(in_dtype, want))
            if timed and rows == R:
                checks.timed("bert_col_sum", label, lambda: fe.col_sum(x), lambda: fe.col_sum_reference(x),
                             library=lambda: x.sum(dim=0, dtype=torch.float32), io_bytes=nbytes(x, got), ops=1.0 * rows * n)

        # the two halves at the step's shape
        l = {k: v.to(dtype) for k, v in random_bert_layer(g, d, dff).items()}
        x, x1, dy = randn(B, T, d).to(dtype), randn(B, T, d).to(dtype), randn(B, T, d).to(dtype)
        mask = ragged_mask(B, T, dev)
        ffn = (x1, dy, l["ln2"], l["w1"], l["b1"], l["w2"], l["b2"])
        got, want = fe.bert_ffn_bwd(*ffn, eps=eps), fe.bert_ffn_bwd_reference(*ffn, eps=eps)
        for name, a, b in zip(("dx1", "dln2", "dw1", "db1", "dw2", "db2"), got, want):
            checks.compare("bert_ffn_bwd", f"bge-small B{B} T{T} {tag} {name}", a, b, rel_tol(dtype, b))
        att = (x, dy, mask, l["wqkv"], l["bqkv"], l["wo"], l["bo"], l["ln1"])
        got, want = fe.bert_attn_bwd(*att, num_heads=H, eps=eps), fe.bert_attn_bwd_reference(*att, num_heads=H, eps=eps)
        for name, a, b in zip(("dx", "dln1", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):
            checks.compare("bert_attn_bwd", f"bge-small B{B} T{T} {tag} {name}", a, b, rel_tol(dtype, b))
        if timed:
            checks.timed("bert_ffn_bwd", f"bge-small B{B} T{T} {tag}", lambda: fe.bert_ffn_bwd(*ffn, eps=eps),
                         lambda: fe.bert_ffn_bwd_reference(*ffn, eps=eps), iters=5)
            checks.timed("bert_attn_bwd", f"bge-small B{B} T{T} {tag}", lambda: fe.bert_attn_bwd(*att, num_heads=H, eps=eps),
                         lambda: fe.bert_attn_bwd_reference(*att, num_heads=H, eps=eps), iters=5)
        del l, x, x1, dy, got, want
    torch.cuda.empty_cache()

    # a sequence with no valid key: a finite output cotangent gives finite gradients, zero through its attention
    l = random_bert_layer(g, 64, 128)
    lens = torch.tensor([24, 17, 0, 3], device=dev)
    m = torch.arange(24, device=dev)[None, :] < lens[:, None]
    att = (randn(4, 24, 64), randn(4, 24, 64), m, l["wqkv"], l["bqkv"], l["wo"], l["bo"], l["ln1"])
    got, want = fe.bert_attn_bwd(*att, num_heads=4, eps=eps), fe.bert_attn_bwd_reference(*att, num_heads=4, eps=eps)
    for name, a, b in zip(("dx", "dln1", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):  # fails on a non-finite value
        checks.compare("bert_attn_bwd", f"ragged B4 T24 d64, one row without keys f32 {name}", a, b,
                       rel_tol(torch.float32, b))

    # the whole layer, f32: BertLayerTrain against autograd through the plain layer
    l = {k: v.requires_grad_() for k, v in random_bert_layer(g, d, dff).items()}
    x, cot, mask = randn(B, T, d).requires_grad_(), randn(B, T, d), ragged_mask(B, T, dev)
    ins = [x] + [l[k] for k in fe.BERT_KEYS]
    got = torch.autograd.grad(fe.bert_layer_train(x, mask, l, num_heads=H, eps=eps), ins, cot)
    want = torch.autograd.grad(fe.bert_layer_reference(x, mask, l, num_heads=H, eps=eps), ins, cot)
    for name, a, b in zip(["x", *fe.BERT_KEYS], got, want):
        checks.compare("bert_layer_train", f"bge-small B{B} T{T} f32 d{name}", a, b, rel_tol(torch.float32, b))
    del l, x, got, want
    torch.cuda.empty_cache()

    # the full-width f32 12-layer bge-small encoder gradient, B 16
    cfg = bert.BertConfig(**BGE)
    params = bert.init_bert_params(g, cfg)
    params.requires_grad_(True)
    ids, mask = bert_tokens(g, 16, T, cfg.vocab_size)
    cot = randn(16, T, d)
    names, ins = zip(*params.named_parameters())
    t0 = time.perf_counter()
    got = torch.autograd.grad(bert.bert_encode(params, cfg, ids, mask), ins, cot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = torch.autograd.grad(plain_bert_stack(params, cfg, ids, mask), ins, cot)
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, got, want):
        if name.endswith(".k_b"):
            # a shift of every key moves each query's scores by one constant: the key bias has a zero
            # gradient in exact arithmetic and both sides hold rounding residue, held to an absolute limit
            if not (a - b).abs().max().item() <= F32_TOL:
                raise AssertionError(f"BERT encoder gradient {name}: residue {(a - b).abs().max().item():.3e}")
            continue
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if not (math.isfinite(rel) and rel <= F32_TOL):
            raise AssertionError(f"BERT encoder gradient {name}: {rel:.3e} of its largest value, above {F32_TOL}")
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  encoder gradient f32 bge-small B16 T{T} (12 layers) kernels vs autograd of the plain stack: worst "
        f"{worst:.3e} of the largest value ({worst_name}; limit {F32_TOL:.0e}), {ms:.1f} ms forward+backward")
    return worst


def contrastive_path(g: torch.Generator, steps: int = 8):
    """8f, path 3: contrastive steps of the bge-small bi-encoder on one
    repeated batch of pairs, bf16 compute on f32 masters."""
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.training.contrastive import (ContrastiveConfig, contrastive_optimizer,
                                                           make_contrastive_step)

    B, T = CONTRASTIVE_B, BERT_T
    cfg = bert.BertConfig(**BGE)
    ccfg = ContrastiveConfig(batch_size=B, max_tokens=T, bf16_compute=True)  # MNRL at scale 20, lr 2e-5
    embed = lambda p, ids, mask: bert.bert_sentence_embed(p, cfg, ids, mask)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g, device=g.device).item())

    def run():
        gg = torch.Generator(device=g.device).manual_seed(seed)
        params = bert.init_bert_params(gg, cfg)  # f32 masters
        a_ids, a_mask = bert_tokens(gg, B, T, cfg.vocab_size)
        p_ids, p_mask = bert_tokens(gg, B, T, cfg.vocab_size)
        opt = contrastive_optimizer(ccfg.lr)
        state = opt.init(params)
        step = make_contrastive_step(embed, opt, ccfg)
        rows = []
        for _ in range(steps):
            ev = {n: torch.cuda.Event(enable_timing=True) for n in ("start", "forward", "backward", "update")}
            t0 = time.perf_counter()
            ev["start"].record()
            loss = step(params, state, a_ids, a_mask, p_ids, p_mask, mark=lambda n: ev[n].record())
            torch.cuda.synchronize()
            rows.append({"loss": loss.item(), "wall_ms": (time.perf_counter() - t0) * 1e3,
                         "forward_ms": ev["start"].elapsed_time(ev["forward"]),
                         "backward_ms": ev["forward"].elapsed_time(ev["backward"]),
                         "update_ms": ev["backward"].elapsed_time(ev["update"])})
        return rows, (a_ids, p_ids)

    run()  # warmup, not counted; also the first of the two runs whose losses must repeat
    kernels.reset_launch_counts()
    rows, (a_ids, p_ids) = run()
    launches = dict(kernels.LAUNCHES)
    again, _ = run()
    for i, r in enumerate(rows):
        log(f"  step {i + 1}: loss {r['loss']:.6f}, {r['wall_ms']:.1f} ms (forward {r['forward_ms']:.1f}, "
            f"backward {r['backward_ms']:.1f}, update {r['update_ms']:.1f})")
    losses = [r["loss"] for r in rows]
    repeat = losses == [r["loss"] for r in again]
    log(f"  launches in the {steps} contrastive steps: {launches}")
    log(f"  the {steps} losses repeat digit for digit in a second run from the same seed: {repeat}")
    check_launched(launches, CONTRASTIVE_KERNELS, "contrastive")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite contrastive loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the contrastive loss did not fall on the repeated batch: {losses}")
    # the word-embedding gradient is a scatter of 2 x B x T rows into the table: its time alone
    table = torch.zeros((cfg.vocab_size, cfg.hidden_size), device=g.device)
    idx = torch.cat([a_ids, p_ids]).reshape(-1)
    src = torch.randn((idx.numel(), cfg.hidden_size), generator=g, device=g.device)
    scatter_ms = time_ms(lambda: table.index_put_((idx,), src, accumulate=True))
    log(f"  the word-embedding gradient's scatter alone ({idx.numel()} rows of {cfg.hidden_size} f32 into "
        f"{cfg.vocab_size}, index_put_ accumulate): {scatter_ms:.3f} ms")
    steady = rows[1:]
    mean = lambda key: sum(r[key] for r in steady) / len(steady)
    summary = {"ms": mean("wall_ms"), "forward_ms": mean("forward_ms"), "backward_ms": mean("backward_ms"),
               "update_ms": mean("update_ms"), "losses": losses, "losses_repeat": repeat,
               "word_emb_scatter_ms": scatter_ms,
               "case": f"bge-small B{B} pairs T{T} MNRL bf16 compute, mean of steps 2-{steps}"}
    log(f"  mean of steps 2-{steps}: {summary['ms']:.1f} ms per step (forward {summary['forward_ms']:.1f}, "
        f"backward {summary['backward_ms']:.1f}, update {summary['update_ms']:.1f})")
    return launches, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rag_docvqa_tpu_torch import kernels

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"phase 1: card {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s ({kernels.BUILD_DIR})")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = Checks()
    only = set(sys.argv[1:])  # e.g. `chip_smoke.py 8`: that phase alone, for work on it; no report
    if only - {"3", "4", "5", "6", "7", "8"}:
        raise SystemExit(f"usage: chip_smoke.py [phase ...], phases 3-8; got {sorted(only)}")
    want = lambda phase: not only or phase in only
    launches, path_launches = {}, {}
    if want("3") or want("4") or want("5"):
        with torch.inference_mode():
            if want("3"):
                log("phase 3: kernels against their plain versions")
                check_kernels(checks, g)
            if want("4"):
                log("phase 4: full-width f32 t5-base stack")
                check_stack(g)
                torch.cuda.empty_cache()
            if want("5"):
                log("phase 5: RAGVT5Engine.inference, concat, bf16 weights, int8 cross cache, decode kernel on")
                launches = serve(g)
                path_launches["serve"] = dict(launches)
    torch.cuda.empty_cache()
    if want("6"):
        log("phase 6a: the flash backward (K6) against its plain version")
        check_flash_bwd(checks, g)
        log("phase 6b: the T5 layer backward (K7, K8) against their plain versions")
        check_layer_bwd(checks, g)
        torch.cuda.empty_cache()
        log("phase 6c: full-width f32 t5-base encoder gradient")
        encoder_grad = check_encoder_grad(g)
        torch.cuda.empty_cache()
        log("phase 6d: t5-base VT5 train steps, bf16 compute, f32 masters")
        train_launches, train_summary = train(g)
        path_launches["train"] = train_launches
        launches.update({k: train_launches[k] for k in KERNELS if KERNELS[k][2] == "train"})
        torch.cuda.empty_cache()
    if want("7"):
        with torch.inference_mode():
            log("phase 7a: the top-k kernels (K4, K5, K11, K12) against their plain versions")
            crossover = check_index_kernels(checks, g)
            torch.cuda.empty_cache()
            log(f"phase 7b: the resident index, N {INDEX_N} x D {INDEX_D}, B {INDEX_B}, k {INDEX_K}; "
                f"card and power limit: {card}")
            kernels.reset_launch_counts()
            index_summary = index_path(g)
            torch.cuda.empty_cache()
        log("phase 7c: precompute index | query on the synthetic corpus, t5-base width")
        index_summary["cli"] = index_cli()
        index_launches = dict(kernels.LAUNCHES)
        log(f"  launches in the index path (7b and 7c): {index_launches}")
        check_launched(index_launches, INDEX_KERNELS, "index")
        path_launches["index"] = index_launches
        launches.update({k: index_launches[k] for k in INDEX_KERNELS})
        index_summary["whole_function_ms"] = crossover
        torch.cuda.empty_cache()
    if want("8"):
        with torch.inference_mode():
            log("phase 8a: the BERT layer (K9) and its parts against their plain versions")
            check_bert_kernels(checks, g)
            log("phase 8b: full-width f32 bge-small stack")
            check_bert_stack(g)
            torch.cuda.empty_cache()
            log(f"phase 8c: embed -> index, bge-small bf16; card and power limit: {card}")
            embed_launches, embed_summary = embed_index_path(g)
            torch.cuda.empty_cache()
            log("phase 8d: RAGVT5Engine.inference with the XLM-R-base-width cross-encoder reranker, bf16")
            rerank_launches, rerank_summary = serve_reranked(g)
            torch.cuda.empty_cache()
        log("phase 8e: the BERT layer backward (K10) against its plain versions")
        bert_encoder_grad = check_bert_bwd(checks, g)
        torch.cuda.empty_cache()
        log("phase 8f: contrastive steps, bge-small, B 256 pairs, bf16 compute, f32 masters")
        contrastive_launches, contrastive_summary = contrastive_path(g)
        path_launches.update(embed_index=embed_launches, rerank_serve=rerank_launches,
                             contrastive=contrastive_launches)
        launches.update({k: embed_launches[k] for k in KERNELS if KERNELS[k][2] == "embed"})
        launches.update({k: contrastive_launches[k] for k in KERNELS if KERNELS[k][2] == "contrastive"})
        torch.cuda.empty_cache()
    if only:
        print(json.dumps({"ok": True, "phases": sorted(only), "card": card}), flush=True)
        return 0

    def times(unit: str, case: str) -> dict:
        row = checks.times[unit][case]
        return {k: row.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def pair(unit: str, case: str) -> dict:
        return {k: checks.times[unit][case][k] for k in ("ms", "plain_ms")}

    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
             "max_abs_err": checks.err[name], **times(name, case), "case": case,
             "cases": checks.times[name]}
            for name, (src, rep, _, case) in KERNELS.items()],
        # the whole layer K1 composes from rms_norm, gemm and flash_fwd
        "t5_layer": {"max_abs_err": checks.err["t5_layer"], **pair("t5_layer", "B32 T512 t5-base bf16")},
        # K7 and K8 compose from gemm_bwd, rms_bwd and (K8) the K1 parts and K6
        "t5_ffn_bwd": {"max_abs_err": checks.err["t5_ffn_bwd"], **pair("t5_ffn_bwd", "B8 T512 t5-base bf16")},
        "t5_attn_bwd": {"max_abs_err": checks.err["t5_attn_bwd"], **pair("t5_attn_bwd", "B8 T512 t5-base bf16")},
        "t5_layer_train": {"max_abs_err": checks.err["t5_layer_train"]},
        "encoder_grad_max_rel_err": encoder_grad,
        "train_step": train_summary,
        "index": index_summary,
        # the whole layer K9 composes from bert_gemm, bert_layer_norm and flash_fwd, at both path shapes
        "bert_layer": {"max_abs_err": checks.err["bert_layer"], **pair("bert_layer", "bge-small B1024 T64 bf16"),
                       "cases": checks.times["bert_layer"]},
        # K10's halves compose from bert_gemm_bwd, bert_ln_bwd, bert_col_sum, t5_gemm_bwd, the K9 parts and K6
        "bert_ffn_bwd": {"max_abs_err": checks.err["bert_ffn_bwd"], **pair("bert_ffn_bwd", "bge-small B256 T64 bf16")},
        "bert_attn_bwd": {"max_abs_err": checks.err["bert_attn_bwd"], **pair("bert_attn_bwd", "bge-small B256 T64 bf16")},
        "bert_layer_train": {"max_abs_err": checks.err["bert_layer_train"]},
        "bert_encoder_grad_max_rel_err": bert_encoder_grad,
        "embed_index": embed_summary,
        "rerank_serve": rerank_summary,
        "contrastive_step": contrastive_summary,
        # every kernel's launches in each path's run, counts set to 0 just before it
        "launches_by_path": path_launches,
        "card": card,
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
