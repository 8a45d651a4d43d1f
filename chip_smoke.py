#!/usr/bin/env python3
"""Drive the PyTorch port's RAG-VT5 serving and training paths once on one
CUDA card.

    python3 chip_smoke.py

Six phases; any failure raises and the script exits non-zero:

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
        learning rate is not zero.

The line before the last is a JSON object with every kernel's launches in
its path's run (phase 5 for serving, 6d for training), its worst error
over its own checks, and its times against the plain version at its
path's shape (every timed case under "cases"); the whole K1 layer's error
and times under "t5_layer", K7's and K8's under "t5_ffn_bwd" and
"t5_attn_bwd", and the train steps under "train_step". The last line is
{"ok": true, "device": {...}}. Weights are random, made from a seed.

Nothing here imports jax or flax. Of the JAX package only its plain-Python
host modules are shared with the port, the chunker (ops/chunking.py) and
the metrics (metrics/), neither of which imports jax.
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
}
# the kernels each path launches
SERVE_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "decode_cross_attention")
TRAIN_KERNELS = ("t5_rms_norm", "t5_gemm", "flash_fwd", "flash_bwd", "t5_gemm_bwd", "t5_rms_bwd")


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
        self.times = {}  # unit -> {case label: (ms, plain_ms)}

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

    def timed(self, unit: str, label: str, fn, plain, iters: int = 10) -> None:
        ms, plain_ms = time_ms(fn, iters), time_ms(plain, iters)
        self.times.setdefault(unit, {})[label] = (ms, plain_ms)
        log(f"  {unit:24s} {label:44s} kernel {ms:.4f} ms   plain {plain_ms:.4f} ms")


# --------------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #
def check_kernels(checks: Checks, g: torch.Generator) -> None:
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
            checks.timed("flash_fwd", label, lambda: fa.flash_attention_fwd(q, k, v, mask, bias, scale, causal, mask_value),
                         lambda: fa.flash_attention_reference(q, k, v, mask, bias, scale, causal, mask_value))

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
                             lambda: rms_norm(x, w, 1e-6))
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
                checks.timed("t5_gemm", f"{label} {tag}", lambda: fe.gemm(a, w, epi, aux),
                             lambda: fe.gemm_reference(a, w, epi, aux))

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
                             lambda: da.cross_attention_reference(qs, k2, v2, m))


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
    from rag_docvqa_tpu.metrics.anls import anls
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu.ops.chunking import ChunkSpec

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
        if timed:
            checks.timed("flash_bwd", label, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *args),
                         lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, *args))

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
            want = fe.gemm_bwd_reference(a, b, layout, epi, *aux, acc=None if acc0 is None else acc0.clone())
            if epi == "relu_bwd":
                # dpre follows the kernel's own sign decision (see kernel_relu_masks)
                checks.compare("t5_gemm_bwd", f"{label} {tag} dpre", got[0],
                               torch.where(got[1] > 0, aux[0], torch.zeros_like(aux[0])), 0.0)
                got, want = got[1], want[1]
            for i, (x, y) in enumerate(zip(got, want) if isinstance(got, tuple) else [(got, want)]):
                checks.compare("t5_gemm_bwd", f"{label} {tag} out{i}", x, y, tol(dtype, y))
            if not label.startswith("ragged") and dtype == torch.bfloat16:
                checks.timed("t5_gemm_bwd", f"{label} {tag}", lambda: fe.gemm_bwd(a, b, layout, epi, *aux),
                             lambda: fe.gemm_bwd_reference(a, b, layout, epi, *aux))
        for rows, label in ((77, "77x768"), (R, f"{R}x768")):
            x, resid, dh = randn(rows, d).to(dtype), randn(rows, d).to(dtype), randn(rows, d)
            w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
            got, want = fe.rms_norm_bwd(x, dh, w, resid, eps), fe.rms_norm_bwd_reference(x, dh, w, resid, eps)
            checks.compare("t5_rms_bwd", f"{label} {tag} dx", got[0], want[0], tol(dtype, want[0]))
            checks.compare("t5_rms_bwd", f"{label} {tag} dw", got[1], want[1], rel_tol(dtype, want[1]))
            if rows == R and dtype == torch.bfloat16:
                checks.timed("t5_rms_bwd", f"{label} {tag}", lambda: fe.rms_norm_bwd(x, dh, w, resid, eps),
                             lambda: fe.rms_norm_bwd_reference(x, dh, w, resid, eps))

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
    from rag_docvqa_tpu.ops.chunking import ChunkSpec

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
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    kernels.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s ({kernels.BUILD_DIR})")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = Checks()
    with torch.inference_mode():
        log("phase 3: kernels against their plain versions")
        check_kernels(checks, g)
        log("phase 4: full-width f32 t5-base stack")
        check_stack(g)
        torch.cuda.empty_cache()
        log("phase 5: RAGVT5Engine.inference, concat, bf16 weights, int8 cross cache, decode kernel on")
        launches = serve(g)
    torch.cuda.empty_cache()
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
    launches.update({k: train_launches[k] for k in KERNELS if KERNELS[k][2] == "train"})

    def times(unit: str, case: str) -> dict:
        ms, plain_ms = checks.times[unit][case]
        return {"ms": ms, "plain_ms": plain_ms}

    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
             "max_abs_err": checks.err[name], **times(name, case), "case": case,
             "cases": {c: times(name, c) for c in checks.times[name]}}
            for name, (src, rep, _, case) in KERNELS.items()],
        # the whole layer K1 composes from rms_norm, gemm and flash_fwd
        "t5_layer": {"max_abs_err": checks.err["t5_layer"], **times("t5_layer", "B32 T512 t5-base bf16")},
        # K7 and K8 compose from gemm_bwd, rms_bwd and (K8) the K1 parts and K6
        "t5_ffn_bwd": {"max_abs_err": checks.err["t5_ffn_bwd"], **times("t5_ffn_bwd", "B8 T512 t5-base bf16")},
        "t5_attn_bwd": {"max_abs_err": checks.err["t5_attn_bwd"], **times("t5_attn_bwd", "B8 T512 t5-base bf16")},
        "t5_layer_train": {"max_abs_err": checks.err["t5_layer_train"]},
        "encoder_grad_max_rel_err": encoder_grad,
        "train_step": train_summary,
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
