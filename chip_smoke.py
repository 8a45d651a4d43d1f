#!/usr/bin/env python3
"""Drive the PyTorch port's RAG-VT5 serving path once on one CUDA card.

    python3 chip_smoke.py

Five phases; any failure raises and the script exits non-zero:

  1. a CUDA device is required; prints the card's name and power limit and
     turns TF32 off, so f32 products are full f32;
  2. builds the hand-written kernels (rag_docvqa_tpu_torch/csrc) with nvcc
     into build/torch_kernels/ and prints the build time;
  3. checks each kernel against its plain PyTorch version on the card, on a
     small ragged shape and at the main path's t5-base shape, in f32
     (max abs error <= 1e-4) and bf16 (max abs error <= 2e-2 of the largest
     reference value, at least 1); the decode-attention kernel does f32 math
     on every cache dtype and is held to 1e-4 on each. Times both with CUDA
     events after a warmup;
  4. runs the full-width f32 t5-base stack at B 8: encode through the
     kernels against the plain stack (<= 1e-4), and greedy decode with the
     decode-attention kernel on and off (identical ids, f32, bf16 and int8
     caches);
  5. serves two batches of 32 synthetic documents through
     RAGVT5Engine.inference with the configs/RAGVT5.yml values, bf16 random
     weights, an int8 cross cache and the decode-attention kernel; checks
     that every kernel of the path was launched and that every confidence
     is finite.

The line before the last is a JSON object with every kernel's launches in
phase 5, its worst error over its own checks, and its times against the
plain version at its phase-5 shape (every timed case under "cases"), and
the whole K1 layer's error and times under "t5_layer"; the last line
is {"ok": true, "device": {...}}. Weights are random, made from a seed.

Nothing here imports jax or flax. Of the JAX package only its two
plain-Python host modules are shared with the port, the chunker
(ops/chunking.py) and ANLS (metrics/anls.py), neither of which imports jax.
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

# kernel -> (source, TPU kernel it replaces, the timed case whose times the
# report's "ms"/"plain_ms" give: the shape and dtype phase 5 runs it at)
KERNELS = {
    "t5_rms_norm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                    "B32 T512 d768 bf16"),
    "t5_gemm": ("rag_docvqa_tpu_torch/csrc/t5_layer.cu", "rag_docvqa_tpu/ops/fused_encoder.py:364",
                "ffn-out 16384x768x3072 residual bf16"),
    "flash_fwd": ("rag_docvqa_tpu_torch/csrc/flash_fwd.cu", "rag_docvqa_tpu/ops/flash_attention.py:155",
                  "B32 H12 T512 dk64 shared bias bf16"),
    "decode_cross_attention": ("rag_docvqa_tpu_torch/csrc/decode_attention.cu",
                               "rag_docvqa_tpu/ops/decode_attention.py:81", "B32 H12 dk64 Te512 int8 cache"),
}


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
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
    return launches


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

    def times(unit: str, case: str) -> dict:
        ms, plain_ms = checks.times[unit][case]
        return {"ms": ms, "plain_ms": plain_ms}

    report = {
        "kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
             "max_abs_err": checks.err[name], **times(name, case), "case": case,
             "cases": {c: times(name, c) for c in checks.times[name]}}
            for name, (src, rep, case) in KERNELS.items()],
        # the whole layer K1 composes from rms_norm, gemm and flash_fwd
        "t5_layer": {"max_abs_err": checks.err["t5_layer"], **times("t5_layer", "B32 T512 t5-base bf16")},
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
