"""Time the norm and reduction kernels of the train steps, the
flash-attention backward (K6), the corpus-index kernels (K4, K5, K11, K12)
and MaxSim (K15) of one checkout of this repository on the card, so that two
trees can be held side by side in one run on one card (run them A B B A):

    python3 kernel_ab.py --tree /path/to/other/checkout --tag parent
    python3 kernel_ab.py --tree . --tag change

It imports `rag_docvqa_tpu_torch` from `--tree` (building that tree's
kernels into its own `build/torch_kernels/`), makes the inputs from a seed,
and prints one JSON line: per case the device time and the time by CUDA
events around back-to-back calls (`chip_smoke.device_ms` and `time_ms`,
means of 20 calls), and the device time of the one PyTorch call for the
same function where the case has one (`library_device_ms`, the same in
every tree), with the card's name and power limit. The cases: K6 at the
train and the contrastive step's shapes, `bert_ln_bwd` 16384x384,
`t5_rms_bwd` 4096x768, `bert_col_sum` 16384x1152 bf16 and 16384x1536 f32,
`vit_layer_norm` 6304x768; over a 524,288 x 768 index, K4 on an f32 index
at B 8 and B 256 and K5 (g8 sg16) at B 256, against `matmul`+`topk` in
strict f32 (`torch.backends.cuda.matmul.allow_tf32 = False`), K4 and K5 on a
bf16 index at B 256, K12 and K11 at B 8 and B 256, against `torch._int_mm`
of the (unpacked) int8 operands (no scale, no maxima; B > 16 only, as
`_int_mm` takes), and `ShardedIndex.query` over an f32 and an int4 index at
B 256; K15 at Pix2Struct's shapes (Tq = Tp = 128, D 768, 16 patch sets a
batch row, B 8 and B 32): the kernel alone (one call of the tree's C entry
point on normalised rows, its inputs prepared beforehand as its wrapper
prepares them) and `late_interaction` as the engine calls it, with its f32
normalisation. `--group flash_fwd` times only K2's forward in f32 at the
Gemma reranker's shape (B 320, 8 heads on 1 KV head, T 192, dh 256, causal,
ragged pairs), at t5-base's (B 8, H 12, T 512, dh 64, a shared bias) and at
the answer-quality model's (B 8, H 4, T 128, dh 16, a shared bias), with
bf16 at dh 256 as the control, against SDPA on the same inputs. Runs only on
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from chip_smoke import device_ms, time_ms


def maxsim_alone(li, kernels, q, p, qw, pm):
    """One call of the tree's MaxSim C entry point on normalised rows, with its
    inputs prepared as its wrapper prepares them: `maxsim_launch` where the
    tree has it, else the SIMT kernel's arguments (the f32 query, strips of 64
    query tokens)."""
    if hasattr(li, "maxsim_launch"):
        return li.maxsim_launch(q, p, qw, pm)[0]
    B, Tq, D = q.shape
    N, Tp = p.shape[1], p.shape[2]
    pmb = (pm != 0).contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    strips = -(-Tq // 64)
    part = torch.empty((B, N, strips), dtype=torch.float32, device=q.device) if strips > 1 else None
    return lambda: kernels.check("maxsim", kernels.library().maxsim(
        q.data_ptr(), p.data_ptr(), qw.data_ptr(), pmb.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, N, Tq, Tp, D, kernels.stream_ptr(q)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--group", choices=("all", "flash_fwd"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe
    from rag_docvqa_tpu_torch.ops import quant, topk
    from rag_docvqa_tpu_torch.parallel import ShardedIndex

    torch.backends.cuda.matmul.allow_tf32 = False  # the library's f32 product in strict f32

    kernels.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    bf16 = torch.bfloat16
    rows = {}

    def case(label, fn, library=None):
        rows[label] = {"device_ms": device_ms(fn, 20), "event_ms": time_ms(fn, 20)}
        if library is not None:
            rows[label]["library_device_ms"] = device_ms(library, 20)

    def flash(label, B, T, H, dh, lens, shared_bias, scale, mask_value):
        q, k, v, do = (randn(B, T, H, dh).to(bf16) for _ in range(4))
        mask = torch.arange(T, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
        bias = randn(1, H, T, T).to(bf16) if shared_bias else None
        a = (mask, bias, scale, False, mask_value)
        out, lse = fa.flash_attention_reference(q, k, v, *a)
        out = out.contiguous()  # as K2 returns it: the wrapper would copy a strided one
        case(label, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *a))

    def flash_fwd(label, B, T, H, Hkv, dh, lens, shared_bias, scale, causal, dtype):
        q = randn(B, T, H, dh).to(dtype)
        k, v = randn(B, T, Hkv, dh).to(dtype), randn(B, T, Hkv, dh).to(dtype)
        mask = torch.arange(T, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
        bias = randn(1, H, T, T).to(dtype) if shared_bias else None
        allowed = mask[:, None, None, :]
        if causal:
            allowed = allowed & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        # SDPA: one mask with the bias added where it is given, else the bool mask
        sdpa_mask = (bias + torch.where(allowed, 0.0, fe.T5_MASK_VALUE).to(dtype)) if shared_bias else allowed
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        case(label, lambda: fa.flash_attention_fwd(q, k, v, mask, bias, scale, causal),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, scale=scale,
                                                    enable_gqa=Hkv != H))

    f32 = torch.float32
    gemma_lens = [192 - (i * 37) % 150 for i in range(320)]
    flash_fwd("flash_fwd B320 H8 Hkv1 T192 dh256 causal ragged f32", 320, 192, 8, 1, 256, gemma_lens, False,
              256**-0.5, True, f32)
    flash_fwd("flash_fwd B320 H8 Hkv1 T192 dh256 causal ragged bf16 (control)", 320, 192, 8, 1, 256, gemma_lens,
              False, 256**-0.5, True, bf16)
    flash_fwd("flash_fwd B8 H12 T512 dk64 shared bias f32", 8, 512, 12, 12, 64, [512 - 40 * i for i in range(8)],
              True, 1.0, False, f32)
    flash_fwd("flash_fwd B8 H4 T128 dk16 shared bias f32", 8, 128, 4, 4, 16, [128 - 9 * i for i in range(8)],
              True, 1.0, False, f32)
    if args.group == "flash_fwd":
        print(json.dumps({"tag": args.tag, "tree": args.tree, "card": _card(), "cases": rows}), flush=True)
        return 0

    flash("flash_bwd B8 H12 T512 dk64 shared bias t5-mask bf16", 8, 512, 12, 64, [512 - 40 * i for i in range(8)],
          True, 1.0, fe.T5_MASK_VALUE)
    flash("flash_bwd B256 H12 T64 dh32 no bias ragged bf16", 256, 64, 12, 32,
          [max(1, 64 - (i * 7) % 64) for i in range(256)], False, 32**-0.5, fa.NEG_INF)

    R, d = 16384, 384
    y, gg = randn(R, d) * 3.0 + 0.5, randn(R, d).to(bf16)
    ln = torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(bf16)
    case("bert_ln_bwd 16384x384 bf16", lambda: fe.layer_norm_bwd(y, gg, ln, 1e-12))

    R, d, eps = 4096, 768, 1e-6
    x, resid, dh = randn(R, d).to(bf16), randn(R, d).to(bf16), randn(R, d)
    w = (torch.rand(d, generator=g, device=dev) + 0.5).to(bf16)
    x32, w32 = x.float(), w.float()

    def rms_library():  # autograd of the one library RMSNorm call, as chip_smoke.py phase 6b times it
        xx, wx = x32.detach().requires_grad_(), w32.detach().requires_grad_()
        return torch.autograd.grad(F.rms_norm(xx, (d,), wx, eps), (xx, wx), dh)

    case("t5_rms_bwd 4096x768 bf16", lambda: fe.rms_norm_bwd(x, dh, w, resid, eps), rms_library)

    for R, n, dtype in ((16384, 1152, bf16), (16384, 1536, torch.float32)):
        xs = randn(R, n).to(dtype)
        case(f"bert_col_sum {R}x{n} {'bf16' if dtype == bf16 else 'f32'}", lambda: fe.col_sum(xs),
             lambda: xs.sum(dim=0, dtype=torch.float32))

    R, d = 6304, 768
    xv = (randn(R, d) * 3.0 + 0.5).to(bf16)
    lnv = torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(bf16)
    case("vit_layer_norm 6304x768 bf16", lambda: fe.vit_layer_norm_rows(xv, lnv, 1e-12),
         lambda: F.layer_norm(xv, (d,), lnv[0], lnv[1], 1e-12))

    # the corpus index: N 524,288 x D 768, k 10 (chip_smoke.py phase 7a's shape)
    N, D, k = 524288, 768, 10
    x = topk.l2_normalize(randn(N, D))
    q = topk.l2_normalize(randn(256, D))
    for B in (8, 256):
        qb = q[:B]
        case(f"K4 f32 N{N} D{D} B{B} k{k}", lambda: topk.fused_topk(x, qb, N, k),
             lambda: torch.matmul(qb, x.t()).topk(k))
    case(f"K5 f32 N{N} D{D} B256 g8 sg16", lambda: topk.segment_max(x, q, N, 8, 16),
         lambda: torch.matmul(q, x.t()).topk(k))
    xb = x.bfloat16()  # a bf16 index: its tile is not this change's, so its times are the control
    case(f"K4 bf16 N{N} D{D} B256 k{k}", lambda: topk.fused_topk(xb, q, N, k))
    case(f"K5 bf16 N{N} D{D} B256 g8 sg16", lambda: topk.segment_max(xb, q, N, 8, 16))
    del xb
    q8, _ = quant.quantize_rows(q)
    rows8, scale8 = quant.quantize_rows(x)
    packed, scale4 = quant.quantize_rows_int4(x)
    del x
    unpacked = torch.cat(quant.unpack_int4(packed), dim=1)
    for B in (8, 256):
        qb = q8[:B]
        case(f"K12 N{N} D{D} B{B} g16", lambda: quant.segment_max_int4(packed, scale4, qb, N, 16),
             (lambda: torch._int_mm(qb, unpacked.t())) if B > 16 else None)
    del packed, scale4, unpacked
    for B in (8, 256):
        qb = q8[:B]
        case(f"K11 N{N} D{D} B{B} g16", lambda: quant.segment_max_int8(rows8, scale8, qb, N, 16),
             (lambda: torch._int_mm(qb, rows8.t())) if B > 16 else None)
    del rows8, scale8
    # end to end: `ShardedIndex.query` at B 256 as a user calls it (f32: K4 by the default kernel="merge";
    # int4: K12 in the two-phase function), from raw rows
    emb, queries = randn(N, D), randn(256, D)
    for dtype in ("f32", "int4"):
        index = ShardedIndex.build(emb, dtype=dtype)
        case(f"ShardedIndex.query {dtype} N{N} D{D} B256 k{k}", lambda: index.query(queries, k))
        del index

    # K15 at the Pix2Struct retrieve's shapes: ragged query and patch masks, the last 4 of 16 sets padding
    from rag_docvqa_tpu_torch.ops import late_interaction as li
    T, d, mc = 128, 768, 16
    for B in (8, 32):
        q, p = randn(B, T, d), randn(B, mc, T, d)
        lens = lambda *s: torch.randint(1, T + 1, s, generator=g, device=dev)
        qm = (torch.arange(T, device=dev) < lens(B, 1)).float()
        pm = (torch.arange(T, device=dev) < lens(B, mc, 1)).float()
        pm[:, 12:] = 0.0
        qn, pn = li._normalize(q), li._normalize(p)
        case(f"K15 kernel alone B{B} x {mc} Tq{T} Tp{T} D{d}", maxsim_alone(li, kernels, qn, pn, qm, pm))
        case(f"K15 late_interaction B{B} x {mc} Tq{T} Tp{T} D{d}", lambda: li.late_interaction(q, p, qm, pm))
        del q, p, qn, pn

    print(json.dumps({"tag": args.tag, "tree": args.tree, "card": _card(), "cases": rows}), flush=True)
    return 0


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
