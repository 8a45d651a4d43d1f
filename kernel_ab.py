"""Time the norm and reduction kernels of the train steps, and the
flash-attention backward (K6), of one checkout of this repository on the
card, so that two trees can be held side by side in one run on one card
(run them A B B A):

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
`vit_layer_norm` 6304x768. Runs only on a CUDA device.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.ops import flash_attention as fa
    from rag_docvqa_tpu_torch.ops import fused_encoder as fe

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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"tag": args.tag, "tree": args.tree, "card": smi.stdout.strip(), "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
