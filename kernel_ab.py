"""Time the flash-attention backward (K6) and the BERT LayerNorm backward of
one checkout of this repository on the card, so that two trees can be held
side by side in one run on one card (run them A B B A):

    python3 kernel_ab.py --tree /path/to/other/checkout --tag parent
    python3 kernel_ab.py --tree . --tag change

It imports `rag_docvqa_tpu_torch` from `--tree` (building that tree's
kernels into its own `build/torch_kernels/`), makes the inputs from a seed,
and prints one JSON line: per case the device time and the time by CUDA
events around back-to-back calls (`chip_smoke.device_ms` and `time_ms`,
means of 20 calls), with the card's name and power limit. Runs only on a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

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

    def flash(label, B, T, H, dh, lens, shared_bias, scale, mask_value):
        q, k, v, do = (randn(B, T, H, dh).to(bf16) for _ in range(4))
        mask = torch.arange(T, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
        bias = randn(1, H, T, T).to(bf16) if shared_bias else None
        a = (mask, bias, scale, False, mask_value)
        out, lse = fa.flash_attention_reference(q, k, v, *a)
        out = out.contiguous()  # as K2 returns it: the wrapper would copy a strided one
        fn = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *a)
        rows[label] = {"device_ms": device_ms(fn, 20), "event_ms": time_ms(fn, 20)}

    flash("flash_bwd B8 H12 T512 dk64 shared bias t5-mask bf16", 8, 512, 12, 64, [512 - 40 * i for i in range(8)],
          True, 1.0, fe.T5_MASK_VALUE)
    flash("flash_bwd B256 H12 T64 dh32 no bias ragged bf16", 256, 64, 12, 32,
          [max(1, 64 - (i * 7) % 64) for i in range(256)], False, 32**-0.5, fa.NEG_INF)
    R, d = 16384, 384
    y, gg = randn(R, d) * 3.0 + 0.5, randn(R, d).to(bf16)
    ln = torch.stack([torch.rand(d, generator=g, device=dev) + 0.5, randn(d)]).to(bf16)
    fn = lambda: fe.layer_norm_bwd(y, gg, ln, 1e-12)
    rows["bert_ln_bwd 16384x384 bf16"] = {"device_ms": device_ms(fn, 20), "event_ms": time_ms(fn, 20)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"tag": args.tag, "tree": args.tree, "card": smi.stdout.strip(), "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
