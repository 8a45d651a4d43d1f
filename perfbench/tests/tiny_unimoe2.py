"""The cell `unimoe2-text-mpdocvqa` cut to a size the CPU runs in seconds:
the same files and code, the language model (4 routed experts of 96, a null
expert, 2 shared experts of 32, top-p 0.7 capped at 2), M-RoPE's sections
(scaled to the head's 8 frequencies), the vocabulary, documents and batches
made small, the weights in float32, where the program's and the reference's
readings agree to rounding (~1e-6) and no decision lies inside the margin."""

from __future__ import annotations

import copy

from perfbench.harness import Spec, spec
from perfbench.tests.tiny import TRAFFIC

CELL = "unimoe2-text-mpdocvqa"
ENGINE = {"d_model": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "mrope_section": [2, 3, 3],
          "moe_d_ff": 96, "moe_shared_d_ff": 32, "chunk_num": 3, "chunk_size": 12, "overlap": 2,
          "max_prompt_tokens": 128, "max_new_tokens": 4}
LIMITS = {"logit_gap": 1e-3}
DELTA = 1e-4


def tiny() -> Spec:
    sp = copy.deepcopy(spec(CELL))
    sp.cfg["engine"].update(ENGINE)
    sp.cfg.update(dtype="float32", tokenizer="hash:512", check_docs=4, route_delta=DELTA)
    sp.cfg["limits"].update(LIMITS)
    sp.traffic.update(TRAFFIC)
    return sp
