"""The cell `qwen25vl-crops-mpdocvqa` cut to a size the CPU runs in seconds:
the same files and code, the language model, the tower (112-px crops, 56-px
windows, full attention at layers 1 and 3), M-RoPE's sections (scaled to the
head's 8 frequencies), the vocabulary, documents, pages and batches made
small, the weights in float32, where the program's and the reference's
readings agree to rounding (~1e-6)."""

from __future__ import annotations

import copy

from perfbench.harness import Spec, spec
from perfbench.tests.tiny import TRAFFIC

CELL = "qwen25vl-crops-mpdocvqa"
ENGINE = {"d_model": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "mrope_section": [2, 3, 3],
          "chunk_num": 3, "chunk_size": 12, "overlap": 2, "max_prompt_tokens": 256, "max_new_tokens": 4,
          "max_crops": 2}
VISION = {"hidden_size": 32, "intermediate_size": 64, "num_heads": 4, "depth": 4, "window_size": 56,
          "fullatt_block_indexes": [1, 3], "image_size": 112}
IMAGES = {"width": 160, "height": 208}
LIMITS = {"crop_err": 1e-4, "logit_gap": 1e-3}


def tiny() -> Spec:
    sp = copy.deepcopy(spec(CELL))
    c = sp.cfg["engine"]
    c.update(ENGINE)
    c["vision"] = dict(c["vision"], **VISION)
    sp.cfg.update(dtype="float32", tokenizer="hash:512", check_docs=4)
    sp.cfg["limits"].update(LIMITS)
    sp.traffic.update(TRAFFIC, page_images=IMAGES)
    return sp
