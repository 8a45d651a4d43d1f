"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files and code, the widths, depth, vocabulary, documents and batches made
small, the weights in float32."""

from __future__ import annotations

import copy

from perfbench.harness import Spec, spec

ENGINE = {"d_model": 64, "d_kv": 16, "num_heads": 4, "d_ff": 128, "num_layers": 2, "max_source_length": 128,
          "max_text_tokens": 64, "page_tokens": 4, "max_pages": 4, "chunk_num": 3}
TRAFFIC = {"batch_size": 2, "warmup_batches": 1, "trace_batches": 1, "block_docs": 4,
           "pool_docs": 8, "pages": {"dist": "lognormal", "median": 2, "sigma": 0.5, "min": 1, "max": 3},
           "words_per_page": {"dist": "uniform", "min": 20, "max": 40}, "vocab": {"size": 500, "zipf": 1.1, "seed": 1}}


def tiny(workload: str, max_new_tokens: int = 6) -> Spec:
    sp = copy.deepcopy(spec(workload))
    sp.cfg["engine"].update({k: v for k, v in ENGINE.items() if k in sp.cfg["engine"]}, max_new_tokens=max_new_tokens)
    sp.cfg["tokenizer"] = "hash:512"
    # float32: the limits are set for bfloat16 at the published widths, where
    # rounding spreads less than at these widths; the faults stay far above them
    sp.cfg["dtype"] = "float32"
    sp.cfg["check_docs"] = 3
    sp.traffic.update(TRAFFIC)
    return sp
