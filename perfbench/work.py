"""The work arithmetic: operations and bytes of the encoder, the decode and
the whole step from shapes and valid counts, and the card's peaks.

Only what the inputs need is counted: each row's valid tokens (its attention
mask), a Hi-VT5 document's real pages, and in the decode each row's steps up
to and including its EOS. Padding, padded page slots and the steps a
finished row still runs are left out, so a program that skips them shows a
gain with this work unchanged. Bytes count each input read once and each
output written once, in bfloat16 (2 bytes), as the configurations serve.

A stage's least time is the larger of its operations over the bfloat16 peak
and its bytes over the memory bandwidth; a roofline share is that time over
the stage's measured device time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_BYTES)


def widths(c: Dict) -> Dict[str, int]:
    d = c["d_model"]
    return {"d": d, "inner": c["num_heads"] * c["d_kv"], "ff": c["d_ff"], "enc": c["num_layers"],
            "dec": c.get("num_decoder_layers", c["num_layers"])}


def embed_work(c: Dict, tokens: int) -> Work:
    """Token and spatial embedding of `tokens` positions: a gather of the
    token row and four spatial rows each, the d x d linear layer."""
    d = c["d_model"]
    return Work(2.0 * tokens * d * d, BF16 * (d * d + 5 * tokens * d))


def encoder_work(c: Dict, valid: Sequence[int]) -> Work:
    """The encoder over rows of `valid` tokens: each layer's four attention
    projections, the attention over the row's valid keys, the two
    feed-forward products; the weights read once, each row's embedding read
    and its output written."""
    w = widths(c)
    d, inner, ff, L = w["d"], w["inner"], w["ff"], w["enc"]
    flops = 0.0
    for n in valid:
        flops += L * (2.0 * n * (4 * d * inner + 2 * d * ff) + 4.0 * n * n * inner)
    weights = L * (4 * d * inner + 2 * d * ff + 2 * d) * BF16
    return Work(flops, weights + BF16 * 2.0 * d * sum(valid))


def decode_work(c: Dict, vocab: int, enc_valid: Sequence[int], steps: Sequence[int]) -> Work:
    """The greedy decode of rows over `enc_valid` encoder positions, row b
    running `steps[b]` steps: the cross keys and values once, then each
    step's decoder over the rows still running and the tied LM head."""
    w = widths(c)
    d, inner, ff, L = w["d"], w["inner"], w["ff"], w["dec"]
    total = Work(L * 4.0 * d * inner * sum(enc_valid),
                 BF16 * (L * 2 * d * inner + d * sum(enc_valid) + L * 2 * inner * sum(enc_valid)))
    layer_w = L * (6 * d * inner + 2 * d * ff + 3 * d) * BF16 + vocab * d * BF16
    for t in range(max(steps, default=0)):
        rows = [b for b, s in enumerate(steps) if s > t]
        n, te = len(rows), sum(enc_valid[b] for b in rows)
        flops = n * (L * 2.0 * (6 * d * inner + 2 * d * ff) + 2.0 * d * vocab) + L * 4.0 * inner * (n * (t + 1) + te)
        cache = L * 2 * inner * (te + n * (t + 1)) * BF16
        total = total + Work(flops, layer_w + cache + n * vocab * BF16)
    return total


def page_head_work(c: Dict, pages: Sequence[int], page_tokens: int, max_pages: int) -> Work:
    """Hi-VT5's page head over each document's real pages' kept states."""
    d = c["d_model"]
    flops = sum(2.0 * p * page_tokens * d * max_pages for p in pages)
    return Work(flops, BF16 * max_pages * max_pages * page_tokens * d + BF16 * d * page_tokens * sum(pages))
