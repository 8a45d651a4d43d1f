"""What decides `correct`: a sample of the served documents, held to the
plain reference.

The sample is drawn from the seed among the documents that the window's
calls answered, with the longest of them (the most words) always in it. The
numbers compared are widest gaps and counts, each against the limit of its
configuration file: a served token's gap is how far the reference's logit of
that token lies below the reference's best logit at its position, the
reference teacher-forced with the served tokens up to and including the
first EOS.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EOS = 1


@dataclass
class Sampled:
    call: object  # record.Call
    row: int
    doc: object  # RawDocument


def sample(calls: Sequence, docs_by_id: Dict[int, object], n: int, seed: int) -> List[Sampled]:
    served = [Sampled(c, r, docs_by_id[q]) for c in calls for r, q in enumerate(c.question_ids)]
    if not served:
        return []
    size = lambda s: sum(len(p) for p in s.doc.words)
    longest = max(served, key=size)
    rest = [s for s in served if s is not longest]
    picked = random.Random(seed).sample(rest, min(n - 1, len(rest)))
    return [longest] + picked


def served_steps(tokens: np.ndarray) -> np.ndarray:
    """(N,) steps each row needed: up to and including its first EOS."""
    T = tokens.shape[1]
    hit = tokens == EOS
    return np.where(hit.any(1), hit.argmax(1) + 1, T)


def teacher_inputs(tokens: np.ndarray) -> torch.Tensor:
    """The decoder's inputs under teacher forcing: the start token (0), then
    the served tokens but the last."""
    dec = np.concatenate([np.zeros((tokens.shape[0], 1), tokens.dtype), tokens[:, :-1]], 1)
    return torch.from_numpy(dec.astype(np.int64))


def token_gaps(ref_logits: torch.Tensor, chosen: torch.Tensor, steps: np.ndarray) -> float:
    """Widest gap, over rows and their served steps, between the best
    reference logit and the reference's logit of the `chosen` token."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, chosen[..., None].long())[..., 0]
    gap = (best - got).cpu().numpy()
    live = np.arange(gap.shape[1])[None, :] < steps[:, None]
    return float(gap[live].max()) if live.any() else 0.0


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    out = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
