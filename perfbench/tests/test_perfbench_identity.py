"""The weights and documents of the existing cells, bit for bit as commit
716382e made them: SHA-256 digests of `make_weights` over the `rag-vt5-base`
and `hivt5-base` trees (at `tiny.py`'s widths in float32 and at the
published widths in bfloat16, on the CPU's generator) and of the first 64
documents of `mpdocvqa` and `mpdocvqa-b64`.

The digests were recorded on that commit, from the root of its checkout with
this file copied into its `perfbench/tests/`, by

    python3 -c "from perfbench.tests.test_perfbench_identity import record; record()"

(`_weights` calls `make_weights` the way that commit's signature has it,
with `d_model` and `d_kv` in place of the family's rule, where the family
module has no `leaf_init`.) Recorded with torch 2.13.0 on the CPU.
"""

from __future__ import annotations

import copy
import hashlib
import importlib
import json

import pytest
import torch

from perfbench.harness import BENCH, load_json, spec
from perfbench.stream import DocStream
from perfbench.tests.tiny import tiny

SEED = 2**31 + 17
CELLS = {"rag-vt5-base": "vt5-concat-mpdocvqa", "hivt5-base": "hivt5-mpdocvqa"}
WEIGHTS = {
    ("rag-vt5-base", "tiny"): "0b80e6440612812a942cca142cc4332060af22211c824f5de2dc0974fe4da3c7",
    ("rag-vt5-base", "published"): "c9a43b9d1885e433c5a134c09c5d31f6ec85dfa46c9feb433fd1322ec6b75ffb",
    ("hivt5-base", "tiny"): "4f7bb0d73687adaea6702fb2b8425367008d676d55e1d51cabab6081cf5389e4",
    ("hivt5-base", "published"): "881652adc1449298ded47066b9cdf28852d2a5b9561ddbc67bd7ae3937f3ab4e",
}
DOCS = {"mpdocvqa": "a84d98e378c656501219e83498ecab0ebb84afa1a78f22cf00a5047a7b6f5389",
        "mpdocvqa-b64": "0c8fc3e66044d96d54a7a26a18e4f346dcac11bf5faca341289188ae5fff5da7"}


def _spec(config: str, widths: str):
    return tiny(CELLS[config]) if widths == "tiny" else copy.deepcopy(spec(CELLS[config]))


def _weights(config: str, widths: str):
    from perfbench.weights import make_weights

    sp = _spec(config, widths)
    c = sp.cfg["engine"]
    fam = importlib.import_module(f"perfbench.families.{sp.cfg['family']}")
    vocab = int(sp.cfg["tokenizer"].split(":")[1])
    leaves = [(n, tuple(p.shape)) for n, p in fam.structure(c, vocab, torch.device("cpu")).named_parameters()]
    dtype = getattr(torch, sp.cfg["dtype"])
    rule = getattr(fam, "leaf_init", None)
    if rule is None:
        return leaves, make_weights(leaves, SEED, torch.device("cpu"), c["d_model"], c["d_kv"], dtype)
    return leaves, make_weights(leaves, SEED, torch.device("cpu"), lambda n, s: rule(n, s, c), dtype)


def weights_digest(config: str, widths: str) -> str:
    leaves, w = _weights(config, widths)
    h = hashlib.sha256()
    for name, shape in leaves:
        t = w[name]
        h.update(f"{name} {tuple(t.shape)} {t.dtype};".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def docs_digest(traffic: str, n: int = 64) -> str:
    h = hashlib.sha256()
    for d in DocStream(load_json(BENCH / "traffic" / f"{traffic}.json"), SEED).take(n):
        h.update(json.dumps([d.question, d.words, d.answers, d.answer_page_idx, d.question_id,
                             d.images is None]).encode())
        for b in d.boxes:
            h.update(b.tobytes())
    return h.hexdigest()


def record() -> None:
    torch.set_num_threads(2)
    print({k: weights_digest(*k) for k in WEIGHTS})
    print({k: docs_digest(k) for k in DOCS})


@pytest.mark.parametrize("config,widths", list(WEIGHTS))
def test_weights_are_the_recorded_bits(config, widths):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert weights_digest(config, widths) == WEIGHTS[config, widths]
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("traffic", list(DOCS))
def test_documents_are_the_recorded_bits(traffic):
    assert docs_digest(traffic) == DOCS[traffic]


def test_a_tree_larger_than_a_piece_is_drawn_piece_by_piece(monkeypatch):
    from perfbench import weights

    monkeypatch.setattr(weights, "PIECE", 8)
    leaves = [("a", (3, 4)), ("n", (2,)), ("b", (5,)), ("c", (2, 2))]
    rule = {"a": ("normal", 2.0), "n": ("ones",), "b": ("normal", 1.0), "c": ("normal", 0.5)}
    w = weights.make_weights(leaves, SEED, torch.device("cpu"), lambda n, s: rule[n], torch.float32)
    g = torch.Generator().manual_seed(SEED)
    draw = lambda n: torch.empty(n).normal_(generator=g)
    # "a" (12 elements) has a buffer of its own, drawn 8 then 4; "b" and "c" (9) do not share one
    assert torch.equal(w["a"], torch.cat([draw(8), draw(4)]).view(3, 4) * 2.0)
    assert torch.equal(w["b"], draw(5)) and torch.equal(w["c"], draw(4).view(2, 2) * 0.5)
    assert torch.equal(w["n"], torch.ones(2)) and list(w) == ["a", "n", "b", "c"]
