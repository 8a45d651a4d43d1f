"""Whole runs of the harness on the CPU at a tiny size: a sound program
comes out correct against the plain reference, and a program broken
underneath the timed path comes out not correct."""

import copy

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny

CELLS = ("vt5-concat-mpdocvqa", "hivt5-mpdocvqa")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, seed=2**31 + 11):
    return harness.run(tiny(cell), seed, 0.05, False, device="cpu", log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 0 and set(r["metrics"]) == {"docs_per_s", "setup_s"} or r["attempted"] == 0
    assert list(r)[-1] == "checks"


def _altered_token(monkeypatch):
    from rag_docvqa_tpu_torch.engine import rag_vt5
    from rag_docvqa_tpu_torch.models import hivt5

    original = rag_vt5.greedy_decode

    def altered(*args, **kwargs):
        tokens, conf = original(*args, **kwargs)
        tokens = tokens.clone()
        tokens[0, 1] = (tokens[0, 1] + 101) % 509 + 3
        return tokens, conf

    monkeypatch.setattr(rag_vt5, "greedy_decode", altered)
    monkeypatch.setattr(hivt5, "greedy_decode", altered)


def _state_unchanged(monkeypatch):
    from rag_docvqa_tpu_torch.models import t5

    original = t5.decode_step

    def stale(params, cfg, cache, *args, **kwargs):
        logits, _ = original(params, cfg, copy.copy(cache).__class__(
            **{k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in vars(cache).items()}), *args, **kwargs)
        return logits, cache

    monkeypatch.setattr(t5, "decode_step", stale)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged], ids=["token_altered", "state_unchanged"])
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"], r["checks"]
