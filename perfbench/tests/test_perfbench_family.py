"""A decoder-only family comes in as a module of its own: `qwen_probe`
(RAG-Qwen at a tiny size, float32, its tree on the `meta` device, page
images in its traffic) registered as `perfbench.families.qwen_probe` runs
through `harness.run` on the CPU with no edit to the harness. The page
images each call was handed are the ones the stream makes again; a served
token altered where it is produced makes `correct` false."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.stream import DocStream
from perfbench.tests import qwen_probe
from perfbench.tests.tiny import TRAFFIC

ENGINE = {"d_model": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "chunk_num": 3,
          "chunk_size": 12, "overlap": 2, "max_prompt_tokens": 160, "max_new_tokens": 4}
IMAGES = {"width": 48, "height": 64}
SEED = 2**31 + 23


@pytest.fixture(autouse=True)
def registered(monkeypatch):
    monkeypatch.setitem(sys.modules, f"perfbench.families.{qwen_probe.NAME}", qwen_probe)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def probe(images=True) -> harness.Spec:
    cfg = copy.deepcopy(qwen_probe.PUBLISHED)
    cfg["engine"].update(ENGINE)
    cfg.update(dtype="float32", tokenizer="hash:512", check_docs=16)
    # float32 on both sides: the program's and the reference's logits agree to rounding (~1e-6)
    cfg["limits"]["logit_gap"] = 1e-3
    traffic = dict(harness.load_json(harness.BENCH / "traffic" / "mpdocvqa.json"), **TRAFFIC)
    if images:
        traffic["page_images"] = IMAGES
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if m["name"] in ("docs_per_s", "setup_s")]
    return harness.Spec("qwen-probe", cfg, traffic, 1, {"end_to_end": e2e, "per_layer": []})


def run(sp, monkeypatch):
    """harness.run of `sp` on the CPU, and the check's input it built."""
    kept = {}
    check = qwen_probe.check

    def keep(ctx, control=False):
        kept["ctx"] = ctx
        return check(ctx, control)

    monkeypatch.setattr(qwen_probe, "check", keep)
    r = harness.run(sp, SEED, 0.05, False, device="cpu", log=lambda *a: None)
    return r, kept["ctx"]


def test_the_tree_is_built_without_memory():
    sp = probe()
    tree = qwen_probe.structure(sp.cfg["engine"], 512, torch.device("cpu"))
    assert all(p.is_meta for p in tree.parameters())
    assert tree.lm_head is not None


@pytest.mark.parametrize("images", [True, False], ids=["page_images", "no_images"])
def test_decoder_only_family_is_correct(images, monkeypatch):
    r, ctx = run(probe(images), monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"prompt_mismatch", "image_mismatch", "logit_gap"}
    # a call that ends past the short window answers no document inside it
    assert set(r["metrics"]) == ({"docs_per_s", "setup_s"} if r["attempted"] else {"setup_s"})
    assert ctx.sample and all(s.call.record["tokens"].device.type == "cpu" for s in ctx.sample)
    for s in ctx.sample:
        seen = s.call.record["images"][s.row]
        if not images:
            assert seen is None
            continue
        assert len(seen) == len(s.doc.words)
        for p, img in enumerate(seen):
            assert img.dtype == np.uint8 and img.shape == (IMAGES["height"], IMAGES["width"], 3)
            assert np.array_equal(img, ctx.stream.page_image(s.doc, p))
        assert s.doc.images is None  # the pool keeps no pixels


def test_altered_token_is_not_correct(monkeypatch):
    from rag_docvqa_tpu_torch.models import causal_lm

    original = causal_lm.generate

    def altered(*args, **kwargs):
        tokens, conf = original(*args, **kwargs)
        tokens = tokens.clone()
        tokens[0, 1] = (tokens[0, 1] + 101) % 509 + 3
        return tokens, conf

    monkeypatch.setattr(causal_lm, "generate", altered)
    r, _ = run(probe(), monkeypatch)
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


def test_pages_are_made_on_the_prefetch_thread(monkeypatch):
    threads = []
    page_image = DocStream.page_image

    def counted(self, doc, p):
        threads.append(threading.current_thread().name)
        return page_image(self, doc, p)

    monkeypatch.setattr(DocStream, "page_image", counted)
    # the check makes the pages again on this thread: only the run's own are counted here
    monkeypatch.setattr(qwen_probe, "check", lambda ctx, control=False: {})
    harness.run(probe(), SEED, 0.05, False, device="cpu", log=lambda *a: None)
    assert threads and set(threads) == {"ingest-prefetch"}
