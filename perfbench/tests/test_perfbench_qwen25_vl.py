"""The Qwen2.5-VL cell's family and reference at a tiny size on the CPU
(`tiny_qwen25_vl.py`): a sound run through `harness.run` is correct, with
every crop, position and page compared; each fault put under the timed path
(1-D RoPE in place of M-RoPE, every tower layer full or every one windowed,
a crop cut one pixel to the right, a served token altered) makes it not
correct, on the number that should catch it. Also the family's tree and its
work arithmetic."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.families import rag_qwen25_vl as fam
from perfbench.tests.tiny_qwen25_vl import tiny

SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(monkeypatch, seconds=0.05):
    """harness.run of the tiny cut on the CPU, and the check's input."""
    kept = {}
    check = fam.check

    def keep(ctx, control=False):
        kept["ctx"] = ctx
        return check(ctx, control)

    monkeypatch.setattr(fam, "check", keep)
    r = harness.run(tiny(), SEED, seconds, False, device="cpu", log=lambda *a: None)
    return r, kept["ctx"]


def test_the_tree_is_the_program_s_and_built_without_memory():
    c = tiny().cfg["engine"]
    tree = fam.structure(c, 512, torch.device("cpu"))
    assert all(p.is_meta for p in tree.parameters())
    names = [n for n, _ in tree.named_parameters()]
    assert "lm_head" in names and "vision.patch_w" in names and "vision.layers.3.qkv_w" in names
    assert {fam.leaf_init(n, tuple(p.shape), c)[0] for n, p in tree.named_parameters()} == {"ones", "zeros", "normal"}


def test_sound_run_is_correct(monkeypatch):
    r, ctx = run(monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"prompt_mismatch", "position_mismatch", "image_mismatch", "crop_err", "logit_gap"}
    assert 0 < r["checks"]["crop_err"]["value"] < 1e-5
    served = [s for s in ctx.sample if s.call.record["crop_valid"][s.row].any()]
    assert served and all(s.call.record["positions"] is not None for s in ctx.sample)
    for s in served:  # the image tokens' (t, h, w) indices are not the text's
        pos = s.call.record["positions"][:, s.row].numpy()
        assert (pos[1] != pos[0]).any() and (pos[2] != pos[0]).any()


def test_call_work_counts_the_tower_over_valid_crops(monkeypatch):
    r, ctx = run(monkeypatch)
    c = ctx.cfg["engine"]
    rec = ctx.sample[0].call.record
    w = fam.call_work(c, 512, rec)
    assert set(w) == {"crops", "prefill", "decode", "model"}
    n = int(np.asarray(rec["crop_valid"]).sum())
    assert w["crops"].flops == pytest.approx(n * fam.tower_work(c, 1).flops)
    assert w["model"].flops == pytest.approx(w["crops"].flops + w["prefill"].flops + w["decode"].flops)
    # windowed layers attend over a window's patches only: all-full would count more
    full = dict(c, vision=dict(c["vision"], fullatt_block_indexes=list(range(c["vision"]["depth"]))))
    assert fam.tower_work(full, 1).flops > fam.tower_work(c, 1).flops


def _rope_1d(monkeypatch):
    from rag_docvqa_tpu_torch import config

    build = config.build_qwen_config
    monkeypatch.setattr(config, "build_qwen_config", lambda c, v: build(dict(c, mrope_section=[]), v))
    return "position_mismatch"


def _tower_layers(full: bool):
    def fault(monkeypatch):
        from rag_docvqa_tpu_torch import config

        build = config.build_qwen25_vision_config

        def built(c, out):
            v = build(c, out)
            import dataclasses

            return dataclasses.replace(v, fullatt_block_indexes=tuple(range(v.depth)) if full else ())

        monkeypatch.setattr(config, "build_qwen25_vision_config", built)
        return "crop_err"

    return fault


def _crop_shifted(monkeypatch):
    from rag_docvqa_tpu_torch.ops import patches

    cut = patches.crop_box

    def shifted(image, box):
        c = cut(image, box)
        x0 = c.__array_interface__["data"][0] - image.__array_interface__["data"][0]
        y, x = divmod(x0 // image.strides[1], image.shape[1])
        x = min(x + 1, image.shape[1] - c.shape[1])
        return image[y:y + c.shape[0], x:x + c.shape[1]]

    monkeypatch.setattr(patches, "crop_box", shifted)
    return "crop_err"


def _token_altered(monkeypatch):
    from rag_docvqa_tpu_torch.models import causal_lm

    original = causal_lm.generate

    def altered(*args, **kwargs):
        tokens, conf = original(*args, **kwargs)
        tokens = tokens.clone()
        tokens[0, 1] = (tokens[0, 1] + 101) % 509 + 3
        return tokens, conf

    monkeypatch.setattr(causal_lm, "generate", altered)
    return "logit_gap"


@pytest.mark.parametrize("fault", [_rope_1d, _tower_layers(True), _tower_layers(False), _crop_shifted,
                                   _token_altered],
                         ids=["rope_1d", "every_layer_full", "every_layer_windowed", "crop_shifted", "token_altered"])
def test_broken_program_is_not_correct(fault, monkeypatch):
    number = fault(monkeypatch)
    r, _ = run(monkeypatch)
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], (number, r["checks"])
