"""The Uni-MoE-2.0-Omni cell's family, reference and readers at a tiny size
on the CPU (`tiny_unimoe2.py`): a sound run through `harness.run` is
correct, with every routing decision compared; a served token altered, and
a routing decision altered outside the margin, each make it not correct on
the number that should catch it; the float8 control is not correct; the
work of a call counts only what the router chose; `moe_ms` and
`moe_roofline` read what the family recorded; a run loads no JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness, work
from perfbench.families import rag_unimoe2 as fam
from perfbench.harness import ROOT, RunData
from perfbench.record import Call
from perfbench.tests.tiny_unimoe2 import tiny

SEED = 2**31 + 31


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(monkeypatch, control=False):
    kept = {}
    check = fam.check

    def keep(ctx, control=False):
        kept["ctx"] = ctx
        return check(ctx, control)

    monkeypatch.setattr(fam, "check", keep)
    r = harness.run(tiny(), SEED, 0.05, False, device="cpu", log=lambda *a: None, control=control)
    return r, kept["ctx"]


def test_the_tree_is_the_program_s_and_built_without_memory():
    c = tiny().cfg["engine"]
    tree = fam.structure(c, 512, torch.device("cpu"))
    assert all(p.is_meta for p in tree.parameters())
    shapes = {n: tuple(p.shape) for n, p in tree.named_parameters()}
    assert shapes["layers.1.moe.router"] == (5, 64) and shapes["layers.0.moe.gate_up"] == (4, 192, 64)
    assert shapes["layers.0.moe.down"] == (4, 64, 96) and shapes["layers.0.moe.shared_gate_up"] == (128, 64)
    assert shapes["layers.0.moe.shared_down"] == (64, 64) and "layers.0.gate.weight" not in shapes
    rules = {n: fam.leaf_init(n, s, c) for n, s in shapes.items()}
    assert rules["layers.0.moe.shared_down"] == ("normal", 32 ** -0.5)  # a shared expert's own width
    assert rules["layers.0.moe.down"] == ("normal", 96 ** -0.5) and rules["layers.0.moe.router"] == ("normal", 0.125)


def test_sound_run_is_correct(monkeypatch):
    r, ctx = run(monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"prompt_mismatch", "route_mismatch", "logit_gap"}
    rec = ctx.sample[0].call.record
    L = ctx.cfg["engine"]["num_layers"]
    assert len(rec["route"]) == L * ctx.cfg["engine"]["max_new_tokens"]  # the prefill and every decode step
    assert rec["route"][0].dtype == torch.int8 and rec["moe_s"] > rec["moe_prefill_s"] > 0


def test_the_control_is_not_correct(monkeypatch):
    r, _ = run(monkeypatch, control=True)
    low = r["control"]
    assert low["route_mismatch"] > 0 or low["logit_gap"] > r["checks"]["logit_gap"]["limit"], low


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


def _route_altered(monkeypatch):
    """The prefill's first token of each row takes, in layer 0, the routed
    expert after its first one: a decision far outside the margin."""
    from rag_docvqa_tpu_torch.models import moe

    original = moe.route
    seen = {"n": 0}

    def altered(h, router, cfg):
        experts, probs = original(h, router, cfg)
        seen["n"] += 1
        if h.shape[0] > 2 and seen["n"] % cfg.moe_experts:  # a prefill, some of its layers
            experts = experts.clone()
            first = experts[0, 0]
            experts[0, 0] = (first + 1) % cfg.moe_experts if first < cfg.moe_experts else 0
        return experts, probs

    monkeypatch.setattr(moe, "route", altered)
    return "route_mismatch"


@pytest.mark.parametrize("fault", [_token_altered, _route_altered], ids=["token_altered", "route_altered"])
def test_broken_program_is_not_correct(fault, monkeypatch):
    number = fault(monkeypatch)
    r, _ = run(monkeypatch)
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"], (number, r["checks"])


def test_call_work_counts_what_the_router_chose():
    """Two rows of 3 and 2 prompt tokens (one padded position), 2 layers, 4
    experts and a null one: the prefill's routing by hand, then the two
    decode steps the first row alone runs (the second served its EOS
    first)."""
    c = dict(tiny().cfg["engine"], num_layers=2)
    d, ff = c["d_model"], c["moe_d_ff"]
    mask = torch.tensor([[True, True, True], [True, True, False]])
    tokens = torch.tensor([[5, 6, 1], [1, 0, 0]])  # row 0 serves 3 tokens (2 decode steps), row 1 its EOS
    pre = [torch.tensor([[[0, 1], [4, -1], [2, -1]], [[3, 4], [0, -1], [1, 2]]]),  # layer 0; (1, 2) is padding
           torch.tensor([[[0, -1], [0, 1], [0, 4]], [[0, -1], [0, -1], [3, 3]]])]
    step = [torch.tensor([[[1, 2]], [[0, 1]]]), torch.tensor([[[4, -1]], [[2, 3]]])]  # row 1's are not counted
    route = [r.reshape(-1, 2).to(torch.int8) for r in pre] + [r.reshape(-1, 2).to(torch.int8) for r in step] * 2
    w = fam.call_work(c, 512, {"mask": mask, "tokens": tokens, "route": route})
    assert set(w) == {"prefill", "decode", "experts", "model"}
    router, shared, expert = d * 5, 3 * d * 2 * c["moe_shared_d_ff"], 3 * d * ff
    # the prefill: 5 valid tokens, routed pairs 5 in layer 0 and 6 in layer 1, experts with a row {0, 1, 2, 3}
    # and {0, 1}; each decode step: 1 token, pairs (1, 2) in layer 0 and the null expert in layer 1
    prefill, step = w["experts"][0], w["experts"][1]
    assert len(w["experts"]) == 3 and w["experts"][2] == step  # a Work a pass: the prefill, two decode steps
    assert prefill.flops == pytest.approx(2.0 * 5 * 2 * (router + shared) + 2.0 * expert * 11)
    assert prefill.bytes == pytest.approx(work.BF16 * (2 * (router + shared) + 6 * expert + 2 * 2 * d * 5))
    assert step.flops == pytest.approx(2.0 * 2 * (router + shared) + 2.0 * expert * 2)
    assert step.bytes == pytest.approx(work.BF16 * (2 * (router + shared) + 2 * expert + 2 * 2 * d))
    assert w["model"].flops == pytest.approx(w["prefill"].flops + w["decode"].flops)
    assert w["prefill"].flops + w["decode"].flops > sum(p.flops for p in w["experts"])


def test_moe_readers_read_the_recorded_stream_time():
    from perfbench.harness import reader

    calls = [Call(0, 1, 2, [0, 1], {}, {"moe_s": 0.5, "moe_prefill_s": 0.2}),
             Call(1, 2, 2, [2, 3], {}, {"moe_s": 1.5, "moe_prefill_s": 0.3})]
    sp = harness.spec("unimoe2-text-mpdocvqa")
    # the prefill pass 0.1 s bound by operations, then a decode step 0.1 s by bytes
    passes = [work.Work(0.1 * work.PEAK_BF16_FLOPS, 0), work.Work(0, 0.1 * work.PEAK_BYTES)]
    least = [{"experts": passes}, {"experts": passes * 1}]
    data = RunData(sp, 1.0, 0.0, calls, [], least)
    assert reader("moe_ms")(data) == pytest.approx(1000.0)  # prefill and decode
    assert reader("moe_roofline")(data) == pytest.approx(40.0)  # the prefill's alone: 0.2 s least over 0.5 s
    bare = RunData(sp, 1.0, 0.0, [Call(0, 1, 2, [0, 1], {}, {})], [], [{"model": work.Work()}])
    assert reader("moe_ms")(bare) is None and reader("moe_roofline")(bare) is None  # a program without the layer


PROBE = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench import harness
from perfbench.tests.tiny_unimoe2 import tiny
harness.run(tiny(), 1, 0.05, False, device="cpu", log=lambda *a: None)
print(" ".join(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1:] in ([], [""]), out.stdout


def test_passes_split_the_recorded_routing_by_pass():
    c = dict(tiny().cfg["engine"], num_layers=2)
    mask = torch.ones(2, 3, dtype=torch.bool)
    route = [torch.full((6, 2), i, dtype=torch.int8) for i in range(2)] + \
        [torch.full((2, 2), 10 + i, dtype=torch.int8) for i in range(4)]
    got = fam.passes(c, {"mask": mask, "route": route})
    assert [g.shape for g in got] == [(2, 3, 2, 2), (2, 1, 2, 2), (2, 1, 2, 2)]
    assert np.array_equal(got[2][:, 0, :, 0], [[12, 13], [12, 13]])
