"""The dynamic-capacity expert layer (`models/moe.py`) and the causal LM
that holds it, against the plain float32 reference of
`perfbench/reference/unimoe2.py` (which imports nothing of the port).

On the CPU: the routing rule on hand-built probabilities (top-p stopping at
one expert, the cap at two, ties to the lower index, a null expert adding
nothing, no renormalisation); the layer against the reference's at d 64, 4
experts of 96, 2 shared experts of 32, with and without padded positions;
a small expert-layer causal LM's prefill and cached decode against the
reference's full forward (logits, and every routing decision whose
reference margin exceeds 1e-4); the config keys; `build_engine` serving it;
the dense path left as it was. Marked `card`: a prefill and a decode step
under `torch.cuda.set_sync_debug_mode("error")`, and the layer at the
benchmark cell's widths against its plain path. On the card: `python3 -m
pytest --noconftest tests/test_torch_moe.py -m card` (the tests' conftest.py
imports JAX, which that machine lacks)."""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.reference.unimoe2 import UniMoE2, decide  # noqa: E402
from rag_docvqa_tpu_torch import config, kernels, profiling  # noqa: E402
from rag_docvqa_tpu_torch.models import causal_lm as C  # noqa: E402
from rag_docvqa_tpu_torch.models import moe  # noqa: E402
from rag_docvqa_tpu_torch.ops import lm_glue as G  # noqa: E402

SMALL = dict(vocab_size=97, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128, tie_word_embeddings=False,
             mrope_section=(2, 3, 3), moe_experts=4, moe_null_experts=1, moe_top_k=2, moe_top_p=0.7, moe_d_ff=96,
             moe_shared_experts=2, moe_shared_d_ff=32)
DELTA = 1e-4  # the margin inside which the reference follows the program's decision (f32 on both sides)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def engine_dict(cfg: C.CausalLMConfig) -> dict:
    keys = ("num_layers", "num_heads", "num_kv_heads", "d_model") + config.MOE_KEYS
    return dict({k: getattr(cfg, k) for k in keys}, mrope_section=list(cfg.mrope_section))


def small(seed: int = 0, dtype=torch.float32, **over):
    cfg = C.CausalLMConfig(**dict(SMALL, **over))
    params = C.init_causal_lm_params(torch.Generator().manual_seed(seed), cfg, dtype)
    return cfg, params, {n: p.detach() for n, p in params.named_parameters()}


def probs_case(p, d: int = 8):
    """(h (N, d), router) whose router softmax is exactly the rows of p: the
    router the identity on h's first columns, which hold the
    log-probabilities (d 8: the grouped GEMM takes rows of 16-byte
    multiples)."""
    p = torch.tensor(p, dtype=torch.float32)
    n = p.shape[-1]
    return torch.nn.functional.pad(torch.log(p), (0, d - n)), torch.nn.Parameter(torch.eye(n, d), requires_grad=False)


# --------------------------------------------------------------------------- #
# the routing rule
# --------------------------------------------------------------------------- #
ROUTES = {  # probabilities over 4 routed experts and the null one -> (experts, probabilities) taken
    "top_p_stops_at_one": ([0.05, 0.8, 0.05, 0.05, 0.05], [1, -1], [0.8, 0.0]),
    "stops_where_the_sum_reaches": ([0.1, 0.7, 0.1, 0.05, 0.05], [1, -1], [0.7, 0.0]),
    "cap_at_two": ([0.3, 0.1, 0.3, 0.2, 0.1], [0, 2], [0.3, 0.3]),
    "ties_to_the_lower_index": ([0.2, 0.2, 0.2, 0.2, 0.2], [0, 1], [0.2, 0.2]),
    "null_expert_taken": ([0.1, 0.05, 0.05, 0.3, 0.5], [4, 3], [0.5, 0.3]),
    "null_expert_alone": ([0.05, 0.05, 0.05, 0.05, 0.8], [4, -1], [0.8, 0.0]),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_takes_the_top_p_prefix_capped_at_top_k(case):
    p, experts, probs = ROUTES[case]
    cfg = C.CausalLMConfig(**SMALL)
    h, router = probs_case([p])
    got_e, got_p = moe.route(h, router, cfg)
    assert got_e.tolist() == [experts]
    assert torch.allclose(got_p, torch.tensor([probs]), atol=1e-6)
    ref_e, _ = decide(torch.tensor([p]), cfg.moe_top_k, cfg.moe_top_p)
    assert sorted(ref_e[0].tolist()) == sorted(experts)


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_layer_weights_each_taken_expert_by_its_unnormalised_probability(case):
    """d 8 (the log-probabilities in h): the layer's output is the shared
    experts plus p_i SwiGLU_i(h) over the taken routed experts; a null
    expert adds nothing and the taken p_i are not renormalised."""
    p, experts, probs = ROUTES[case]
    cfg = C.CausalLMConfig(**dict(SMALL, d_model=8, moe_d_ff=8, moe_shared_d_ff=8))
    g = torch.Generator().manual_seed(3)
    block = moe.init_moe_block(lambda shape, std, dt: (torch.randn(shape, generator=g) * std).to(dt), cfg,
                               torch.float32)
    h, block.router = probs_case([p])
    got = moe.expert_layer(h, block, cfg, fused=False)
    silu = torch.nn.functional.silu
    ff, fs = cfg.moe_d_ff, cfg.moe_shared_d_ff
    want = torch.zeros(1, 8)
    for s in range(2):
        gate, up = block.shared_gate_up[s * fs:(s + 1) * fs], block.shared_gate_up[(2 + s) * fs:(3 + s) * fs]
        want += (silu(h @ gate.t()) * (h @ up.t())) @ block.shared_down[:, s * fs:(s + 1) * fs].t()
    for e, q in zip(experts, probs):
        if 0 <= e < cfg.moe_experts:
            gate, up = block.gate_up[e, :ff], block.gate_up[e, ff:]
            want += q * ((silu(h @ gate.t()) * (h @ up.t())) @ block.down[e].t())
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_margin_is_the_distance_from_another_decision():
    p = torch.tensor([[0.8, 0.1, 0.05, 0.03, 0.02], [0.5, 0.3, 0.1, 0.05, 0.05], [0.69, 0.2, 0.05, 0.03, 0.03],
                      [0.4, 0.2, 0.2, 0.1, 0.1]])
    experts, margin = decide(p, 2, 0.7)
    assert experts.tolist() == [[0, -1], [0, 1], [0, 1], [0, 1]]
    # past the stop by 0.1; the 2nd against the 3rd 0.2 and 0.7 - 0.5 = 0.2; 0.7 - 0.69; a tie at the cap
    assert margin.tolist() == pytest.approx([0.1, 0.2, 0.01, 0.0], abs=1e-6)


# --------------------------------------------------------------------------- #
# the layer and the LM against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("padded", [False, True], ids=["all_valid", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_expert_layer_matches_the_reference(dtype, padded):
    cfg, params, w = small(1, dtype)
    block = params.layers[0].moe
    h = torch.randn(3, 11, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(dtype)
    valid = torch.ones(3, 11, dtype=torch.bool)
    if padded:
        valid[1, 7:] = valid[2, 4:] = False
    got = moe.expert_layer(h, block, cfg, fused=False, valid=valid if padded else None)
    ref = UniMoE2(w, engine_dict(cfg), torch.device("cpu"))
    y, chosen, mine, margin = ref.experts(h.float().reshape(-1, cfg.d_model), ref.layer_weights(0))
    keep = valid.reshape(-1)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    scale = y[keep].abs().max()
    assert (got.float().reshape(-1, cfg.d_model)[keep] - y[keep]).abs().max() <= tol * scale
    experts, _ = moe.route(h.reshape(-1, cfg.d_model), block.router, cfg)
    sure = keep & (margin > (DELTA if dtype == torch.float32 else 0.02))
    assert torch.equal(experts[sure].sort(-1).values, mine[sure].sort(-1).values)
    if padded:  # a padded position takes no expert: only the shared experts' output is there
        shared = moe._shared(h.reshape(-1, cfg.d_model), block, "silu", False)
        assert torch.equal(got.reshape(-1, cfg.d_model)[~keep], shared[~keep].float().to(dtype))


def test_prefill_and_cached_decode_match_the_reference_forward():
    cfg, params, w = small(4)
    g = torch.Generator().manual_seed(5)
    B, T, steps = 3, 10, 4
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, 7:] = mask[2, 5:] = False
    lens = mask.sum(1)
    routed = []
    route = moe.route

    def record(*a, **k):
        out = route(*a, **k)
        routed.append(out[0])
        return out

    new = torch.randint(3, cfg.vocab_size, (B, steps), generator=g)  # teacher-forced continuation
    logits = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", record)
        with torch.no_grad():
            first, cache = C.prefill(params, cfg, ids, mask, T + steps)
            logits.append(first)
            k_pos = torch.arange(T + steps)[None]
            for t in range(steps):
                slot = T + t
                attn = (k_pos < lens[:, None]) | ((k_pos >= T) & (k_pos <= slot))
                out, cache = C.decode_step(params, cfg, cache, new[:, t], slot, attn, rope_pos=lens + t)
                logits.append(out)
    logits = torch.stack(logits, 1)  # (B, steps + 1, V)
    L = cfg.num_layers
    ref = UniMoE2(w, engine_dict(cfg), torch.device("cpu"), delta=DELTA)
    seqs = [ids[b, :lens[b]].tolist() + new[b].tolist() for b in range(B)]
    at = [list(range(int(lens[b]) - 1, int(lens[b]) + steps)) for b in range(B)]
    pos = [np.broadcast_to(np.arange(len(s)), (3, len(s))).copy() for s in seqs]
    mine = []
    for b in range(B):
        n = int(lens[b])
        pre = torch.stack([routed[l].reshape(B, T, -1)[b, :n] for l in range(L)], 1)
        dec = torch.stack([torch.stack([routed[L * (1 + t) + l][b] for l in range(L)]) for t in range(steps)])
        mine.append(torch.cat([pre, dec]).numpy())
    passes = ref.run(seqs, pos, at, follow=mine)
    for b, p in enumerate(passes):
        assert (logits[b] - p.logits).abs().max() <= 1e-4 * p.logits.abs().max(), b
        sure = p.margin > DELTA
        assert np.array_equal(np.sort(mine[b], -1)[sure], np.sort(p.own, -1)[sure]), b
        assert sure.mean() > 0.9


def test_the_reference_without_the_program_s_decisions_differs_where_a_decision_flips():
    """Held to the reference without following inside the margin, a
    flipped decision shows in the logits: the program's routing is what
    the comparison holds, not only its sums."""
    cfg, params, w = small(4)
    ids = torch.randint(3, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        hidden = C.forward(params, cfg, ids, torch.ones(1, 12, dtype=torch.bool))[0]
    ref = UniMoE2(w, engine_dict(cfg), torch.device("cpu"))
    pos = [np.broadcast_to(np.arange(12), (3, 12)).copy()]
    p = ref.run([ids[0].tolist()], pos, [list(range(12))])[0]
    assert (hidden - p.logits).abs().max() <= 1e-4 * p.logits.abs().max()
    forced = p.own.copy()
    forced[3, 0] = [(forced[3, 0, 0] + 1) % cfg.moe_experts, -1]  # another expert for one token of layer 0
    ref.delta = math.inf  # follow every decision
    q = ref.run([ids[0].tolist()], pos, [list(range(12))], follow=[forced])[0]
    assert (q.logits[3:] - p.logits[3:]).abs().max() > 1e-2 * p.logits.abs().max()
    assert torch.equal(q.logits[:3], p.logits[:3])


# --------------------------------------------------------------------------- #
# configuration, engine, counters, the dense path
# --------------------------------------------------------------------------- #
def test_build_qwen_config_reads_the_expert_keys_and_refuses_a_layer_without_widths():
    c = {"d_model": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "moe_experts": 4, "moe_null_experts": 1,
         "moe_top_k": 2, "moe_top_p": 0.7, "moe_d_ff": 96, "moe_shared_experts": 2, "moe_shared_d_ff": 32}
    cfg = config.build_qwen_config(c, 97)
    assert (cfg.moe_experts, cfg.moe_null_experts, cfg.moe_top_k, cfg.moe_top_p, cfg.moe_d_ff,
            cfg.moe_shared_experts, cfg.moe_shared_d_ff) == (4, 1, 2, 0.7, 96, 2, 32)
    assert config.build_qwen_config({k: v for k, v in c.items() if not k.startswith("moe")}, 97).moe_experts == 0
    with pytest.raises(ValueError):
        config.build_qwen_config(dict(c, moe_d_ff=0), 97)
    with pytest.raises(ValueError):
        config.build_qwen_config(dict(c, moe_shared_d_ff=0), 97)


def test_a_config_and_a_tree_that_disagree_raise():
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer

    cfg, params, _ = small(0)
    dense_cfg = C.CausalLMConfig(**dict(SMALL, moe_experts=0))
    dense = C.init_causal_lm_params(torch.Generator().manual_seed(0), dense_cfg)
    c = dict(engine_dict(cfg), model_name="Qwen")
    tok = HashTokenizer(cfg.vocab_size)
    with pytest.raises(ValueError, match="do not match"):  # an expert tree under a dense engine dict
        config.build_engine({k: v for k, v in c.items() if not k.startswith("moe")}, params, tok)
    with pytest.raises(ValueError, match="do not match"):  # a dense tree under the expert keys
        config.build_engine(c, dense, tok)
    with pytest.raises(NotImplementedError):
        C.quantize_weights_int8(params)
    with pytest.raises(NotImplementedError):
        C.init_causal_lm_params_int8(torch.Generator().manual_seed(0), cfg)


def test_build_engine_serves_the_expert_lm_through_evaluate():
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.engine.rag_qwen import RAGQwenEngine
    from rag_docvqa_tpu_torch.metrics import Evaluator
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(512)
    cfg, params, _ = small(7, torch.float32, vocab_size=512)
    for layer in params.layers:  # a tree loaded in bf16: the engine holds the router in f32
        layer.moe.router = torch.nn.Parameter(layer.moe.router.to(torch.bfloat16), requires_grad=False)
    c = dict(engine_dict(cfg), model_name="Qwen", chunk_num=3, max_prompt_tokens=96, max_new_tokens=3)
    engine = config.build_engine(c, params, tok)
    assert isinstance(engine, RAGQwenEngine) and engine.lm_cfg.moe_experts == 4
    assert all(l.moe.router.dtype == torch.float32 for l in engine.params.layers)
    calls = []
    layer = moe.expert_layer
    ingestor = DocVQAIngestor(tok, ChunkSpec(chunk_size=10, overlap=2), Caps(max_pages=2, max_chunks=12, max_slots=128))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "expert_layer", lambda *a, **k: calls.append(1) or layer(*a, **k))
        out = evaluate(engine, make_corpus(4, n_pages=2, words_per_page=30, seed=3), ingestor, Evaluator(),
                       batch_size=2)
    assert len(calls) == 2 * cfg.num_layers * 3  # 2 batches x (the prefill + 2 decode steps) x layers
    assert out is not None


def test_counters_count_tokens_pairs_null_picks_and_single_picks():
    cfg = C.CausalLMConfig(**SMALL)
    g = torch.Generator().manual_seed(3)
    block = moe.init_moe_block(lambda shape, std, dt: (torch.randn(shape, generator=g) * std).to(dt),
                               C.CausalLMConfig(**dict(SMALL, d_model=8)), torch.float32)
    cases = [ROUTES[k][0] for k in ("top_p_stops_at_one", "cap_at_two", "null_expert_taken", "null_expert_alone")]
    h, block.router = probs_case(cases)
    valid = torch.tensor([True, True, True, False])
    profiling.reset()
    profiling.enable()
    try:
        moe.expert_layer(h, block, dataclasses.replace(cfg, d_model=8), fused=False, valid=valid)
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    total = {n: profiling.total(counts, n) for n in ("moe.layers", "moe.tokens", "moe.routed_pairs",
                                                     "moe.null_picks", "moe.one_pick")}
    # valid: [1, -1], [0, 2], [4, 3]; the fourth left out
    assert total == {"moe.layers": 1, "moe.tokens": 3, "moe.routed_pairs": 4, "moe.null_picks": 1,
                     "moe.one_pick": 1}


def test_the_dense_path_never_enters_the_expert_layer(monkeypatch):
    cfg = C.CausalLMConfig(**dict(SMALL, moe_experts=0))
    params = C.init_causal_lm_params(torch.Generator().manual_seed(0), cfg)
    assert all(l.moe is None and l.gate is not None for l in params.layers)
    ids, mask = torch.randint(3, 97, (2, 6), generator=torch.Generator().manual_seed(1)), torch.ones(2, 6, dtype=bool)
    want = C.forward(params, cfg, ids, mask)
    monkeypatch.setattr(moe, "expert_layer", lambda *a, **k: pytest.fail("the expert layer on a dense model"))
    monkeypatch.setattr(moe, "route", lambda *a, **k: pytest.fail("the router on a dense model"))
    assert torch.equal(C.forward(params, cfg, ids, mask), want)
    dense = C.CausalLMLayer(*(getattr(params.layers[0], n) for n in ("ln0", "q", "k", "v", "o", "ln1", "gate", "up",
                                                                     "down")))
    assert dense.moe is None


def test_glu_rows_arguments_and_plain_version(monkeypatch):
    gu = torch.randn(6, 80, generator=torch.Generator().manual_seed(0))
    assert torch.equal(G.glu_rows(gu, "silu"), G.glu_reference(gu[:, :40], gu[:, 40:], "silu"))

    class Rec:
        calls = []

        def __getattr__(self, name):
            return lambda *args: Rec.calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "library", lambda: Rec())
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    monkeypatch.setattr(kernels, "FORM_LAUNCHES", dict(kernels.FORM_LAUNCHES))
    live = torch.tensor([4], dtype=torch.int32)
    gu = gu.to(torch.bfloat16)
    out = G.glu_rows(gu, "silu", live)
    (name, args), = Rec.calls  # the dense product's kernel: the up half 40 elements on, rows 80 apart
    assert name == "lm_glu" and len(args) == len(kernels._SIGNATURES[name])
    assert args == (gu.data_ptr(), gu.data_ptr() + 40 * 2, out.data_ptr(), 6, 40, 80, live.data_ptr(), 0, 1, 7)
    assert out.shape == (6, 40) and kernels.LAUNCHES[name] == kernels.FORM_LAUNCHES["lm_glu_rows"] == 1
    with pytest.raises(ValueError):
        G.glu_rows(gu.t(), "silu")


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the expert layer's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
def test_card_prefill_and_decode_step_make_no_host_sync(dev):
    cfg = C.CausalLMConfig(**dict(SMALL, vocab_size=1024, d_model=512, num_heads=4, num_kv_heads=2, d_ff=1024,
                                  moe_d_ff=1024, moe_shared_d_ff=256, mrope_section=(16, 24, 24)))
    params = C.init_causal_lm_params(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)
    B, T, steps = 4, 64, 2
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
    lens = torch.tensor([64, 50, 33, 7], device=dev)
    mask = torch.arange(T, device=dev)[None] < lens[:, None]
    pos = torch.arange(T, device=dev).expand(3, B, T).contiguous()
    k_pos = torch.arange(T + steps, device=dev)[None]
    with torch.no_grad():
        C.prefill(params, cfg, ids, mask, T + steps, positions=pos)  # warm: the kernels' first launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = C.prefill(params, cfg, ids, mask, T + steps, positions=pos)
            tok = logits.argmax(-1)
            for t in range(steps):
                attn = (k_pos < lens[:, None]) | ((k_pos >= T) & (k_pos <= T + t))
                logits, cache = C.decode_step(params, cfg, cache, tok, T + t, attn, rope_pos=lens + t)
                tok = logits.argmax(-1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits).all()


@pytest.mark.card
@pytest.mark.parametrize("rows", [(32, 1280), (32, 1)], ids=["prefill", "decode"])
def test_card_expert_layer_at_the_cell_widths_matches_its_plain_path(dev, rows):
    """Uni-MoE-2.0-Omni's layer (d 3,584, 4 experts of 18,944 and a null
    one, 2 shared of 2,368) in bf16 at the cell's prefill and decode shapes:
    the kernels' path (the grouped GEMMs, `glu_rows` over the live rows, the
    f32 scatter-add) against the same layer with the plain gated product,
    and against the float32 reference where no decision lies within 0.02."""
    cfg = C.CausalLMConfig(vocab_size=1024, d_model=3584, num_layers=1, num_heads=28, num_kv_heads=4, d_ff=18944,
                           moe_experts=4, moe_null_experts=1, moe_top_k=2, moe_top_p=0.7, moe_d_ff=18944,
                           moe_shared_experts=2, moe_shared_d_ff=2368)
    g = torch.Generator(device=dev).manual_seed(2)
    block = moe.init_moe_block(lambda shape, std, dt: (torch.randn(shape, generator=g, device=dev) * std).to(dt), cfg,
                               torch.bfloat16)
    B, T = rows
    h = torch.randn(B, T, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    valid = torch.arange(T, device=dev)[None] < torch.tensor([T - 3 * b for b in range(B)], device=dev)[:, None] \
        if T > 1 else None
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fused = moe.expert_layer(h, block, cfg, True, valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        plain = moe.expert_layer(h, block, cfg, False, valid)
    keep = torch.ones(B * T, dtype=torch.bool, device=dev) if valid is None else valid.reshape(-1)
    a, b = fused.reshape(-1, cfg.d_model)[keep].float(), plain.reshape(-1, cfg.d_model)[keep].float()
    assert (a - b).abs().max() <= 2e-2 * b.abs().max()  # one bf16 rounding of the gated product apart at most
    sample = keep.nonzero()[:, 0][:: max(1, int(keep.sum()) // 256)]
    w = {f"layers.0.moe.{k}": v for k, v in zip(("router", "gate_up", "down", "shared_gate_up", "shared_down"),
                                                   block.tensors())}
    ref = UniMoE2(w, {"num_layers": 1, "num_heads": 28, "num_kv_heads": 4, "d_model": 3584, "moe_experts": 4,
                      "moe_null_experts": 1, "moe_top_k": 2, "moe_top_p": 0.7, "moe_d_ff": 18944,
                      "moe_shared_experts": 2, "moe_shared_d_ff": 2368}, dev)
    W = {k: ref.weight(f"layers.0.{k}") for k in ("moe.router", "moe.gate_up", "moe.down", "moe.shared_gate_up",
                                                  "moe.shared_down")}
    y, _, _, margin = ref.experts(h.reshape(-1, cfg.d_model)[sample].float(), W)
    sure = margin > 0.02
    err = (fused.reshape(-1, cfg.d_model)[sample].float() - y)[sure]
    assert err.abs().max() <= 3e-2 * y[sure].abs().max()
