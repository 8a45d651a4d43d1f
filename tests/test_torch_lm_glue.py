"""The causal LM's elementwise glue on the CPU: the dispatch of
`models/causal_lm.py` (`_glue_fused`, `_records_graph`) and the wrappers of
`ops/lm_glue.py`, whose kernels (csrc/lm_glue.cu) run only on the card
(tests/test_torch_lm_glue_card.py holds them to these plain versions there).

The kernels' branch of `_stack` and `decode_step`, taken on CPU tensors by
forcing `_glue_fused`, reaches the wrappers' plain versions, and gives the
plain branch's logits, KV cache, tokens and confidences bit for bit (Qwen2
with biases, int8 weights, M-RoPE positions, Gemma's (1 + w) norms and
tanh-GELU; f32 and bf16). On the CPU, and under autograd (a LoRA `sft_loss`
backward, with the device check forced), the plain ops run; with the tracer
on every layer of every pass counts one `lm.glue_plain` or `lm.glue_fused`.
The wrappers hand the C entry points the argument lists that `kernels.py`
declares, through a recording stand-in for the library."""

import pytest
import torch

from rag_docvqa_tpu_torch import kernels, profiling
from rag_docvqa_tpu_torch.models import causal_lm as C
from rag_docvqa_tpu_torch.models import lora as L
from rag_docvqa_tpu_torch.ops import lm_glue as G

torch.set_num_threads(2)

ARCHS = {
    "qwen2": dict(vocab_size=97, d_model=32, num_layers=3, num_heads=4, num_kv_heads=2, d_ff=48,
                  tie_word_embeddings=False),
    "qwen2_mrope": dict(vocab_size=97, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=96,
                        tie_word_embeddings=False, mrope_section=(2, 3, 3)),
    "gemma": dict(vocab_size=97, d_model=32, num_layers=2, num_heads=4, num_kv_heads=1, d_ff=48,
                  qkv_bias=False, arch="gemma", head_dim_override=32, rope_theta=1e4),
}
LENS = [10, 7, 4]
T = 10
STEPS = 4  # generated tokens: the prefill and 3 decode steps, 4 passes over the layers


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def glue_counts():
    counts = profiling.read().counts
    return profiling.total(counts, "lm.glue_fused"), profiling.total(counts, "lm.glue_plain")


def model(case: str, dtype: torch.dtype):
    """Seeded weights with norms and biases moved off their init values, so
    that each term of the glue is exercised."""
    cfg = C.CausalLMConfig(**ARCHS[case.removesuffix("_int8")])
    params = C.init_causal_lm_params(torch.Generator().manual_seed(0), cfg, dtype)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in params.layers:
            for t in [layer.ln0, layer.ln1] + [getattr(layer, n).bias for n in ("q", "k", "v")]:
                if t is not None:
                    t.add_((0.3 * torch.randn(t.shape, generator=g)).to(dtype))
    if case.endswith("_int8"):
        params = C.quantize_weights_int8(params)
    return cfg, params


def inputs(cfg):
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(2, cfg.vocab_size, (len(LENS), T), generator=g)
    mask = torch.arange(T)[None] < torch.tensor(LENS)[:, None]
    if not cfg.mrope_section:
        return ids, mask, None
    # a 2 x 2 image span at positions 3-6 of each row, as the engine's prompts have them: text indices, then
    # (t, h, w) = (s, s + h, s + w) over the span, then text from the span's largest index + 1
    pos = torch.arange(T).repeat(3, len(LENS), 1)
    s = 3
    pos[:, :, 3:7] = s + torch.tensor([[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1]])[:, None, :]
    pos[:, :, 7:] = s + 2 + torch.arange(T - 7)
    return ids, mask, pos


def run_all(params, cfg, ids, mask, pos):
    logits, cache = C.prefill(params, cfg, ids, mask, T + STEPS, positions=pos)
    tokens, conf = C.generate(params, cfg, ids, mask, STEPS, positions=pos)
    hidden = C.forward_hidden(params, cfg, ids, mask)
    return logits, cache.k, cache.v, tokens, conf, hidden


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["qwen2", "qwen2_int8", "qwen2_mrope", "gemma"])
def test_kernel_branch_gives_the_plain_branch_bits(monkeypatch, tracer, case, dtype):
    cfg, params = model(case, dtype)
    ids, mask, pos = inputs(cfg)
    with torch.no_grad():
        plain = run_all(params, cfg, ids, mask, pos)
        assert glue_counts() == (0, cfg.num_layers * (1 + STEPS + 1))  # prefill, generate, forward_hidden
        profiling.reset()
        monkeypatch.setattr(C, "_glue_fused", lambda x, *held: True)
        fused = run_all(params, cfg, ids, mask, pos)
        assert glue_counts() == (cfg.num_layers * (1 + STEPS + 1), 0)
    for name, a, b in zip(("logits", "cache k", "cache v", "tokens", "confidences", "hidden"), fused, plain):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["qwen2", "gemma"])
def test_cpu_takes_the_plain_path_and_counts_one_a_layer_a_pass(monkeypatch, tracer, case):
    cfg, params = model(case, torch.float32)
    ids, mask, _ = inputs(cfg)
    for name in ("add_rms_norm", "bias_rope_", "glu"):  # the kernels' wrappers are never entered
        monkeypatch.setattr(G, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called on the plain path"))
    C.generate(params, cfg, ids, mask, STEPS)
    assert glue_counts() == (0, cfg.num_layers * STEPS)
    C.forward_hidden(params, cfg, ids, mask)
    assert glue_counts() == (0, cfg.num_layers * (STEPS + 1))


def test_records_graph_reads_grad_mode_and_every_tensor_of_a_layer():
    cfg, params = model("qwen2", torch.float32)
    layer = params.layers[0]
    x = torch.ones(2, 3, cfg.d_model)
    lora = L.init_lora(torch.Generator().manual_seed(1), params, targets=("v",), rank=2)
    merged = L.merge_lora(params, lora).layers[0]
    assert merged.v.weight.requires_grad and not isinstance(merged.v.weight, torch.nn.Parameter)
    assert not C._records_graph(x, None, layer)  # frozen weights: nothing to record under grad mode
    assert C._records_graph(x, None, merged)  # a merged adapter weight held as a plain attribute
    assert C._records_graph(x.requires_grad_(), layer)
    with torch.no_grad():
        assert not C._records_graph(x, merged)
    with torch.inference_mode():
        assert not C._records_graph(torch.ones(2), merged)
    assert not C._glue_fused(torch.ones(2), layer)  # a CPU tensor never takes the kernels


def test_lora_sft_backward_takes_the_plain_path(monkeypatch, tracer):
    """As if every tensor were on the card (the device check forced): a
    LoRA `sft_loss` records a graph, so every layer runs the plain ops and
    counts `lm.glue_plain`, and the adapters get the gradient they get
    unforced; the frozen model without grad mode counts `lm.glue_fused`."""
    cfg, params = model("qwen2", torch.float32)
    ids, mask, _ = inputs(cfg)
    labels = torch.where(mask, ids, -100)
    lora = L.init_lora(torch.Generator().manual_seed(1), params, targets=("q", "v"), rank=2)
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))

    def grads():
        loss = C.sft_loss(L.merge_lora(params, lora), cfg, ids, mask, labels)
        return torch.autograd.grad(loss, list(lora.parameters()))

    want = grads()
    profiling.reset()
    entered = []
    monkeypatch.setattr(C, "_glue_fused", lambda x, *held: not C._records_graph(x, *held))
    for name in ("add_rms_norm", "bias_rope_", "glu"):
        monkeypatch.setattr(G, name, lambda *a, _n=name, _f=getattr(G, name), **k: entered.append(_n) or _f(*a, **k))
    got = grads()
    assert glue_counts() == (0, cfg.num_layers) and not entered
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and any(g.abs().sum() > 0 for g in got)
    with torch.no_grad():
        C.forward_hidden(params, cfg, ids, mask)
    assert glue_counts() == (cfg.num_layers, cfg.num_layers)
    assert sorted(set(entered)) == ["add_rms_norm", "bias_rope_", "glu"]


# --------------------------------------------------------------------------- #
# the wrappers' C argument lists, through a recording stand-in
# --------------------------------------------------------------------------- #
class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    return rec


def test_entry_points_are_declared_and_counted():
    text = (kernels.CSRC / "lm_glue.cu").read_text()
    for name in ("lm_add_rms_norm", "lm_bias_rope", "lm_glu"):
        assert f'extern "C" int {name}(' in text and name in kernels._SIGNATURES and name in kernels.LAUNCHES


@pytest.mark.parametrize("resid", [True, False])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_arguments(recorder, resid, w_dtype):
    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    d = torch.zeros_like(x) if resid else None
    w = torch.ones(64, dtype=w_dtype)
    xo, h = G.add_rms_norm(x, d, w, 1e-6)
    (name, args), = recorder.calls
    assert name == "lm_add_rms_norm" and len(args) == len(kernels._SIGNATURES[name])
    assert args[:5] == (x.data_ptr(), d.data_ptr() if resid else None, w.data_ptr(),
                        xo.data_ptr() if resid else None, h.data_ptr())
    assert args[5:] == (10, 64, pytest.approx(1e-6), 1, kernels.DTYPE_CODES[w_dtype], 7)
    assert (xo is x) == (not resid) and h.shape == x.shape and kernels.LAUNCHES[name] == 1


@pytest.mark.parametrize("tables", ["1d", "mrope", "decode"])
def test_bias_rope_arguments(recorder, tables):
    B, Tn = (2, 1) if tables == "decode" else (2, 5)
    q = torch.zeros(B, Tn, 4, 16, dtype=torch.bfloat16)
    k, v = torch.zeros(B, Tn, 2, 16, dtype=torch.bfloat16), torch.zeros(B, Tn, 2, 16, dtype=torch.bfloat16)
    bq, bk, bv = torch.ones(64), torch.ones(32), torch.ones(32)  # f32: cast to q's dtype for the kernel
    shape = {"1d": (Tn, 8), "mrope": (B, Tn, 8), "decode": (B, 1, 8)}[tables]
    cos, sin = torch.ones(shape), torch.zeros(shape)
    G.bias_rope_(q, k, v, bq, bk, bv, cos, sin)
    (name, args), = recorder.calls
    assert name == "lm_bias_rope" and len(args) == len(kernels._SIGNATURES[name])
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr()) and all(isinstance(a, int) for a in args[3:8])
    strides = {"1d": (0, 8), "mrope": (Tn * 8, 8), "decode": (8, 8)}[tables]
    assert args[6:8] == (cos.data_ptr(), sin.data_ptr())
    assert args[8:] == (B * Tn, Tn, 4, 2, 16, *strides, 1, 7)
    G.bias_rope_(q, k, v, None, None, None, cos, sin)  # Gemma: no biases
    assert recorder.calls[1][1][3:6] == (None, None, None) and kernels.LAUNCHES[name] == 2


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_glu_arguments(recorder, act):
    g, u = torch.zeros(3, 1, 40), torch.zeros(3, 1, 40)
    out = G.glu(g, u, act)
    (name, args), = recorder.calls
    assert name == "lm_glu" and len(args) == len(kernels._SIGNATURES[name])
    assert args == (g.data_ptr(), u.data_ptr(), out.data_ptr(), 120, G.ACTS[act], 0, 7)


def test_wrappers_refuse_what_the_kernels_do_not_take(recorder):
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        G.add_rms_norm(x.t(), None, torch.ones(4), 1e-6)  # not contiguous
    with pytest.raises(ValueError):
        G.add_rms_norm(x, torch.zeros(4, 64), torch.ones(64), 1e-6)  # d in another dtype
    q = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        G.bias_rope_(q, q, q, None, None, None, torch.ones(2, 4, dtype=torch.float64), torch.ones(2, 4))
    with pytest.raises(TypeError):
        G.glu(torch.zeros(4, dtype=torch.float16), torch.zeros(4, dtype=torch.float16), "silu")
    assert not recorder.calls
