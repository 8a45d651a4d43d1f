"""The causal LM's glue kernels (csrc/lm_glue.cu through `ops/lm_glue.py`)
on the card, against their plain versions at the shapes the port runs them
at: the Qwen2.5-VL-7B prefill of the benchmark's cell (B 32 x T 2,304, d
3,584; q/k/v at 28/4 heads of 128 under M-RoPE tables from (3, B, T)
positions laid out as the engine lays out a prompt with four crops; the
SwiGLU at d_ff 18,944), its decode step (T 1), and the Gemma reranker (hd
256, MQA, no biases, (1 + w) norms, tanh-GELU at d_ff 16,384). The rotary
and the SwiGLU product are bit-equal to the plain ops; the norm lies within
one bf16 ulp of them on every element (its sum of squares is taken in
another order), its residual sum bit-equal. A whole `generate` at a small
width, kernels against plain ops: the same tokens, logits within 1e-2 of the
largest; the Gemma reranker's hidden states likewise. Every test skips
without a CUDA device. On the card: `python3 -m pytest --noconftest
tests/test_torch_lm_glue_card.py` (the tests' conftest.py imports JAX, which
that machine lacks)."""

import pytest
import torch

from rag_docvqa_tpu_torch import kernels, profiling
from rag_docvqa_tpu_torch.models import causal_lm as C
from rag_docvqa_tpu_torch.ops import lm_glue as G

pytestmark = pytest.mark.card

BF = torch.bfloat16
QWEN7B_LM = dict(vocab_size=152064, d_model=3584, num_layers=28, num_heads=28, num_kv_heads=4, d_ff=18944,
                 tie_word_embeddings=False, mrope_section=(16, 24, 24))
CELL_B, CELL_T = 32, 2304


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the glue kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(g, *shape, scale=1.0, dtype=BF):
    return (scale * torch.randn(shape, generator=g, device=g.device)).to(dtype)


def within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """Asserts |got - want| <= one ulp of want in got's dtype on every
    element; returns how many elements differ at all."""
    g32, w32 = got.float(), want.float()
    _, e = torch.frexp(w32)
    mantissa = {torch.bfloat16: 7, torch.float32: 23}[got.dtype]
    ulp = torch.ldexp(torch.ones_like(w32), e - (1 + mantissa))
    diff = (g32 - w32).abs()
    assert bool((diff <= ulp).all()), f"worst {(diff / ulp).max().item():.2f} ulp"
    return int((diff > 0).sum())


def engine_positions(B: int, T: int, g: torch.Generator) -> torch.Tensor:
    """(3, B, T) M-RoPE positions as the engine lays out a prompt: text,
    four spans of 256 crop tokens (a 16 x 16 grid each: t the span's start,
    h and w its row and column added), text, then padding."""
    pos = torch.ones(3, B, T, dtype=torch.long)
    grid = torch.stack([torch.zeros(256, dtype=torch.long), torch.arange(256) // 16, torch.arange(256) % 16])
    for b in range(B):
        lead = int(torch.randint(600, 1100, (1,), generator=torch.Generator().manual_seed(b)))
        at = nxt = 0
        for m in range(4):
            start = lead + m * 260
            pos[:, b, at:start] = nxt + torch.arange(start - at)
            nxt += start - at
            pos[:, b, start:start + 256] = nxt + grid
            nxt = int(pos[:, b, start:start + 256].max()) + 1
            at = start + 256
        end = T - 40 * (b % 5)
        pos[:, b, at:end] = nxt + torch.arange(end - at)
    return pos.to(g.device)


# --------------------------------------------------------------------------- #
# each kernel against its plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["prefill", "prefill_first", "decode", "gemma", "f32_weight"])
def test_add_rms_norm(dev, case):
    g = torch.Generator(device=dev).manual_seed(1)
    rows, d = {"prefill": (CELL_B * CELL_T, 3584), "prefill_first": (CELL_B * CELL_T, 3584), "decode": (32, 3584),
               "gemma": (320 * 192, 2048), "f32_weight": (4096, 3584)}[case]
    x = randn(g, rows, d, scale=4.0)
    delta = None if case == "prefill_first" else randn(g, rows, d, scale=2.0)
    w = 1.0 + randn(g, d, scale=0.2, dtype=torch.float32 if case == "f32_weight" else BF)
    if case == "gemma":
        w = 1 + w  # the caller's (1 + w), in w's dtype
    eps = 1e-6
    got_x, got_h = G.add_rms_norm(x, delta, w, eps)
    want_x, want_h = G.add_rms_norm_reference(x, delta, w, eps)
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x)
    assert (got_x is x) == (delta is None)
    within_one_ulp(got_h, want_h)


@pytest.mark.parametrize("case", ["prefill_mrope", "decode_rope_pos", "decode_1d", "gemma", "f32"])
def test_bias_rope_is_bit_equal(dev, case):
    g = torch.Generator(device=dev).manual_seed(2)
    B, T, H, Hkv, hd, bias = {"prefill_mrope": (CELL_B, CELL_T, 28, 4, 128, True),
                              "decode_rope_pos": (CELL_B, 1, 28, 4, 128, True),
                              "decode_1d": (CELL_B, 1, 28, 4, 128, True), "gemma": (320, 192, 8, 1, 256, False),
                              "f32": (4, 64, 28, 4, 128, True)}[case]
    dtype = torch.float32 if case == "f32" else BF
    if case == "prefill_mrope":
        cfg = C.CausalLMConfig(**QWEN7B_LM)
        cos, sin = C.mrope_frequencies(cfg, engine_positions(B, T, g))
    else:
        cfg = C.CausalLMConfig(d_model=H * hd, num_heads=H, num_kv_heads=Hkv,
                               rope_theta=1e4 if case == "gemma" else 1e6)
        if case == "decode_rope_pos":
            cos, sin = C.rope_frequencies(cfg, torch.randint(1500, 2300, (B,), generator=g, device=dev)[:, None])
        elif case == "decode_1d":
            cos, sin = C.rope_frequencies(cfg, torch.tensor([2310], device=dev))
        else:
            cos, sin = C.rope_frequencies(cfg, torch.arange(T, device=dev))
    q, k, v = randn(g, B, T, H, hd, scale=3.0, dtype=dtype), randn(g, B, T, Hkv, hd, scale=3.0, dtype=dtype), \
        randn(g, B, T, Hkv, hd, scale=3.0, dtype=dtype)
    biases = [randn(g, n * hd, dtype=dtype) for n in (H, Hkv, Hkv)] if bias else [None] * 3
    want = G.bias_rope_reference(q, k, v, *biases, cos, sin)
    G.bias_rope_(q, k, v, *biases, cos, sin)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", (q, k, v), want):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} elements differ"


@pytest.mark.parametrize("case", ["prefill", "decode", "gemma", "f32", "odd_width"])
def test_glu(dev, case):
    g = torch.Generator(device=dev).manual_seed(3)
    rows, d_ff, act = {"prefill": (CELL_B * CELL_T, 18944, "silu"), "decode": (32, 18944, "silu"),
                       "gemma": (320 * 192, 16384, "gelu_tanh"), "f32": (512, 18944, "silu"),
                       "odd_width": (77, 3421, "silu")}[case]
    dtype = torch.float32 if case == "f32" else BF
    gate, up = randn(g, rows, d_ff, scale=3.0, dtype=dtype), randn(g, rows, d_ff, dtype=dtype)
    gate[0, :8] = torch.tensor([0.0, -0.0, 20.0, -20.0, 90.0, -90.0, 1e-3, -1e-3], dtype=dtype)
    got = G.glu(gate, up, act)
    want = G.glu_reference(gate, up, act)
    torch.cuda.synchronize()
    if act == "silu":
        assert torch.equal(got, want), f"{(got != want).sum().item()} elements differ"
    else:  # tanh-GELU: PyTorch's build may contract its polynomial otherwise; held to one ulp
        within_one_ulp(got, want)


# --------------------------------------------------------------------------- #
# whole passes, kernels against plain ops
# --------------------------------------------------------------------------- #
def seeded(cfg: C.CausalLMConfig, dev, dtype=BF) -> C.CausalLMParams:
    params = C.init_causal_lm_params(torch.Generator(device=dev).manual_seed(4), cfg, dtype)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for layer in params.layers:
            for t in [layer.ln0, layer.ln1] + [getattr(layer, n).bias for n in ("q", "k", "v")]:
                if t is not None:
                    t.add_(randn(g, *t.shape, scale=0.2, dtype=t.dtype))
    return params


def close(got, want, rel=1e-2):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(want.float().abs().max().item(), 1.0), err


def test_generate_kernels_against_plain_ops(dev, monkeypatch):
    cfg = C.CausalLMConfig(vocab_size=1024, d_model=256, num_layers=4, num_heads=4, num_kv_heads=2, d_ff=704,
                           tie_word_embeddings=False, mrope_section=(8, 12, 12))
    params = seeded(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    B, T, steps = 8, 96, 8
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None] < torch.tensor([T - 9 * b for b in range(B)], device=dev)[:, None]
    pos = torch.arange(T, device=dev).repeat(3, B, 1)

    def run():
        with torch.no_grad():
            logits, _ = C.prefill(params, cfg, ids, mask, T + steps, positions=pos)
        return logits, *C.generate(params, cfg, ids, mask, steps, positions=pos)

    profiling.reset()
    profiling.enable()
    kernels.reset_launch_counts()
    try:
        fused = run()
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    passes = 1 + steps  # the prefill, then generate's prefill and steps - 1 decode steps
    assert profiling.total(counts, "lm.glue_fused") == cfg.num_layers * passes
    assert profiling.total(counts, "lm.glue_plain") == 0
    assert kernels.LAUNCHES["lm_add_rms_norm"] == (2 * cfg.num_layers + 1) * passes
    assert kernels.LAUNCHES["lm_bias_rope"] == kernels.LAUNCHES["lm_glu"] == cfg.num_layers * passes
    monkeypatch.setattr(C, "_glue_fused", lambda x, *held: False)
    plain = run()
    close(fused[0], plain[0])
    assert torch.equal(fused[1], plain[1]), "tokens differ"
    close(fused[2], plain[2])


def test_gemma_reranker_hidden_states_against_plain_ops(dev, monkeypatch):
    cfg = C.CausalLMConfig(vocab_size=1024, d_model=512, num_layers=2, num_heads=8, num_kv_heads=1, d_ff=1024,
                           rope_theta=1e4, qkv_bias=False, arch="gemma", head_dim_override=256)
    params = seeded(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    B, T = 16, 192
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
    mask = torch.arange(T, device=dev)[None] < torch.tensor([T - 11 * b for b in range(B)], device=dev)[:, None]
    with torch.no_grad():
        kernels.reset_launch_counts()
        fused = C.forward_hidden(params, cfg, ids, mask)
        assert kernels.LAUNCHES["lm_glu"] == cfg.num_layers
        monkeypatch.setattr(C, "_glue_fused", lambda x, *held: False)
        plain = C.forward_hidden(params, cfg, ids, mask)
    close(fused[mask], plain[mask])
