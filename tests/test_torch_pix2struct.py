"""Port parity, the Pix2Struct model on the CPU: the plain versions of the
query-tiled T5 layer (K13) and of K1's bias-free form against the JAX
package's Pallas kernels in interpret mode, `vision_encode` and `generate`
against the JAX model, and the parameter conversions, on the same
numpy-seeded inputs.

Tolerances: one f32 layer 2e-5 (of the largest value, at least 1) on every
row with a valid key; the stack 3e-5 against the JAX XLA blocks (the JAX
tests' own bound for the kernels against them); decoded ids exact, the
confidence 1e-5; bf16 2e-2 of the largest value (two bf16 ulps there). A row
with no valid key attends uniformly in both packages (-1e9 masking) and is
compared too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import pix2struct as j_p2s
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.ops import fused_encoder as j_fe
from rag_docvqa_tpu_torch import params as P
from rag_docvqa_tpu_torch.models import pix2struct as p2s
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.ops import fused_encoder as fe

torch.set_num_threads(2)

D, H, DFF, EPS = 64, 4, 128, 1e-6
T = torch.from_numpy


def _jax_layer(seed, gated, d=D, dff=DFF):
    """One bias-free T5 layer in the JAX kernels' form: (in, out) kernels,
    (1, d) norm rows."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    l = {"wqkv": f(d, 3 * d) * d**-0.5, "wo": f(d, d) * d**-0.5, "ln0": rng.rand(1, d).astype(np.float32) + 0.5,
         "ln1": rng.rand(1, d).astype(np.float32) + 0.5, "wof": f(dff, d) * dff**-0.5}
    if gated:
        l.update(wi_0=f(d, dff) * d**-0.5, wi_1=f(d, dff) * d**-0.5)
    else:
        l["wi"] = f(d, dff) * d**-0.5
    return l


def _port_layer(jl, dtype=torch.float32):
    return {k: (T(np.array(v)).t().contiguous() if k.startswith("w") else T(np.array(v))[0]).to(dtype)
            for k, v in jl.items()}


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all(), name
    assert float(np.abs(got - want).max()) <= tol * scale, (name, float(np.abs(got - want).max()), scale)


def _jax_qtiled(x, mask, jl, gated, TQ, kc, ffn_chunk):
    ffn = (jl["wi_0"], jl["wi_1"], jl["wof"]) if gated else (jl["wi"], jl["wof"])
    return j_fe._t5_layer_call_qtiled(jnp.asarray(x), jnp.asarray(mask)[:, None, :], jnp.asarray(jl["wqkv"]),
                                      jnp.asarray(jl["wo"]), jnp.asarray(jl["ln0"]), jnp.asarray(jl["ln1"]),
                                      *map(jnp.asarray, ffn), num_heads=H, eps=EPS, gated=gated, interpret=True,
                                      TQ=TQ, kc=kc, ffn_chunk=ffn_chunk)


# lengths straddle the query tiles and the key chunks; the last row has no valid key
QTILED_CASES = [(True, 8, 8, 0), (True, 16, 8, 64), (False, 8, 16, 0), (False, 32, 32, 32), (True, 32, 8, 32)]


@pytest.mark.parametrize("gated,TQ,kc,ffn_chunk", QTILED_CASES)
def test_qtiled_layer_matches_jax_kernel(gated, TQ, kc, ffn_chunk):
    B, N = 4, 32
    jl = _jax_layer(TQ + kc, gated)
    rng = np.random.RandomState(kc)
    x = rng.randn(B, N, D).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray([32, 19, 5, 0])[:, None]
    want = _jax_qtiled(x, mask, jl, gated, TQ, kc, ffn_chunk)
    kw = dict(num_heads=H, eps=EPS, gated=gated)
    # the plain version with the TPU kernel's own tile sizes, step by step
    ref = fe.t5_layer_qtiled_reference(T(x), T(mask), _port_layer(jl), TQ=TQ, kc=kc, ffn_chunk=ffn_chunk, **kw)
    _close(ref.numpy(), want, 2e-5, "plain, same tiles")
    # the wrapper (on CPU tensors: the plain version, one query tile) and K1's plain parts, which are
    # what the card runs: tile sizes change only the order of f32 sums
    got = fe.fused_t5_layer_qtiled(T(x), T(mask), _port_layer(jl), **kw)
    _close(got.numpy(), want, 2e-5, "wrapper")
    parts = fe.t5_layer_reference(T(x), T(mask), None, _port_layer(jl), **kw)
    _close(parts.numpy(), want, 2e-5, "K1 parts without a bias")


def test_qtiled_reference_needs_whole_tiles():
    jl = _port_layer(_jax_layer(0, True))
    x, mask = torch.zeros(1, 12, D), torch.ones(1, 12, dtype=torch.bool)
    with pytest.raises(ValueError):
        fe.t5_layer_qtiled_reference(x, mask, jl, num_heads=H, eps=EPS, gated=True, TQ=8)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("B,N,lens", [(4, 13, [13, 9, 1, 0]), (2, 24, [24, 17])])
def test_bias_free_layer_matches_jax_kernel(gated, B, N, lens):
    """K1 without a bias (the chunk budget's layer). The JAX kernel wants
    T % 8 == 0: its callers pad and mask, and so does this test."""
    jl = _jax_layer(N, gated)
    rng = np.random.RandomState(N + gated)
    x = rng.randn(B, N, D).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(lens)[:, None]
    pad = -N % 8
    xp, mp = np.pad(x, ((0, 0), (0, pad), (0, 0))), np.pad(mask, ((0, 0), (0, pad)))
    want = j_fe.fused_t5_layer_parts(jnp.asarray(xp), jnp.asarray(mp), None, {k: jnp.asarray(v) for k, v in jl.items()},
                                     num_heads=H, eps=EPS, gated=gated, interpret=True)[:, :N]
    got = fe.fused_t5_layer_parts(T(x), T(mask), None, _port_layer(jl), num_heads=H, eps=EPS, gated=gated)
    alive = mask.any(axis=1)
    _close(got.numpy()[alive], np.asarray(want)[alive], 2e-5)
    # a row with no valid key is uniform over its keys: over N here, over the padded N there
    assert np.isfinite(got.numpy()).all()
    if pad == 0:
        _close(got.numpy(), want, 2e-5)


def test_bias_free_layer_bf16_bound():
    jl = _jax_layer(1, True)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, D).astype(np.float32)
    mask = np.arange(16)[None, :] < np.asarray([16, 7])[:, None]
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in jl.items()}
    want = j_fe.fused_t5_layer_parts(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask), None, jb, num_heads=H,
                                     eps=EPS, gated=True, interpret=True)
    for fn in (lambda *a, **k: fe.fused_t5_layer_parts(a[0], a[1], None, a[2], **k), fe.fused_t5_layer_qtiled):
        got = fn(T(x).bfloat16(), T(mask), _port_layer(jl, torch.bfloat16), num_heads=H, eps=EPS, gated=True)
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), want.astype(jnp.float32), 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_free_attention_slot_picks_by_dtype(dtype, monkeypatch):
    """Every bias-free row, bf16 or f32, K1's and K13's alike, takes K2's
    wrapper with no bias, scale 1 and mask value -1e9, as a layer with a bias
    does with its bias. On the CPU the wrapper runs the plain attention."""
    calls = []
    real_f = fe.flash_attention_fwd

    def spy(q, k, v, key_mask, bias, scale, causal, mask_value):
        calls.append((bias is None, scale, causal, mask_value))
        return real_f(q, k, v, key_mask, bias, scale, causal, mask_value)

    monkeypatch.setattr(fe, "flash_attention_fwd", spy)
    jl = _jax_layer(2, True)
    rng = np.random.RandomState(2)
    x, mask = T(rng.randn(2, 16, D).astype(np.float32)).to(dtype), T(np.arange(16)[None, :] < np.asarray([16, 7])[:, None])
    l = _port_layer(jl, dtype)
    kw = dict(num_heads=H, eps=EPS, gated=True)
    got = fe.fused_t5_layer_parts(x, mask, None, l, **kw)
    assert calls == [(True, 1.0, False, fe.T5_MASK_VALUE)] and fe.T5_MASK_VALUE == -1e9
    want = fe.t5_layer_reference(x, mask, None, l, **kw)
    assert torch.equal(got, want)
    calls.clear()
    bias = T(rng.randn(H, 16, 16).astype(np.float32)).bfloat16()
    fe.fused_t5_layer_parts(x, mask, bias, l, **kw)
    assert calls == [(False, 1.0, False, fe.T5_MASK_VALUE)]
    assert not hasattr(fe, "qtiled_attention") and not hasattr(fe, "bias_free_attention")


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def _cfg_pair(vocab=300):
    vis = dict(hidden_size=64, num_layers=2, num_heads=4, d_ff=128, patch_dim=48, max_rows=16, max_cols=16)
    text = dict(vocab_size=vocab, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_encoder_layers=0,
                num_decoder_layers=2, gated_ffn=True, tie_word_embeddings=False, dropout_rate=0.0)
    return (j_p2s.Pix2StructConfig(vision=j_p2s.P2SVisionConfig(**vis), text=j_t5.T5Config(**text)),
            p2s.Pix2StructConfig(vision=p2s.P2SVisionConfig(**vis), text=t5m.T5Config(**text)))


def _patches(B, N, lens, seed, cols=4):
    rng = np.random.RandomState(seed)
    vals = rng.randn(B, N, 48).astype(np.float32)
    rows = np.tile((np.arange(N)[None, :, None] // cols + 1), (B, 1, 1)).astype(np.float32)
    colid = np.tile((np.arange(N)[None, :, None] % cols + 1), (B, 1, 1)).astype(np.float32)
    mask = (np.arange(N)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    patches = np.concatenate([rows, colid, vals], axis=-1) * mask[..., None]  # padding rows are all zero
    return patches, mask


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfg_pair()
    tree = jax.tree.map(np.array, j_p2s.init_p2s_params(jax.random.PRNGKey(0), jcfg))
    tree["vision"]["patch_proj"]["bias"] = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    return jcfg, cfg, tree, P.p2s_from_jax(tree)


@pytest.mark.parametrize("N,lens", [(13, [13, 9, 1, 5]), (32, [32, 19, 5, 32])])
def test_vision_encode_matches_jax(model, N, lens):
    jcfg, cfg, tree, params = model
    patches, mask = _patches(4, N, lens, N)
    want = j_p2s.vision_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(patches), jnp.asarray(mask),
                               fused=False)
    got = p2s.vision_encode(params, cfg, T(patches), T(mask))
    assert got.shape == (4, N, 64)
    m = mask.astype(bool)
    _close(got.numpy()[m], np.asarray(want)[m], 3e-5)


def test_vision_encode_long_rows_take_the_qtiled_layer(model, monkeypatch):
    """T > 1024 goes to K13, T <= 1024 to K1's bias-free form: the line the
    TPU pickers draw at pix2struct-base width. Both give the JAX values."""
    jcfg, cfg, tree, params = model
    calls = []
    real_q, real_p = p2s.fused_t5_layer_qtiled, p2s.fused_t5_layer_parts
    monkeypatch.setattr(p2s, "fused_t5_layer_qtiled", lambda *a, **k: (calls.append("qtiled"), real_q(*a, **k))[1])
    monkeypatch.setattr(p2s, "fused_t5_layer_parts", lambda *a, **k: (calls.append("parts"), real_p(*a, **k))[1])
    patches, mask = _patches(1, 1024, [700], 5, cols=16)
    p2s.vision_encode(params, cfg, T(patches), T(mask))
    assert calls == ["parts", "parts"]
    calls.clear()
    monkeypatch.setattr(p2s, "QTILED_ABOVE", 16)
    patches, mask = _patches(3, 32, [32, 19, 5], 6)
    got = p2s.vision_encode(params, cfg, T(patches), T(mask))
    assert calls == ["qtiled", "qtiled"]
    want = j_p2s.vision_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(patches), jnp.asarray(mask),
                               fused=False)
    m = mask.astype(bool)
    _close(got.numpy()[m], np.asarray(want)[m], 3e-5)
    assert p2s.QTILED_ABOVE == 16 and j_fe._pick_rows_t5(8, 2048, 768, 768, 2048, 12, True, 2, has_bias=False)[0] == 0 \
        and j_fe._pick_rows_t5(8, 1024, 768, 768, 2048, 12, True, 2, has_bias=False)[0] > 0


def test_generate_matches_jax(model):
    jcfg, cfg, tree, params = model
    patches, mask = _patches(3, 24, [24, 11, 3], 2)
    jt, jc = j_p2s.generate(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(patches), jnp.asarray(mask),
                            max_new_tokens=5)
    gt, gc = p2s.generate(params, cfg, T(patches), T(mask), max_new_tokens=5)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(gc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    # f16 patches on the wire with f32 weights: cast to the parameter dtype before the projection
    h16 = p2s.vision_encode(params, cfg, T(patches.astype(np.float16)), T(mask))
    assert h16.dtype == torch.float32
    # ids beyond the tables are clipped, as in JAX
    far = patches.copy()
    far[:, :, 0] *= 100
    want = j_p2s.vision_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(far), jnp.asarray(mask), fused=False)
    m = mask.astype(bool)
    _close(p2s.vision_encode(params, cfg, T(far), T(mask)).numpy()[m], np.asarray(want)[m], 3e-5)


def test_p2s_params_round_trip(model):
    jcfg, cfg, tree, params = model
    back = P.p2s_to_jax(params)
    for part in ("vision", "text"):
        a = jax.tree_util.tree_flatten_with_path(tree[part])[0]
        b = jax.tree_util.tree_flatten_with_path(back[part])[0]
        a = [(k, v) for k, v in a if np.size(v)]  # the JAX decoder-only T5 tree keeps empty (0, ...) encoder stacks
        assert [k for k, _ in a] == [k for k, _ in b], part
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y)
    own = P.p2s_to_jax(p2s.init_p2s_params(torch.Generator().manual_seed(0), cfg))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, back)
    assert p2s.Pix2StructConfig() .text.vocab_size == j_p2s.Pix2StructConfig().text.vocab_size == 50244
    import dataclasses
    want = dataclasses.asdict(j_p2s.Pix2StructConfig().vision)
    assert want.pop("flash_encoder") is False  # the JAX tower's route switch; the port's tower has one route
    assert dataclasses.asdict(p2s.Pix2StructConfig().vision) == want


def test_convert_p2s_state_dict_copy_matches_original():
    jcfg, cfg = _cfg_pair()
    rng = np.random.RandomState(11)
    d, f, V = 64, 128, 300
    sd = {"encoder.embeddings.patch_projection.weight": rng.randn(d, 48),
          "encoder.embeddings.patch_projection.bias": rng.randn(d),
          "encoder.embeddings.row_embedder.weight": rng.randn(16, d),
          "encoder.embeddings.column_embedder.weight": rng.randn(16, d),
          "encoder.layernorm.weight": rng.randn(d), "decoder.embed_tokens.weight": rng.randn(V, d),
          "decoder.final_layer_norm.weight": rng.randn(d), "decoder.lm_head.weight": rng.randn(V, d),
          "decoder.layer.0.self_attention.attention.relative_attention_bias.weight": rng.randn(32, 4)}
    for i in range(2):
        e = f"encoder.encoder.layer.{i}."
        for n in ("query", "key", "value", "output"):
            sd[e + f"attention.{n}.weight"] = rng.randn(d, d)
        sd[e + "pre_attention_layer_norm.weight"], sd[e + "pre_mlp_layer_norm.weight"] = rng.randn(d), rng.randn(d)
        sd[e + "mlp.wi_0.weight"], sd[e + "mlp.wi_1.weight"], sd[e + "mlp.wo.weight"] = \
            rng.randn(f, d), rng.randn(f, d), rng.randn(d, f)
        dl = f"decoder.layer.{i}."
        for blk in ("self_attention", "encoder_decoder_attention"):
            for n in ("query", "key", "value", "output"):
                sd[dl + f"{blk}.attention.{n}.weight"] = rng.randn(d, d)
            sd[dl + f"{blk}.layer_norm.weight"] = rng.randn(d)
        sd[dl + "mlp.layer_norm.weight"] = rng.randn(d)
        sd[dl + "mlp.DenseReluDense.wi_0.weight"], sd[dl + "mlp.DenseReluDense.wi_1.weight"] = rng.randn(f, d), rng.randn(f, d)
        sd[dl + "mlp.DenseReluDense.wo.weight"] = rng.randn(d, f)
    want, got = j_p2s.convert_p2s_state_dict(sd, jcfg), p2s.convert_p2s_state_dict(sd, cfg)
    fw, fg = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in fw] == [k for k, _ in fg]
    for (_, a), (_, b) in zip(fw, fg):
        np.testing.assert_array_equal(a, b)
    params = P.p2s_from_jax(got)  # a decoder-only text tree ("encoder": {}) loads
    assert len(params.text.encoder.layers) == 0 and params.text.lm_head.shape == (V, d)
