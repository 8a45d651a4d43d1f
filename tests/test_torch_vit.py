"""Port parity, the ViT / BEiT tower (K14) on the CPU: the plain versions the
wrappers run on CPU tensors against the JAX package's Pallas ViT-layer
kernel in interpret mode, `vit_encode` against the JAX tower (its fused
stack in interpret mode and its XLA blocks), and `visual_features`, on the
same numpy-seeded inputs.

Tolerances: one f32 layer 2e-5 (of the largest value, at least 1); the
stack 1e-4 against the kernel route and 1e-3 against the XLA blocks, which
use the exact erf and keep an f32 rel-pos table (the JAX tests' own bound
for kernel vs blocks); integer outputs exact; bf16 0.06 absolute on values
of magnitude up to ~4 (a few bf16 ulps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import vit as j_vit
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops import fused_encoder as j_fe
from rag_docvqa_tpu_torch import params as P
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models import vit
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops import fused_encoder as fe

torch.set_num_threads(2)

EPS = 1e-12
D, H, DFF = 64, 4, 128


def _jax_layer(seed, T, has_bias, has_gamma, d=D, dff=DFF):
    """One layer in the JAX kernel's form: (in, out) kernels, (1, n) biases,
    (2, d) pairs, a bf16 (H, T, T) bias."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    ln = lambda: np.stack([rng.rand(d).astype(np.float32) + 0.5, f(d) * 0.1])
    l = {"wqkv": f(d, 3 * d) * d**-0.5, "bqkv": f(1, 3 * d) * 0.1, "wo": f(d, d) * d**-0.5, "bo": f(1, d) * 0.1,
         "ln1": ln(), "ln2": ln(), "w1": f(d, dff) * d**-0.5, "b1": f(1, dff) * 0.1, "w2": f(dff, d) * dff**-0.5,
         "b2": f(1, d) * 0.1}
    if has_bias:
        l["bias"] = jnp.asarray(f(H, T, T)).astype(jnp.bfloat16)
    if has_gamma:
        l["gamma"] = np.stack([rng.rand(d).astype(np.float32) * 0.5 + 0.1, rng.rand(d).astype(np.float32) * 0.5 + 0.1])
    return l


def _port_layer(jl, dtype=torch.float32):
    out = {}
    for k, v in jl.items():
        if k == "bias":
            out[k] = torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
            continue
        t = torch.from_numpy(np.array(v))
        out[k] = (t.t().contiguous() if k.startswith("w") else t[0] if k.startswith("b") else t).to(dtype)
    return out


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all(), name
    assert float(np.abs(got - want).max()) <= tol * scale, (name, float(np.abs(got - want).max()), scale)


# (B, T, valid lengths): T 197's residue (odd), a T that is no multiple of 8, and an aligned one; then T on
# either side of the card kernel's 64-query tiles and of its 256-key score row (257: two passes), with rows of
# no valid key (uniform over the T real keys) and of a single key
LAYER_CASES = [(3, 17, [17, 17, 17]), (4, 13, [13, 9, 13, 1]), (2, 24, [24, 16]),
               (2, 63, [63, 0]), (2, 65, [65, 1]), (2, 129, [129, 0]), (1, 257, [257])]


@pytest.mark.parametrize("form", ["vit", "beit_bias_gamma", "bias_only", "gamma_only"])
@pytest.mark.parametrize("B,T,lens", LAYER_CASES)
def test_vit_layer_matches_jax_kernel(form, B, T, lens):
    has_bias, has_gamma = form in ("beit_bias_gamma", "bias_only"), form in ("beit_bias_gamma", "gamma_only")
    jl = _jax_layer(T + len(form), T, has_bias, has_gamma)
    if form == "beit_bias_gamma":
        jl["bqkv"][0, D:2 * D] = 0.0  # BEiT: no key bias
    rng = np.random.RandomState(B * T)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    want = j_fe.fused_vit_layer_parts(jnp.asarray(x), jnp.asarray(mask), {k: jnp.asarray(v) for k, v in jl.items()},
                                      num_heads=H, eps=EPS, interpret=True)
    got = fe.fused_vit_layer_parts(torch.from_numpy(x), torch.from_numpy(mask), _port_layer(jl), num_heads=H, eps=EPS)
    _close(got.numpy(), want, 2e-5, form)
    ref = fe.vit_layer_reference(torch.from_numpy(x), torch.from_numpy(mask), _port_layer(jl), num_heads=H, eps=EPS)
    assert torch.equal(got, ref)  # on CPU tensors the wrapper is the plain version
    if has_bias:  # the kernels' form: the bias rows zero-padded to a multiple of 8, as fuse_vit_blocks builds it
        pl = _port_layer(jl)
        pl["bias"] = torch.nn.functional.pad(pl["bias"], (0, fe.vit_bias_width(T) - T))
        assert torch.equal(fe.fused_vit_layer_parts(torch.from_numpy(x), torch.from_numpy(mask), pl, num_heads=H,
                                                    eps=EPS), got)


def test_fuse_vit_blocks_pads_the_bias_rows():
    """The rel-pos bias in the kernels' form: (H, T, vit_bias_width(T)) bf16,
    the gathered table in the first T columns and zeros after, contiguous (the
    card kernel copies its rows 16 bytes at a time)."""
    _, pcfg = _cfg_pair("beit")
    params = vit.init_vit_params(torch.Generator().manual_seed(3), pcfg)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for layer in params.layers:  # the init's table is zeros: make it count
            layer.rel_bias_table.copy_(torch.from_numpy(rng.randn(*layer.rel_bias_table.shape).astype(np.float32)))
    rel_index = torch.from_numpy(vit.beit_relative_position_index(pcfg.grid)).long()
    T = rel_index.shape[-1]
    Tb = fe.vit_bias_width(T)
    assert Tb % 8 == 0 and 0 <= Tb - T < 8
    for layer, fused in zip(params.layers, fe.fuse_vit_blocks(params.layers, rel_index)):
        b = fused["bias"]
        assert b.shape == (H, T, Tb) and b.dtype == torch.bfloat16 and b.is_contiguous()
        assert torch.equal(b[..., :T], layer.rel_bias_table[rel_index].permute(2, 0, 1).to(torch.bfloat16))
        assert not b[..., T:].any()


def test_vit_layer_bf16_bound():
    B, T = 3, 17
    jl = _jax_layer(5, T, True, True)
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.ones((B, T), bool)
    jb = {k: (jnp.asarray(v).astype(jnp.bfloat16)) for k, v in jl.items()}
    want = j_fe.fused_vit_layer_parts(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask), jb, num_heads=H, eps=EPS,
                                      interpret=True)
    got = fe.fused_vit_layer_parts(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask),
                                   _port_layer(jl, torch.bfloat16), num_heads=H, eps=EPS)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 0.06, err


def test_vit_parts_plain_versions():
    """The new parts against straightforward formulas: the LayerNorm over the
    compute dtype, the layer-scale residual epilogue, the attention with
    normalise-then-cast."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(11, D).astype(np.float32))
    ln = torch.from_numpy(np.stack([rng.rand(D) + 0.5, rng.randn(D) * 0.1]).astype(np.float32))
    want = torch.nn.functional.layer_norm(x, (D,), ln[0], ln[1], EPS)
    assert (fe.vit_layer_norm_rows(x, ln, EPS) - want).abs().max() <= 2e-6
    a, w = torch.from_numpy(rng.randn(11, 24).astype(np.float32)), torch.from_numpy(rng.randn(D, 24).astype(np.float32))
    b, g = torch.from_numpy(rng.randn(D).astype(np.float32)), torch.from_numpy(rng.rand(D).astype(np.float32))
    got = fe.vit_gemm(a, w, "bias_scale_residual", x, b, g)
    assert (got - (x + (a @ w.t() + b) * g)).abs().max() <= 1e-5
    got = fe.vit_gemm(a, w, "bias_scale_residual", x, b)
    assert (got - (x + (a @ w.t() + b))).abs().max() <= 1e-5
    with pytest.raises(ValueError):
        fe.vit_gemm(a, w, "relu")
    with pytest.raises(ValueError):
        fe.gemm(a, w, "bias_scale_residual", x, b)
    # bf16: every step of the residual branch is rounded to bf16
    a16, w16, x16, b16, g16 = (t.bfloat16() for t in (a, w, x, b, g))
    got = fe.vit_gemm(a16, w16, "bias_scale_residual", x16, b16, g16)
    y = (a16.float() @ w16.float().t() + b16.float()).bfloat16()
    assert torch.equal(got, (y * g16) + x16)
    qkv = torch.from_numpy(rng.randn(2, 9, 3, H, 16).astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[1, 5:] = False
    out = fe.vit_attention(qkv, mask, None, 0.25)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :], scale=0.25)
    assert (out - want.transpose(1, 2).reshape(2, 9, H * 16)).abs().max() <= 2e-6


def _cfg_pair(arch, image=32, patch=8):
    kw = dict(image_size=image, patch_size=patch, hidden_size=D, num_layers=2, num_heads=H, mlp_dim=DFF, arch=arch,
              use_rel_pos_bias=arch == "beit", use_abs_pos=arch == "vit",
              layer_scale_init=0.1 if arch == "beit" else 0.0, use_final_layernorm=arch == "vit")
    return j_vit.ViTConfig(**kw), vit.ViTConfig(**kw)


def _jax_vit_params(jcfg, seed, bf16_exact_table=True):
    tree = jax.tree.map(np.array, j_vit.init_vit_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    blocks = tree["blocks"]
    for name in ("q", "k", "v", "o", "fc1", "fc2"):  # the JAX init has zero biases: make them count
        if "bias" in blocks[name]:
            blocks[name]["bias"] = (rng.randn(*blocks[name]["bias"].shape) * 0.1).astype(np.float32)
    if "rel_bias_table" in blocks:
        t = rng.randn(*blocks["rel_bias_table"].shape).astype(np.float32)
        # a table that bf16 holds exactly: the kernel route casts the gathered bias to bf16, the XLA blocks do not
        blocks["rel_bias_table"] = np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
    if "lambda_1" in blocks:
        blocks["lambda_1"] = (rng.rand(*blocks["lambda_1"].shape) * 0.5 + 0.1).astype(np.float32)
        blocks["lambda_2"] = (rng.rand(*blocks["lambda_2"].shape) * 0.5 + 0.1).astype(np.float32)
    return tree


@pytest.mark.parametrize("arch", ["vit", "beit"])
def test_vit_encode_matches_jax(arch):
    jcfg, cfg = _cfg_pair(arch)
    tree = _jax_vit_params(jcfg, 3)
    rng = np.random.RandomState(3)
    pixels = rng.randn(3, 32, 32, 3).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    want_kernel = j_vit.vit_encode(jtree, jcfg, jnp.asarray(pixels), fused=True)  # interpret mode off the TPU
    want_blocks = j_vit.vit_encode(jtree, jcfg, jnp.asarray(pixels), fused=False)
    params = P.vit_from_jax(tree)
    got = vit.vit_encode(params, cfg, torch.from_numpy(pixels))
    assert got.shape == (3, cfg.seq_len, D)
    _close(got.numpy(), want_kernel, 1e-4, "kernel route")
    _close(got.numpy(), want_blocks, 1e-3, "XLA blocks")
    # return_hidden_states: the same layers' outputs, as the JAX blocks collect them
    got2, per_layer = vit.vit_encode(params, cfg, torch.from_numpy(pixels), return_hidden_states=True)
    _, want_layers = j_vit.vit_encode(jtree, jcfg, jnp.asarray(pixels), return_hidden_states=True)
    assert torch.equal(got, got2) and per_layer.shape == (2, 3, cfg.seq_len, D)
    _close(per_layer.numpy(), want_layers, 1e-3, "per layer")


@pytest.mark.parametrize("arch", ["vit", "beit"])
def test_vit_params_round_trip(arch):
    jcfg, cfg = _cfg_pair(arch)
    tree = _jax_vit_params(jcfg, 4)
    back = P.vit_to_jax(P.vit_from_jax(tree))
    flat_a, flat_b = jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the same tree (names and shapes)
    own = P.vit_to_jax(vit.init_vit_params(torch.Generator().manual_seed(0), cfg))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)


def test_helpers_match_jax():
    for grid in (2, 4, 14):
        np.testing.assert_array_equal(vit.beit_relative_position_index(grid), j_vit.beit_relative_position_index(grid))
    rng = np.random.RandomState(1)
    pixels = rng.randn(2, 32, 48, 3).astype(np.float32)
    np.testing.assert_array_equal(vit.extract_patches(torch.from_numpy(pixels), 8).numpy(),
                                  np.asarray(j_vit.extract_patches(jnp.asarray(pixels), 8)))
    jcfg, cfg = _cfg_pair("beit", 224, 16)
    assert (cfg.seq_len, cfg.num_relative_distance, cfg.grid) == (jcfg.seq_len, jcfg.num_relative_distance, jcfg.grid)
    assert cfg.seq_len == 197


@pytest.mark.parametrize("arch", ["vit", "beit"])
def test_convert_vit_state_dict_copy_matches_original(arch):
    jcfg, cfg = _cfg_pair(arch)
    rng = np.random.RandomState(7)
    L, d, m, p = 2, D, DFF, 8
    sd = {"embeddings.patch_embeddings.projection.weight": rng.randn(d, 3, p, p), "embeddings.cls_token": rng.randn(1, 1, d),
          "embeddings.patch_embeddings.projection.bias": rng.randn(d)}
    if arch == "vit":
        sd.update({"embeddings.position_embeddings": rng.randn(1, 17, d), "layernorm.weight": rng.randn(d),
                   "layernorm.bias": rng.randn(d)})
    for i in range(L):
        pre = f"encoder.layer.{i}."
        for n, shape in (("layernorm_before", (d,)), ("layernorm_after", (d,))):
            sd[pre + n + ".weight"], sd[pre + n + ".bias"] = rng.randn(*shape), rng.randn(*shape)
        for n in ("query", "key", "value"):
            sd[pre + f"attention.attention.{n}.weight"] = rng.randn(d, d)
            if not (arch == "beit" and n == "key"):
                sd[pre + f"attention.attention.{n}.bias"] = rng.randn(d)
        for n, (o, i_) in (("attention.output.dense", (d, d)), ("intermediate.dense", (m, d)), ("output.dense", (d, m))):
            sd[pre + n + ".weight"], sd[pre + n + ".bias"] = rng.randn(o, i_), rng.randn(o)
        if arch == "beit":
            sd[pre + "attention.attention.relative_position_bias.relative_position_bias_table"] = \
                rng.randn(cfg.num_relative_distance, H)
            sd[pre + "lambda_1"], sd[pre + "lambda_2"] = rng.rand(d), rng.rand(d)
    want, got = j_vit.convert_vit_state_dict(sd, jcfg), vit.convert_vit_state_dict(sd, cfg)
    flat_w, flat_g = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(a, b)
    P.vit_from_jax(got)  # and the port's modules take it


def test_visual_features_and_input_embeds_match_jax():
    jvit, pvit = _cfg_pair("beit")
    t5kw = dict(vocab_size=512, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=1, num_decoder_layers=1,
                dropout_rate=0.0)
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**t5kw), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           vit=jvit, use_visual=True)
    cfg = vt5m.VT5Config(t5=t5m.T5Config(**t5kw), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0), vit=pvit,
                         use_visual=True)
    tree = jax.tree.map(np.array, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    tree["visual"]["vit"] = _jax_vit_params(jvit, 9)
    tree["visual"]["matcher"]["bias"] = np.linspace(-1, 1, 32).astype(np.float32)
    params = P.from_jax(tree)
    assert params.visual is not None
    rng = np.random.RandomState(2)
    images = rng.randn(2, 32, 32, 3).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    want = j_vt5.visual_features(jtree, jcfg, jnp.asarray(images))
    got = vt5m.visual_features(params, cfg, torch.from_numpy(images))
    assert got.shape == (2, 17, 32)
    _close(got.numpy(), want, 1e-3)
    # the tree goes back whole
    back = P.to_jax(params)
    np.testing.assert_array_equal(back["visual"]["matcher"]["kernel"], tree["visual"]["matcher"]["kernel"])
    assert jax.tree.map(np.shape, back["visual"]) == jax.tree.map(np.shape, tree["visual"])
    # the port's own init builds the same subtree
    own = P.to_jax(vt5m.init_vt5_params(torch.Generator().manual_seed(0), cfg))
    assert jax.tree.map(np.shape, own["visual"]) == jax.tree.map(np.shape, tree["visual"])
