"""Port parity, the causal LM: `models/causal_lm.py` against the JAX
package's on the same weights (the JAX init carried over with
`params.causal_lm_from_jax`) and numpy-seeded inputs.

Qwen2 (GQA 4/2, QKV biases, an untied head) and Gemma (MQA, head_dim 32 and
256, the tied head), in f32 and bf16: `forward`, `prefill` (last logits and
the KV cache), one `decode_step`, `generate` on ragged right-padded prompts,
`sft_loss` and the visual splice. f32 holds logits and hidden states within
2e-5 relative to their largest value (XLA's and torch's CPU sums run in other
orders), decoded ids exactly and confidences within 1e-5 relative; bf16
outputs within twice JAX's own bf16 error against JAX's f32 (see the test)
and its greedy ids on 3 of 4 positions. The int8 tree of
`quantize_weights_int8` equals JAX's bit for bit and decodes the same ids;
`init_causal_lm_params_int8` gives the same tree shape. The converters give
JAX's trees and Hugging Face's logits (Qwen2ForCausalLM, GemmaForCausalLM,
within 3e-4 as the JAX tests hold them); a Qwen2 checkpoint saved under
tmp_path loads through both `load_params_for`.

The port's attention here is K2's plain version (CPU tensors); a padded
query row gets zeros there and a uniform row in JAX's XLA path, so padded
positions are not compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import causal_lm as J
from rag_docvqa_tpu_torch import params as P
from rag_docvqa_tpu_torch.models import causal_lm as C

torch.set_num_threads(2)

ARCHS = {
    "qwen2": dict(vocab_size=97, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=48,
                  tie_word_embeddings=False),
    "gemma_hd32": dict(vocab_size=97, d_model=32, num_layers=2, num_heads=4, num_kv_heads=1, d_ff=48,
                       qkv_bias=False, arch="gemma", head_dim_override=32, rope_theta=1e4),
    "gemma_hd256": dict(vocab_size=97, d_model=64, num_layers=2, num_heads=2, num_kv_heads=1, d_ff=64,
                        qkv_bias=False, arch="gemma", head_dim_override=256, rope_theta=1e4),
}
LENS = [10, 7, 4]
T = 10


def _tree(arch, dtype=jnp.float32):
    """JAX weights with every leaf moved off its init (unit norms, zero
    biases) so that each term is exercised; cast to `dtype`."""
    cfg = J.CausalLMConfig(**ARCHS[arch])
    tree = J.init_causal_lm_params(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.RandomState(1)
    leaves = [jnp.asarray(np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32), dtype) for x in leaves]
    return cfg, C.CausalLMConfig(**ARCHS[arch]), jax.tree.unflatten(treedef, leaves)


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 97, (len(LENS), T)).astype(np.int32)
    mask = np.arange(T)[None] < np.asarray(LENS)[:, None]
    return ids, mask


def _jax_fields(cfg) -> dict:
    """The port's config as JAX's has it: the fields JAX has, the port's
    others (`mrope_section`, M-RoPE's sections; the expert layer's `moe_*`)
    at their defaults, off."""
    default = C.CausalLMConfig()
    own = [k for k in vars(cfg) if k == "mrope_section" or k.startswith("moe_")]
    assert all(getattr(cfg, k) == getattr(default, k) for k in own)
    return {k: v for k, v in vars(cfg).items() if k not in own}


def _close(got, want, rel, where=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1.0))


def _jax_outputs(tree, jc, ids, mask, vemb, vmask, token, step_mask, rope, labels):
    """What the test compares, from JAX: logits, hidden states, spliced
    logits, prefill's last logits and cache, a decode step's logits, the
    SFT loss."""
    ids, mask = jnp.asarray(ids), jnp.asarray(mask)
    jl, jcache = J.prefill(tree, jc, ids, mask, T + 3)
    jdl, _ = J.decode_step(tree, jc, jcache, jnp.asarray(token), jnp.int32(T), jnp.asarray(step_mask),
                           rope_pos=jnp.asarray(rope))
    out = dict(logits=J.forward(tree, jc, ids, mask), hidden=J.forward_hidden(tree, jc, ids, mask),
               spliced=J.forward(tree, jc, ids, mask, jnp.asarray(vemb), jnp.asarray(vmask)), last=jl,
               k=jcache.k, v=jcache.v, step=jdl, loss=J.sft_loss(tree, jc, ids, mask, jnp.asarray(labels)))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_prefill_decode_sft_and_splice(arch, dtype):
    """f32: every output within 2e-5 of JAX's largest value (the loss 1e-5
    relative). bf16: the port's bf16 outputs are held to JAX's f32 outputs on
    the same (bf16-valued) weights, within twice JAX's own bf16 error there
    (and at least 1e-2 of the largest value): the two frameworks' bf16 SiLU
    and tanh-GELU differ by one ulp on over a third of the elements (measured
    on 1000 normal draws), so bf16 against bf16 compares two roundings, and
    the test asks that the port's be as accurate as JAX's."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jc, pc, tree = _tree(arch, jdt)
    p = P.causal_lm_from_jax(jax.tree.map(np.asarray, tree))
    assert p.embed.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    ids, mask = _inputs()
    rng = np.random.RandomState(2)
    vemb = rng.randn(len(LENS), T, jc.d_model).astype(np.float32)
    vmask = np.zeros((len(LENS), T), bool)
    vmask[:, 2:5] = True
    token = np.asarray([5, 6, 7], np.int32)
    step_mask = (np.arange(T + 3)[None] < np.asarray(LENS)[:, None]) | (np.arange(T + 3)[None] == T)
    rope = np.asarray(LENS, np.int32)
    labels = np.where(mask, ids, -100)
    labels[:, :3] = -100
    args = (ids, mask, vemb, vmask, token, step_mask, rope, labels)
    want = _jax_outputs(tree, jc, *args)
    f32 = _jax_outputs(jax.tree.map(lambda x: x.astype(jnp.float32), tree), jc, *args) if dtype == "bf16" else want

    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    pl, pcache = C.prefill(p, pc, ti, tm, T + 3)
    dl, _ = C.decode_step(p, pc, pcache, torch.from_numpy(token), T, torch.from_numpy(step_mask),
                          rope_pos=torch.from_numpy(rope))
    logits = C.forward(p, pc, ti, tm)
    assert logits.dtype == p.embed.dtype
    got = dict(logits=logits, hidden=C.forward_hidden(p, pc, ti, tm),
               spliced=C.forward(p, pc, ti, tm, torch.from_numpy(vemb), torch.from_numpy(vmask)), last=pl,
               k=pcache.k, v=pcache.v, step=dl, loss=C.sft_loss(p, pc, ti, tm, torch.from_numpy(labels)))
    slots = np.zeros((1, len(LENS), 1, T + 3, 1), bool)
    slots[0, :, 0, :T, 0] = mask
    where = dict(logits=mask, hidden=mask, spliced=mask, k=np.broadcast_to(slots, want["k"].shape),
                 v=np.broadcast_to(slots, want["v"].shape))
    for name, w in want.items():
        g = got[name].detach().float().numpy()
        sel = where.get(name, np.ones(w.shape, bool))
        g, w, w32 = g[sel], w[sel], f32[name][sel]
        scale = max(np.abs(w).max(), 1.0)
        if dtype == "f32":
            limit = 1e-5 * abs(float(w)) if name == "loss" else 2e-5 * scale
            err = np.abs(g - w).max()
        else:
            limit = max(2 * np.abs(w - w32).max(), 1e-2 * scale)
            err = np.abs(g - w32).max()
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_on_ragged_prompts(arch, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jc, pc, tree = _tree(arch, jdt)
    p = P.causal_lm_from_jax(jax.tree.map(np.asarray, tree))
    ids, mask = _inputs()
    got, gconf = C.generate(p, pc, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=6)
    want, wconf = J.generate(tree, jc, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=6)
    assert got.dtype == torch.int32 and gconf.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gconf.numpy(), np.asarray(wconf), rtol=1e-5)
    else:
        assert np.mean(got.numpy() == np.asarray(want)) >= 0.75, (got, want)
        assert np.isfinite(gconf.numpy()).all()


@pytest.mark.parametrize("arch", ["qwen2", "gemma_hd32"])
def test_int8_tree_and_generate(arch):
    """quantize_weights_int8 of the same weights: JAX's tree bit for bit
    (q8 and scales, the embedding's per-row and the head's per-column
    scales), carried both ways; f32 generate on it gives JAX's ids and
    confidences."""
    jc, pc, tree = _tree(arch)
    jq = J.quantize_weights_int8(tree)
    pq = C.quantize_weights_int8(P.causal_lm_from_jax(jax.tree.map(np.asarray, tree)))
    back = P.causal_lm_to_jax(pq)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jq))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32) if np.asarray(b).dtype != np.int8 else b)
    assert pq.layers[0].q.q8.dtype == torch.int8 and pq.layers[0].q.weight is None
    ids, mask = _inputs()
    got, gconf = C.generate(pq, pc, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=6)
    want, wconf = J.generate(jq, jc, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(gconf.numpy(), np.asarray(wconf), rtol=1e-5)
    # carried from JAX's int8 tree, the same ids again
    again, _ = C.generate(P.causal_lm_from_jax(jax.tree.map(np.asarray, jq)), pc, torch.from_numpy(ids),
                          torch.from_numpy(mask), max_new_tokens=6)
    np.testing.assert_array_equal(again.numpy(), np.asarray(want))


def test_init_int8_tree_shape_and_scales():
    """init_causal_lm_params_int8: the tree quantize_weights_int8 gives (names,
    shapes, dtypes; norms in bf16), every channel pinned by a |q8| of 127,
    vocabulary drawn in blocks (96 rows: 16 blocks of 6), and generate runs."""
    cfg = C.CausalLMConfig(vocab_size=96, d_model=64, num_layers=3, num_heads=4, num_kv_heads=2, d_ff=80,
                           tie_word_embeddings=False)
    p8 = C.init_causal_lm_params_int8(torch.Generator().manual_seed(0), cfg)
    ref = C.quantize_weights_int8(C.init_causal_lm_params(torch.Generator().manual_seed(0), cfg,
                                                          dtype=torch.bfloat16))
    got = {n: (tuple(t.shape), t.dtype) for n, t in p8.state_dict().items()}
    assert got == {n: (tuple(t.shape), t.dtype) for n, t in ref.state_dict().items()}
    for name, t in p8.state_dict().items():
        if t.dtype == torch.int8:
            assert bool((t.abs().amax(dim=1) == 127).all()), name
    jtree = J.init_causal_lm_params_int8(jax.random.PRNGKey(0), J.CausalLMConfig(**_jax_fields(cfg)))
    back = P.causal_lm_to_jax(p8)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jtree))
    assert [np.shape(a) for a in jax.tree.leaves(back)] == [np.shape(b) for b in jax.tree.leaves(jtree)]
    ids = torch.randint(3, 96, (2, 8), generator=torch.Generator().manual_seed(1))
    tokens, conf = C.generate(p8, cfg, ids, torch.ones_like(ids, dtype=torch.bool), max_new_tokens=4)
    assert tokens.shape == (2, 4) and torch.isfinite(conf).all()


def test_rope_tables_match_jax_bit_for_bit():
    """The rotary tables: f32 from an f32 arange / head_dim, as JAX."""
    cfg = C.CausalLMConfig(d_model=64, num_heads=2, head_dim_override=0)
    pos = np.arange(0, 700, 7)
    c, s = C.rope_frequencies(cfg, torch.from_numpy(pos))
    jc, js = J.rope_frequencies(J.CausalLMConfig(d_model=64, num_heads=2), jnp.asarray(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-6)


def test_from_jax_round_trip_keeps_dtypes():
    _, _, tree = _tree("qwen2", jnp.bfloat16)
    p = P.causal_lm_from_jax(jax.tree.map(np.asarray, tree))
    assert {t.dtype for t in p.state_dict().values()} == {torch.bfloat16}
    back = P.causal_lm_to_jax(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def _hf_qwen2(transformers):
    cfg = transformers.Qwen2Config(vocab_size=160, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                   rope_theta=1_000_000.0, tie_word_embeddings=False, attention_dropout=0.0)
    torch.manual_seed(0)
    return transformers.Qwen2ForCausalLM(cfg).eval()


QWEN_TINY = dict(vocab_size=160, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=64,
                 tie_word_embeddings=False)


def test_qwen2_converter_against_jax_and_hugging_face():
    transformers = pytest.importorskip("transformers", reason="Hugging Face parity needs transformers")
    hf = _hf_qwen2(transformers)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = C.CausalLMConfig(**QWEN_TINY)
    tree = C.convert_qwen2_state_dict(sd, cfg)
    want_tree = J.convert_qwen2_state_dict(sd, J.CausalLMConfig(**QWEN_TINY))
    assert jax.tree.structure(tree) == jax.tree.structure(want_tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want_tree)):
        np.testing.assert_array_equal(a, b)
    # the VLM wrappers' naming converts the same
    vlm = {("model.language_model." + k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}
    for a, b in zip(jax.tree.leaves(C.convert_qwen2_state_dict(vlm, cfg)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    p = P.causal_lm_from_jax(tree)
    rng = np.random.RandomState(5)
    ids, mask = rng.randint(2, 160, (3, 12)), np.arange(12)[None] < np.asarray([12, 7, 4])[:, None]
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask.astype(np.int64))).logits
    got = C.forward(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy()[mask], want.numpy()[mask], rtol=3e-4, atol=3e-4)
    # greedy decode of ragged right-padded prompts: HF's unpadded per-row decode
    tokens, _ = C.generate(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=5)
    with torch.no_grad():
        for b, n in enumerate([12, 7, 4]):
            ref = hf.generate(torch.from_numpy(ids[b:b + 1, :n]), max_new_tokens=5, do_sample=False, num_beams=1)
            for t in range(5):
                if tokens[b, t] == cfg.eos_id:
                    assert ref[0, n + t] == cfg.eos_id
                    break
                assert tokens[b, t] == ref[0, n + t], (b, t)


def test_gemma_converter_and_config_against_jax_and_hugging_face():
    transformers = pytest.importorskip("transformers", reason="Hugging Face parity needs transformers")
    hf_cfg = transformers.GemmaConfig(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=1, head_dim=16, rms_norm_eps=1e-6,
                                      rope_theta=10000.0, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.GemmaForCausalLM(hf_cfg).eval()
    cfg = C.gemma_config_from_hf(hf_cfg)
    assert _jax_fields(cfg) == vars(J.gemma_config_from_hf(hf_cfg))
    assert C.gemma_config_from_hf(hf_cfg.to_dict(), num_layers=1).num_layers == 1
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    tree = C.convert_gemma_state_dict(sd, cfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(J.convert_gemma_state_dict(sd, J.gemma_config_from_hf(hf_cfg)))):
        np.testing.assert_array_equal(a, b)
    p = P.causal_lm_from_jax(tree)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 256, size=(2, 9))
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask.astype(np.int64))).logits
    got = C.forward(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy()[mask], want.numpy()[mask], rtol=3e-4, atol=3e-4)


def test_qwen_checkpoint_through_both_loaders(tmp_path):
    """An HF Qwen2 checkpoint saved under tmp_path (safetensors) read by the
    port's `load_params_for("qwen")` (into a CausalLMParams, and as the
    bare tree) and by JAX's: the same weights, the same logits."""
    transformers = pytest.importorskip("transformers", reason="writing the checkpoint needs transformers")
    from rag_docvqa_tpu.models import loader as j_loader
    from rag_docvqa_tpu_torch.models import loader as p_loader

    hf = _hf_qwen2(transformers)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, jcfg = C.CausalLMConfig(**QWEN_TINY), J.CausalLMConfig(**QWEN_TINY)
    want = J.init_causal_lm_params(jax.random.PRNGKey(0), jcfg)
    want = j_loader.load_params_for("qwen", str(tmp_path), jcfg, want)
    like = C.init_causal_lm_params(torch.Generator().manual_seed(3), cfg)
    got = p_loader.load_params_for("qwen", str(tmp_path), cfg, like)
    assert isinstance(got, C.CausalLMParams)
    for a, b in zip(jax.tree.leaves(P.causal_lm_to_jax(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bare = p_loader.load_params_for("qwen", str(tmp_path), cfg)
    for a, b in zip(jax.tree.leaves(bare), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ids = np.random.RandomState(1).randint(2, 160, (2, 8))
    am = np.ones((2, 8), bool)
    _close(C.forward(got, cfg, torch.from_numpy(ids), torch.from_numpy(am)).detach(),
           J.forward(want, jcfg, jnp.asarray(ids), jnp.asarray(am)), 2e-5)
