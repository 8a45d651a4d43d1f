"""Port parity, the VT5 family's training forms: VT5 `forward_train` with
precomputed visual tokens and with the LayoutT5 head, Pix2Struct
`forward_train` (its tower through the layer backward), and `remat` in the
VT5 train step.

Tolerances: the loss within 1e-5 (relative) of the JAX `forward_train`;
every gradient leaf within 1e-4 of the largest value of `jax.grad`'s leaf
(the encoder's rel-pos table 1e-2 where the JAX fused-train gate is off: JAX
keeps that bias in f32, the port's layer takes it in bf16). The JAX
fused-train gate runs on (its whole-layer kernels in interpret mode) and off
(its plain blocks). remat: the plain step's losses, grad norms and updated
parameters, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import pix2struct as j_p2s
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
from rag_docvqa_tpu_torch.models import pix2struct as p_p2s
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step
from test_torch_training import RAG_KW, _batches, _configs

torch.set_num_threads(2)


def _max_rel(want):
    return max(float(np.abs(want).max()), 1e-6)


def _same_grads(got, jg, gate):
    """Every leaf of the port's gradient tree against jax.grad's; a JAX leaf
    the port's tree lacks must be empty (the 0-layer text encoder of
    Pix2Struct, whose stacked weights JAX keeps with a leading 0)."""
    want_by = {jax.tree_util.keystr(p): w for p, w in jax.tree_util.tree_leaves_with_path(jg)}
    got_by = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(got)}
    assert set(got_by) <= set(want_by) and all(want_by[k].size == 0 for k in set(want_by) - set(got_by))
    for name, g in got_by.items():
        want = want_by[name]
        assert g.shape == want.shape, name
        limit = (1e-2 if gate == "off" and name == "['t5']['encoder']['rel_bias']" else 1e-4) * _max_rel(want)
        err = float(np.abs(g - want).max())
        assert np.isfinite(g).all() and err <= limit, f"gradient {name}: {err} above {limit}"


def _vt5_grad_tree(port, grads):
    """The gradients of `port.parameters()`, in the layout of `to_jax`."""
    g = p_params.from_jax(p_params.to_jax(port))
    for (_, p), grad in zip(g.named_parameters(), grads):
        p.data = grad.detach().clone()
    return p_params.to_jax(g)


def _forward_train_against_jax(jcfg, pcfg, tree, gen_np, labels, visual=None, visual_mask=None, gate="on",
                               monkeypatch=None):
    """The loss within 1e-5 (relative) of the JAX `forward_train` and every
    gradient leaf within 1e-4 of its largest value of `jax.grad`'s (the
    encoder's rel-pos table 1e-2 with the gate off, where JAX keeps the bias
    in f32 and the port takes it in bf16). Returns the port's gradient tree."""
    from rag_docvqa_tpu.data.contract import GeneratorInputs as JGen
    from rag_docvqa_tpu_torch.data.contract import GeneratorInputs

    if gate == "on":
        monkeypatch.setattr(j_feb, "fused_t5_train_wanted", lambda *a, **k: True)
    jgen = JGen(**{k: jnp.asarray(v) for k, v in gen_np.items()})
    pgen = GeneratorInputs(**{k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
                              for k, v in gen_np.items()})
    jvis = None if visual is None else jnp.asarray(visual)
    jvm = None if visual_mask is None else jnp.asarray(visual_mask)

    def jloss(params):
        return j_vt5.forward_train(params, jcfg, jgen, jnp.asarray(labels), jvis, jvm)[0]

    jl, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    port = p_params.from_jax(tree)
    params = list(port.parameters())
    for p in params:
        p.requires_grad_(True)
    loss, logits = p_vt5.forward_train(port, pcfg, pgen, torch.from_numpy(labels).long(),
                                       None if visual is None else torch.from_numpy(visual),
                                       None if visual_mask is None else torch.from_numpy(visual_mask))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = _vt5_grad_tree(port, torch.autograd.grad(loss, params))
    _same_grads(got, jax.tree.map(np.asarray, jgrads), gate)
    return got


def _layout_gen(rng, B, S, vocab, n_labels, ragged=False):
    mask = np.ones((B, S), bool)
    if ragged:
        mask[1, S // 2:] = False
    return dict(input_ids=rng.randint(3, vocab, (B, S)).astype(np.int32),
                input_boxes=rng.randint(0, 1000, (B, S, 4)).astype(np.int32),
                input_labels=rng.randint(0, n_labels, (B, S)).astype(np.int32), attention_mask=mask)


@pytest.mark.parametrize("mode,gate", [("Embed", "on"), ("Embed", "off"), ("Text", "off")])
def test_layout_head_forward_train_matches_jax(mode, gate, monkeypatch):
    """The LayoutT5 head (`tests/test_layout.py`'s case: t5 d 16, one layer
    each side, layout labels on): `init_vt5_params` makes `layout_head` (and,
    for "Embed", `layout_emb`) where JAX does, `params` carries it both ways,
    the loss adds the per-token layout CE over the text positions (labels
    beyond the head's 12 classes clipped, a ragged mask), and the loss and
    every gradient, the head's among them, match jax.grad."""
    from dataclasses import replace

    t5kw = dict(vocab_size=100, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_encoder_layers=1,
                num_decoder_layers=1, dropout_rate=0.0)
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**t5kw), spatial=JSpatialConfig(hidden_size=16, dropout_rate=0.0),
                           use_layout_labels=mode, use_visual=False, layout_loss_weight=0.5)
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**t5kw), spatial=SpatialConfig(hidden_size=16, dropout_rate=0.0),
                           use_layout_labels=mode, layout_loss_weight=0.5)
    tree = jax.tree.map(np.array, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    rb = tree["t5"]["encoder"]["rel_bias"]  # bf16-exact, as the port's layer takes it
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(rb).bfloat16().float())
    assert "layout_head" in tree and ("layout_emb" in tree) == (mode == "Embed")
    port = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), pcfg)
    assert port.layout_head is not None and (port.layout_emb is not None) == (mode == "Embed")
    back = p_params.to_jax(p_params.from_jax(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(p_params.to_jax(port)) == jax.tree_util.tree_structure(tree)
    head = tree["layout_head"]  # a head that is not the identity, so its LayerNorm counts
    rng = np.random.RandomState(0)
    head["ln_w"], head["ln_b"] = (1 + 0.1 * rng.randn(16)).astype(np.float32), (0.1 * rng.randn(16)).astype(np.float32)
    gen = _layout_gen(rng, 2, 12, 100, 4 if mode == "Embed" else 20, ragged=True)
    labels = np.asarray([[5, 1, -100], [7, 1, -100]], np.int32)
    got = _forward_train_against_jax(jcfg, pcfg, tree, gen, labels, gate=gate, monkeypatch=monkeypatch)
    assert all(np.abs(v).sum() > 0 for v in jax.tree_util.tree_leaves(got["layout_head"]))
    # without the head the loss is the LM loss alone: the head's term is really added
    plain_tree = {k: v for k, v in tree.items() if k != "layout_head"}
    from rag_docvqa_tpu_torch.data.contract import GeneratorInputs

    pgen = GeneratorInputs(**{k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
                              for k, v in gen.items()})
    with torch.no_grad():
        with_head, _ = p_vt5.forward_train(p_params.from_jax(tree), pcfg, pgen, torch.from_numpy(labels).long())
        without, _ = p_vt5.forward_train(p_params.from_jax(plain_tree), replace(pcfg, layout_loss_weight=0.0), pgen,
                                         torch.from_numpy(labels).long())
    assert with_head.item() > without.item()


def test_forward_train_with_visual_tokens_matches_jax(monkeypatch):
    """Precomputed visual tokens appended after the text (a visual mask with
    masked tokens, a ragged text mask): the loss and every gradient against
    jax.grad of the JAX plain blocks (the layout case above also holds the
    JAX fused-train kernels)."""
    gate = "off"
    jcfg, pcfg = _configs()
    tree = jax.tree.map(np.array, j_vt5.init_vt5_params(jax.random.PRNGKey(1), jcfg))
    rb = tree["t5"]["encoder"]["rel_bias"]  # bf16-exact, as the port's layer takes it
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(rb).bfloat16().float())
    rng = np.random.RandomState(2)
    gen = _layout_gen(rng, 3, 20, 256, 5, ragged=True)
    visual = rng.randn(3, 9, 32).astype(np.float32)
    visual_mask = np.ones((3, 9), bool)
    visual_mask[0, 5:] = False
    visual_mask[2, :] = False
    labels = np.asarray([[5, 9, 1, -100], [7, 1, -100, -100], [40, 41, 42, 1]], np.int32)
    _forward_train_against_jax(jcfg, pcfg, tree, gen, labels, visual, visual_mask, gate=gate, monkeypatch=monkeypatch)


@pytest.mark.parametrize("remat", [True, "layer"])
def test_remat_step_matches_plain(remat):
    """`remat=True` (the whole forward, keeping aten mm outputs) and
    `remat="layer"` (each encoder and decoder layer) change memory, not
    math: three steps give the plain step's losses, grad norms and updated
    parameters exactly (`tests/test_training.py`'s two VT5 remat cases)."""
    jcfg, pcfg = _configs()
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    _, pb, labels = _batches()
    states, steps = [], []
    for r in (False, remat):
        port = p_params.from_jax(tree)
        opt = build_optimizer(lr=1e-3, warmup_steps=1, total_steps=10, mask=trainable_mask(port, ("t5", "spatial")))
        states.append(TrainState.create(port, opt))
        steps.append(make_train_step(pcfg, RAGConfig(**RAG_KW), opt, remat=r))
    for i in range(3):
        (s1, m1), (s2, m2) = (step(state, pb, labels) for step, state in zip(steps, states))
        states = [s1, s2]
        for k in m1:
            assert m1[k].item() == m2[k].item(), (k, i)
    for (n, a), (_, b) in zip(states[0].params.named_parameters(), states[1].params.named_parameters()):
        assert torch.equal(a, b), n


def test_remat_takes_only_the_jax_values():
    _, pcfg = _configs()
    opt = build_optimizer(lr=1e-3)
    for bad in ("layers", 2, "true"):
        with pytest.raises(ValueError, match="remat must be False, True, or 'layer'"):
            make_train_step(pcfg, RAGConfig(**RAG_KW), opt, remat=bad)


# --------------------------------------------------------------------------- #
# Pix2Struct
# --------------------------------------------------------------------------- #
# tests/test_pix2struct.py's TINY_P2S
J_P2S = j_p2s.Pix2StructConfig(
    vision=j_p2s.P2SVisionConfig(hidden_size=32, num_layers=2, num_heads=4, d_ff=64, patch_dim=768, max_rows=128,
                                 max_cols=128),
    text=j_t5.T5Config(vocab_size=300, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=0,
                       num_decoder_layers=2, gated_ffn=True, tie_word_embeddings=False, dropout_rate=0.0))
P_P2S = p_p2s.Pix2StructConfig(
    vision=p_p2s.P2SVisionConfig(hidden_size=32, num_layers=2, num_heads=4, d_ff=64, patch_dim=768, max_rows=128,
                                 max_cols=128),
    text=p_t5.T5Config(vocab_size=300, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=0,
                       num_decoder_layers=2, gated_ffn=True, tie_word_embeddings=False, dropout_rate=0.0))


def _patches(rng, B, N, valid):
    """Flattened patches with 1-based (row, col) ids and a key mask of
    `valid` patches a row (the rest padding, their pixels zero)."""
    x = rng.rand(B, N, 770).astype(np.float32)
    ids = np.arange(N)
    x[:, :, 0], x[:, :, 1] = 1 + ids // 8, 1 + ids % 8
    mask = ids[None, :] < np.asarray(valid)[:, None]
    x[~mask] = 0.0
    return x, mask


@pytest.mark.parametrize("case", ["test_pix2struct_shapes", "padded_rows"])
def test_p2s_forward_train_matches_jax(case):
    """`tests/test_pix2struct.py`'s `forward_train` case (2 rows of 24
    patches, labels [[5, 1, -100], [7, 8, 1]]) and one with padded patches (a
    row of 24 valid of 40, one of 9): the loss and every gradient leaf (the
    patch projection, the row and column tables, each layer's weights, the
    decoder) against jax.grad of the JAX model, whose tower trains through
    its plain blocks."""
    tree = jax.tree.map(np.array, j_p2s.init_p2s_params(jax.random.PRNGKey(0), J_P2S))
    rng = np.random.RandomState(0)
    if case == "test_pix2struct_shapes":
        patches = rng.rand(2, 24, 770).astype(np.float32)
        mask = np.ones((2, 24), bool)
    else:
        patches, mask = _patches(rng, 2, 40, [24, 9])
    labels = np.asarray([[5, 1, -100], [7, 8, 1]], np.int32)

    def jloss(p):
        return j_p2s.forward_train(p, J_P2S, jnp.asarray(patches), jnp.asarray(mask), jnp.asarray(labels))

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, tree))
    port = p_params.p2s_from_jax(tree)
    params = list(port.parameters())
    for p in params:
        p.requires_grad_(True)
    loss, logits = p_p2s.forward_train(port, P_P2S, torch.from_numpy(patches), torch.from_numpy(mask),
                                       torch.from_numpy(labels).long())
    assert logits.shape == (2, 3, 300)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4 * _max_rel(jlogits))
    # the text model's unused encoder rel-pos table and final norm get no gradient: zeros, as jax.grad gives
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    g = p_params.p2s_from_jax(p_params.p2s_to_jax(port))
    for (_, p), grad in zip(g.named_parameters(), grads):
        p.data = torch.zeros_like(p) if grad is None else grad.detach().clone()
    got, jg = p_params.p2s_to_jax(g), jax.tree.map(np.asarray, jgrads)
    _same_grads(got, jg, "on")
    for leaf in ("patch_proj", "row_emb", "col_emb", "ffn"):
        assert all(np.abs(x).sum() > 0 for x in jax.tree_util.tree_leaves(got["vision"][leaf])), leaf


def test_p2s_forward_train_never_takes_the_query_tiled_layer(monkeypatch):
    """A training row above QTILED_ABOVE patches runs the layer backward too
    (K13 has none): the loss and the patch projection's gradient against the
    JAX model at N = QTILED_ABOVE + 8, with K13 made to fail if called."""
    def no_k13(*a, **k):
        raise AssertionError("the training tower reached the query-tiled layer")

    monkeypatch.setattr(p_p2s, "fused_t5_layer_qtiled", no_k13)
    N = p_p2s.QTILED_ABOVE + 8
    tree = jax.tree.map(np.array, j_p2s.init_p2s_params(jax.random.PRNGKey(1), J_P2S))
    patches, mask = _patches(np.random.RandomState(1), 1, N, [N - 100])
    patches[:, :, 0] = np.minimum(patches[:, :, 0], 128)
    labels = np.asarray([[5, 6, 1]], np.int32)

    def jloss(p):
        return j_p2s.forward_train(p, J_P2S, jnp.asarray(patches), jnp.asarray(mask), jnp.asarray(labels))[0]

    jl, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    port = p_params.p2s_from_jax(tree)
    port.vision.patch_w.requires_grad_(True)
    loss, _ = p_p2s.forward_train(port, P_P2S, torch.from_numpy(patches), torch.from_numpy(mask),
                                  torch.from_numpy(labels).long())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    (dw,) = torch.autograd.grad(loss, [port.vision.patch_w])
    want = np.asarray(jgrads["vision"]["patch_proj"]["kernel"]).T
    assert float(np.abs(dw.numpy() - want).max()) <= 1e-4 * _max_rel(want)
