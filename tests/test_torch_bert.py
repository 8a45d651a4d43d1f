"""Port parity, the BERT family: `models/bert.py`, `params.bert_from_jax` /
`bert_to_jax` and `models/embedder.embed_batch` against the JAX package on
the same numpy-seeded token ids and the same weights.

Tolerances (f32): the encoder 2e-5 against the JAX whole-layer kernel in
interpret mode (`fused=True`) and against its XLA blocks (`fused=False`),
the JAX tests' own bound; sentence embeddings and scores 2e-5; gradients
3e-4 of max(1, each gradient's largest value); HF `BertModel` 2e-4 (the JAX test's).
Integer work (RoBERTa positions) is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import bert as j_bert
from rag_docvqa_tpu.models.embedder import embed_batch as j_embed_batch
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import bert as p_bert
from rag_docvqa_tpu_torch.models.embedder import embed_batch

torch.set_num_threads(2)

KW = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
          max_position_embeddings=48)


def _tree(jcfg, seed=0):
    """JAX-initialised weights with the zero biases and unit LayerNorms
    replaced by random ones, so that every parameter matters."""
    tree = jax.tree.map(np.array, j_bert.init_bert_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    rnd = lambda a, s=0.1: (rng.randn(*a.shape) * s).astype(np.float32)
    b = tree["blocks"]
    for n in ("q", "k", "v", "o", "fc1", "fc2"):
        b[n]["bias"] = rnd(b[n]["bias"])
        b[n]["kernel"] = b[n]["kernel"] * 5.0  # std 0.1: attention that is not uniform
    for n in ("attn_ln_w", "out_ln_w"):
        b[n] = 1.0 + rnd(b[n])
    for n in ("attn_ln_b", "out_ln_b"):
        b[n] = rnd(b[n])
    tree["emb_ln_w"], tree["emb_ln_b"] = 1.0 + rnd(tree["emb_ln_w"]), rnd(tree["emb_ln_b"])
    for n in ("cls_dense", "cls_out"):
        if n in tree:
            tree[n]["kernel"], tree[n]["bias"] = tree[n]["kernel"] * 20.0, rnd(tree[n]["bias"])
    return tree


def _tokens(seed, B, T, lens, vocab=300):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (B, T)).astype(np.int32), np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _both(**over):
    kw = dict(KW, **over)
    return j_bert.BertConfig(**kw), p_bert.BertConfig(**kw)


CASES = {"ragged_t24": (6, 24, [24, 17, 9, 3, 1, 24]), "full_t16": (3, 16, [16, 16, 16]), "t8": (8, 8, [8, 7, 6, 5, 4, 3, 2, 1])}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fused", [True, False])
def test_bert_encode_matches_jax(case, fused):
    B, T, lens = CASES[case]
    jcfg, pcfg = _both()
    tree = _tree(jcfg)
    ids, mask = _tokens(1, B, T, lens)
    want = j_bert.bert_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask), fused=fused)
    got = p_bert.bert_encode(p_params.bert_from_jax(tree), pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_bert_encode_three_layers_token_types():
    jcfg, pcfg = _both(num_layers=3, type_vocab_size=2)
    tree = _tree(jcfg, seed=2)
    ids, mask = _tokens(2, 4, 16, [16, 11, 6, 2])
    types = (np.arange(16)[None, :] >= np.array([8, 5, 3, 1])[:, None]).astype(np.int32)
    want = j_bert.bert_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(types), fused=True)
    got = p_bert.bert_encode(p_params.bert_from_jax(tree), pcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.from_numpy(types))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("lead", ["flat", "chunks"])
def test_bert_sentence_embed_matches_jax(pooling, lead):
    jcfg, pcfg = _both(pooling=pooling)
    tree = _tree(jcfg, seed=3)
    ids, mask = _tokens(3, 6, 16, [16, 12, 9, 5, 2, 1])
    if lead == "chunks":  # (B, C, T) chunk batches
        ids, mask = ids.reshape(2, 3, 16), mask.reshape(2, 3, 16)
    want = j_bert.bert_sentence_embed(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask))
    got = p_bert.bert_sentence_embed(p_params.bert_from_jax(tree), pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == ids.shape[:-1] + (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("options", ["alibi", "glu", "jina"])
def test_jina_options_match_jax(options):
    """ALiBi and the GLU feed-forward are plain tensor code in both
    packages; the fc1 kernel of a GLU config is (d, 2 d_ff) = gate | up."""
    over = {"alibi": dict(use_alibi=True), "glu": dict(glu_mlp=True),
            "jina": dict(use_alibi=True, glu_mlp=True, pooling="mean")}[options]
    jcfg, pcfg = _both(**over)
    tree = _tree(jcfg, seed=4)
    ids, mask = _tokens(4, 4, 16, [16, 10, 4, 1])
    want = j_bert.bert_sentence_embed(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask))
    port = p_params.bert_from_jax(tree)
    if "glu" in over or options == "jina":
        assert port.layers[0].fc1_w.shape == (256, 64)
    got = p_bert.bert_sentence_embed(port, pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert torch.equal(embed_batch(port, "JINA", torch.from_numpy(ids), torch.from_numpy(mask), pcfg), got)


def test_alibi_bias_matches_jax():
    for heads, T in ((4, 9), (6, 12), (12, 5)):  # 6 and 12 heads: not a power of two
        np.testing.assert_allclose(p_bert._alibi_bias(heads, T).numpy(), np.asarray(j_bert._alibi_bias(heads, T)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_pos", [48, 10])
def test_roberta_positions_exact(max_pos):
    """Cumulative positions over the mask, offset by pad_id + 1, clipped to
    the table (max_pos 10 clips); holes in the mask included."""
    jcfg, pcfg = _both(position_offset=2, pad_id=1, max_position_embeddings=max_pos)
    _, mask = _tokens(5, 5, 16, [16, 9, 4, 1, 0])
    mask[0, 3] = mask[1, 0] = False
    m = jnp.asarray(mask)
    pos = jnp.cumsum(m.astype(jnp.int32), axis=1) * m + jcfg.pad_id
    want = jnp.clip(pos + jcfg.position_offset - 1 - jcfg.pad_id, 0, jcfg.max_position_embeddings - 1)
    got = p_bert.roberta_positions(torch.from_numpy(mask), pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64 and int(got.max()) <= max_pos - 1


def test_cross_encoder_score_matches_jax():
    """The reranker's form: RoBERTa positions, one token type, one label."""
    jcfg, pcfg = _both(position_offset=2, pad_id=1, type_vocab_size=1, num_labels=1)
    tree = _tree(jcfg, seed=6)
    ids, mask = _tokens(6, 6, 24, [24, 20, 13, 8, 3, 24])
    want = j_bert.cross_encoder_score(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask))
    port = p_params.bert_from_jax(tree)
    got = p_bert.cross_encoder_score(port, pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (6,) and bool(((got >= 0) & (got <= 1)).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert float(got.max() - got.min()) > 1e-3  # the head is not degenerate on these weights


def test_sequence_without_valid_key_through_the_embedder():
    """Padded chunk slots reach `bert_sentence_embed` with an all-False
    mask: finite everywhere, and every row with a valid key equals JAX."""
    jcfg, pcfg = _both()
    tree = _tree(jcfg, seed=7)
    ids, mask = _tokens(7, 6, 16, [16, 0, 7, 0, 0, 3])
    want = j_bert.bert_sentence_embed(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids), jnp.asarray(mask))
    got = p_bert.bert_sentence_embed(p_params.bert_from_jax(tree), pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    valid = mask.any(axis=1)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=2e-5, rtol=2e-5)


def test_bert_encode_gradient_matches_jax_grad():
    """Every layer through `BertLayerTrain` when a gradient is required:
    the gradient of every parameter against `jax.grad` of the XLA blocks."""
    jcfg, pcfg = _both()
    tree = _tree(jcfg, seed=8)
    ids, mask = _tokens(8, 6, 24, [24, 17, 9, 3, 1, 24])
    cot = np.random.RandomState(8).randn(6, 24, 64).astype(np.float32)
    loss = lambda p: jnp.sum(j_bert.bert_encode(p, jcfg, jnp.asarray(ids), jnp.asarray(mask), fused=False) * cot)
    want = jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray, tree)))

    port = p_params.bert_from_jax(tree)
    port.requires_grad_(True)
    out = p_bert.bert_encode(port, pcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "BertLayerTrainBackward"
    out.backward(torch.from_numpy(cot))
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(p.grad)
    got = p_params.bert_to_jax(port)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        scale = max(float(np.abs(w).max()), 1.0)  # the key bias's gradient is rounding residue on both sides
        assert float(np.abs(g - w).max()) <= 3e-4 * scale, jax.tree_util.keystr(path)
    with torch.no_grad():  # no gradient required: the inference layer, no autograd node
        assert p_bert.bert_encode(port, pcfg, torch.from_numpy(ids), torch.from_numpy(mask)).grad_fn is None


@pytest.mark.parametrize("head", [False, True])
def test_bert_params_round_trip(head):
    jcfg, _ = _both(num_labels=1 if head else 0)
    tree = _tree(jcfg, seed=9)
    back = p_params.bert_to_jax(p_params.bert_from_jax(tree))
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    port = p_params.bert_from_jax(tree)
    assert port.layers[0].q_w.shape == (64, 64) and port.layers[1].fc1_w.shape == (128, 64)
    np.testing.assert_array_equal(port.layers[1].fc2_w.numpy(), tree["blocks"]["fc2"]["kernel"][1].T)
    assert port.has_head == head


@pytest.mark.parametrize("labels", [0, 1])
def test_init_bert_params_shapes_and_distributions(labels):
    jcfg, pcfg = _both(num_labels=labels)
    port = p_bert.init_bert_params(torch.Generator().manual_seed(0), pcfg)
    want = jax.tree.map(np.shape, j_bert.init_bert_params(jax.random.PRNGKey(0), jcfg))
    got = jax.tree.map(np.shape, p_params.bert_to_jax(port))
    assert got == want
    assert abs(float(port.word_emb.std()) - 0.02) < 2e-3 and abs(float(port.layers[0].fc1_w.std()) - 0.02) < 2e-3
    assert float(port.layers[0].q_b.abs().max()) == 0.0 and float(port.layers[1].out_ln_w.min()) == 1.0
    assert not any(p.requires_grad for p in port.parameters())  # created frozen


def test_hf_bert_model_through_the_port():
    """An HF BertModel built from a config (nothing downloaded): its state
    dict through the port's `convert_bert_state_dict` and `bert_from_jax`."""
    from transformers import BertConfig as HFBertConfig, BertModel

    hf_cfg = HFBertConfig(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, hidden_act="gelu")
    torch.manual_seed(0)
    hf = BertModel(hf_cfg, add_pooling_layer=False).eval()
    cfg = p_bert.BertConfig(vocab_size=200, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                            max_position_embeddings=64)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    port = p_params.bert_from_jax(p_bert.convert_bert_state_dict(sd, cfg))
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(1, 200, (2, 12)))
    mask = torch.ones((2, 12), dtype=torch.int64)
    mask[1, 8:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state.numpy()
    got = p_bert.bert_encode(port, cfg, ids, mask.bool()).numpy()
    # only the non-padded positions (HF computes garbage on masked slots)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1, :8], want[1, :8], rtol=2e-4, atol=2e-4)


def test_embed_batch_backends_match_jax():
    from rag_docvqa_tpu.models import vt5 as j_vt5
    from rag_docvqa_tpu.models import t5 as j_t5
    from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig

    jcfg, pcfg = _both()
    tree = _tree(jcfg, seed=10)
    ids, mask = _tokens(10, 2 * 3, 16, [16, 9, 4, 12, 1, 7])
    ids, mask = ids.reshape(2, 3, 16), mask.reshape(2, 3, 16)
    want = j_embed_batch(jax.tree.map(jnp.asarray, tree), "BGE", jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = embed_batch(p_params.bert_from_jax(tree), "BGE", torch.from_numpy(ids), torch.from_numpy(mask), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)

    t5_kw = dict(vocab_size=300, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=1, num_decoder_layers=1)
    vcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**t5_kw), spatial=JSpatialConfig(hidden_size=32), use_visual=False)
    vtree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(1), vcfg))
    want = j_embed_batch(jax.tree.map(jnp.asarray, vtree["t5"]), "VT5", jnp.asarray(ids), jnp.asarray(mask))
    got = embed_batch(p_params.from_jax(vtree).t5, "VT5", torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown embedder backend"):
        embed_batch(None, "E5", torch.from_numpy(ids), torch.from_numpy(mask))
