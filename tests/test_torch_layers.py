"""Port parity, building blocks: norms, dense, embeddings, rel-pos buckets,
the int8 KV quantizer and the JAX <-> port parameter round trip. Inputs and
parameters come from numpy with a seed and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import embedder as j_embedder
from rag_docvqa_tpu.models import embeddings as j_emb
from rag_docvqa_tpu.models import layers as j_layers
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import GeneratorInputs
from rag_docvqa_tpu_torch.models import embedder as p_embedder
from rag_docvqa_tpu_torch.models import embeddings as p_emb
from rag_docvqa_tpu_torch.models import layers as p_layers
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 norms and embeddings


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_and_layer_norm_match():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = rng.rand(16).astype(np.float32) + 0.5
    b = rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(p_layers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    np.testing.assert_allclose(p_layers.layer_norm(_t(x), _t(w), _t(b), 1e-12).numpy(),
                               np.asarray(j_layers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12)),
                               **TOL)


def test_dense_layout_and_dtype():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32)
    k = rng.randn(6, 3).astype(np.float32)  # JAX (in, out)
    bias = rng.randn(3).astype(np.float32)
    want = np.asarray(j_layers.dense(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)))
    got = p_layers.dense(_t(x), _t(k.T.copy()), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the product comes back in the input's dtype
    assert p_layers.dense(_t(x).bfloat16(), _t(k.T.copy())).dtype == torch.bfloat16


def test_spatial_embed_and_table_embed():
    cfg_j = j_emb.SpatialConfig(hidden_size=16, dropout_rate=0.0)
    cfg_p = p_emb.SpatialConfig(hidden_size=16, dropout_rate=0.0)
    tree = jax.tree.map(np.asarray, j_emb.init_spatial_params(jax.random.PRNGKey(0), cfg_j))
    sp = p_emb.SpatialEmbeddings(_t(tree["x_emb"]), _t(tree["y_emb"]), _t(tree["ln_w"]), _t(tree["ln_b"]),
                                 _t(tree["matcher"]["kernel"].T.copy()), _t(tree["matcher"]["bias"]))
    rng = np.random.RandomState(2)
    boxes = rng.randint(-5, 1100, size=(2, 7, 4)).astype(np.int32)  # clipping exercised
    want = np.asarray(j_emb.spatial_embed(jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(boxes)))
    got = p_emb.spatial_embed(sp, cfg_p, _t(boxes).long())
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    table = rng.randn(50, 16).astype(np.float32)
    toks = rng.randint(0, 50, size=(2, 3, 9)).astype(np.int32)
    mask = rng.rand(2, 3, 9) > 0.4
    mask[0, 1] = False  # an empty row: the 1e-9 count clip
    want = np.asarray(j_embedder.vt5_table_embed(jnp.asarray(table), jnp.asarray(toks), jnp.asarray(mask)))
    got = p_embedder.vt5_table_embed(_t(table), _t(toks).long(), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_exact(bidirectional):
    rel = np.arange(-1100, 1100, dtype=np.int32)[None, :]
    want = np.asarray(j_t5._relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128))
    got = p_t5._relative_position_bucket(_t(rel).long(), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_kv_matches():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 11, 4).astype(np.float32)
    x[0, 1, :, 2] = 0.0  # all-zero channel: the 1e-12 amax floor
    x[1, 0, 0, 0] = 2.5 * 127 / 127  # values landing on .5 steps round half to even
    qj, sj = j_t5._quantize_kv(jnp.asarray(x))
    qp, sp = p_t5._quantize_kv(_t(x))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=0, atol=0)


def _tiny_vt5(layout="Default", gated=False):
    t5 = j_t5.T5Config(vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_encoder_layers=2,
                       num_decoder_layers=3, dropout_rate=0.0, gated_ffn=gated, tie_word_embeddings=not gated)
    return j_vt5.VT5Config(t5=t5, spatial=j_emb.SpatialConfig(hidden_size=16, dropout_rate=0.0),
                           use_visual=False, use_layout_labels=layout)


@pytest.mark.parametrize("layout,gated", [("Default", False), ("Embed", True)])
def test_from_jax_to_jax_round_trip(layout, gated):
    cfg = _tiny_vt5(layout, gated)
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), cfg))
    tree.pop("layout_head", None)  # training-only head, not held by the port
    port = p_params.from_jax(tree)
    back = p_params.to_jax(port)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))
    # the port's layouts: (out, in) dense, one module per layer
    layer = port.t5.encoder.layers[0]
    assert tuple(layer.attn.q.shape) == (16, 16) and len(port.t5.decoder.layers) == 3
    assert torch.equal(layer.attn.o, torch.from_numpy(tree["t5"]["encoder"]["attn"]["o"][0].T.copy()))


def test_init_distributions_and_input_embeds():
    cfg_j = _tiny_vt5("Embed")
    cfg_p = p_vt5.VT5Config(t5=p_t5.T5Config(**{f: getattr(cfg_j.t5, f) for f in p_t5.T5Config.__dataclass_fields__}),
                            spatial=p_emb.SpatialConfig(hidden_size=16, dropout_rate=0.0),
                            use_layout_labels="Embed")
    g = torch.Generator().manual_seed(0)
    port = p_vt5.init_vt5_params(g, cfg_p)
    tree = p_params.to_jax(port)
    ref = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), cfg_j))
    # same shapes and the same scales as the JAX init (different numbers)
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        r = ref
        for k in path:
            r = r[k.key]
        assert a.shape == r.shape, path
        if a.size > 64 and r.std() > 0:
            assert 0.7 < a.std() / r.std() < 1.4, path

    rng = np.random.RandomState(4)
    ids = rng.randint(0, 64, size=(2, 9)).astype(np.int32)
    boxes = rng.randint(0, 1000, size=(2, 9, 4)).astype(np.int32)
    labels = rng.randint(0, 5, size=(2, 9)).astype(np.int32)
    mask = rng.rand(2, 9) > 0.3
    from rag_docvqa_tpu.data.contract import GeneratorInputs as JGen

    want, _ = j_vt5.input_embeds(jax.tree.map(jnp.asarray, tree), cfg_j,
                                 JGen(jnp.asarray(ids), jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask)))
    got, m = p_vt5.input_embeds(port, cfg_p, GeneratorInputs(_t(ids).long(), _t(boxes).long(),
                                                             _t(labels).long(), _t(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(m, _t(mask))
