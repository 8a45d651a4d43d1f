"""Port parity, the Qwen2.5-VL vision tower: `models/qwen25_vision.py`
against the JAX tower on the same weights (carried with
`params.qwen25_vision_from_jax`) and against Hugging Face's
`Qwen2_5_VisionTransformerPretrainedModel` where `transformers` imports.

Exact: the grid geometry (merge order, position ids, the window permutation
with padded windows dropped, the rotary tables) and the patch extraction.
Within 2e-5 of the largest value: the merged tokens against JAX (f32, sums
in another order); within 3e-4 against HF (its own tolerance in the JAX
tests), on a grid the window does not divide (10 x 8 patches, merger window
2: the padded window partition)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import qwen25_vision as J
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import qwen25_vision as Q

torch.set_num_threads(2)

KW = dict(hidden_size=32, intermediate_size=64, num_heads=4, depth=4, patch_size=4, temporal_patch_size=2,
          spatial_merge_size=2, window_size=16, out_hidden_size=48, fullatt_block_indexes=(1, 3))


def _close(got, want, rel=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("grid", [(8, 8), (10, 8), (4, 12)])
def test_geometry_matches_jax(grid):
    jc, pc = J.Qwen25VisionConfig(**KW), Q.Qwen25VisionConfig(**KW)
    h, w = grid
    np.testing.assert_array_equal(Q._merge_order_indices(h, w, 2), J._merge_order_indices(h, w, 2))
    np.testing.assert_array_equal(Q._pos_ids(h, w, 2), J._pos_ids(h, w, 2))
    for a, b in zip(Q._window_index(h, w, pc), J._window_index(h, w, jc)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(Q._rotary_tables(h, w, pc), J._rotary_tables(h, w, jc)):
        np.testing.assert_array_equal(a, b)


def test_tower_matches_jax():
    """Random weights moved off their init (unit norms, zero biases), the
    patch extraction and `encode_image` on 32 x 32 and 40 x 32 crops."""
    jc, pc = J.Qwen25VisionConfig(**KW), Q.Qwen25VisionConfig(**KW)
    tree = J.init_qwen25_vision_params(jax.random.PRNGKey(0), jc)
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.RandomState(1)
    tree = jax.tree.unflatten(treedef, [jnp.asarray(np.asarray(x) + 0.05 * rng.randn(*x.shape), jnp.float32)
                                        for x in leaves])
    p = p_params.qwen25_vision_from_jax(jax.tree.map(np.asarray, tree))
    back = p_params.qwen25_vision_to_jax(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for shape in ((2, 32, 32, 3), (1, 40, 32, 3)):
        pix = np.random.RandomState(3).randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(Q.extract_qwen_patches(torch.from_numpy(pix), pc).numpy(),
                                      np.asarray(J.extract_qwen_patches(jnp.asarray(pix), jc)))
        out = Q.encode_image(p, pc, torch.from_numpy(pix))
        assert out.shape == (shape[0], (shape[1] // 8) * (shape[2] // 8), pc.out_hidden_size)
        _close(out, J.encode_image(tree, jc, jnp.asarray(pix)))


def test_tower_matches_hugging_face_on_a_padded_window_grid():
    transformers = pytest.importorskip("transformers", reason="Hugging Face parity needs transformers")
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLVisionConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VisionTransformerPretrainedModel

    del transformers
    hf_cfg = Qwen2_5_VLVisionConfig(depth=4, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=4,
                                    temporal_patch_size=2, spatial_merge_size=2, window_size=16, out_hidden_size=48,
                                    fullatt_block_indexes=[1, 3], in_channels=3, hidden_act="silu")
    torch.manual_seed(0)
    hf = Qwen2_5_VisionTransformerPretrainedModel._from_config(hf_cfg).eval().float()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    pc = Q.Qwen25VisionConfig(**KW)
    tree = Q.convert_qwen25_vision_state_dict(sd, pc)
    want_tree = J.convert_qwen25_vision_state_dict(sd, J.Qwen25VisionConfig(**KW))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want_tree)):
        np.testing.assert_array_equal(a, b)
    prefixed = {"model.visual." + k: v for k, v in sd.items()}
    for a, b in zip(jax.tree.leaves(Q.convert_qwen25_vision_state_dict(prefixed, pc)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    p = p_params.qwen25_vision_from_jax(tree)
    grid = (10, 8)
    feats = np.random.RandomState(3).randn(grid[0] * grid[1], pc.patch_dim).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(feats), grid_thw=torch.tensor([[1, *grid]])).numpy()
    got = Q.encode_features(p, pc, torch.from_numpy(feats)[None], grid)[0]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=3e-4, atol=3e-4)
