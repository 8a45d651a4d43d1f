"""Port parity, the Qwen2.5-VL vision tower: `models/qwen25_vision.py`
against the JAX tower on the same weights (carried with
`params.qwen25_vision_from_jax`) and against Hugging Face's
`Qwen2_5_VisionTransformerPretrainedModel` where `transformers` imports.

Exact: the grid geometry (merge order, position ids, the window permutation
with padded windows dropped, the rotary tables) and the patch extraction.
Within 2e-5 of the largest value: the merged tokens against JAX (f32, sums
in another order); within 3e-4 against HF (its own tolerance in the JAX
tests), on a grid the window does not divide (10 x 8 patches, merger window
2: the padded window partition).

The feed-forward on an intermediate padded to a multiple of 8 (`_ffn_weights`),
at widths 64 (no copy) and 60 (a copy at 64): the padded path against the
plain one (f32 within 1e-6 of the largest value, bf16 within its rounding)
and against JAX; the parameter tree, `state_dict()` and
`qwen25_vision_to_jax` untouched by it; the copy made again when a layer's
tensor is replaced or changed in place; weights that require a gradient
take the plain path; the counters `vision.mlp_padded` / `vision.mlp_plain`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import qwen25_vision as J
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch import profiling
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


# --------------------------------------------------------------------------- #
# the feed-forward on a padded intermediate
# --------------------------------------------------------------------------- #
@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _tower(width: int):
    """(JAX config, port config, JAX tree, the port's tree) at intermediate
    `width`, the JAX init moved off its unit norms and zero biases."""
    kw = dict(KW, intermediate_size=width)
    jc, pc = J.Qwen25VisionConfig(**kw), Q.Qwen25VisionConfig(**kw)
    tree = J.init_qwen25_vision_params(jax.random.PRNGKey(0), jc)
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.RandomState(1)
    tree = jax.tree.unflatten(treedef, [np.asarray(x) + np.float32(0.05) * rng.randn(*x.shape).astype(np.float32)
                                        for x in leaves])
    return jc, pc, tree, p_params.qwen25_vision_from_jax(tree)


PIX = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)


def _plain(p, pc, pix):
    """The tower on the layers' own tensors: with a gradient asked of the
    feed-forward weights, `_ffn_weights` takes the plain path."""
    ffn = [getattr(layer, n) for layer in p.layers for n in Q.FFN_FIELDS]
    for t in ffn:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            return Q.encode_image(p, pc, pix).detach()
    finally:
        for t in ffn:
            t.requires_grad_(False)


def _counts():
    counts = profiling.read().counts
    return profiling.total(counts, "vision.mlp_padded"), profiling.total(counts, "vision.mlp_plain")


@pytest.mark.parametrize("width", [64, 60])
def test_padded_ffn_matches_plain_and_jax(tracer, width):
    jc, pc, tree, p = _tower(width)
    pix = torch.from_numpy(PIX)
    got = Q.encode_image(p, pc, pix)
    padded = width % 8 != 0
    assert _counts() == ((pc.depth, 0) if padded else (0, pc.depth))
    assert (p.layers[0] in Q._padded_ffn) == padded
    if padded:
        copy = Q._padded_ffn[p.layers[0]][2]
        assert [tuple(t.shape) for t in copy] == [(64, 32), (64,), (64, 32), (64,), (32, 64)]
        assert all(t.dtype == torch.float32 and t.is_contiguous() and not t.requires_grad for t in copy)
        for t, own in zip(copy, (p.layers[0].gate_w, p.layers[0].gate_b, p.layers[0].up_w, p.layers[0].up_b)):
            assert torch.equal(t[:width], own) and not t[width:].any()
        assert torch.equal(copy[4][:, :width], p.layers[0].down_w) and not copy[4][:, width:].any()
    profiling.reset()
    want = _plain(p, pc, pix)
    assert _counts() == (0, pc.depth)
    _close(got, want.numpy(), rel=1e-6)
    _close(got, J.encode_image(tree, jc, jnp.asarray(PIX)))
    # bf16: the same tree cast in place (`Module.to` swaps each parameter's data, so the copy is made anew)
    p.to(torch.bfloat16)
    pix16 = pix.to(torch.bfloat16)
    profiling.reset()
    got16 = Q.encode_image(p, pc, pix16)
    assert _counts() == ((pc.depth, 0) if padded else (0, pc.depth))
    if padded:
        assert all(t.dtype == torch.bfloat16 for t in Q._padded_ffn[p.layers[0]][2])
    want16 = _plain(p, pc, pix16)
    # bf16's unit roundoff is 2^-8; four layers of sums in another order stay within a few units of it
    _close(got16.float(), want16.float().numpy(), rel=4 * 2.0**-8)


def test_padded_ffn_leaves_the_parameter_tree_alone():
    _, pc, tree, p = _tower(60)
    before = [(n, tuple(t.shape)) for n, t in p.named_parameters()]
    state = {k: v.clone() for k, v in p.state_dict().items()}
    Q.encode_image(p, pc, torch.from_numpy(PIX))
    assert p.layers[0] in Q._padded_ffn
    assert [(n, tuple(t.shape)) for n, t in p.named_parameters()] == before
    assert all(s == (60, 32) for n, s in before if n.endswith(("gate_w", "up_w")))
    after = p.state_dict()
    assert list(after) == list(state) and all(torch.equal(after[k], v) for k, v in state.items())
    assert len(list(p.buffers())) == 0
    for a, b in zip(jax.tree.leaves(p_params.qwen25_vision_to_jax(p)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert pc.intermediate_size == 60


@pytest.mark.parametrize("how", ["new_parameter", "data", "in_place"])
def test_replacing_a_layer_tensor_rebuilds_the_copy(how):
    _, pc, _, p = _tower(60)
    pix = torch.from_numpy(PIX)
    Q.encode_image(p, pc, pix)
    layer, other = p.layers[1], p.layers[0]
    old, kept = Q._padded_ffn[layer][2], Q._padded_ffn[other][2]
    new_w = layer.gate_w.detach() * 1.5
    if how == "new_parameter":  # as the benchmark's `load_into` replaces a `meta` parameter
        layer.gate_w = torch.nn.Parameter(new_w, requires_grad=False)
    elif how == "data":
        layer.gate_w.data = new_w
    else:
        with torch.no_grad():
            layer.gate_w.mul_(1.5)
    got = Q.encode_image(p, pc, pix)
    copy = Q._padded_ffn[layer][2]
    assert copy[0] is not old[0] and torch.equal(copy[0][:60], new_w)
    assert Q._padded_ffn[other][2] is kept
    _close(got, _plain(p, pc, pix).numpy(), rel=1e-6)


def test_a_second_call_reuses_the_copy():
    _, pc, _, p = _tower(60)
    pix = torch.from_numpy(PIX)
    Q.encode_image(p, pc, pix)
    first = [Q._padded_ffn[layer][2] for layer in p.layers]
    Q.encode_image(p, pc, pix)
    assert all(Q._padded_ffn[layer][2] is c for layer, c in zip(p.layers, first))


@pytest.mark.parametrize("grad_of", ["weights", "pixels"])
def test_a_recorded_graph_takes_the_plain_path(tracer, grad_of):
    _, pc, _, p = _tower(60)
    pix = torch.from_numpy(PIX).requires_grad_(grad_of == "pixels")
    if grad_of == "weights":
        for t in p.parameters():
            t.requires_grad_(True)
    out = Q.encode_image(p, pc, pix)
    assert _counts() == (0, pc.depth)
    assert p.layers[0] not in Q._padded_ffn
    out.square().sum().backward()
    if grad_of == "weights":
        assert all(layer.gate_w.grad is not None and layer.gate_w.grad.shape == (60, 32) for layer in p.layers)
    else:
        assert pix.grad is not None and pix.grad.abs().sum() > 0
    profiling.reset()
    with torch.no_grad():  # no graph recorded: the padded path, whatever the flags
        Q.encode_image(p, pc, pix)
    assert _counts() == (pc.depth, 0)
