"""Port parity, the DiT layout detector's network (`rag_docvqa_tpu_torch/
models/layout_seg.py`): `beit_segment_logits` and `segment_map` against the
JAX functions on the same seeded weights (the JAX init's tree carried over
with `params.layout_seg_from_jax`) at the config of `tests/test_layout_seg.py`
(64 px, a 4x4 grid) and at 224 px, where the top feature is 7x7 and the PSP
pool bins of scales 2, 3 and 6 overlap; then against Hugging Face
`BeitForSemanticSegmentation` through the same `hf_pair` fixture (random
BatchNorm statistics), its state dict converted by the port. The backbone
runs K14's plain version on the CPU.

Limits: logits within 1e-5 of JAX's (f32; measured ~1e-6 of values ~1) and
2e-4 of HF's (the JAX test's limit); the class maps equal on every pixel
whose top-two logit margin exceeds 1e-4 (an argmax of near-tied logits may
flip). The adaptive pooling, the converted tree and the detector's boxes are
held exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import layout_seg as j_seg
from rag_docvqa_tpu.models.vit import ViTConfig as JViTConfig
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import layout_seg as p_seg
from rag_docvqa_tpu_torch.models.vit import ViTConfig as PViTConfig

torch.set_num_threads(2)

LOGIT_TOL, HF_TOL, MARGIN = 1e-5, 2e-4, 1e-4


def _configs(image_size: int):
    vit = dict(hidden_size=32, num_layers=5, num_heads=4, mlp_dim=64, patch_size=16, image_size=image_size,
               arch="beit", use_abs_pos=False, use_rel_pos_bias=True, layer_scale_init=0.1,
               use_final_layernorm=False)
    kw = dict(num_labels=12, out_indices=(2, 3, 4, 5))
    return j_seg.BeitSegConfig(vit=JViTConfig(**vit), **kw), p_seg.BeitSegConfig(vit=PViTConfig(**vit), **kw)


def _same_map(got: np.ndarray, want: np.ndarray, logits: np.ndarray):
    """Equal wherever the top-two margin of the (upsampled) logits exceeds MARGIN."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def _upsampled(logits_nhwc: torch.Tensor, size: int) -> np.ndarray:
    return p_seg._resize(logits_nhwc.permute(0, 3, 1, 2), size, size).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("image_size", [64, 224], ids=["grid4", "grid14_top7x7"])
def test_segment_logits_and_map_match_jax(image_size):
    jcfg, pcfg = _configs(image_size)
    tree = j_seg.init_beit_seg_params(jax.random.PRNGKey(0), jcfg)
    # BatchNorm statistics away from the identity, so inference-mode BN is exercised
    rng = np.random.RandomState(1)
    tree = jax.tree.map(np.array, tree)
    for mods in (tree["psp"], tree["laterals"], tree["fpn_convs"], [tree["bottleneck"], tree["fpn_bottleneck"]]):
        for m in mods:
            m["bn"]["mean"] = rng.normal(0, 0.5, m["bn"]["mean"].shape).astype(np.float32)
            m["bn"]["var"] = rng.uniform(0.5, 2.0, m["bn"]["var"].shape).astype(np.float32)
    params = p_params.layout_seg_from_jax(tree)
    pix = np.random.RandomState(image_size).randn(2, image_size, image_size, 3).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(j_seg.beit_segment_logits(jtree, jcfg, jnp.asarray(pix)))
    with torch.inference_mode():
        got = p_seg.beit_segment_logits(params, pcfg, torch.from_numpy(pix))
        gmap = p_seg.segment_map(params, pcfg, torch.from_numpy(pix)).numpy()
    assert got.shape == want.shape == (2, image_size // 4, image_size // 4, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    wmap = np.asarray(j_seg.segment_map(jtree, jcfg, jnp.asarray(pix)))
    assert gmap.dtype == np.int32 and gmap.shape == wmap.shape == (2, image_size, image_size)
    _same_map(gmap, wmap, _upsampled(got, image_size))


@pytest.mark.parametrize("grid", [2, 4, 7])
def test_adaptive_pool_bins_match_jax(grid):
    """torch's floor/ceil bins against JAX's hand-written ones, with the
    overlapping bins of a 7x7 grid (scale 2: rows 0-3 and 3-6)."""
    x = np.random.RandomState(grid).randn(2, grid, grid, 5).astype(np.float32)
    for scale in (1, 2, 3, 6):
        if scale > grid:
            continue
        want = np.asarray(j_seg._adaptive_avg_pool(jnp.asarray(x), scale))
        got = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), scale)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_maxpool_refuses_an_odd_grid_as_jax_does():
    with pytest.raises(TypeError):
        j_seg._maxpool2(jnp.zeros((1, 7, 7, 2)))
    with pytest.raises(RuntimeError):
        p_seg._maxpool2(torch.zeros((1, 2, 7, 7)))
    x = np.random.RandomState(0).randn(1, 6, 6, 2).astype(np.float32)
    np.testing.assert_array_equal(p_seg._maxpool2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j_seg._maxpool2(jnp.asarray(x))))


@pytest.fixture(scope="module")
def hf_pair():
    """tests/test_layout_seg.py's fixture: a seeded HF model with random
    BatchNorm statistics, its state dict converted by both packages."""
    from transformers import BeitConfig, BeitForSemanticSegmentation

    jcfg, pcfg = _configs(64)
    hf_cfg = BeitConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=5,
        num_attention_heads=4, intermediate_size=64, num_labels=12,
        out_indices=list(pcfg.out_indices), use_relative_position_bias=True,
        use_absolute_position_embeddings=False, use_mean_pooling=True,
        layer_scale_init_value=0.1, use_auxiliary_head=False,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0,
    )
    torch.manual_seed(0)
    hf = BeitForSemanticSegmentation(hf_cfg).eval()
    with torch.no_grad():
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    return hf, sd, jcfg, pcfg


def test_converted_tree_matches_jax(hf_pair):
    _, sd, jcfg, pcfg = hf_pair
    got, want = p_seg.convert_beit_seg_state_dict(sd, pcfg), j_seg.convert_beit_seg_state_dict(sd, jcfg)
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hf_parity_segmentation_logits_and_class_map(hf_pair):
    hf, sd, _, pcfg = hf_pair
    params = p_params.layout_seg_from_jax(p_seg.convert_beit_seg_state_dict(sd, pcfg))
    pix = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        hf_logits = hf(pixel_values=torch.from_numpy(pix.transpose(0, 3, 1, 2))).logits
        hf_map = torch.nn.functional.interpolate(hf_logits, size=(64, 64), mode="bilinear",
                                                 align_corners=False).argmax(1).numpy()
    with torch.inference_mode():
        got = p_seg.beit_segment_logits(params, pcfg, torch.from_numpy(pix))
        gmap = p_seg.segment_map(params, pcfg, torch.from_numpy(pix)).numpy()
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), hf_logits.numpy(), rtol=HF_TOL, atol=HF_TOL)
    _same_map(gmap, hf_map, _upsampled(got, 64))


def test_detector_plugs_into_layout_provider_and_batches(hf_pair):
    """The detector's boxes equal the JAX detector's on the same weights,
    page by page, and its batch form equals one page at a time."""
    from rag_docvqa_tpu_torch.models.layout import LayoutProvider

    _, sd, jcfg, pcfg = hf_pair
    det = p_seg.make_dit_detector(p_params.layout_seg_from_jax(p_seg.convert_beit_seg_state_dict(sd, pcfg)), pcfg)
    jdet = j_seg.make_dit_detector(jax.tree.map(jnp.asarray, j_seg.convert_beit_seg_state_dict(sd, jcfg)), jcfg)
    rng = np.random.RandomState(2)
    imgs = [(rng.rand(96, 80, 3) * 255).astype(np.uint8), (rng.rand(50, 70, 3) * 255).astype(np.uint8)]
    singles = [det(img) for img in imgs]
    assert det.batch(imgs) == singles
    for (boxes, labels), img in zip(singles, imgs):
        assert isinstance(boxes, list) and isinstance(labels, list)
        assert (boxes, labels) == jdet(img)
        for b in boxes:
            assert 0.0 <= b[0] <= b[2] <= 1.0 and 0.0 <= b[1] <= b[3] <= 1.0
    layout = LayoutProvider(detector=det).page_layout(image=imgs[0])
    assert set(layout) >= {"boxes", "labels"}
