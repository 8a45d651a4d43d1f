"""Port parity, the YOLO layout detector (`rag_docvqa_tpu_torch/models/
yolo.py`): the five cases of `tests/test_yolo.py` (forward shapes, decoded
boxes normalized, the DFL decode of a hand-set distribution, the detector in
a LayoutProvider, the ultralytics conversion) against the JAX functions at
width 8, on the JAX init's weights carried over with `params.yolo_from_jax`,
and F9: JAX's stride-2 "SAME" convolution pads an even input (0, 1), which
the port copies, where ultralytics' Conv pads (1, 1).

Limits: the raw head outputs and the decoded boxes and scores within 1e-5
of JAX's (f32 convolutions summed in another order; measured ~1e-7), the
classes and the filtered boxes of the detector equal. Seeded weights put
every class score near sigmoid(-4.59) ~ 0.01, under `conf_thresh`, so the
conversion case, with random weights of unit scale, is the one whose
detector finds boxes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import yolo as j_yolo
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import conv as p_conv
from rag_docvqa_tpu_torch.models import yolo as p_yolo

torch.set_num_threads(2)

TOL = 1e-5
KW = dict(num_classes=10, width=8, depth=1, reg_max=4, image_size=128, conf_thresh=0.2)


def _pair(seed: int, **kw):
    jcfg, pcfg = j_yolo.YOLOConfig(**{**KW, **kw}), p_yolo.YOLOConfig(**{**KW, **kw})
    tree = jax.tree.map(np.asarray, j_yolo.init_yolo_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, pcfg, jax.tree.map(jnp.asarray, tree), p_params.yolo_from_jax(tree)


def _close(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL, err_msg=what)


def test_forward_shapes_and_values():
    jcfg, pcfg, jp, pp = _pair(0)
    pix = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
    with torch.inference_mode():
        outs = p_yolo.yolo_forward(pp, pcfg, torch.from_numpy(pix))
    want = j_yolo.yolo_forward(jp, jcfg, jnp.asarray(pix))
    assert len(outs) == 3
    for (reg, cls), (jreg, jcls), stride in zip(outs, want, pcfg.strides):
        g = 128 // stride
        assert reg.shape == (2, g, g, 4 * pcfg.reg_max) and cls.shape == (2, g, g, pcfg.num_classes)
        _close(reg, jreg, f"reg stride {stride}")
        _close(cls, jcls, f"cls stride {stride}")


def test_detect_decode_boxes_normalized():
    jcfg, pcfg, jp, pp = _pair(1)
    pix = np.random.RandomState(1).rand(1, 128, 128, 3).astype(np.float32)
    with torch.inference_mode():
        boxes, scores, classes = p_yolo.yolo_detect(pp, pcfg, torch.from_numpy(pix))
    jb, js, jc = j_yolo.yolo_detect(jp, jcfg, jnp.asarray(pix))
    A = sum((128 // s) ** 2 for s in pcfg.strides)
    assert boxes.shape == (1, A, 4) and scores.shape == (1, A) and classes.dtype == torch.int32
    b = boxes.numpy()
    assert (b >= 0).all() and (b <= 1).all()
    assert (b[..., 2] >= b[..., 0]).all() and (b[..., 3] >= b[..., 1]).all()
    assert ((scores >= 0) & (scores <= 1)).all() and (classes < pcfg.num_classes).all()
    _close(boxes, jb, "boxes")
    _close(scores, js, "scores")
    np.testing.assert_array_equal(classes.numpy(), np.asarray(jc))


def test_dfl_decode_math():
    """A hand-set regression distribution decodes to the expected box:
    bin-expectation distances (l, t, r, b) in cells around each cell centre;
    the same boxes as JAX's."""
    kw = dict(num_classes=2, width=8, depth=1, reg_max=4, image_size=64)
    jcfg, pcfg = j_yolo.YOLOConfig(**kw), p_yolo.YOLOConfig(**kw)
    tree = jax.tree.map(np.array, j_yolo.init_yolo_params(jax.random.PRNGKey(2), jcfg))
    hp = tree["head"][0]
    bias = np.full((4 * pcfg.reg_max,), -50.0, np.float32)
    bias[2::pcfg.reg_max] = 50.0  # bin 2 on each of the 4 sides
    hp["reg_out"] = {"kernel": np.zeros_like(hp["reg_out"]["kernel"]), "bias": bias}
    pix = np.zeros((1, 64, 64, 3), np.float32)
    with torch.inference_mode():
        boxes = p_yolo.yolo_detect(p_params.yolo_from_jax(tree), pcfg, torch.from_numpy(pix))[0][0].numpy()
    s = 8 / 64  # the first P3 cell: centre (0.5, 0.5) cells, stride 8, S 64
    np.testing.assert_allclose(boxes[0], [0.0, 0.0, 2.5 * s, 2.5 * s], atol=1e-5)
    i = 3 * 8 + 4  # row 3, col 4
    np.testing.assert_allclose(boxes[i], [(4.5 - 2) * s, (3.5 - 2) * s, (4.5 + 2) * s, (3.5 + 2) * s], atol=1e-5)
    jboxes = np.asarray(j_yolo.yolo_detect(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(pix))[0][0])
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=TOL)


def test_detector_plugs_into_layout_provider():
    from rag_docvqa_tpu_torch.models.layout import LayoutProvider

    jcfg, pcfg, jp, pp = _pair(3)
    det, jdet = p_yolo.make_yolo_detector(pp, pcfg), j_yolo.make_yolo_detector(jp, jcfg)
    img = (np.random.RandomState(4).rand(200, 160, 3) * 255).astype(np.uint8)
    boxes, labels = det(img)
    assert isinstance(boxes, list) and isinstance(labels, list)
    assert (boxes, labels) == jdet(img)
    assert det.batch([img, img[:100]]) == [det(img), det(img[:100])]
    layout = LayoutProvider(detector=det).page_layout(image=img)
    assert set(layout) >= {"boxes", "labels"}


def ultralytics_state_dict(cfg, seed: int = 0) -> dict:
    """A synthetic ultralytics-named state dict for `cfg`: random conv
    kernels of unit scale, BatchNorm parameters in [0.5, 1.5), random output
    biases (tests/test_yolo.py's)."""
    ref = jax.tree.map(np.asarray, j_yolo.init_yolo_params(jax.random.PRNGKey(5), cfg))
    rng = np.random.RandomState(seed)
    sd = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = rng.randn(*np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)).shape).astype(np.float32)
        for name, arr in (("weight", "w"), ("bias", "b"), ("running_mean", "mean"), ("running_var", "var")):
            sd[f"{prefix}.bn.{name}"] = rng.rand(*p["bn"][arr].shape).astype(np.float32) + 0.5

    def put_c2f(prefix, p):
        put_conv(f"{prefix}.cv1", p["cv1"])
        put_conv(f"{prefix}.cv2", p["cv2"])
        for j, m in enumerate(p["m"]):
            put_conv(f"{prefix}.m.{j}.cv1", m["cv1"])
            put_conv(f"{prefix}.m.{j}.cv2", m["cv2"])

    for prefix, name in (("model.0", "stem"), ("model.1", "down2"), ("model.3", "down3"), ("model.5", "down4"),
                         ("model.7", "down5"), ("model.16", "pan_down3"), ("model.19", "pan_down4")):
        put_conv(prefix, ref[name])
    for prefix, name in (("model.2", "c2f_2"), ("model.4", "c2f_3"), ("model.6", "c2f_4"), ("model.8", "c2f_5"),
                         ("model.12", "up4"), ("model.15", "up3"), ("model.18", "pan4"), ("model.21", "pan5")):
        put_c2f(prefix, ref[name])
    put_conv("model.9.cv1", ref["sppf"]["cv1"])
    put_conv("model.9.cv2", ref["sppf"]["cv2"])
    for i, hp in enumerate(ref["head"]):
        for branch, (a, b, out) in (("cv2", ("reg1", "reg2", "reg_out")), ("cv3", ("cls1", "cls2", "cls_out"))):
            put_conv(f"model.22.{branch}.{i}.0", hp[a])
            put_conv(f"model.22.{branch}.{i}.1", hp[b])
            k = np.transpose(hp[out]["kernel"], (3, 2, 0, 1))
            sd[f"model.22.{branch}.{i}.2.weight"] = rng.randn(*k.shape).astype(np.float32)
            sd[f"model.22.{branch}.{i}.2.bias"] = rng.randn(k.shape[0]).astype(np.float32)
    return sd


def test_ultralytics_conversion_structural():
    """The synthetic state dict converts onto the same tree as JAX's
    converter gives, exactly, and changes the forward output; the converted
    detector's filtered boxes equal the JAX detector's."""
    kw = dict(num_classes=3, width=8, depth=1, reg_max=4, image_size=64)
    jcfg, pcfg = j_yolo.YOLOConfig(**kw), p_yolo.YOLOConfig(**kw)
    sd = ultralytics_state_dict(jcfg)
    got, want = p_yolo.convert_yolo_state_dict(sd, pcfg), j_yolo.convert_yolo_state_dict(sd, jcfg)
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, b)
    converted = p_params.yolo_from_jax(got)
    ref = p_params.yolo_from_jax(jax.tree.map(np.asarray, j_yolo.init_yolo_params(jax.random.PRNGKey(5), jcfg)))
    assert len(list(converted.parameters())) == len(list(ref.parameters()))
    pix = np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32)
    with torch.inference_mode():
        out_conv = p_yolo.yolo_detect(converted, pcfg, torch.from_numpy(pix))
        out_ref = p_yolo.yolo_detect(ref, pcfg, torch.from_numpy(pix))
    assert not np.allclose(out_ref[1].numpy(), out_conv[1].numpy())
    jout = j_yolo.yolo_detect(jax.tree.map(jnp.asarray, want), jcfg, jnp.asarray(pix))
    scale = max(1.0, float(np.abs(np.asarray(jout[1])).max()))
    np.testing.assert_allclose(out_conv[0].numpy(), np.asarray(jout[0]), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(out_conv[1].numpy(), np.asarray(jout[1]), rtol=0, atol=TOL * scale)
    img = (np.random.RandomState(7).rand(90, 70, 3) * 255).astype(np.uint8)
    found = p_yolo.make_yolo_detector(converted, pcfg)(img)
    assert found == j_yolo.make_yolo_detector(jax.tree.map(jnp.asarray, want), jcfg)(img)


@pytest.mark.parametrize("size", [16, 15])
def test_f9_stride2_same_pads_low_zero_high_one(size):
    """F9: `lax.conv_general_dilated` "SAME" with stride 2, k 3 pads an even
    input (0, 1) and an odd one (1, 1); the port's conv2d equals it, and on
    an even input differs from PyTorch's padding=1 (ultralytics' Conv)."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, 4, size, size).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
                                        (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = p_conv.conv2d(torch.from_numpy(x), p_conv.Conv(torch.from_numpy(w)), stride=2)
    assert p_conv.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    symmetric = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=1)
    assert symmetric.shape == got.shape
    if size % 2 == 0:  # one pixel off: no output agrees with the (1, 1) padding's
        assert not np.allclose(symmetric.numpy(), got.numpy(), atol=1e-3)
        np.testing.assert_allclose(
            got.numpy(), torch.nn.functional.conv2d(torch.nn.functional.pad(torch.from_numpy(x), (0, 1, 0, 1)),
                                                    torch.from_numpy(w), stride=2).numpy(), rtol=0, atol=TOL)
    else:
        np.testing.assert_allclose(symmetric.numpy(), got.numpy(), rtol=0, atol=TOL)
