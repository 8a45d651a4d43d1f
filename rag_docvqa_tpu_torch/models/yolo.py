"""YOLOv10-style document-layout detector (DocLayout-YOLO's shape).

Counterpart of `rag_docvqa_tpu/models/yolo.py`: `YOLOConfig`,
`init_yolo_params`, `yolo_forward`, `yolo_detect`, `make_yolo_detector` and
`convert_yolo_state_dict` (numpy only; it gives the JAX package's tree,
which `params.yolo_from_jax` turns into `YOLOParams`). The reference wraps
the `doclayout_yolo` package (`juliozhao/DocLayout-YOLO-DocStructBench`,
imgsz 1024, conf 0.2, src/_modules.py:622-829) and feeds its detections to
`models/layout.py::filter_detections_yolo`:

  * CSP backbone (Conv-BN-SiLU, C2f, SPPF) -> P3/P4/P5 features
  * PAN neck (top-down, then bottom-up fusion)
  * anchor-free decoupled head: per-cell class logits and DFL box
    regression (a distribution over `reg_max` bins per side, decoded
    against the cell grid)

Activations are NCHW and every convolution is `F.conv2d` through
`models/conv.py::conv2d`: NCHW is the layout PyTorch's convolutions take
without a copy, and the detector runs in f32, where channels-last buys
cuDNN little. No Pallas kernel backs any of it in JAX. Padding is XLA's
"SAME" as JAX computes it, so a stride-2 3x3 conv of an even input pads
(0, 1), where ultralytics' `Conv` pads 1 on both sides: a one-pixel offset
on converted weights that the port keeps, to stay equal to JAX (ROADMAP
Queue 3, F9). SPPF's 5x5 SAME max-pool is `F.max_pool2d(5, 1, 2)`, the
upsample nearest, BatchNorm's eps 1e-3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch.models.conv import ConvBN, batch_norm, conv2d, init_conv, init_conv_bn


@dataclass(frozen=True)
class YOLOConfig:
    num_classes: int = 10  # DocLayout-YOLO's 10-class space
    width: int = 32  # base channel count (P1); doubles per stage
    depth: int = 1  # bottlenecks per C2f
    reg_max: int = 16  # DFL bins per box side
    image_size: int = 1024  # reference imgsz (src/_modules.py:719)
    conf_thresh: float = 0.2  # reference conf (src/_modules.py:720)
    bn_eps: float = 1e-3  # ultralytics BatchNorm2d eps

    @property
    def strides(self) -> Tuple[int, int, int]:
        return (8, 16, 32)


class C2f(nn.Module):
    """cv1, cv2 (ConvBN) and `m`, a list of bottlenecks {cv1, cv2}."""

    def __init__(self, cv1: ConvBN, cv2: ConvBN, m):
        super().__init__()
        self.cv1, self.cv2 = cv1, cv2
        self.m = nn.ModuleList(nn.ModuleDict(b) for b in m)


class YOLOParams(nn.Module):
    """The backbone (stem, down2-5, c2f_2-5, sppf {cv1, cv2}), the neck
    (up4, up3, pan_down3, pan4, pan_down4, pan5) and three head branches
    {reg1, reg2, reg_out, cls1, cls2, cls_out}, one a scale."""

    def __init__(self, **parts):
        super().__init__()
        for name, p in parts.items():
            if name == "head":
                p = nn.ModuleList(nn.ModuleDict(h) for h in p)
            elif name == "sppf":
                p = nn.ModuleDict(p)
            setattr(self, name, p)


def init_yolo_params(generator: torch.Generator, cfg: YOLOConfig) -> YOLOParams:
    """Random f32 weights on the generator's device with the JAX package's
    distributions: N(0, 1/fan_in) kernels, identity BatchNorms, the output
    convs N(0, 0.01^2) with zero box biases and class biases of -4.59 (a
    sigmoid prior of ~0.01, under `conf_thresh`: seeded weights find no box)."""
    g, w, d = generator, cfg.width, cfg.depth
    c3, c4, c5 = 4 * w, 8 * w, 16 * w  # P3/P4/P5 channels

    def c2f(cin, cout):
        h = cout // 2
        return C2f(init_conv_bn(g, 1, cin, cout), init_conv_bn(g, 1, (2 + d) * h, cout),
                   [{"cv1": init_conv_bn(g, 3, h, h), "cv2": init_conv_bn(g, 3, h, h)} for _ in range(d)])

    def head_branch(cin):
        return {"reg1": init_conv_bn(g, 3, cin, 64), "reg2": init_conv_bn(g, 3, 64, 64),
                "reg_out": init_conv(g, 1, 64, 4 * cfg.reg_max, bias=True, std=0.01),
                "cls1": init_conv_bn(g, 3, cin, 64), "cls2": init_conv_bn(g, 3, 64, 64),
                "cls_out": init_conv(g, 1, 64, cfg.num_classes, bias=True, std=0.01, bias_value=-4.59)}

    return YOLOParams(
        stem=init_conv_bn(g, 3, 3, w), down2=init_conv_bn(g, 3, w, 2 * w), c2f_2=c2f(2 * w, 2 * w),
        down3=init_conv_bn(g, 3, 2 * w, c3), c2f_3=c2f(c3, c3),
        down4=init_conv_bn(g, 3, c3, c4), c2f_4=c2f(c4, c4),
        down5=init_conv_bn(g, 3, c4, c5), c2f_5=c2f(c5, c5),
        sppf={"cv1": init_conv_bn(g, 1, c5, c5 // 2), "cv2": init_conv_bn(g, 1, 2 * c5, c5)},
        up4=c2f(c5 + c4, c4), up3=c2f(c4 + c3, c3), pan_down3=init_conv_bn(g, 3, c3, c3), pan4=c2f(c3 + c4, c4),
        pan_down4=init_conv_bn(g, 3, c4, c4), pan5=c2f(c4 + c5, c5),
        head=[head_branch(c) for c in (c3, c4, c5)],
    )


# --------------------------------------------------------------------------- #
# forward (NCHW)
# --------------------------------------------------------------------------- #
def _cbs(x: torch.Tensor, p: ConvBN, cfg: YOLOConfig, stride: int = 1) -> torch.Tensor:
    """Conv + BN + SiLU (ultralytics Conv)."""
    return F.silu(batch_norm(conv2d(x, p.conv, stride), p.bn, cfg.bn_eps))


def _c2f_fwd(x: torch.Tensor, p: C2f, cfg: YOLOConfig) -> torch.Tensor:
    y = _cbs(x, p.cv1, cfg)
    h = y.shape[1] // 2
    parts = [y[:, :h], y[:, h:]]
    for m in p.m:
        parts.append(_cbs(_cbs(parts[-1], m["cv1"], cfg), m["cv2"], cfg) + parts[-1])
    return _cbs(torch.cat(parts, dim=1), p.cv2, cfg)


def _sppf(x: torch.Tensor, p, cfg: YOLOConfig) -> torch.Tensor:
    pools = [_cbs(x, p["cv1"], cfg)]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return _cbs(torch.cat(pools, dim=1), p["cv2"], cfg)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def yolo_forward(params: YOLOParams, cfg: YOLOConfig, pixels: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(B, S, S, 3) pixels in [0, 1] -> per scale (box_dist, cls_logits),
    channels last as JAX returns them: (B, S/s, S/s, 4 * reg_max) and
    (B, S/s, S/s, num_classes) for s in 8, 16, 32."""
    p = params
    x = _cbs(pixels.permute(0, 3, 1, 2), p.stem, cfg, stride=2)
    x = _c2f_fwd(_cbs(x, p.down2, cfg, stride=2), p.c2f_2, cfg)
    p3 = _c2f_fwd(_cbs(x, p.down3, cfg, stride=2), p.c2f_3, cfg)
    p4 = _c2f_fwd(_cbs(p3, p.down4, cfg, stride=2), p.c2f_4, cfg)
    p5 = _sppf(_c2f_fwd(_cbs(p4, p.down5, cfg, stride=2), p.c2f_5, cfg), p.sppf, cfg)

    # PAN: top-down, then bottom-up
    u4 = _c2f_fwd(torch.cat([_upsample2(p5), p4], dim=1), p.up4, cfg)
    u3 = _c2f_fwd(torch.cat([_upsample2(u4), p3], dim=1), p.up3, cfg)
    n4 = _c2f_fwd(torch.cat([_cbs(u3, p.pan_down3, cfg, stride=2), u4], dim=1), p.pan4, cfg)
    n5 = _c2f_fwd(torch.cat([_cbs(n4, p.pan_down4, cfg, stride=2), p5], dim=1), p.pan5, cfg)

    outs = []
    for feat, hp in zip((u3, n4, n5), p.head):
        reg = conv2d(_cbs(_cbs(feat, hp["reg1"], cfg), hp["reg2"], cfg), hp["reg_out"])
        cls = conv2d(_cbs(_cbs(feat, hp["cls1"], cfg), hp["cls2"], cfg), hp["cls_out"])
        outs.append((reg.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1)))
    return outs


def yolo_detect(params: YOLOParams, cfg: YOLOConfig, pixels: torch.Tensor):
    """Decode to flat candidates over all anchors A = sum(grid^2):
    (boxes_xyxy normalized (B, A, 4), scores (B, A), classes (B, A) int32).
    DFL: a softmax over the `reg_max` bins of each side, its expectation in
    cells around the cell centre, scaled by the stride and clipped to [0, 1];
    scores are the largest class sigmoid, classes its argmax."""
    outs = yolo_forward(params, cfg, pixels)
    S = pixels.shape[1]
    all_boxes, all_scores, all_cls = [], [], []
    for (reg, cls), stride in zip(outs, cfg.strides):
        B, H, W, _ = reg.shape
        dist = torch.softmax(reg.reshape(B, H, W, 4, cfg.reg_max).float(), dim=-1)
        dist = (dist * torch.arange(cfg.reg_max, dtype=torch.float32, device=reg.device)).sum(-1)  # l, t, r, b
        cy = (torch.arange(H, dtype=torch.float32, device=reg.device) + 0.5)[None, :, None]
        cx = (torch.arange(W, dtype=torch.float32, device=reg.device) + 0.5)[None, None, :]
        boxes = torch.stack([(cx - dist[..., 0]) * stride / S, (cy - dist[..., 1]) * stride / S,
                             (cx + dist[..., 2]) * stride / S, (cy + dist[..., 3]) * stride / S], dim=-1)
        probs = torch.sigmoid(cls.float()).reshape(B, H * W, cfg.num_classes)
        all_boxes.append(boxes.reshape(B, H * W, 4).clamp(0.0, 1.0))
        score, label = probs.max(dim=-1)
        all_scores.append(score)
        all_cls.append(label.to(torch.int32))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1), torch.cat(all_cls, dim=1)


def yolo_pixels(images, size: int, device) -> torch.Tensor:
    """Page images (H, W, 3) uint8 -> (B, size, size, 3) f32 pixels in
    [0, 1] on `device`: the host resize of `ops/patches.py`, / 255."""
    from rag_docvqa_tpu_torch.ops.patches import resize_image

    pix = [resize_image(np.asarray(im), size, size) / 255.0 for im in images]
    return torch.from_numpy(np.stack(pix).astype(np.float32)).to(device)


def make_yolo_detector(params: YOLOParams, cfg: YOLOConfig, max_det: int = 300):
    """A detector callable for `models.layout.LayoutProvider`: image ->
    filtered (normalized boxes, 4-class labels) through the reference's
    confidence gate, 10 -> 4 remap and NMS (`filter_detections_yolo`,
    src/_modules.py:671-724). Its `batch(images)` does the same for a list
    of pages in one forward."""
    from rag_docvqa_tpu_torch.models.layout import filter_detections_yolo

    device = params.stem.conv.weight.device

    def batch(images):
        with torch.inference_mode():
            out = yolo_detect(params, cfg, yolo_pixels(images, cfg.image_size, device))
        result = []
        for boxes, scores, classes in zip(*(t.cpu().numpy() for t in out)):
            keep = scores >= cfg.conf_thresh
            order = np.argsort(-scores[keep])[:max_det]
            result.append(filter_detections_yolo(boxes[keep][order].tolist(), classes[keep][order].tolist()))
        return result

    def detector(image: np.ndarray):
        return batch([image])[0]

    detector.batch = batch
    return detector


# --------------------------------------------------------------------------- #
# ultralytics weight conversion (structural name map)
# --------------------------------------------------------------------------- #
def convert_yolo_state_dict(sd, cfg: YOLOConfig) -> Dict:
    """An ultralytics-format state dict whose module layout matches this
    architecture (model.<i>.conv/bn for Conv blocks, cv1/cv2/m.<j> for C2f)
    -> the JAX package's tree of numpy arrays (HWIO kernels), which
    `params.yolo_from_jax` turns into `YOLOParams`. doclayout_yolo ships v10
    modules (SCDown, PSA, the one-to-one head) that have no counterpart here;
    pass a dict pre-filtered to the shared trunk. A missing key raises."""
    a = lambda k: np.asarray(sd[k])
    kernel = lambda k: np.transpose(a(k), (2, 3, 1, 0))

    def conv_bn(prefix):
        return {"conv": {"kernel": kernel(f"{prefix}.conv.weight")},
                "bn": {"w": a(f"{prefix}.bn.weight"), "b": a(f"{prefix}.bn.bias"),
                       "mean": a(f"{prefix}.bn.running_mean"), "var": a(f"{prefix}.bn.running_var")}}

    def c2f(prefix, n):
        return {"cv1": conv_bn(f"{prefix}.cv1"), "cv2": conv_bn(f"{prefix}.cv2"),
                "m": [{"cv1": conv_bn(f"{prefix}.m.{j}.cv1"), "cv2": conv_bn(f"{prefix}.m.{j}.cv2")}
                      for j in range(n)]}

    d = cfg.depth
    return {
        "stem": conv_bn("model.0"), "down2": conv_bn("model.1"), "c2f_2": c2f("model.2", d),
        "down3": conv_bn("model.3"), "c2f_3": c2f("model.4", d), "down4": conv_bn("model.5"),
        "c2f_4": c2f("model.6", d), "down5": conv_bn("model.7"), "c2f_5": c2f("model.8", d),
        "sppf": {"cv1": conv_bn("model.9.cv1"), "cv2": conv_bn("model.9.cv2")},
        "up4": c2f("model.12", d), "up3": c2f("model.15", d), "pan_down3": conv_bn("model.16"),
        "pan4": c2f("model.18", d), "pan_down4": conv_bn("model.19"), "pan5": c2f("model.21", d),
        "head": [
            {"reg1": conv_bn(f"model.22.cv2.{i}.0"), "reg2": conv_bn(f"model.22.cv2.{i}.1"),
             "reg_out": {"kernel": kernel(f"model.22.cv2.{i}.2.weight"), "bias": a(f"model.22.cv2.{i}.2.bias")},
             "cls1": conv_bn(f"model.22.cv3.{i}.0"), "cls2": conv_bn(f"model.22.cv3.{i}.1"),
             "cls_out": {"kernel": kernel(f"model.22.cv3.{i}.2.weight"), "bias": a(f"model.22.cv3.{i}.2.bias")}}
            for i in range(3)
        ],
    }
