"""BEiT semantic segmentation: the DiT layout detector's network (HF
BeitForSemanticSegmentation).

Counterpart of `rag_docvqa_tpu/models/layout_seg.py`: `BeitSegConfig`,
`init_beit_seg_params`, `beit_segment_logits`, `segment_map`,
`make_dit_detector` and `convert_beit_seg_state_dict` (numpy only; it gives
the JAX package's tree, which `params.layout_seg_from_jax` turns into
`BeitSegParams`). The reference runs `cmarkea/dit-base-layout-detection`, a
BEiT backbone and a UPerNet decode head, for an (H, W) class map, then
`models/layout.py` turns the map into boxes (src/_modules.py:293-619):

  backbone taps (4 block outputs)    `vit_encode(return_hidden_states=True)`:
                                     every layer through K14 in its BEiT form
                                     (per-layer rel-pos bias, layer-scale)
  fpn1..fpn4 multi-scale adapters    ConvT(2, 2) + BN + exact GELU + ConvT /
                                     ConvT / identity / 2x2 max-pool
  UPerHead                           PSP pooling (1, 2, 3, 6) on the top
                                     feature, lateral 1x1 convs, top-down
                                     FPN, fpn_bottleneck, 1x1 classifier

The head is plain PyTorch, as JAX computes it outside any Pallas kernel:
`F.conv2d` / `F.conv_transpose2d` in NCHW (`models/conv.py`), inference-mode
BatchNorm, `F.adaptive_avg_pool2d` (torch's floor/ceil bin edges, which JAX
copies by hand; at DiT-base's 7x7 top feature the bins overlap), bilinear
resizes with half-pixel centres and no antialiasing, and a max-pool by
reshape, which refuses an odd grid as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch.models.conv import Conv, ConvBN, batch_norm, conv2d, init_bn, init_conv, init_conv_bn
from rag_docvqa_tpu_torch.models.vit import ViTConfig, ViTParams, convert_vit_state_dict, init_vit_params, vit_encode


@dataclass(frozen=True)
class BeitSegConfig:
    vit: ViTConfig = field(default_factory=lambda: ViTConfig(arch="beit"))
    num_labels: int = 12
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)  # 1-based block outputs
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)
    bn_eps: float = 1e-5


class BeitSegParams(nn.Module):
    """The backbone (`ViTParams`) and the head: `fpn1` {deconv1, bn, deconv2}
    and `fpn2` {deconv1} (ConvTranspose2d kernels (in, out, 2, 2) with
    biases), `psp`, `laterals`, `fpn_convs` (lists of ConvBN), `bottleneck`,
    `fpn_bottleneck` (ConvBN) and `classifier` (Conv with a bias)."""

    def __init__(self, backbone: ViTParams, fpn1: Dict[str, nn.Module], fpn2: Dict[str, nn.Module], psp, bottleneck,
                 laterals, fpn_convs, fpn_bottleneck, classifier):
        super().__init__()
        self.backbone = backbone
        self.fpn1, self.fpn2 = nn.ModuleDict(fpn1), nn.ModuleDict(fpn2)
        self.psp, self.laterals, self.fpn_convs = nn.ModuleList(psp), nn.ModuleList(laterals), nn.ModuleList(fpn_convs)
        self.bottleneck, self.fpn_bottleneck, self.classifier = bottleneck, fpn_bottleneck, classifier


def init_beit_seg_params(generator: torch.Generator, cfg: BeitSegConfig) -> BeitSegParams:
    """Random f32 weights on the generator's device with the JAX package's
    distributions: N(0, 1/fan_in) kernels, zero biases, identity BatchNorms."""
    g, D = generator, cfg.vit.hidden_size
    backbone = init_vit_params(g, cfg.vit)
    deconv = lambda: init_conv(g, 2, D, D, bias=True)  # (D, D, 2, 2): in, out as ConvTranspose2d reads it
    return BeitSegParams(
        backbone,
        {"deconv1": deconv(), "bn": init_bn(D, g.device), "deconv2": deconv()},
        {"deconv1": deconv()},
        [init_conv_bn(g, 1, D, D) for _ in cfg.pool_scales],
        init_conv_bn(g, 3, D * (1 + len(cfg.pool_scales)), D),
        [init_conv_bn(g, 1, D, D) for _ in range(3)],
        [init_conv_bn(g, 3, D, D) for _ in range(3)],
        init_conv_bn(g, 3, 4 * D, D),
        init_conv(g, 1, D, cfg.num_labels, bias=True),
    )


# --------------------------------------------------------------------------- #
# primitives (NCHW)
# --------------------------------------------------------------------------- #
def _conv_module(x: torch.Tensor, p: ConvBN, eps: float) -> torch.Tensor:
    """BeitConvModule: conv (no bias) + BN + ReLU."""
    return torch.relu(batch_norm(conv2d(x, p.conv), p.bn, eps))


def _deconv2x2(x: torch.Tensor, p: Conv) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2): output pixel (2i+a, 2j+b) is
    sum_ci x[ci, i, j] W[ci, co, a, b] + bias[co]."""
    return F.conv_transpose2d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=2)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    return x.reshape(B, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialiasing (every call upsamples)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def beit_segment_logits(params: BeitSegParams, cfg: BeitSegConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, H/4, W/4, num_labels) logits,
    channels last as JAX returns them (HF returns them NCHW at
    patch_resolution * 4; the upsample and argmax come downstream)."""
    _, per_layer = vit_encode(params.backbone, cfg.vit, pixels, return_hidden_states=True)
    return beit_seg_head(params, cfg, per_layer)


def beit_seg_head(params: BeitSegParams, cfg: BeitSegConfig, per_layer: torch.Tensor) -> torch.Tensor:
    """The decode head alone: the backbone's per-layer outputs (L, B, T, d)
    -> (B, 4g, 4g, num_labels) logits."""
    eps, g = cfg.bn_eps, cfg.vit.grid
    B = per_layer.shape[1]
    feats: List[torch.Tensor] = []
    for oi in cfg.out_indices:
        assert oi >= 2, "out_index 1 (pre-block embeddings) unsupported"
        h = per_layer[oi - 2]  # block (oi-1)'s output = HF hidden_states[oi-1]
        feats.append(h[:, 1:, :].reshape(B, g, g, -1).permute(0, 3, 1, 2))  # drop CLS -> NCHW

    # multi-scale adapters (modeling_beit.py fpn1..fpn4)
    f1 = _deconv2x2(F.gelu(batch_norm(_deconv2x2(feats[0], params.fpn1["deconv1"]), params.fpn1["bn"], eps)),
                    params.fpn1["deconv2"])  # 4x
    f2 = _deconv2x2(feats[1], params.fpn2["deconv1"])  # 2x
    feats = [f1, f2, feats[2], _maxpool2(feats[3])]

    # PSP on the top feature
    top = feats[-1]
    th, tw = top.shape[2], top.shape[3]
    psp_outs = [top]
    for scale, p in zip(cfg.pool_scales, params.psp):
        pooled = _conv_module(F.adaptive_avg_pool2d(top, scale), p, eps)
        psp_outs.append(_resize(pooled, th, tw))
    psp = _conv_module(torch.cat(psp_outs, dim=1), params.bottleneck, eps)

    # laterals + top-down
    laterals = [_conv_module(feats[i], params.laterals[i], eps) for i in range(3)] + [psp]
    for i in range(3, 0, -1):
        laterals[i - 1] = laterals[i - 1] + _resize(laterals[i], laterals[i - 1].shape[2], laterals[i - 1].shape[3])

    fpn_outs = [_conv_module(laterals[i], params.fpn_convs[i], eps) for i in range(3)] + [laterals[3]]
    h0, w0 = fpn_outs[0].shape[2], fpn_outs[0].shape[3]
    fpn_outs = [fpn_outs[0]] + [_resize(f, h0, w0) for f in fpn_outs[1:]]
    out = _conv_module(torch.cat(fpn_outs, dim=1), params.fpn_bottleneck, eps)
    return conv2d(out, params.classifier).permute(0, 2, 3, 1)  # (B, 4g, 4g, num_labels)


def segment_map(params: BeitSegParams, cfg: BeitSegConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) int32 class map: the logits upsampled to the
    input size, then the argmax (the map LayoutModelDIT post-processes,
    src/_modules.py:440-465)."""
    logits = beit_segment_logits(params, cfg, pixels).permute(0, 3, 1, 2)
    return _resize(logits, pixels.shape[1], pixels.shape[2]).argmax(dim=1).to(torch.int32)


def dit_pixels(images, size: int, device) -> torch.Tensor:
    """Page images (H, W, 3) uint8 -> (B, size, size, 3) f32 pixels in
    [-1, 1] on `device`: the host resize of `ops/patches.py`, then
    (x / 255 - 0.5) / 0.5, as the JAX detector prepares one page."""
    from rag_docvqa_tpu_torch.ops.patches import resize_image

    pix = [(resize_image(np.asarray(im), size, size) / 255.0 - 0.5) / 0.5 for im in images]
    return torch.from_numpy(np.stack(pix).astype(np.float32)).to(device)


def make_dit_detector(params: BeitSegParams, cfg: BeitSegConfig):
    """A detector callable for `models.layout.LayoutProvider`: image (H, W, 3)
    uint8 -> (normalized boxes, 4-class labels) through the segmentation map
    and the post-processing of `models/layout.py` (src/_modules.py:440-511).
    Its `batch(images)` does the same for a list of pages in one forward."""
    from rag_docvqa_tpu_torch.models.layout import filter_detections_dit, segmentation_to_layout

    size = cfg.vit.image_size
    device = params.backbone.patch_w.device

    def batch(images):
        with torch.inference_mode():
            seg = segment_map(params, cfg, dit_pixels(images, size, device)).cpu().numpy()
        return [filter_detections_dit(*segmentation_to_layout(s), (size, size)) for s in seg]

    def detector(image: np.ndarray):
        return batch([image])[0]

    detector.batch = batch
    return detector


# --------------------------------------------------------------------------- #
# HF conversion (BeitForSemanticSegmentation)
# --------------------------------------------------------------------------- #
def convert_beit_seg_state_dict(sd, cfg: BeitSegConfig) -> Dict:
    """HF BeitForSemanticSegmentation state dict -> the JAX package's tree of
    numpy arrays (HWIO conv kernels, (kh, kw, in, out) deconv kernels), which
    `params.layout_seg_from_jax` turns into `BeitSegParams`."""
    a = lambda k: np.asarray(sd[k])
    conv_k = lambda k: np.transpose(a(k), (2, 3, 1, 0))  # torch conv (O, I, kh, kw) -> HWIO
    deconv_k = lambda k: np.transpose(a(k), (2, 3, 0, 1))  # ConvTranspose2d (I, O, kh, kw) -> (kh, kw, I, O)

    def bn(prefix):
        return {"w": a(prefix + ".weight"), "b": a(prefix + ".bias"),
                "mean": a(prefix + ".running_mean"), "var": a(prefix + ".running_var")}

    def conv_mod(prefix):
        return {"conv": {"kernel": conv_k(prefix + ".conv.weight")}, "bn": bn(prefix + ".bn")}

    backbone_sd = {k[len("beit."):]: v for k, v in sd.items() if k.startswith("beit.")}
    return {
        "backbone": convert_vit_state_dict(backbone_sd, cfg.vit),
        "fpn1": {
            "deconv1": {"kernel": deconv_k("fpn1.0.weight"), "bias": a("fpn1.0.bias")},
            "bn": bn("fpn1.1"),
            "deconv2": {"kernel": deconv_k("fpn1.3.weight"), "bias": a("fpn1.3.bias")},
        },
        "fpn2": {"deconv1": {"kernel": deconv_k("fpn2.0.weight"), "bias": a("fpn2.0.bias")}},
        "psp": [conv_mod(f"decode_head.psp_modules.{i}.1") for i in range(len(cfg.pool_scales))],
        "bottleneck": conv_mod("decode_head.bottleneck"),
        "laterals": [conv_mod(f"decode_head.lateral_convs.{i}") for i in range(3)],
        "fpn_convs": [conv_mod(f"decode_head.fpn_convs.{i}") for i in range(3)],
        "fpn_bottleneck": conv_mod("decode_head.fpn_bottleneck"),
        "classifier": {"kernel": conv_k("decode_head.classifier.weight"), "bias": a("decode_head.classifier.bias")},
    }
