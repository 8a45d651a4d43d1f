"""Image patch math for the visual paths (the DiT branch of RAG-VT5 and
RAG-Pix2Struct).

A copy of `rag_docvqa_tpu/ops/patches.py`, which imports numpy only but lives
in the JAX package; tests/test_torch_copies.py holds the two together. Host
code, pure numpy, no device work:
  * divide_image_into_patches — ImageChunker patch grids
    (src/_modules.py:1146-1244: square / horizontal / page modes with
    half-patch overlap and edge re-alignment)
  * extract_flattened_patches — Pix2Struct patch extraction with row/col ids
    and cross-image row offsets
    (src/custom_pix2struct_processor.py:33-132)
  * adaptive_normalize — per-image mean/std with the 1/sqrt(numel) floor
    (custom_pix2struct_processor.py:176-198)
  * render_text / render_header — question rendering
    (HF pix2struct render_text; header used for VQA, :223-229)
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# chunking (ImageChunker)
# --------------------------------------------------------------------------- #
def divide_image_into_patches(
    image: np.ndarray,  # (H, W, 3)
    patch_size: int = 256,
    overlap: bool = False,
    mode: str = "horizontal",
) -> Tuple[List[np.ndarray], Tuple[int, int], List[List[int]]]:
    """Returns (patches, matrix shape (rows, cols), xyxy coords)."""
    assert mode in ("square", "horizontal", "page")
    height, width = image.shape[:2]
    ov = patch_size // 2 if overlap else 0
    step = patch_size - ov
    patches: List[np.ndarray] = []
    xyxy: List[List[int]] = []

    if mode == "page":
        return [image], (1, 1), [[0, 0, width, height]]

    if mode == "square":
        n_w = math.ceil((width - ov) / step)
        n_h = math.ceil((height - ov) / step)
        for i in range(n_h):
            for j in range(n_w):
                left, top = j * step, i * step
                right, bottom = min(left + patch_size, width), min(top + patch_size, height)
                if right - left < patch_size:
                    left = max(right - patch_size, 0)
                if bottom - top < patch_size:
                    top = max(bottom - patch_size, 0)
                patches.append(image[top:bottom, left:right])
                xyxy.append([left, top, right, bottom])
        return patches, (n_h, n_w), xyxy

    # horizontal: full-width strips; a short tail strip merges into the last
    # full strip (src/_modules.py:1203-1244)
    n_h = math.ceil((height - ov) / step)
    last_h = height - (n_h - 1) * step
    n_actual = n_h - 1 if (0 < last_h < patch_size and n_h > 1) else n_h
    for i in range(n_actual):
        top = i * step
        if i == n_actual - 1 and n_actual < n_h:
            bottom = height
        else:
            bottom = min(top + patch_size, height)
            if bottom - top < patch_size:
                top = max(bottom - patch_size, 0)
        patches.append(image[top:bottom, 0:width])
        xyxy.append([0, top, width, bottom])
    return patches, (n_actual, 1), xyxy


def layout_region_crops(
    image: np.ndarray,  # (H, W, 3)
    boxes: Sequence[Sequence[float]],  # normalized xyxy layout boxes
    labels: Sequence[int],
    clusters: Optional[Sequence[int]] = None,
) -> Tuple[List[np.ndarray], List[int], List[List[int]]]:
    """Layout regions -> pixel crops (ImageChunker.crop_boxes,
    src/_modules.py:1246-1305): regions sorted left-right/top-bottom by
    (x0, y0); with clusters, same-cluster boxes union into one bbox whose
    label is the area-majority label (cluster -1 = unclustered singleton).
    Returns (crops, labels, region pixel boxes)."""
    H, W = image.shape[:2]
    entries = list(zip(boxes, labels, clusters if clusters is not None else [-1] * len(boxes)))
    entries.sort(key=lambda e: (e[0][0], e[0][1]))

    merged: List[Tuple[List[float], int]] = []
    groups: Dict[int, List[Tuple[Sequence[float], int]]] = {}
    for box, label, cl in entries:
        if clusters is None or cl == -1:
            merged.append((list(box), int(label)))
        else:
            groups.setdefault(int(cl), []).append((box, int(label)))
    for cl in groups:
        bs = [b for b, _ in groups[cl]]
        union = [min(b[0] for b in bs), min(b[1] for b in bs),
                 max(b[2] for b in bs), max(b[3] for b in bs)]
        areas: Dict[int, float] = {}
        for b, lab in groups[cl]:
            areas[lab] = areas.get(lab, 0.0) + (b[2] - b[0]) * (b[3] - b[1])
        merged.append((union, max(areas.items(), key=lambda kv: kv[1])[0]))

    crops, out_labels, out_boxes = [], [], []
    for box, label in merged:
        px = [int(box[0] * W), int(box[1] * H), int(box[2] * W), int(box[3] * H)]
        crop = image[px[1]: px[3], px[0]: px[2]]
        crops.append(crop)
        out_labels.append(label)
        out_boxes.append(px)
    return crops, out_labels, out_boxes


def divide_image_into_layout_patches(
    image: np.ndarray,  # (H, W, 3) page pixels
    boxes: Sequence[Sequence[float]],  # normalized layout boxes
    labels: Sequence[int],
    clusters: Optional[Sequence[int]] = None,
    patch_size: int = 256,
    overlap: bool = False,
    mode: str = "horizontal",
) -> List[Tuple[List[np.ndarray], Tuple[int, int], List[List[int]]]]:
    """Layout-guided ImageChunker (src/_modules.py:1379-1394): crop layout
    regions first; TEXT regions (label 1, ops/chunking.LAYOUT_LABEL_MAP)
    subdivide at patch_size, title/figure/table regions stay whole. Returns
    one (patches, (rows, cols), xyxy) group per region — xyxy in PAGE pixel
    coordinates (the reference reports region-local coords because it crops
    first; page-frame coords are equivalent content and what the retrieval
    crop-merge consumes)."""
    crops, c_labels, c_boxes = layout_region_crops(image, boxes, labels, clusters)
    groups = []
    for crop, label, region in zip(crops, c_labels, c_boxes):
        if crop.size == 0:
            continue
        if label == 1:  # text: subdivide
            patches, shape, xyxy = divide_image_into_patches(crop, patch_size, overlap, mode)
            if not patches:
                continue
            xyxy = [[x0 + region[0], y0 + region[1], x1 + region[0], y1 + region[1]]
                    for x0, y0, x1, y1 in xyxy]
        else:  # title / figure / table: keep whole
            patches = [crop]
            shape = (1, 1)
            xyxy = [list(region)]
        groups.append((patches, shape, xyxy))
    return groups


# --------------------------------------------------------------------------- #
# Pix2Struct patch extraction
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=256)
def _resize_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) antialiased-bilinear resample weights: the separable
    triangle kernel, widened by the scale when downsampling, rows summing to
    one."""
    scale = out_size / in_size
    kscale = max(1.0, 1.0 / scale)  # widen the kernel when downsampling
    out_coords = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = (np.arange(in_size, dtype=np.float64)[None, :] - out_coords[:, None]) / kscale
    w = np.clip(1.0 - np.abs(x), 0.0, None)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_weight_sparse(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(out, K) tap indices + weights of _resize_weight_mat's rows — the
    triangle kernel touches only ~ceil(2·kscale)+1 inputs per output pixel,
    so the dense (out, in) matmul wastes ~in/K of its FLOPs."""
    dense = _resize_weight_mat(in_size, out_size)
    counts = (dense > 0).sum(axis=1)
    K = max(int(counts.max()), 1)
    idx = np.zeros((out_size, K), np.int64)
    wgt = np.zeros((out_size, K), np.float32)
    for o in range(out_size):
        nz = np.nonzero(dense[o])[0]
        idx[o, : nz.size] = nz
        wgt[o, : nz.size] = dense[o, nz]
    return idx, wgt


def _resize_axis0_sparse(img: np.ndarray, out: int) -> np.ndarray:
    """Resample axis 0 of (h, ...) via the K-tap sparse kernel."""
    idx, wgt = _resize_weight_sparse(img.shape[0], out)
    gathered = img[idx]  # (out, K, ...)
    w = wgt.reshape(wgt.shape + (1,) * (img.ndim - 1))
    return np.einsum("ok...,ok...->o...", w, gathered)


def _resize_bilinear(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host resize, pure numpy, antialiased-bilinear, through the K-tap
    sparse form of the weights (see _resize_weight_sparse). It runs in every
    engine's host preprocessing loop, once per page crop."""
    img = image.astype(np.float32)
    ih, iw = img.shape[:2]
    if ih != h:
        img = _resize_axis0_sparse(img, h)
    if iw != w:
        img = np.moveaxis(_resize_axis0_sparse(np.moveaxis(img, 1, 0), w), 0, 1)
    return img


def adaptive_normalize(image: np.ndarray) -> np.ndarray:
    """Per-image standardization with std floored at 1/sqrt(numel)."""
    image = image.astype(np.float32)
    mean = image.mean()
    std = max(image.std(), 1.0 / math.sqrt(image.size))
    return (image - mean) / std


def _adaptive_moments(image: np.ndarray) -> Tuple[float, float]:
    """(mean, std-with-floor) of adaptive_normalize, without materializing
    the normalized image. uint8 inputs use exact histogram moments (one
    cheap pass over 1-byte pixels instead of three over the f32 copy)."""
    n = image.size
    if image.dtype == np.uint8:
        hist = np.bincount(image.reshape(-1), minlength=256).astype(np.float64)
        vals = np.arange(256, dtype=np.float64)
        mean = float(hist @ vals) / n
        var = float(hist @ (vals - mean) ** 2) / n
        std = math.sqrt(var)
    else:
        x = image.astype(np.float32)
        mean = float(x.mean())
        std = float(x.std())
    return mean, max(std, 1.0 / math.sqrt(n))


def patch_grid_shape(
    h: int, w: int, max_patches: int, patch_size: int = 16
) -> Tuple[int, int]:
    """(rows, cols) of the Pix2Struct patch grid an (h, w) image resizes
    into at a given patch budget — rows*cols <= max_patches by construction
    (floor on both axes of the area-preserving scale). Pure function of the
    shape, so packers can chain row offsets without extracting."""
    if h < 1 or w < 1:
        raise ValueError(f"patch_grid_shape needs a non-empty image, got h={h} w={w}")
    scale = math.sqrt(max_patches * (patch_size / h) * (patch_size / w))
    rows = max(min(math.floor(scale * h / patch_size), max_patches), 1)
    cols = max(min(math.floor(scale * w / patch_size), max_patches), 1)
    return rows, cols


def extract_flattened_patches(
    image: np.ndarray,  # (H, W, 3) float (normalized), or raw with normalize=True
    max_patches: int,
    patch_size: int = 16,
    row_offset: int = 0,
    pad: bool = True,
    normalize: bool = False,
) -> Tuple[np.ndarray, int]:
    """Resize so ~max_patches fit, cut non-overlapping patch_size grid, prepend
    (row, col) ids (1-based + row_offset). Returns ((N, 2 + 3*p*p), max_row).

    normalize=True applies adaptive_normalize FOLDED THROUGH the resize:
    the kernel rows sum to 1, so resize((x-m)/s) == (resize(x)-m)/s — the
    affine runs on the ~2x-smaller resized image, the full-size normalized
    f32 copy is never written, and uint8 inputs take an exact histogram
    moment pass instead of three f32 passes (equal to the unfolded path to
    1e-6)."""
    h, w = image.shape[:2]
    rows, cols = patch_grid_shape(h, w, max_patches, patch_size)
    rh, rw = max(rows * patch_size, 1), max(cols * patch_size, 1)
    if normalize:
        mean, std = _adaptive_moments(image)
        image = _resize_bilinear(image, rh, rw)
        image -= mean
        image /= std
    else:
        image = _resize_bilinear(image, rh, rw)

    x = image.reshape(rows, patch_size, cols, patch_size, 3)
    x = x.transpose(0, 2, 1, 3, 4).reshape(rows * cols, patch_size * patch_size * 3)

    row_ids = (np.repeat(np.arange(rows), cols) + 1 + row_offset).astype(np.float32)
    col_ids = (np.tile(np.arange(cols), rows) + 1).astype(np.float32)
    result = np.concatenate([row_ids[:, None], col_ids[:, None], x], axis=1)

    if pad and result.shape[0] < max_patches:
        result = np.concatenate(
            [result, np.zeros((max_patches - result.shape[0], result.shape[1]), result.dtype)]
        )
    else:
        result = result[:max_patches]
    return result, int(row_ids.max())


def pack_multi_image_patches(
    images: Sequence[np.ndarray],
    max_total_patches: int,
    patch_size: int = 16,
    normalize: bool = True,
    header: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Equal patch budget per image, continued row offsets across images
    (custom_pix2struct_processor.py:97-132). Optional header image rendered
    above the first image. Returns (patches (max_total, 2+D), mask)."""
    images = list(images)
    if header is not None and images:
        images[0] = stack_header(header, images[0])
    elif header is not None:
        images = [header]
    assert images, "no images provided"
    per_image = max_total_patches // len(images)
    out = []
    row_offset = 0
    for img in images:
        patches, row_offset = extract_flattened_patches(
            img, per_image, patch_size=patch_size, row_offset=row_offset,
            pad=False, normalize=normalize,
        )
        out.append(patches)
    cat = np.concatenate(out, axis=0)
    if cat.shape[0] < max_total_patches:
        cat = np.concatenate(
            [cat, np.zeros((max_total_patches - cat.shape[0], cat.shape[1]), cat.dtype)]
        )
    else:
        cat = cat[:max_total_patches]
    mask = (np.abs(cat).sum(axis=-1) != 0).astype(np.float32)
    return cat, mask

# --------------------------------------------------------------------------- #
# text rendering (question header / question-as-image)
# --------------------------------------------------------------------------- #
def render_text(text: str, width: int = 448, font_size: int = 20) -> np.ndarray:
    """Render text on a white canvas (HF pix2struct render_text equivalent;
    used both for the VQA header and for embedding the question as an image,
    src/RAGPix2Struct.py:147)."""
    try:
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.load_default()
        probe = Image.new("RGB", (width, 10))
        draw = ImageDraw.Draw(probe)
        lines: List[str] = []
        line = ""
        for word in text.split():
            cand = (line + " " + word).strip()
            if draw.textlength(cand, font=font) > width - 10 and line:
                lines.append(line)
                line = word
            else:
                line = cand
        lines.append(line)
        height = 10 + 12 * len(lines)
        img = Image.new("RGB", (width, height), (255, 255, 255))
        draw = ImageDraw.Draw(img)
        for i, ln in enumerate(lines):
            draw.text((5, 5 + 12 * i), ln, fill=(0, 0, 0), font=font)
        return np.asarray(img)
    except ImportError:
        # deterministic fallback: encode text bytes into a pixel strip
        data = np.frombuffer(text.encode("utf-8"), np.uint8)
        img = np.full((16, max(len(data), 16), 3), 255, np.uint8)
        img[4:12, : len(data), 0] = data
        return img


def concatenate_patches_grid(
    patches: Sequence[np.ndarray],
    mode: str = "grid",
) -> np.ndarray:
    """Pack image patches into one canvas (src/utils.py:180-231).

    grid = strip packing: sort by height desc, estimate canvas from total
    area, place left-to-right wrapping into rows. horizontal/vertical modes
    concatenate directly. Empty input -> 5x5 blank (reference behavior)."""
    patches = [np.asarray(p) for p in patches if p is not None and p.size]
    if not patches:
        return np.zeros((5, 5, 3), np.uint8)
    if mode == "horizontal":
        h = max(p.shape[0] for p in patches)
        cols = [np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0))) for p in patches]
        return np.concatenate(cols, axis=1)
    if mode == "vertical":
        w = max(p.shape[1] for p in patches)
        rows = [np.pad(p, ((0, 0), (0, w - p.shape[1]), (0, 0))) for p in patches]
        return np.concatenate(rows, axis=0)

    patches = sorted(patches, key=lambda p: p.shape[0], reverse=True)
    total_area = sum(p.shape[0] * p.shape[1] for p in patches)
    grid_w = max(p.shape[1] for p in patches)
    grid_h = max(int(total_area / grid_w), max(p.shape[0] for p in patches))
    canvas = np.zeros((grid_h, grid_w, 3), patches[0].dtype)
    x = y = row_h = 0
    for p in patches:
        ph, pw = p.shape[:2]
        if x + pw > grid_w:
            x, y, row_h = 0, y + row_h, 0
        y_end, x_end = min(y + ph, grid_h), min(x + pw, grid_w)
        if y_end > y and x_end > x:
            canvas[y:y_end, x:x_end] = p[: y_end - y, : x_end - x]
        x += pw
        row_h = max(row_h, ph)
    return canvas


def crop_box(image: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """Crop a normalized box from a page image with the reference's coordinate
    ordering safeguard (src/_modules.py:2108-2119)."""
    h, w = image.shape[:2]
    coords = [box[0] * w, box[1] * h, box[2] * w, box[3] * h]
    xmin, xmax = sorted((int(coords[0]), int(coords[2])))
    ymin, ymax = sorted((int(coords[1]), int(coords[3])))
    return image[max(ymin, 0) : max(ymax, ymin + 1), max(xmin, 0) : max(xmax, xmin + 1)]


def resize_image(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize to (h, w) for the visual encoder input."""
    return _resize_bilinear(image.astype(np.float32), h, w)


def stack_header(header: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Place a header image above a body image (render_header semantics)."""
    w = max(header.shape[1], image.shape[1])

    def pad_w(x):
        if x.shape[1] == w:
            return x
        pad = np.full((x.shape[0], w - x.shape[1], 3), 255, x.dtype)
        return np.concatenate([x, pad], axis=1)

    return np.concatenate([pad_w(header.astype(image.dtype)), pad_w(image)], axis=0)
