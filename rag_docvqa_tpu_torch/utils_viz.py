"""Step-overlay visualization (reference demo.py:68-178).

The port's own copy of `rag_docvqa_tpu/utils_viz.py` (numpy only, but in the
JAX package); `tests/test_torch_copies.py` holds it against the original.
The reference's Gradio demo draws the pipeline's intermediate geometry onto
the page images: layout regions, text-chunk boxes and the retrieved top-k
regions. This module renders the same overlays headlessly (numpy rectangle
drawing onto the page pixels; PNG through Pillow, imported where it is used,
with a matplotlib fallback), so `demo --save-viz DIR` works without a
display. The batch it reads is the host (numpy) `ChunkedBatch` of the ingest.

Colors: layout regions green, all chunk boxes blue, retrieved top-k red
(thicker). Visual (Pix2Struct) runs overlay the image-patch grid instead of
text chunks.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

LAYOUT_COLOR = (40, 180, 60)
CHUNK_COLOR = (70, 110, 230)
RETRIEVED_COLOR = (230, 60, 50)


def draw_box(img: np.ndarray, box_px: Sequence[int], color, thickness: int = 2) -> None:
    """In-place rectangle outline; box clipped to the image."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in box_px)
    x0, x1 = max(0, min(x0, w - 1)), max(0, min(x1, w))
    y0, y1 = max(0, min(y0, h - 1)), max(0, min(y1, h))
    if x1 <= x0 or y1 <= y0:
        return
    t = max(1, thickness)
    img[y0:y1, x0:min(x0 + t, w)] = color
    img[y0:y1, max(x1 - t, 0):x1] = color
    img[y0:min(y0 + t, h), x0:x1] = color
    img[max(y1 - t, 0):y1, x0:x1] = color


def _norm_to_px(box, w: int, h: int) -> List[int]:
    return [box[0] * w, box[1] * h, box[2] * w, box[3] * h]


def save_png(img: np.ndarray, path: str) -> None:
    try:
        from PIL import Image

        Image.fromarray(img.astype(np.uint8)).save(path)
    except ImportError:  # headless fallback
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.image as mpimg

        mpimg.imsave(path, img.astype(np.uint8))


def render_page_overlay(
    image: Optional[np.ndarray],  # (H, W, 3) page pixels, or None -> canvas
    chunk_boxes: Sequence[Sequence[float]] = (),  # normalized, all chunks
    retrieved_boxes: Sequence[Sequence[float]] = (),  # normalized, top-k
    layout: Optional[Dict[str, Any]] = None,  # {boxes, labels} normalized
    canvas_size=(1000, 772),
) -> np.ndarray:
    """One page's overlay image (page pixels or a white canvas)."""
    if image is not None:
        img = np.ascontiguousarray(np.asarray(image)[..., :3].astype(np.uint8).copy())
    else:
        img = np.full((*canvas_size, 3), 255, np.uint8)
    h, w = img.shape[:2]
    if layout:
        for box in layout.get("boxes", []):
            draw_box(img, _norm_to_px(box, w, h), LAYOUT_COLOR, 2)
    for box in chunk_boxes:
        draw_box(img, _norm_to_px(box, w, h), CHUNK_COLOR, 1)
    for box in retrieved_boxes:
        draw_box(img, _norm_to_px(box, w, h), RETRIEVED_COLOR, 3)
    return img


def save_step_overlays(
    doc,  # RawDocument (words/boxes/images/layout)
    batch,  # ChunkedBatch for the single-doc batch
    result: Dict[str, Any],  # engine.inference output
    out_dir: str,
    prefix: str = "page",
) -> List[str]:
    """Write one PNG per page with layout / chunk / retrieved overlays
    (text-engine path). Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    n_pages = len(doc.words)
    chunk_box = np.asarray(batch.chunk_box[0])
    chunk_page = np.asarray(batch.chunk_page[0])
    chunk_mask = np.asarray(batch.chunk_mask[0])

    ret = result.get("retrieval", {}) or {}
    ret_boxes = ret.get("boxes")
    pages_list = result.get("pred_answer_pages", [[]])[0]
    if not isinstance(pages_list, list):
        pages_list = [pages_list]
    retrieved_by_page: Dict[int, List[Sequence[float]]] = {}
    if ret_boxes is not None:
        for r, page in enumerate(pages_list):
            if r < len(np.asarray(ret_boxes)[0]):
                retrieved_by_page.setdefault(int(page), []).append(np.asarray(ret_boxes)[0][r])

    paths = []
    for p in range(n_pages):
        img = None
        if doc.images is not None and p < len(doc.images) and doc.images[p] is not None:
            img = np.asarray(doc.images[p])
        overlay = render_page_overlay(
            img,
            chunk_boxes=[chunk_box[c] for c in range(len(chunk_box))
                         if chunk_mask[c] and chunk_page[c] == p],
            retrieved_boxes=retrieved_by_page.get(p, []),
            layout=doc.layout[p] if doc.layout and p < len(doc.layout) else None,
        )
        path = os.path.join(out_dir, f"{prefix}_{p}.png")
        save_png(overlay, path)
        paths.append(path)
    return paths


def save_patch_overlays(
    images: Sequence[np.ndarray],
    steps: Dict[str, Any],  # RAGPix2StructEngine.retrieve steps (coords/xyxy)
    out_dir: str,
    prefix: str = "page",
    retrieved: Sequence[int] = (),  # flat chunk indices highlighted
) -> List[str]:
    """Visual-engine overlay: the image-patch grid (pixel xyxy per chunk)
    drawn per page, retrieved chunks highlighted."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    coords = steps.get("coords", [])
    xyxy = steps.get("xyxy", [])
    for p, img in enumerate(images):
        overlay = np.ascontiguousarray(np.asarray(img)[..., :3].astype(np.uint8).copy())
        for i, coord in enumerate(coords):
            if coord[0] != p:
                continue
            color = RETRIEVED_COLOR if i in set(retrieved) else CHUNK_COLOR
            draw_box(overlay, xyxy[i], color, 3 if i in set(retrieved) else 1)
        path = os.path.join(out_dir, f"{prefix}_{p}.png")
        save_png(overlay, path)
        paths.append(path)
    return paths
