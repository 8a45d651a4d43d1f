"""Layout detection: post-processing, label maps and pluggable detectors.

The port's own copy of `rag_docvqa_tpu/models/layout.py` (numpy only, but in
the JAX package); `tests/test_torch_copies.py` holds it against the original.
The reference wraps two pretrained detectors (src/_modules.py):
  * LayoutModelDIT  -- BEiT semantic segmentation -> contour boxes ->
    12-class -> 4-class remap + weighted-area/containment filtering
    (:293-619); the network is `models/layout_seg.py`
  * LayoutModelYOLO -- DocLayout-YOLO boxes -> 10-class -> 4-class remap +
    NMS (:622-829); the network is `models/yolo.py`

Both emit {boxes (normalized), labels in the 4-label map} per page, the
contract the chunker consumes. A segmentation mask becomes boxes without cv2
(two-pass connected-component labelling), and detectors plug in as callables
through `LayoutProvider`: precomputed .npz layouts (`precompute layouts`), a
converted BEiT/YOLO, or any page -> mask/boxes function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rag_docvqa_tpu_torch.ops.chunking import LAYOUT_LABEL_MAP, containment_ratio

# raw -> 4-label remaps (None = drop)
DIT_LABEL_MAP: Dict[int, Optional[int]] = {
    0: None, 1: 1, 2: 1, 3: None, 4: 3, 5: 1, 6: 1, 7: 2, 8: 0, 9: 3, 10: 1, 11: 0,
}  # src/_modules.py:379-392
YOLO_LABEL_MAP: Dict[int, Optional[int]] = {
    0: 0, 1: 1, 2: 1, 3: 2, 4: 2, 5: 3, 6: 3, 7: 3, 8: None, 9: None,
}  # src/_modules.py:671-699


def get_layout_model_map(_config: Optional[dict] = None) -> Dict[int, str]:
    """Both reference detectors share the same 4-label output map."""
    return dict(LAYOUT_LABEL_MAP)


# --------------------------------------------------------------------------- #
# geometry (src/utils.py:283-326)
# --------------------------------------------------------------------------- #
def compute_iou(box: Sequence[float], boxes: np.ndarray) -> np.ndarray:
    xx1 = np.maximum(box[0], boxes[:, 0])
    yy1 = np.maximum(box[1], boxes[:, 1])
    xx2 = np.minimum(box[2], boxes[:, 2])
    yy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (area + areas - inter + 1e-8)


def non_maximum_suppression(boxes: Sequence[Sequence[float]], iou_threshold: float = 0.7) -> List[int]:
    """Area-ordered NMS returning kept indices (src/utils.py:300-326)."""
    if not len(boxes):
        return []
    arr = np.asarray(boxes, np.float64)
    areas = (arr[:, 2] - arr[:, 0]) * (arr[:, 3] - arr[:, 1])
    order = areas.argsort()[::-1]
    keep: List[int] = []
    while order.size > 0:
        idx = order[0]
        keep.append(int(idx))
        if order.size == 1:
            break
        ious = compute_iou(arr[idx], arr[order[1:]])
        order = order[1:][ious <= iou_threshold]
    return keep


# --------------------------------------------------------------------------- #
# segmentation mask -> boxes (cv2.findContours replacement)
# --------------------------------------------------------------------------- #
def mask_to_boxes(mask: np.ndarray) -> List[List[int]]:
    """Bounding boxes of connected components in a binary mask (the reference
    uses cv2 contours, src/_modules.py:449-465; component bboxes are
    equivalent for box extraction). Two-pass row-run union-find."""
    mask = np.ascontiguousarray(mask.astype(bool))
    if not mask.any():
        return []
    h, w = mask.shape
    parent: List[int] = []

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    # row runs
    runs: List[Tuple[int, int, int, int]] = []  # (row, start, end, label)
    prev_row_runs: List[Tuple[int, int, int]] = []  # (start, end, label)
    for y in range(h):
        row = mask[y]
        xs = np.flatnonzero(np.diff(np.concatenate([[0], row.view(np.int8), [0]])))
        row_runs: List[Tuple[int, int, int]] = []
        for i in range(0, len(xs), 2):
            s, e = int(xs[i]), int(xs[i + 1])  # [s, e)
            lab = len(parent)
            parent.append(lab)
            # union with overlapping runs in previous row (8-connectivity)
            for ps, pe, pl in prev_row_runs:
                if ps < e + 1 and pe > s - 1:
                    union(pl, lab)
            row_runs.append((s, e, lab))
            runs.append((y, s, e, lab))
        prev_row_runs = row_runs

    boxes: Dict[int, List[int]] = {}
    for y, s, e, lab in runs:
        root = find(lab)
        b = boxes.get(root)
        if b is None:
            boxes[root] = [s, y, e, y + 1]
        else:
            b[0] = min(b[0], s)
            b[1] = min(b[1], y)
            b[2] = max(b[2], e)
            b[3] = max(b[3], y + 1)
    return list(boxes.values())


def segmentation_to_layout(
    seg: np.ndarray,  # (H, W) int class map in DIT's 12-class space
    min_component: int = 4,
) -> Tuple[List[List[int]], List[int]]:
    """Per-class component boxes + raw labels (LayoutModelDIT.forward's
    mask->bbox step, src/_modules.py:449-511)."""
    boxes: List[List[int]] = []
    labels: List[int] = []
    for cls in np.unique(seg):
        if cls == 0:  # background
            continue
        for box in mask_to_boxes(seg == cls):
            if (box[2] - box[0]) * (box[3] - box[1]) >= min_component:
                boxes.append(box)
                labels.append(int(cls))
    return boxes, labels


# --------------------------------------------------------------------------- #
# detection filtering
# --------------------------------------------------------------------------- #
def filter_detections_dit(
    boxes: Sequence[Sequence[float]],  # pixel coords
    labels: Sequence[int],  # raw 12-class labels
    image_size: Tuple[int, int],  # (h, w)
    min_area: float = 0.001,
    containment_threshold: float = 0.5,
    condition: str = "or",
    aspect_power: float = 1.0,
) -> Tuple[List[List[float]], List[int]]:
    """12->4 remap + weighted-area/containment filter; returns NORMALIZED
    boxes + labels (src/_modules.py:349-446; the reference denormalizes at the
    end but downstream consumers re-normalize — we stay normalized)."""
    assert condition in ("or", "and", "small", "overlap")
    h, w = image_size
    rel_boxes, rel_labels = [], []
    for box, label in zip(boxes, labels):
        mapped = DIT_LABEL_MAP.get(int(label))
        if mapped is not None:
            rel_boxes.append([box[0] / w, box[1] / h, box[2] / w, box[3] / h])
            rel_labels.append(mapped)

    def weighted_area(nb):
        width, height = nb[2] - nb[0], nb[3] - nb[1]
        return 0 if height == 0 else (width * height) * ((width / height) ** aspect_power)

    areas = [weighted_area(nb) for nb in rel_boxes]
    out_boxes, out_labels = [], []
    for i, box_a in enumerate(rel_boxes):
        is_small = areas[i] < min_area
        is_overlapping = False
        for j, box_b in enumerate(rel_boxes):
            if i != j and areas[j] > areas[i] and containment_ratio(box_a, box_b) >= containment_threshold:
                is_overlapping = True
                break
        drop = {
            "or": is_small or is_overlapping,
            "and": is_small and is_overlapping,
            "small": is_small,
            "overlap": is_overlapping,
        }[condition]
        if not drop:
            out_boxes.append(box_a)
            out_labels.append(rel_labels[i])
    return out_boxes, out_labels


def filter_detections_yolo(
    boxes: Sequence[Sequence[float]],  # normalized xyxy
    labels: Sequence[int],  # raw 10-class labels
    iou_threshold: float = 0.7,
) -> Tuple[List[List[float]], List[int]]:
    """10->4 remap + biggest-box NMS (src/_modules.py:671-711)."""
    rel_boxes, rel_labels = [], []
    for box, label in zip(boxes, labels):
        mapped = YOLO_LABEL_MAP.get(int(label))
        if mapped is not None:
            rel_boxes.append(list(map(float, box)))
            rel_labels.append(mapped)
    keep = non_maximum_suppression(rel_boxes, iou_threshold)
    return [rel_boxes[i] for i in keep], [rel_labels[i] for i in keep]


# --------------------------------------------------------------------------- #
# providers
# --------------------------------------------------------------------------- #
@dataclass
class LayoutProvider:
    """Per-page layout info provider with the reference's batch_forward shape:
    pages in, {boxes, labels} dicts out (src/_modules.py:538-619)."""

    detector: Optional[Callable[[np.ndarray], Tuple[List[List[float]], List[int]]]] = None
    precomputed: Optional[Dict[str, dict]] = None

    def page_layout(self, image: Optional[np.ndarray] = None, key: Optional[str] = None) -> dict:
        if self.precomputed is not None and key is not None:
            info = self.precomputed.get(key)
            if info is not None:
                return {"boxes": info["boxes"], "labels": info["labels"], "clusters": info.get("clusters")}
            return {"boxes": [], "labels": []}
        if self.detector is not None and image is not None:
            boxes, labels = self.detector(image)
            return {"boxes": boxes, "labels": labels}
        return {"boxes": [], "labels": []}

    def batch_forward(self, images: Sequence[Sequence[np.ndarray]], keys=None) -> List[List[dict]]:
        out = []
        for b, pages in enumerate(images):
            page_keys = keys[b] if keys is not None else [None] * len(pages)
            out.append([self.page_layout(img, k) for img, k in zip(pages, page_keys)])
        return out


def load_precomputed_layouts(path: str) -> Dict[str, dict]:
    """Load a `precompute layouts` .npz (keyed by image name) into {key: {boxes, labels, ...}}."""
    data = np.load(path, allow_pickle=True)
    return {k: data[k].item() for k in data.files}
