"""Crops resized on the device.

`resize_crops` takes page crops cut on the host (uint8 slices of the page
images) and gives them at one size on the device, with the antialiased
bilinear weights of the host resize (`ops/patches.py::_resize_bilinear`):
the separable triangle kernel, widened by the scale when downsampling, in
the K-tap form of `_resize_weight_sparse`, rows first, then columns, an
axis left as it is where its size does not change. The host only works out
the taps (`taps`, from each output's kernel support, so a size costs
O(out K) and not the dense (out, in) matrix: crop sizes vary, and the
dense form cost ~9 ms a new size) and packs the crops' bytes into one
pinned buffer and the taps into two arrays, so the upload is three copies a
call and the arithmetic runs on the card; a crop's two passes are a gather and a
weighted sum each.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=1024)
def taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_out, K) input indices and float32 weights of the antialiased
    bilinear resize from n_in to n_out: `_resize_weight_sparse`'s taps (the
    triangle 1 - |i - c| / k around each output's centre c, k the scale
    when downsampling, each row's weights over their float64 sum), with
    zero-weight taps where a row has fewer than K."""
    scale = n_out / n_in
    kscale = max(1.0, 1.0 / scale)
    centre = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    K = int(np.ceil(2 * kscale)) + 2  # every i with |i - c| < k, and a tap to spare at each end
    idx = np.floor(centre - kscale).astype(np.int64)[:, None] + np.arange(K)
    w = np.clip(1.0 - np.abs((idx - centre[:, None]) / kscale), 0.0, None)
    w[(idx < 0) | (idx >= n_in)] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    return np.clip(idx, 0, n_in - 1), w.astype(np.float32)


def resize_crops(crops: Sequence[np.ndarray], h: int, w: int, device) -> torch.Tensor:
    """(hi, wi, C) uint8 crops -> (N, h, w, C) float32 on `device`, each
    resized as `_resize_bilinear(crop, h, w)` resizes it (to f32 rounding:
    the sums run in another order)."""
    device = torch.device(device)
    if not crops:
        return torch.zeros((0, h, w, 3), dtype=torch.float32, device=device)
    C = crops[0].shape[2]
    sizes = [c.shape[0] * c.shape[1] * C for c in crops]
    starts = np.cumsum([0] + sizes)
    cuda = device.type == "cuda"
    packed = torch.empty(int(starts[-1]), dtype=torch.uint8, pin_memory=cuda)  # pinned: the copy leaves the host free
    flat = packed.numpy()
    plan: List[list] = []  # each crop's [rows, cols]: (offset into the packed taps, their shape), None to keep the axis
    idx_parts, wgt_parts, at = [], [], 0
    for c, lo, hi in zip(crops, starts[:-1], starts[1:]):
        flat[lo:hi].reshape(c.shape)[...] = c
        pair = []
        for n_in, n_out in ((c.shape[0], h), (c.shape[1], w)):
            if n_in == n_out:
                pair.append(None)
                continue
            idx, wgt = taps(n_in, n_out)
            idx_parts.append(idx.reshape(-1))
            wgt_parts.append(wgt.reshape(-1))
            pair.append((at, idx.shape))
            at += idx.size
        plan.append(pair)
    pixels = packed.to(device, non_blocking=cuda)
    if idx_parts:
        idx_all = torch.from_numpy(np.concatenate(idx_parts)).to(device)
        wgt_all = torch.from_numpy(np.concatenate(wgt_parts)).to(device)
    out = torch.empty((len(crops), h, w, C), dtype=torch.float32, device=device)
    for n, (c, lo, hi, (rows, cols)) in enumerate(zip(crops, starts[:-1], starts[1:], plan)):
        img = pixels[lo:hi].view(c.shape[0], c.shape[1], C).float()
        if rows is not None:
            o, shape = rows
            ri, rw = idx_all[o:o + shape[0] * shape[1]].view(shape), wgt_all[o:o + shape[0] * shape[1]].view(shape)
            img = torch.einsum("ok,okwc->owc", rw, img[ri])
        if cols is not None:
            o, shape = cols
            ci, cw = idx_all[o:o + shape[0] * shape[1]].view(shape), wgt_all[o:o + shape[0] * shape[1]].view(shape)
            img = torch.einsum("ok,hokc->hoc", cw, img[:, ci])
        out[n] = img
    return out
