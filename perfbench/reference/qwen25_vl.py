"""The plain reference of Qwen2.5-VL RAG's device side: the page crops, the
vision tower, the M-RoPE index and the Qwen2 language model, in plain
PyTorch and numpy.

It follows Qwen2.5-VL's published architecture (Hugging Face's
`modeling_qwen2_5_vl.py` and the Qwen2-VL image processor):

* a crop is the chunk's box cut from its page (the box's corners times the
  page's width and height in float32, truncated, ordered, at least one
  pixel), resized to the tower's square with antialiased bilinear weights
  (a triangle kernel widened by the scale when shrinking, centred at (o +
  0.5) / scale - 0.5, each output's weights summing to one; worked out in
  float64), then scaled to [-1, 1];
* the tower: 14-px patches, each laid out (channel, frame, row, column) with
  the frame taken twice, in merge order (2 x 2 blocks row-major, their
  patches row-major); a linear patch embedding; 2-D rotary positions (the
  first half of each head's frequencies from the patch's row, the second
  from its column, theta 10^4); in each layer pre-norm RMSNorm (eps 1e-6),
  attention with biases over the patches of the same 112-px window, or over
  every patch at the full-attention layers, a SiLU-gated feed-forward with
  biases; then the merger: RMSNorm, each 2 x 2 block's four patches
  concatenated, a linear layer, exact GELU, a linear layer to the language
  model's width. The window is a mask here, so no permutation is needed;
* the M-RoPE index of a prompt (`get_rope_index` for one image a span): text
  tokens count on from the last index + 1 on all three axes, an image token
  of merged cell (row, column) takes (0, row, column) plus the index its
  place would have had as text, the text after a span goes on from the
  span's largest index + 1;
* Qwen2's decoder (pre-norm RMSNorm at eps 1e-6, q/k/v with biases,
  rotate-half rotary at theta 1e6 split into the (t, h, w) sections of
  `mrope_section`, grouped-query causal attention at hd^-1/2, a SwiGLU
  feed-forward, the final norm, an untied head), the crop tokens put in
  place of the image tokens' embeddings, one layer's weights at a time.

It imports nothing of the program. It computes in float32 with TF32 off,
or, as the control, with every linear layer's weights and inputs rounded to
float8 e4m3 (one scale a tensor; `model.fp8`), the step below the bfloat16
that the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.model import fp8


def antialias_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of the antialiased bilinear resize."""
    scale = n_out / n_in
    width = max(1.0, 1.0 / scale)
    centre = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(np.arange(n_in, dtype=np.float64)[None, :] - centre[:, None]) / width)
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def crop(image: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """The box's pixels of a page image (the box normalised to the page)."""
    h, w = image.shape[:2]
    b = np.asarray(box, np.float32)
    x0, x1 = sorted((int(b[0] * np.float32(w)), int(b[2] * np.float32(w))))
    y0, y1 = sorted((int(b[1] * np.float32(h)), int(b[3] * np.float32(h))))
    return image[max(y0, 0):max(y1, y0 + 1), max(x0, 0):max(x1, x0 + 1)]


def crop_pixels(crops: Sequence[np.ndarray], size: int, device) -> torch.Tensor:
    """(N, size, size, 3) float32 crops in [-1, 1] on `device`."""
    out = []
    for c in crops:
        img = torch.from_numpy(np.ascontiguousarray(c)).to(device, torch.float32)
        rows = torch.from_numpy(antialias_matrix(c.shape[0], size)).to(device)
        cols = torch.from_numpy(antialias_matrix(c.shape[1], size)).to(device)
        img = torch.einsum("oh,hwc->owc", rows, img)
        img = torch.einsum("pw,owc->opc", cols, img)
        out.append((img / 255.0 - 0.5) / 0.5)
    return torch.stack(out) if out else torch.zeros(0, size, size, 3, device=device)


def rope_index(length: int, spans: Sequence[Tuple[int, int]], grid: int) -> np.ndarray:
    """(3, length) M-RoPE positions of a prompt whose image spans are
    (start, tokens) (an image's tokens are merged cells of a grid x grid
    square, row-major; a span cut short keeps its first tokens)."""
    out = np.zeros((3, length), np.int64)
    at = nxt = 0
    for start, n in sorted(spans):
        out[:, at:start] = nxt + np.arange(start - at)
        nxt += start - at
        cells = np.arange(n)
        out[0, start:start + n] = nxt
        out[1, start:start + n] = nxt + cells // grid
        out[2, start:start + n] = nxt + cells % grid
        nxt = int(out[:, start:start + n].max()) + 1
        at = start + n
    out[:, at:] = nxt + np.arange(length - at)
    return out


class QwenVL:
    """`w` maps the program's parameter names (embed, layers.0.q.weight, ...,
    lm_head, vision.patch_w, vision.layers.0.qkv_w, ..., vision.fc2_b) to
    tensors; `c` is the configuration's engine dict (its `vision` dict the
    tower's widths)."""

    def __init__(self, w: Dict[str, torch.Tensor], c: Dict, device, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w, self.device, self.control = w, device, control
        self.L, self.H, self.Hkv = c["num_layers"], c["num_heads"], c["num_kv_heads"]
        self.hd = c["d_model"] // self.H
        self.theta = c.get("rope_theta", 1e6)
        self.section = list(c.get("mrope_section") or [])
        v = c["vision"]
        self.v = v
        self.vH = v["num_heads"]
        self.vhd = v["hidden_size"] // self.vH
        self.patch, self.size = v["patch_size"], v["image_size"]
        self.win = v["window_size"] // v["patch_size"]  # patches a window side
        self.full = set(v["fullatt_block_indexes"])

    def f(self, name: str) -> torch.Tensor:
        return self.w[name].to(self.device, torch.float32)

    def lin(self, x: torch.Tensor, name: str, bias: Optional[str] = None) -> torch.Tensor:
        w = self.f(name)
        if self.control:
            w, x = fp8(w), fp8(x)
        y = x @ w.t()
        return y if bias is None else y + self.f(bias)

    @staticmethod
    def rms(x, w, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w

    @staticmethod
    def rotate(x, cos, sin):
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

    # ------------------------------------------------------------- tower
    def _order(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Each patch's (row, column), in merge order."""
        s = 2
        br, bc, dr, dc = np.meshgrid(np.arange(g // s), np.arange(g // s), np.arange(s), np.arange(s), indexing="ij")
        return (br * s + dr).reshape(-1), (bc * s + dc).reshape(-1)

    def tower(self, pixels: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) pixels in [-1, 1] -> (N, (S / 28)^2, d_model) merged
        tokens, row-major merged cells."""
        N, S = pixels.shape[0], pixels.shape[1]
        p, g = self.patch, S // self.patch
        rows, cols = self._order(g)
        x = pixels.reshape(N, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)  # (N, g, g, C, p, p)
        x = x[:, torch.from_numpy(rows).to(x.device), torch.from_numpy(cols).to(x.device)]  # (N, seq, C, p, p)
        x = x[:, :, :, None].expand(-1, -1, -1, self.v["temporal_patch_size"], -1, -1).reshape(N, g * g, -1)
        x = self.lin(x, "vision.patch_w")
        dim = self.vhd // 2
        inv = 1.0 / self.v.get("rope_theta", 10000.0) ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
        ang = torch.cat([torch.from_numpy(rows)[:, None] * inv, torch.from_numpy(cols)[:, None] * inv], -1)
        ang = torch.cat([ang, ang], -1).float().to(self.device)[:, None]  # (seq, 1, hd)
        cos, sin = torch.cos(ang), torch.sin(ang)
        win = torch.from_numpy((rows // self.win) * g + cols // self.win).to(self.device)
        same = win[:, None] == win[None, :]
        seq, D = g * g, x.shape[-1]
        for i in range(self.v["depth"]):
            p_ = f"vision.layers.{i}."
            h = self.rms(x, self.f(p_ + "ln1"))
            q, k, v = self.lin(h, p_ + "qkv_w", p_ + "qkv_b").view(N, seq, 3, self.vH, self.vhd).unbind(2)
            q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
            s = torch.einsum("nqhd,nkhd->nhqk", q, k) * self.vhd ** -0.5
            if i not in self.full:
                s = s.masked_fill(~same, -math.inf)
            a = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, -1), v).reshape(N, seq, D)
            x = x + self.lin(a, p_ + "proj_w", p_ + "proj_b")
            h = self.rms(x, self.f(p_ + "ln2"))
            gate = torch.nn.functional.silu(self.lin(h, p_ + "gate_w", p_ + "gate_b"))
            x = x + self.lin(gate * self.lin(h, p_ + "up_w", p_ + "up_b"), p_ + "down_w", p_ + "down_b")
        x = self.rms(x, self.f("vision.ln_q")).reshape(N, seq // 4, 4 * D)
        x = torch.nn.functional.gelu(self.lin(x, "vision.fc1_w", "vision.fc1_b"))
        return self.lin(x, "vision.fc2_w", "vision.fc2_b")

    # ------------------------------------------------------ language model
    def logits(self, ids: Sequence[int], positions: np.ndarray, image: Optional[torch.Tensor],
               image_at: Sequence[int], at: Sequence[int]) -> torch.Tensor:
        """(len(at), V) logits at the places `at` of the sequence `ids`, its
        (3, T) positions, the rows of `image` (n, d) put at the places
        `image_at`."""
        T = len(ids)
        x = self.w["embed"][torch.tensor(list(ids), device=self.w["embed"].device)].to(self.device, torch.float32)
        if image is not None and len(image_at):
            x[torch.tensor(list(image_at), device=self.device)] = image.to(self.device, torch.float32)
        inv = 1.0 / self.theta ** (torch.arange(0, self.hd, 2, device=self.device).float() / self.hd)
        pos = torch.from_numpy(np.asarray(positions)).to(self.device).float()  # (3, T)
        ang = pos[..., None] * inv  # (3, T, hd/2)
        if self.section:
            bounds = np.cumsum([0] + self.section)
            ang = torch.cat([ang[i, :, bounds[i]:bounds[i + 1]] for i in range(3)], -1)
        else:
            ang = ang[0]
        ang = torch.cat([ang, ang], -1)[:, None]  # (T, 1, hd)
        cos, sin = torch.cos(ang), torch.sin(ang)
        causal = torch.ones(T, T, dtype=torch.bool, device=self.device).tril()
        for i in range(self.L):
            p = f"layers.{i}."
            h = self.rms(x, self.f(p + "ln0"))
            q = self.lin(h, p + "q.weight", p + "q.bias").view(T, self.H, self.hd)
            k = self.lin(h, p + "k.weight", p + "k.bias").view(T, self.Hkv, self.hd)
            v = self.lin(h, p + "v.weight", p + "v.bias").view(T, self.Hkv, self.hd)
            q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
            k, v = (t.repeat_interleave(self.H // self.Hkv, dim=1) for t in (k, v))
            s = torch.einsum("qhd,khd->hqk", q, k) * self.hd ** -0.5
            a = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
            x = x + self.lin(torch.einsum("hqk,khd->qhd", a, v).reshape(T, -1), p + "o.weight")
            h = self.rms(x, self.f(p + "ln1"))
            g = torch.nn.functional.silu(self.lin(h, p + "gate.weight")) * self.lin(h, p + "up.weight")
            x = x + self.lin(g, p + "down.weight")
        x = self.rms(x, self.f("final_ln"))[torch.tensor(list(at), device=self.device)]
        return self.lin(x, "lm_head")


def chunk_box(boxes: Sequence[np.ndarray], words: List[Tuple[int, int]]) -> np.ndarray:
    """The box around a chunk's words (each (page, word)): the least corner
    and the greatest."""
    b = np.stack([np.asarray(boxes[p][w], np.float32) for p, w in words])
    return np.concatenate([b[:, :2].min(0), b[:, 2:].max(0)])
