"""The Qwen2.5-VL vision tower (HF weight compatible).

Counterpart of `rag_docvqa_tpu/models/qwen25_vision.py`:
`Qwen25VisionConfig` (the same fields), `init_qwen25_vision_params`, the
grid geometry in numpy (`_merge_order_indices`, `_pos_ids`,
`_window_index`, `_rotary_tables`), `extract_qwen_patches`,
`encode_features`, `encode_image` and `convert_qwen25_vision_state_dict`
(numpy; the JAX-layout tree, which `params.qwen25_vision_from_jax` carries
over).

The architecture: the Conv3d patch embedding as one projection (temporal 2
x 14 x 14 patches, the frame duplicated), the 2-D rotary embedding over the
(h, w) patch indices, window attention with full attention at
`fullatt_block_indexes`, RMSNorm blocks, the gated-SiLU MLP with biases,
then the merger: RMSNorm, groups of merge^2 cells, a two-layer MLP with
exact GELU, and the window permutation undone. The crops are fixed-size,
so the permutation, the rotary tables and the window layout are fixed per
grid; they are made once a grid and device and kept there.

The tower computes in its weights' dtype (bfloat16 when served; the pixels
are cast to it), the rotary in f32 then cast back. Attention is PyTorch's
fused `scaled_dot_product_attention`, which never forms the (seq, seq)
scores: a windowed layer attends with one batch row per window where the
grid's windows are all of one size (at 448 px, 16 windows of 64 patches a
crop), and under the block-diagonal window mask where they are not (a grid
that a window does not divide); a full layer attends over the whole crop.
JAX computes the same in f32 with the window mask at -1e9 (einsum,
softmax); a masked key gets no weight in either.

The feed-forward's intermediate width I (3420 in the published tower) is
no multiple of 8, so a bf16 row of it is not 16-byte aligned and cuBLAS
falls back to slow unaligned GEMM kernels. Where I % 8 != 0 and no autograd
graph is recorded through it, the layer loop runs gate, up and down on a
copy padded to the next multiple of 8 (`_ffn_weights`): zero rows of
`gate_w` and `up_w`, zero entries of their biases, zero columns of
`down_w`. The padded columns are silu(0) * 0 = 0 and add nothing through
`down`, so the result is the same sums. The copy is kept beside the layer,
never as a parameter, and made again when the layer's tensors are replaced.

With the tracer on (`profiling.py`), `encode_features` opens
`vision.tower`, and in it one `vision.window_layer` or `vision.full_layer`
a layer; each layer counts `vision.mlp_padded` or `vision.mlp_plain` (host)
by which weights its feed-forward read.
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.models.layers import dense, frozen, normal_init, rms_norm


@dataclass(frozen=True)
class Qwen25VisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    depth: int = 32
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112  # pixels; merger window = ws / merge / patch cells
    out_hidden_size: int = 2048
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    in_channels: int = 3
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    image_size: int = 112  # crop size the engine feeds (a patch multiple)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def tokens_per_image(self) -> int:
        g = self.image_size // self.patch_size
        return (g // self.spatial_merge_size) ** 2


LAYER_FIELDS = ("ln1", "ln2", "qkv_w", "qkv_b", "proj_w", "proj_b", "gate_w", "gate_b", "up_w", "up_b",
                "down_w", "down_b")
FFN_FIELDS = ("gate_w", "gate_b", "up_w", "up_b", "down_w")  # the tensors that hold the intermediate width
FFN_ALIGN = 8  # intermediate widths padded to a multiple of this: a bf16 row then fills whole 16-byte words


class Qwen25VisionLayer(nn.Module):
    """ln1, ln2 (D,), qkv (3D, D), proj (D, D), gate and up (I, D), down
    (D, I), each with its bias."""

    def __init__(self, **tensors):
        super().__init__()
        for name in LAYER_FIELDS:
            setattr(self, name, frozen(tensors[name]))


class Qwen25VisionParams(nn.Module):
    """patch_w (D, patch_dim), the layers, the merger (ln_q (D,), fc1
    (merged, merged), fc2 (out_hidden, merged), with biases)."""

    def __init__(self, patch_w, layers, ln_q, fc1_w, fc1_b, fc2_w, fc2_b):
        super().__init__()
        self.patch_w = frozen(patch_w)
        self.layers = nn.ModuleList(layers)
        self.ln_q, self.fc1_w, self.fc1_b = frozen(ln_q), frozen(fc1_w), frozen(fc1_b)
        self.fc2_w, self.fc2_b = frozen(fc2_w), frozen(fc2_b)


def init_qwen25_vision_params(generator: torch.Generator, cfg: Qwen25VisionConfig) -> Qwen25VisionParams:
    """Random f32 weights on the generator's device, the JAX distributions:
    N(0, 1/din) projections, zero biases, unit norms."""
    g, D, I, dev = generator, cfg.hidden_size, cfg.intermediate_size, generator.device
    zeros = lambda n: torch.zeros(n, device=dev)
    lin = lambda din, dout: (normal_init(g, (dout, din), din**-0.5), zeros(dout))
    merged = D * cfg.spatial_merge_size**2
    patch_w = normal_init(g, (D, cfg.patch_dim), cfg.patch_dim**-0.5)
    layers = []
    for _ in range(cfg.depth):
        t = {"ln1": torch.ones(D, device=dev), "ln2": torch.ones(D, device=dev)}
        for name, din, dout in (("qkv", D, 3 * D), ("proj", D, D), ("gate", D, I), ("up", D, I), ("down", I, D)):
            t[f"{name}_w"], t[f"{name}_b"] = lin(din, dout)
        layers.append(Qwen25VisionLayer(**t))
    fc1_w, fc1_b = lin(merged, merged)
    fc2_w, fc2_b = lin(merged, cfg.out_hidden_size)
    return Qwen25VisionParams(patch_w, layers, torch.ones(D, device=dev), fc1_w, fc1_b, fc2_w, fc2_b)


# --------------------------------------------------------------------------- #
# the grid geometry (numpy)
# --------------------------------------------------------------------------- #
def _merge_order_indices(h: int, w: int, s: int) -> np.ndarray:
    """The patch sequence order: merge blocks row-major, the s*s patches of
    a block row-major inside it."""
    idx = np.arange(h * w).reshape(h // s, s, w // s, s)
    return np.transpose(idx, (0, 2, 1, 3)).reshape(-1)


def _pos_ids(h: int, w: int, s: int) -> np.ndarray:
    """(seq, 2): each patch's (h, w) index, in merge order."""
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
    order = _merge_order_indices(h, w, s)
    return np.stack([hpos.reshape(-1)[order], wpos.reshape(-1)[order]], axis=-1)


def _window_index(h: int, w: int, cfg: Qwen25VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(the merged-cell permutation, each cell's window id): HF's
    get_window_index with the padding cells dropped."""
    s = cfg.spatial_merge_size
    mw = cfg.window_size // s // cfg.patch_size
    lh, lw = h // s, w // s
    pad_h, pad_w = (-lh) % mw, (-lw) % mw
    index = np.full((lh + pad_h, lw + pad_w), -100, np.int64)
    index[:lh, :lw] = np.arange(lh * lw).reshape(lh, lw)
    nwh, nww = (lh + pad_h) // mw, (lw + pad_w) // mw
    index = index.reshape(nwh, mw, nww, mw).transpose(0, 2, 1, 3).reshape(nwh * nww, mw * mw)
    win_id = np.broadcast_to(np.arange(nwh * nww)[:, None], index.shape)
    keep = index.reshape(-1) != -100
    return index.reshape(-1)[keep], win_id.reshape(-1)[keep]


def _rotary_tables(h: int, w: int, cfg: Qwen25VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(seq, head_dim) cos/sin in merge order: the 2-D rotary, h then w halves
    (float64, rounded to f32)."""
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    pos = _pos_ids(h, w, cfg.spatial_merge_size)
    freqs = pos[:, :, None].astype(np.float64) * inv_freq[None, None, :]
    rpe = freqs.reshape(pos.shape[0], -1)
    emb = np.concatenate([rpe, rpe], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def extract_qwen_patches(pixels: torch.Tensor, cfg: Qwen25VisionConfig) -> torch.Tensor:
    """(B, H, W, 3) -> (B, seq, patch_dim): flattened patches in merge order,
    each laid out (C, T, ph, pw) with the frame duplicated over T (the
    Qwen2-VL image processor on one image)."""
    B, H, W, C = pixels.shape
    p, s = cfg.patch_size, cfg.spatial_merge_size
    h, w = H // p, W // p
    x = pixels.reshape(B, h, p, w, p, C).permute(0, 1, 3, 5, 2, 4).reshape(B, h * w, C, p, p)
    x = x[:, torch.from_numpy(_merge_order_indices(h, w, s)).to(x.device)]
    x = x[:, :, :, None].expand(B, h * w, C, cfg.temporal_patch_size, p, p)
    return x.reshape(B, h * w, cfg.patch_dim)


# --------------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------------- #
def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


@dataclass(frozen=True)
class _Grid:
    """A grid's fixed tensors on one device: the merged-cell window
    permutation and its inverse, the rotary tables in permuted order (1,
    seq, 1, head_dim), f32, and the windows: `windows` equal windows of
    contiguous patches (0 where they are unequal, then `mask` (seq, seq) is
    the block-diagonal window mask)."""

    perm: torch.Tensor
    unperm: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    windows: int
    mask: Optional[torch.Tensor]


@functools.lru_cache(maxsize=32)
def _grid(h: int, w: int, cfg: Qwen25VisionConfig, device: torch.device) -> _Grid:
    s2 = cfg.spatial_merge_size**2
    seq = h * w
    win_perm, win_id = _window_index(h, w, cfg)
    cos, sin = _rotary_tables(h, w, cfg)
    table = lambda t: torch.from_numpy(t.reshape(seq // s2, s2, -1)[win_perm].reshape(seq, -1)).to(device)[
        None, :, None, :]
    sizes = np.bincount(win_id)
    equal = bool((sizes == sizes[0]).all())
    mask = None
    if not equal:
        patch_win = np.repeat(win_id, s2)
        mask = torch.from_numpy(patch_win[:, None] == patch_win[None, :]).to(device)
    return _Grid(torch.from_numpy(win_perm).to(device), torch.from_numpy(np.argsort(win_perm)).to(device),
                 table(cos), table(sin), len(sizes) if equal else 0, mask)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, windows: int,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, seq, H, hd) q, k, v -> (B, seq, H * hd): one batch row per window
    when `windows` > 0, else over the whole sequence under `mask` (None for
    full attention)."""
    B, seq, H, hd = q.shape
    rows, n = (B * windows, seq // windows) if windows else (B, seq)
    q, k, v = (t.reshape(rows, n, H, hd).transpose(1, 2) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd**-0.5)
    return out.transpose(1, 2).reshape(B, seq, H * hd)


# layer -> (weak references to its FFN_FIELDS tensors, their (data_ptr, _version), the padded copy)
_padded_ffn: "weakref.WeakKeyDictionary[Qwen25VisionLayer, tuple]" = weakref.WeakKeyDictionary()


def _ffn_weights(layer: Qwen25VisionLayer, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """(gate_w, gate_b, up_w, up_b, down_w) for the layer's feed-forward over
    x and whether they are the padded copy: the layer's own tensors where I %
    8 == 0 or autograd would record a graph through x or them, else their
    copy padded to the next multiple of 8, made once (no grad; the weights'
    dtype and device) and again when a tensor is replaced or changed in
    place."""
    own = tuple(getattr(layer, n) for n in FFN_FIELDS)
    width = own[0].shape[0]
    if width % FFN_ALIGN == 0 or (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *own))):
        return own, False
    state = tuple((t.data_ptr(), t._version) for t in own)
    kept = _padded_ffn.get(layer)
    if kept is not None and kept[1] == state and all(r() is t for r, t in zip(kept[0], own)):
        return kept[2], True
    pad = -width % FFN_ALIGN
    with torch.no_grad():
        gate_w, gate_b, up_w, up_b, down_w = own
        copy = (F.pad(gate_w, (0, 0, 0, pad)), F.pad(gate_b, (0, pad)), F.pad(up_w, (0, 0, 0, pad)),
                F.pad(up_b, (0, pad)), F.pad(down_w, (0, pad)))
    _padded_ffn[layer] = (tuple(weakref.ref(t) for t in own), state, copy)
    return copy, True


def encode_features(params: Qwen25VisionParams, cfg: Qwen25VisionConfig, feats: torch.Tensor,
                    grid: Tuple[int, int]) -> torch.Tensor:
    """(B, seq, patch_dim) merge-order patches of an (h, w) patch grid ->
    (B, seq / merge^2, out_hidden_size) merged visual tokens, row-major
    merged cells, in the weights' dtype."""
    h, w = grid
    B, seq, _ = feats.shape
    s2 = cfg.spatial_merge_size**2
    H, hd = cfg.num_heads, cfg.head_dim
    g = _grid(h, w, cfg, feats.device)
    full = set(cfg.fullatt_block_indexes)
    with profiling.span("vision.tower"):
        x = dense(feats.to(params.patch_w.dtype), params.patch_w)
        x = x.reshape(B, seq // s2, s2, -1)[:, g.perm].reshape(B, seq, -1)
        for i, layer in enumerate(params.layers):
            with profiling.span("vision.full_layer" if i in full else "vision.window_layer"):
                hn = rms_norm(x, layer.ln1, cfg.rms_eps)
                q, k, v = dense(hn, layer.qkv_w, layer.qkv_b).chunk(3, dim=-1)
                q, k, v = (t.reshape(B, seq, H, hd) for t in (q, k, v))
                qf, kf = q.float(), k.float()
                q = (qf * g.cos + _rotate_half(qf) * g.sin).to(x.dtype)
                k = (kf * g.cos + _rotate_half(kf) * g.sin).to(x.dtype)
                a = _attend(q, k, v, 0, None) if i in full else _attend(q, k, v, g.windows, g.mask)
                x = x + dense(a, layer.proj_w, layer.proj_b)
                hn = rms_norm(x, layer.ln2, cfg.rms_eps)
                (gate_w, gate_b, up_w, up_b, down_w), padded = _ffn_weights(layer, hn)
                profiling.count("vision.mlp_padded" if padded else "vision.mlp_plain", 1)
                gu = F.silu(dense(hn, gate_w, gate_b)) * dense(hn, up_w, up_b)
                x = x + dense(gu, down_w, layer.down_b)
        x = rms_norm(x, params.ln_q, cfg.rms_eps).reshape(B, seq // s2, -1)
        x = F.gelu(dense(x, params.fc1_w, params.fc1_b))
        x = dense(x, params.fc2_w, params.fc2_b)
        return x[:, g.unperm]


def encode_image(params: Qwen25VisionParams, cfg: Qwen25VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, (H/14)(W/14)/4, out_hidden)."""
    grid = (pixels.shape[1] // cfg.patch_size, pixels.shape[2] // cfg.patch_size)
    return encode_features(params, cfg, extract_qwen_patches(pixels, cfg), grid)


# --------------------------------------------------------------------------- #
# Hugging Face conversion (Qwen2_5_VisionTransformerPretrainedModel)
# --------------------------------------------------------------------------- #
def convert_qwen25_vision_state_dict(sd: Dict[str, Any], cfg: Qwen25VisionConfig) -> Dict[str, Any]:
    """`visual.*` (hub) or `model.visual.*` (transformers >= 4.54 re-saves)
    -> the JAX package's tree of numpy arrays."""
    for prefix in ("visual.", "model.visual."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    L = cfg.depth

    def stack(fmt, transpose=True):
        mats = [np.asarray(sd[fmt.format(i)]) for i in range(L)]
        if transpose:
            mats = [np.ascontiguousarray(m.T) for m in mats]
        return np.stack(mats)

    def lin(base):
        return {"kernel": stack(base + ".weight"), "bias": stack(base + ".bias", transpose=False)}

    t = lambda name: np.ascontiguousarray(np.asarray(sd[name]).T)
    pe = np.asarray(sd["patch_embed.proj.weight"])  # (D, C, T, ph, pw)
    return {
        "patch_embed": {"kernel": np.ascontiguousarray(pe.reshape(pe.shape[0], -1).T)},
        "blocks": {
            "ln1": stack("blocks.{}.norm1.weight", transpose=False),
            "ln2": stack("blocks.{}.norm2.weight", transpose=False),
            "qkv": lin("blocks.{}.attn.qkv"),
            "proj": lin("blocks.{}.attn.proj"),
            "gate": lin("blocks.{}.mlp.gate_proj"),
            "up": lin("blocks.{}.mlp.up_proj"),
            "down": lin("blocks.{}.mlp.down_proj"),
        },
        "merger": {
            "ln_q": np.asarray(sd["merger.ln_q.weight"]),
            "fc1": {"kernel": t("merger.mlp.0.weight"), "bias": np.asarray(sd["merger.mlp.0.bias"])},
            "fc2": {"kernel": t("merger.mlp.2.weight"), "bias": np.asarray(sd["merger.mlp.2.bias"])},
        },
    }
