"""Spatial (2-D box) embeddings for VT5.

Counterpart of `rag_docvqa_tpu/models/embeddings.py` (`SpatialConfig`,
`init_spatial_params`, `spatial_embed`, `get_visual_boxes`): x/y tables
over bucketed coordinates summed over (x0, y0, x1, y1), LayerNorm(eps=1e-12),
then one linear "matcher". Dropout is an inference no-op and is left out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from rag_docvqa_tpu_torch.models.layers import dense, frozen, layer_norm, normal_init


@dataclass(frozen=True)
class SpatialConfig:
    max_2d_positions: int = 1024
    hidden_size: int = 768
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1


class SpatialEmbeddings(nn.Module):
    """x_emb/y_emb (P, d), ln_w/ln_b (d,), matcher weight (d, d) (out, in)
    and bias (d,)."""

    def __init__(self, x_emb, y_emb, ln_w, ln_b, matcher_w, matcher_b):
        super().__init__()
        self.x_emb = frozen(x_emb)
        self.y_emb = frozen(y_emb)
        self.ln_w = frozen(ln_w)
        self.ln_b = frozen(ln_b)
        self.matcher_w = frozen(matcher_w)
        self.matcher_b = frozen(matcher_b)


def init_spatial_params(generator: torch.Generator, cfg: SpatialConfig) -> SpatialEmbeddings:
    d, dev = cfg.hidden_size, generator.device
    return SpatialEmbeddings(
        x_emb=normal_init(generator, (cfg.max_2d_positions, d), 0.02),
        y_emb=normal_init(generator, (cfg.max_2d_positions, d), 0.02),
        ln_w=torch.ones(d, device=dev),
        ln_b=torch.zeros(d, device=dev),
        matcher_w=normal_init(generator, (d, d), d**-0.5),
        matcher_b=torch.zeros(d, device=dev),
    )


def spatial_embed(p: SpatialEmbeddings, cfg: SpatialConfig, bbox: torch.Tensor) -> torch.Tensor:
    """bbox (B, T, 4) int in [0, 1000] -> (B, T, d) in the tables' dtype."""
    bbox = bbox.clamp(0, cfg.max_2d_positions - 1)
    emb = p.x_emb[bbox[..., 0]] + p.y_emb[bbox[..., 1]] + p.x_emb[bbox[..., 2]] + p.y_emb[bbox[..., 3]]
    emb = layer_norm(emb, p.ln_w, p.ln_b, cfg.layer_norm_eps)
    return dense(emb, p.matcher_w, p.matcher_b)


def get_visual_boxes(num_pages: int = 1, scale: float = 1.0, grid: int = 14, device=None) -> torch.Tensor:
    """(num_pages, 1 + grid * grid, 4) f32 boxes of the visual tokens: the CLS
    box [0, 0, 1, 1], then the grid's cells in row-major order, times `scale`."""
    cells = [[0.0, 0.0, 1.0, 1.0]] + [[x / grid, y / grid, (x + 1) / grid, (y + 1) / grid]
                                      for y in range(grid) for x in range(grid)]
    boxes = torch.tensor(cells, dtype=torch.float32, device=device)[None].repeat(num_pages, 1, 1)
    return boxes * scale
