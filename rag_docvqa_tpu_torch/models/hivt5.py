"""Hi-VT5: hierarchical multi-page encoder with page-token compression.

Counterpart of `rag_docvqa_tpu/models/hivt5.py` (`HiVT5Config`,
`init_hivt5_params`, `page_visual_features`, `encode_document`,
`page_retrieval_logits`, `forward_train`, `attention_viz`, `generate`).
Each page is encoded as

  [PAGE_p] x page_tokens ++ prompt ++ page words (+ spatial emb) [++ visual tokens]

only the first `page_tokens` hidden states of a page are kept, the
concatenation over pages is the document embedding the decoder
cross-attends to, and a linear head over the flattened document embedding
predicts the answer page.

Pages fold into the batch axis: one `t5.encode` over (B*P, K+T[+Tv]) rows,
K1's parts with K2 inside when serving, `t5_layer_train` (K7/K8 with K6)
with train=True. A page slot past a document's page count gives a row with
no valid key at all; the kernels (and their plain versions) average such a
row uniformly at the -1e9 mask, which is finite, and `encode_document` then
multiplies its kept positions by zero, as JAX does. The answer is decoded by
`ops/decode.py::greedy_decode` over the (B, P*K) document embedding (K3 when
`fused_decode_attn` is set). The per-page renders go through
`models/vit.py::vit_encode` (K14) and the matcher. `page_retrieval_logits`
is a plain f32 product, as JAX leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models.embeddings import (
    SpatialConfig,
    SpatialEmbeddings,
    get_visual_boxes,
    init_spatial_params,
    spatial_embed,
)
from rag_docvqa_tpu_torch.models.layers import dense, frozen, masked_cross_entropy, normal_init
from rag_docvqa_tpu_torch.models.vit import ViTConfig, init_vit_params, vit_encode
from rag_docvqa_tpu_torch.models.vt5 import VisualParams
from rag_docvqa_tpu_torch.ops.decode import greedy_decode
from rag_docvqa_tpu_torch.ops.gather import AssembleConfig, assemble_page_rows
from rag_docvqa_tpu_torch.profiling import count, device_count, span

@dataclass(frozen=True)
class HiVT5Config:
    t5: t5m.T5Config = field(default_factory=t5m.T5Config)
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    page_tokens: int = 10  # configs/HiVT5.yml
    max_doc_pages: int = 20
    page_seq_len: int = 512  # per-page token budget (max_text_tokens)
    retrieval_loss_weight: float = 0.25
    # per-page visual branch: ViT features + visual-box spatial embeddings
    # appended to each page's encoder input
    use_visual: bool = False
    vit: ViTConfig = field(default_factory=ViTConfig)


class PageHead(nn.Module):
    """The page-retrieval linear layer: weight (P, P*K*d) (out, in), bias (P,)."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight, self.bias = frozen(weight), frozen(bias)


class HiVT5Params(nn.Module):
    """The T5, the spatial embeddings, one [PAGE_p] embedding a page slot
    (P, d), the page head, and the per-page visual tower when the model has
    one."""

    def __init__(self, t5: t5m.T5Params, spatial: SpatialEmbeddings, page_emb: torch.Tensor, page_head: PageHead,
                 visual: Optional[VisualParams] = None):
        super().__init__()
        self.t5, self.spatial = t5, spatial
        self.page_emb = frozen(page_emb)
        self.page_head = page_head
        self.visual = visual


def init_hivt5_params(generator: torch.Generator, cfg: HiVT5Config) -> HiVT5Params:
    """Random f32 weights on the generator's device, with the JAX package's
    distributions."""
    g, d, P, dev = generator, cfg.t5.d_model, cfg.max_doc_pages, generator.device
    t5 = t5m.init_t5_params(g, cfg.t5)
    spatial = init_spatial_params(g, cfg.spatial)
    page_emb = normal_init(g, (P, d), 1.0)
    head_w = normal_init(g, (P, P * cfg.page_tokens * d), 0.02)
    visual = None
    if cfg.use_visual:
        dv = cfg.vit.hidden_size
        visual = VisualParams(init_vit_params(g, cfg.vit), normal_init(g, (d, dv), dv**-0.5),
                              torch.zeros(d, device=dev))
    return HiVT5Params(t5, spatial, page_emb, PageHead(head_w, torch.zeros(P, device=dev)), visual)


def page_visual_features(params: HiVT5Params, cfg: HiVT5Config, pixels: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) page renders -> (N, 1 + g*g, d_model) visual tokens: the
    tower, the matcher, and the spatial embedding of the visual boxes
    (`get_visual_boxes` at scale 1000) summed in."""
    hidden = vit_encode(params.visual.vit, cfg.vit, pixels)
    vis = dense(hidden, params.visual.matcher_w.to(hidden.dtype), params.visual.matcher_b.to(hidden.dtype))
    grid = cfg.vit.image_size // cfg.vit.patch_size
    boxes = get_visual_boxes(1, 1000.0, grid, device=pixels.device)[0].to(torch.int64)  # truncated, as astype
    box_emb = spatial_embed(params.spatial, cfg.spatial, boxes[None])  # (1, T, d)
    return vis + box_emb.to(vis.dtype)


def _page_valid(cfg: HiVT5Config, batch: ChunkedBatch) -> torch.Tensor:
    return torch.arange(cfg.max_doc_pages, device=batch.num_pages.device)[None, :] < batch.num_pages[:, None]


def encode_document(params: HiVT5Params, cfg: HiVT5Config, batch: ChunkedBatch,
                    page_visual: Optional[torch.Tensor] = None, page_visual_valid: Optional[torch.Tensor] = None,
                    train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical encode: (doc_emb (B, P*K, D), doc_mask (B, P*K) bool).

    `batch` holds tensors on the parameters' device. `page_visual`
    (B, P, Tv, D) are per-page visual tokens, appended after each page's
    text; `page_visual_valid` (B, P) marks the pages with a real render
    (the others' visual tokens are masked). With train, the encoder runs
    through the hand-written layer backward."""
    B = batch.batch_size
    P, K = cfg.max_doc_pages, cfg.page_tokens
    pages = torch.arange(P, device=batch.num_pages.device)[None, :].expand(B, P)
    page_valid = pages < batch.num_pages[:, None]
    acfg = AssembleConfig(max_source_length=cfg.page_seq_len, eos_token_id=cfg.t5.eos_id, pad_token_id=cfg.t5.pad_id)
    gen = assemble_page_rows(batch, pages, page_valid, acfg)  # rows b * P + p

    x = params.t5.shared[gen.input_ids] + spatial_embed(params.spatial, cfg.spatial, gen.input_boxes)
    d = x.shape[-1]
    page_tok = params.page_emb[pages.reshape(B * P)][:, None, :].expand(B * P, K, d)
    x = torch.cat([page_tok.to(x.dtype), x], dim=1)  # (B*P, K+T, D)
    mask = torch.cat([torch.ones((B * P, K), dtype=torch.bool, device=x.device), gen.attention_mask], dim=1)
    if page_visual is not None:
        Tv = page_visual.shape[2]
        x = torch.cat([x, page_visual.reshape(B * P, Tv, -1).to(x.dtype)], dim=1)
        vis_valid = (page_visual_valid.reshape(B * P, 1) if page_visual_valid is not None
                     else torch.ones((B * P, 1), dtype=torch.bool, device=x.device))
        mask = torch.cat([mask, vis_valid.expand(B * P, Tv)], dim=1)
    mask = mask & page_valid.reshape(B * P, 1)
    device_count("encode.tokens_valid", mask)
    count("encode.positions", mask.numel())

    hidden = t5m.encode(params.t5, cfg.t5, x, mask, train=train)  # one pass, pages in the batch
    doc_emb = hidden[:, :K, :].reshape(B, P * K, -1)  # the page summary tokens
    doc_mask = page_valid.repeat_interleave(K, dim=1)
    # padded pages' rows are uniform averages over masked keys: zero them, as
    # page_retrieval_logits flattens the whole document embedding
    return doc_emb * doc_mask[..., None].to(doc_emb.dtype), doc_mask


def page_retrieval_logits(params: HiVT5Params, cfg: HiVT5Config, doc_emb: torch.Tensor) -> torch.Tensor:
    """(B, max_doc_pages) f32 page logits from the flattened document embedding."""
    flat = doc_emb.reshape(doc_emb.shape[0], -1).float()
    return torch.matmul(flat, params.page_head.weight.float().t()) + params.page_head.bias.float()


def predict_page(cfg: HiVT5Config, batch: ChunkedBatch, ret_logits: torch.Tensor) -> torch.Tensor:
    """(B,) argmax of the page logits over the valid pages (the first of ties)."""
    return torch.where(_page_valid(cfg, batch), ret_logits, t5m.MASKED).argmax(dim=-1)


def forward_train(params: HiVT5Params, cfg: HiVT5Config, batch: ChunkedBatch, labels: torch.Tensor,
                  page_visual: Optional[torch.Tensor] = None, page_visual_valid: Optional[torch.Tensor] = None,
                  denominators: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"lm_loss", "ret_loss", "ret_logits"}): the mean LM
    cross-entropy over the labels that are not -100, plus
    retrieval_loss_weight times the mean page cross-entropy over the
    documents. Dropout is off. `denominators` {"lm", "docs"}, when given,
    divide the two sums instead of this batch's label and document counts
    (a data-parallel step's global counts)."""
    denominators = denominators or {}
    doc_emb, doc_mask = encode_document(params, cfg, batch, page_visual, page_visual_valid, train=True)
    dec_in = t5m.shift_tokens_right(labels, cfg.t5.pad_id, cfg.t5.decoder_start_token_id)
    logits = t5m.decode_train(params.t5, cfg.t5, dec_in, doc_emb, doc_mask)
    lm_loss = masked_cross_entropy(logits, labels, labels != -100, denominators.get("lm"))

    ret_logits = page_retrieval_logits(params, cfg, doc_emb)
    masked = torch.where(_page_valid(cfg, batch), ret_logits, t5m.MASKED)
    ret_nll = -torch.gather(torch.log_softmax(masked, dim=-1), 1, batch.answer_page[:, None].long())[:, 0]
    docs = denominators.get("docs")
    ret_loss = (ret_nll.mean() if docs is None else ret_nll.sum() / docs) * cfg.retrieval_loss_weight
    return lm_loss + ret_loss, {"lm_loss": lm_loss, "ret_loss": ret_loss, "ret_logits": ret_logits}


def attention_viz(params: HiVT5Params, cfg: HiVT5Config, batch: ChunkedBatch, labels: torch.Tensor,
                  page_visual: Optional[torch.Tensor] = None, page_visual_valid: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The decoder's cross-attention over the document embedding, mapped back
    to pages: "cross_attn" (L, B, H, Td, P*K) probabilities, and
    "page_relevance" (B, P), the attention mass per page averaged over
    layers, heads and steps, renormalised over the valid pages (0 on the
    others)."""
    doc_emb, doc_mask = encode_document(params, cfg, batch, page_visual, page_visual_valid)
    dec_in = t5m.shift_tokens_right(labels, cfg.t5.pad_id, cfg.t5.decoder_start_token_id)
    _, cross = t5m.decode_train(params.t5, cfg.t5, dec_in, doc_emb, doc_mask, return_cross_attn=True)
    P, K = cfg.max_doc_pages, cfg.page_tokens
    mass = cross.float().mean(dim=(0, 2, 3))  # (B, P*K)
    page_mass = torch.where(_page_valid(cfg, batch), mass.reshape(-1, P, K).sum(dim=-1), 0.0)
    page_rel = page_mass / page_mass.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return {"cross_attn": cross, "page_relevance": page_rel}


def generate(params: HiVT5Params, cfg: HiVT5Config, batch: ChunkedBatch, max_new_tokens: int = 100,
             page_visual: Optional[torch.Tensor] = None, page_visual_valid: Optional[torch.Tensor] = None,
             end_stage: Optional[Callable[[str], None]] = None):
    """Greedy decode over the document embedding: (tokens (B, T), confidence
    (B,), pred_page (B,)), the page from the retrieval head. `end_stage`,
    when given, ends the engine's stage "encode" once the encode and the
    page head are queued, before the decode (`engine/stages.py`)."""
    with span("engine.encode"):
        with span("hivt5.pages"):
            doc_emb, doc_mask = encode_document(params, cfg, batch, page_visual, page_visual_valid)
        with span("hivt5.page_head"):
            pred_page = predict_page(cfg, batch, page_retrieval_logits(params, cfg, doc_emb))
        if end_stage is not None:
            end_stage("encode")
    with span("engine.decode"):
        tokens, conf = greedy_decode(params.t5, cfg.t5, doc_emb, doc_mask, max_new_tokens)
    return tokens, conf, pred_page
