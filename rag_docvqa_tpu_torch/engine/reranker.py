"""Cross-encoder reranking stage.

Counterpart of `rag_docvqa_tpu/engine/reranker.py`: `RerankerConfig`,
`build_pair_tokens`, `build_pair_tokens_surround`, `rerank_select`,
`apply_rerank` and `Reranker`. Pipeline: build [CLS] question [SEP] chunk
[SEP] pair tokens for the K retrieved chunks -> cross-encoder scores in one
batch of B*K pairs (models/bert.py, every layer through K9) -> sort
descending -> threshold filter clamped to [min_chunk_num, max_chunk_num] ->
permuted top-k indices and validity. Everything is on the batch's device.

Pair-text modes: by default pairs carry the chunk's own embed-token text;
`rerank_on_surroundings=True` builds them from the compacted retrieval text
including surrounding words (first-cover dedup in retrieval rank order). The
two are identical at include_surroundings=0.

The sort is `torch.sort(descending=True, stable=True)` on the scores, which
keeps equal scores in rank order as `jnp.argsort(-x, stable=True)` does
(tests/test_torch_reranker.py holds ties and invalid ranks against it).

The LLM pair reranker: `build_llm_pair_tokens` lays out prefix ++ question
++ mid ++ chunk ++ instruction suffix for each pair (the bge-reranker-v2-gemma
prompt), `FlagLLMReranker` scores a pair by the causal LM's yes-token logit
at the pair's last position (sigmoid-normalised, so `filter_thresh` keeps its
[0, 1] meaning) and `_llm_pair_yes_logits` dots the final hidden state with
the yes column of the head alone, never forming the (N, T, V) logits. The
LM's attention is K2 (with a Gemma backbone: dh 256, MQA), under
`torch.no_grad()`: scoring is inference only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, RetrievalResult
from rag_docvqa_tpu_torch.models.bert import BertConfig, BertParams, cross_encoder_score
from rag_docvqa_tpu_torch.ops.gather import AssembleConfig, _flatten_tokens, compute_ownership


@dataclass(frozen=True)
class RerankerConfig:
    filter_thresh: float = 0.4
    max_chunk_num: int = 5
    min_chunk_num: int = 1
    cls_id: int = 0
    sep_id: int = 2
    pair_len: int = 192
    question_len: int = 32
    # pair texts include surrounding words; include_surroundings must match the engine's
    rerank_on_surroundings: bool = False
    include_surroundings: int = 0


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on the last dim, idx broadcast against x."""
    shape = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(*shape, x.shape[-1]), -1, idx.expand(*shape, idx.shape[-1]))


def build_pair_tokens(batch: ChunkedBatch, top_k_idx: torch.Tensor, cfg: RerankerConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B*K, pair_len) [CLS] q [SEP] chunk [SEP] token ids and mask."""
    B, K = top_k_idx.shape
    LQ = batch.q_tokens.shape[1]
    LE = batch.chunk_emb_tokens.shape[2]
    dev = top_k_idx.device
    q_len = batch.q_mask.sum(dim=1).clamp(max=cfg.question_len)  # (B,)
    gather_idx = top_k_idx[:, :, None].expand(B, K, LE)
    chunk_tokens = torch.gather(batch.chunk_emb_tokens, 1, gather_idx)  # (B, K, LE)
    chunk_len = torch.gather(batch.chunk_emb_mask, 1, gather_idx).sum(dim=2)  # (B, K)

    T = cfg.pair_len
    pos = torch.arange(T, device=dev)[None, None, :]
    ql = q_len[:, None, None]
    cl = chunk_len[:, :, None]
    # layout: [CLS] q[0:ql] [SEP] chunk[0:cl] [SEP]
    sep1 = 1 + ql
    chunk_start = sep1 + 1
    sep2 = (chunk_start + cl).clamp(max=T - 1)

    q_idx = (pos - 1).clamp(0, LQ - 1)
    c_idx = (pos - chunk_start).clamp(0, LE - 1)
    q_tok = _take(batch.q_tokens[:, None, :], q_idx)
    c_tok = _take(chunk_tokens, c_idx)
    zero = torch.zeros((), dtype=q_tok.dtype, device=dev)
    ids = torch.where(
        pos == 0, cfg.cls_id,
        torch.where(pos < sep1, q_tok,
                    torch.where(pos == sep1, cfg.sep_id,
                                torch.where(pos < sep2, c_tok, torch.where(pos == sep2, cfg.sep_id, zero)))))
    mask = (pos <= sep2).expand(B, K, T)
    return ids.reshape(B * K, T), mask.reshape(B * K, T)


def build_pair_tokens_surround(batch: ChunkedBatch, top_k_idx: torch.Tensor, top_k_valid: torch.Tensor,
                               cfg: RerankerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair builder whose chunk segment is the rank's compacted retrieval
    text including surroundings (first-cover dedup in retrieval rank order).
    Each rank's owned slots flatten into one row laid out
    [CLS] q [SEP] slot-words [SEP]; the final SEP rides the flattener's
    keep-EOS slot."""
    B, K = top_k_idx.shape
    W = batch.slot_mask.shape[1]
    LQ = batch.q_tokens.shape[1]
    dev = top_k_idx.device
    owner = compute_ownership(batch, top_k_idx, top_k_valid, cfg.include_surroundings)

    # pair "prompt" = [CLS] q[0:ql] [SEP], per sample
    ql = batch.q_mask.sum(dim=1).clamp(max=cfg.question_len)  # (B,)
    LP = min(cfg.question_len, LQ) + 2
    pos = torch.arange(LP, device=dev)[None, :]
    q_idx = (pos - 1).clamp(0, LQ - 1).expand(B, LP)
    zero = torch.zeros((), dtype=batch.q_tokens.dtype, device=dev)
    prompt = torch.where(
        pos == 0, cfg.cls_id,
        torch.where(pos < 1 + ql[:, None], torch.gather(batch.q_tokens, 1, q_idx),
                    torch.where(pos == 1 + ql[:, None], cfg.sep_id, zero)))
    prompt_len = ql + 2

    # per-rank slot token streams: rows = (B*K) pseudo-samples sharing the
    # sample's slot arrays, with ntok zeroed outside the rank's slots
    rank = torch.arange(K, device=dev)[None, :, None]
    ntok = torch.where(owner[:, None, :] == rank, batch.slot_ntok[:, None, :], 0)  # (B, K, W)
    tile = lambda x: x[:, None].expand(B, K, *x.shape[1:]).reshape(B * K, *x.shape[1:])
    fcfg = AssembleConfig(max_source_length=cfg.pair_len, eos_token_id=cfg.sep_id, pad_token_id=0)
    gen = _flatten_tokens(
        tile(batch.slot_tokens), ntok.reshape(B * K, W), tile((batch.slot_box * 1000).to(torch.int64)),
        tile(batch.slot_label), tile(prompt), prompt_len[:, None].expand(B, K).reshape(B * K), fcfg)
    return gen.input_ids, gen.attention_mask


def rerank_select(scores: torch.Tensor, top_k_valid: torch.Tensor, cfg: RerankerConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores (B, K) in [0, 1], top_k_valid (B, K) -> (perm (B, K), the
    reordering of rank positions; new_valid (B, K); sorted_scores). Invalid
    ranks sort last at -inf; keep = n_pass clamped to [min_chunk_num (but at
    most the valid ranks), max_chunk_num]."""
    masked = torch.where(top_k_valid, scores, -torch.inf)
    sorted_scores, order = torch.sort(masked, dim=1, descending=True, stable=True)
    n_valid = top_k_valid.sum(dim=1)
    n_pass = (top_k_valid & (scores >= cfg.filter_thresh)).sum(dim=1)
    keep = torch.where(n_pass > cfg.max_chunk_num, cfg.max_chunk_num,
                       torch.where(n_pass < cfg.min_chunk_num, n_valid.clamp(max=cfg.min_chunk_num), n_pass))
    new_valid = torch.arange(scores.shape[1], device=scores.device)[None, :] < keep[:, None]
    return order, new_valid, sorted_scores


def apply_rerank(ret: RetrievalResult, perm: torch.Tensor, new_valid: torch.Tensor, scores: torch.Tensor
                 ) -> RetrievalResult:
    """Permute every per-rank field of the retrieval result."""
    take = lambda x: torch.gather(x, 1, perm)
    return RetrievalResult(
        top_k_idx=take(ret.top_k_idx), top_k_valid=new_valid, top_k_score=scores,
        top_k_page=take(ret.top_k_page), top_k_label=take(ret.top_k_label),
        top_k_box=torch.gather(ret.top_k_box, 1, perm[..., None].expand(-1, -1, 4)),
        similarities=ret.similarities)


class Reranker:
    """Host-facing wrapper: parameters and configs -> rerank a RetrievalResult."""

    def __init__(self, cfg: RerankerConfig, bert_cfg: BertConfig, params: BertParams):
        self.cfg = cfg
        self.bert_cfg = bert_cfg
        self.params = params

    def __call__(self, batch: ChunkedBatch, ret: RetrievalResult) -> RetrievalResult:
        B, K = ret.top_k_idx.shape
        if self.cfg.rerank_on_surroundings:
            ids, mask = build_pair_tokens_surround(batch, ret.top_k_idx, ret.top_k_valid, self.cfg)
        else:
            ids, mask = build_pair_tokens(batch, ret.top_k_idx, self.cfg)
        scores = cross_encoder_score(self.params, self.bert_cfg, ids, mask).float().reshape(B, K)
        perm, new_valid, sorted_scores = rerank_select(scores, ret.top_k_valid, self.cfg)
        return apply_rerank(ret, perm, new_valid, sorted_scores)


# --------------------------------------------------------------------------- #
# the LLM (Gemma-style) pair reranker
# --------------------------------------------------------------------------- #
def build_llm_pair_tokens(batch: ChunkedBatch, top_k_idx: torch.Tensor, prefix: torch.Tensor, mid: torch.Tensor,
                          suffix: torch.Tensor, cfg: RerankerConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B*K, pair_len) ids laid out prefix ++ q ++ mid ++ chunk ++ suffix, the
    mask, and each row's last valid position (where the yes logit is read).
    The question's budget keeps every segment in the row whatever the
    tokenizer; the chunk is clamped to leave room for the suffix."""
    B, K = top_k_idx.shape
    LQ = batch.q_tokens.shape[1]
    LE = batch.chunk_emb_tokens.shape[2]
    T = cfg.pair_len
    n_prefix, n_mid, n_suffix = len(prefix), len(mid), len(suffix)
    if n_prefix + 1 + n_mid + n_suffix >= T:
        raise ValueError(f"pair_len={T} cannot fit prefix({n_prefix}) + question(>=1) + mid({n_mid}) + "
                         f"suffix({n_suffix}); raise RerankerConfig.pair_len")
    dev = top_k_idx.device
    q_budget = T - n_prefix - n_mid - n_suffix - 1
    q_len = batch.q_mask.sum(dim=1).clamp(max=min(cfg.question_len, q_budget))  # (B,)
    gather_idx = top_k_idx[:, :, None].expand(B, K, LE)
    chunk_tokens = torch.gather(batch.chunk_emb_tokens, 1, gather_idx)
    chunk_len = torch.gather(batch.chunk_emb_mask, 1, gather_idx).sum(dim=2)

    pos = torch.arange(T, device=dev)[None, None, :]
    b_q = n_prefix
    b_mid = b_q + q_len[:, None, None]
    b_chunk = b_mid + n_mid
    b_suf = (b_chunk + chunk_len[:, :, None]).clamp(max=T - n_suffix)
    last = b_suf + n_suffix - 1  # (B, K, 1)

    q_tok = _take(batch.q_tokens[:, None, :], (pos - b_q).clamp(0, LQ - 1))
    c_tok = _take(chunk_tokens, (pos - b_chunk).clamp(0, LE - 1))
    p_tok = prefix.to(dev)[pos.clamp(0, n_prefix - 1)]
    m_tok = mid.to(dev)[(pos - b_mid).clamp(0, n_mid - 1)]
    s_tok = suffix.to(dev)[(pos - b_suf).clamp(0, n_suffix - 1)]
    zero = torch.zeros((), dtype=q_tok.dtype, device=dev)
    ids = torch.where(pos < b_q, p_tok.to(q_tok.dtype),
                      torch.where(pos < b_mid, q_tok,
                                  torch.where(pos < b_chunk, m_tok.to(q_tok.dtype),
                                              torch.where(pos < b_suf, c_tok,
                                                          torch.where(pos <= last, s_tok.to(q_tok.dtype), zero)))))
    ids = ids.expand(B, K, T)
    mask = (pos <= last).expand(B, K, T)
    return (ids.reshape(B * K, T).to(torch.int32), mask.reshape(B * K, T),
            last.expand(B, K, 1).reshape(B * K).to(torch.int32))


LLM_RERANK_PROMPT = ("Given a query A and a passage B, determine whether the passage contains an answer to the "
                     "query by providing a prediction of either 'Yes' or 'No'.")


class FlagLLMReranker:
    """LLM pair reranker: a (query, passage) pair scores the causal LM's
    yes-token logit at the pair's last position (the bge-reranker-v2-gemma
    scheme); `normalize` passes it through a sigmoid. `build_reranker`
    selects it when "gemma" is in the reranker weight name."""

    def __init__(self, cfg: RerankerConfig, lm_cfg, params, tokenizer, yes_token: str = "Yes",
                 normalize: bool = True):
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        self.params = params  # models.causal_lm.CausalLMParams
        self.normalize = normalize
        self.yes_id = tokenizer.encode(yes_token)[0]
        as_ids = lambda text: torch.tensor(tokenizer.encode(text), dtype=torch.int64)
        self._prefix, self._mid, self._suffix = as_ids("A:"), as_ids("B:"), as_ids(LLM_RERANK_PROMPT)

    def __call__(self, batch: ChunkedBatch, ret: RetrievalResult) -> RetrievalResult:
        B, K = ret.top_k_idx.shape
        ids, mask, last = build_llm_pair_tokens(batch, ret.top_k_idx, self._prefix, self._mid, self._suffix, self.cfg)
        scores = _llm_pair_yes_logits(self.params, self.lm_cfg, ids, mask, last, self.yes_id).reshape(B, K)
        if self.normalize:
            scores = torch.sigmoid(scores)
        perm, new_valid, sorted_scores = rerank_select(scores, ret.top_k_valid, self.cfg)
        return apply_rerank(ret, perm, new_valid, sorted_scores)


@torch.no_grad()
def _llm_pair_yes_logits(params, lm_cfg, ids: torch.Tensor, mask: torch.Tensor, last: torch.Tensor,
                         yes_id: int) -> torch.Tensor:
    """The yes-token logit (f32) at each row's last position: the final
    hidden state dotted with the yes column of the LM head alone."""
    from rag_docvqa_tpu_torch.models import causal_lm

    h = causal_lm.forward_hidden(params, lm_cfg, ids, mask)
    h_last = h[torch.arange(ids.shape[0], device=ids.device), last.long()]
    w = params.embed[yes_id] if lm_cfg.tie_word_embeddings else params.lm_head[yes_id]
    return (h_last @ w.to(h_last.dtype)).float()
