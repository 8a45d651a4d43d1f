"""RAG-VT5 engine: embed -> retrieve -> assemble -> encode -> decode.

Counterpart of `rag_docvqa_tpu/engine/rag_vt5.py` for the `concat` and
`oracle` strategies: `RAGConfig`, `retrieve` (the JAX `retrieve_device`)
and `RAGVT5Engine.inference` with `_decode` and `_result`, with the optional
cross-encoder rerank stage after retrieval (engine/reranker.py; never for
`oracle`). The other strategies raise `NotImplementedError` naming the
ROADMAP slice that ports them; NAC, chunk reordering (ROADMAP Queue 1
item 8) and the visual branch (item 13) are not in the port yet, nor their
config fields.

Everything from retrieval to the decoded ids runs on the parameters'
device; the host tokenizes at ingest and detokenizes the answers. The
result carries the stage split of the wall time under "timings", each stage
ended by a device synchronize; with a reranker, "rerank_time" under
"retrieval" is the reranker call alone between two synchronizes (it is part
of "retrieve_assemble_s").
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, RetrievalResult, to_device
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed
from rag_docvqa_tpu_torch.ops.decode import greedy_decode
from rag_docvqa_tpu_torch.ops.gather import AssembleConfig, assemble_concat, group_boxes
from rag_docvqa_tpu_torch.ops.topk import NEG_INF, masked_topk

STRATEGIES = (
    "oracle", "concat", "maxconf", "anyconf", "maxconfpage", "anyconfpage",
    "anyconforacle", "majorpage", "weightmajorpage", "none",
)
PORTED = ("oracle", "concat")


@dataclass(frozen=True)
class RAGConfig:
    page_retrieval: str = "concat"
    chunk_num: int = 10  # k
    include_surroundings: int = 0
    sep_token_id: int = 0  # nonzero enables <sep> between chunk groups
    max_source_length: int = 512
    max_new_tokens: int = 100

    def __post_init__(self):
        if self.page_retrieval not in STRATEGIES:
            raise ValueError(f"unknown page_retrieval {self.page_retrieval!r}")

    def assemble(self) -> AssembleConfig:
        return AssembleConfig(
            max_source_length=self.max_source_length,
            include_surroundings=self.include_surroundings,
            sep_token_id=self.sep_token_id,
        )


def retrieve(shared: torch.Tensor, batch: ChunkedBatch, k: int, oracle: bool = False) -> RetrievalResult:
    """Per-sample cosine top-k over the sample's chunks, with the
    reference's eps placement: dots / (|c| |q| + 1e-8)."""
    chunk_emb = vt5_table_embed(shared, batch.chunk_emb_tokens, batch.chunk_emb_mask)
    q_emb = vt5_table_embed(shared, batch.q_tokens, batch.q_mask)
    dots = torch.einsum("bcd,bd->bc", chunk_emb, q_emb)
    norms = torch.linalg.vector_norm(chunk_emb, dim=-1) * torch.linalg.vector_norm(q_emb, dim=-1, keepdim=True)
    sims = dots / (norms + 1e-8)
    sims = torch.where(batch.chunk_mask, sims, torch.full_like(sims, NEG_INF))
    if oracle:
        # the first chunk of the GT answer page
        is_answer = batch.chunk_mask & (batch.chunk_page == batch.answer_page[:, None])
        idx = is_answer.to(torch.int32).argmax(dim=1, keepdim=True)
        valid = is_answer.any(dim=1, keepdim=True)
        vals = torch.gather(sims, 1, idx)
    else:
        vals, idx, valid = masked_topk(sims, batch.chunk_mask, k)
    take = lambda x: torch.gather(x, 1, idx)
    return RetrievalResult(
        top_k_idx=idx, top_k_valid=valid, top_k_score=vals,
        top_k_page=take(batch.chunk_page), top_k_label=take(batch.chunk_label),
        top_k_box=torch.gather(batch.chunk_box, 1, idx[..., None].expand(-1, -1, 4)),
        similarities=sims,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RAGVT5Engine:
    """Host-facing engine: owns the parameters and the tokenizer."""

    def __init__(self, rag_cfg: RAGConfig, vt5_cfg: vt5m.VT5Config, params: vt5m.VT5Params, tokenizer,
                 reranker=None):
        if rag_cfg.page_retrieval not in PORTED:
            raise NotImplementedError(
                f"strategy {rag_cfg.page_retrieval!r} waits for the slice of the other RAG-VT5 "
                "strategies (ROADMAP Queue 1 item 8)")
        self.cfg = rag_cfg
        self.vt5_cfg = vt5_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.reranker = reranker  # engine.reranker.Reranker, or None
        self.device = params.t5.shared.device

    @torch.inference_mode()
    def inference(self, batch: ChunkedBatch, aux: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """`batch` as numpy (from DocVQAIngestor.ingest) or already on the
        device. Returns answers, confidences, pages and retrieval details."""
        cfg, dev = self.cfg, self.device
        if not isinstance(batch.chunk_mask, torch.Tensor):
            batch = to_device(batch, dev)
        B = batch.batch_size
        oracle = cfg.page_retrieval == "oracle"
        t0 = time.perf_counter()
        ret = retrieve(self.params.t5.shared, batch, k=cfg.chunk_num, oracle=oracle)
        rerank_s = 0.0
        if self.reranker is not None and not oracle:
            _sync(dev)
            tr = time.perf_counter()
            ret = self.reranker(batch, ret)
            _sync(dev)
            rerank_s = time.perf_counter() - tr
        gen, owner = assemble_concat(batch, ret.top_k_idx, ret.top_k_valid, cfg.assemble())
        _sync(dev)
        t1 = time.perf_counter()
        embeds, mask = vt5m.input_embeds(self.params, self.vt5_cfg, gen)
        enc = t5m.encode(self.params.t5, self.vt5_cfg.t5, embeds, mask)
        _sync(dev)
        t2 = time.perf_counter()
        tokens, conf = greedy_decode(self.params.t5, self.vt5_cfg.t5, enc, mask, cfg.max_new_tokens)
        tokens_np = tokens.cpu().numpy()  # waits for the decode
        t3 = time.perf_counter()

        answers = self._decode(tokens_np)
        confs = conf.cpu().tolist()
        valid_np = ret.top_k_valid.cpu().numpy()
        if oracle:
            pages = [[int(p)] for p in batch.answer_page.cpu().tolist()]
        else:
            pages_np = ret.top_k_page.cpu().numpy()
            pages = [pages_np[b][valid_np[b]].tolist() for b in range(B)]
        result = self._result(answers, confs, pages, ret, batch, aux, owner)
        result["retrieval"]["retrieval_time"] = t1 - t0
        result["retrieval"]["generation_time"] = t3 - t1
        if self.reranker is not None:
            result["retrieval"]["rerank_time"] = rerank_s
        result["timings"] = {"retrieve_assemble_s": t1 - t0, "encode_s": t2 - t1, "decode_s": t3 - t2}
        return result

    def _decode(self, tokens: np.ndarray) -> List[str]:
        t5c = self.vt5_cfg.t5
        out = []
        for row in tokens:
            ids = []
            for t in row:
                if t == t5c.eos_id:
                    break
                if t != t5c.pad_id:
                    ids.append(int(t))
            out.append(self.tokenizer.decode(ids))
        return out

    def _result(self, answers, confidences, pred_answer_pages, ret, batch, aux, owner):
        K = ret.top_k_idx.shape[1]
        retrieval: Dict[str, Any] = {
            "page_indices": pred_answer_pages,
            "similarities": ret.top_k_score.float().cpu().numpy(),
            "top_k_layout_labels": ret.top_k_label.cpu().tolist(),
            "boxes": group_boxes(batch, owner, K).cpu().numpy(),
        }
        if aux is not None and "slot_words" in aux:
            retrieval["text"] = self._topk_texts(owner.cpu().numpy(), aux, ret.top_k_valid.cpu().numpy())
        return {
            "pred_answers": answers,
            "confidences": confidences,
            "pred_answer_pages": pred_answer_pages,
            "retrieval": retrieval,
        }

    @staticmethod
    def _topk_texts(owner: np.ndarray, aux: Dict[str, Any], valid: np.ndarray) -> List[List[str]]:
        """Compacted top-k chunk texts including surroundings."""
        texts: List[List[str]] = []
        for b in range(valid.shape[0]):
            words_b = aux["slot_words"][b]
            rows = []
            for r in range(valid.shape[1]):
                if not valid[b, r]:
                    continue
                slots = np.where(owner[b] == r)[0]
                rows.append(" ".join(words_b[g] for g in slots if g < len(words_b)))
            texts.append(rows)
        return texts
