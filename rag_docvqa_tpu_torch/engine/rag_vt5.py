"""RAG-VT5 engine: embed -> retrieve -> assemble -> encode -> decode.

Counterpart of `rag_docvqa_tpu/engine/rag_vt5.py`: `RAGConfig`, `retrieve`
(the JAX `retrieve_device`), `majority_page` (`majority_page_device`),
`reading_order` and `RAGVT5Engine.inference` with all ten page-retrieval
strategies:

  oracle          the GT page's whole-page chunk, one concat row
  concat          the top-k chunk groups flattened into one row
  maxconf         one row of `per_chunk_seq_len` per chunk, the most confident answer
  anyconf         the same rows, every row's answer kept
  anyconforacle   anyconf, with the GT page reported for each row
  maxconfpage     one whole-page row per chunk's page, the most confident answer
  anyconfpage     the same rows, every row's answer kept
  majorpage       a page vote over the top-k chunks, one whole-page row
  weightmajorpage the vote weighted by the top-k similarities*
  none            no retrieval: every word of the document in one row

*As in the JAX package, the weights are the top-k-aligned similarities; the
original reference zips the top-k pages against the full similarity vector
when no reranker runs, which misaligns them.

The optional cross-encoder rerank stage (engine/reranker.py) and the
optional reorder of the top-k chunks into reading order (`reorder_chunks`,
`reading_order`, after the reranker) apply to every strategy but `oracle`.
Only `concat` and `oracle` feed the visual branch (`use_visual`, `_visual`:
the top-k chunk boxes are cropped from the page images, packed into one grid
image per sample, resized, normalised and fed through the DiT tower (K14),
and the 197 visual tokens are appended to the encoder input) and the
not-answerable classifier (`nac=(NACParams, threshold)`, `_apply_nac`,
which adds "not_answerable_probs" under "retrieval").

Everything from retrieval to the decoded ids runs on the parameters'
device; the host tokenizes at ingest and detokenizes the answers. The
result carries the stage split of the wall time under "timings", each stage
but the decode ended on the call's clock (`engine/stages.py`), the decode at
the tokens' copy. "retrieval_time" under "retrieval" ends after retrieve,
rerank and reorder, before the assembly, as the JAX engine's does, and
"generation_time" covers the assembly, the visual branch, encode and decode;
"retrieve_assemble_s" under "timings" includes the assembly (for `none`,
which retrieves nothing and, as the JAX engine, reports no "retrieval_time",
it is the full-document assembly alone). With a reranker, "rerank_time" under
"retrieval" is the reranker call alone, between the clock's ends "topk" and
"rerank" (part of "retrieve_assemble_s"); with the visual branch, "visual_s"
is the host crops and grid plus the tower, ended as "visual" (part of "encode_s").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, RetrievalResult, on_device
from rag_docvqa_tpu_torch.engine import stages
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed
from rag_docvqa_tpu_torch.ops.decode import greedy_decode
from rag_docvqa_tpu_torch.models.embeddings import spatial_embed
from rag_docvqa_tpu_torch.models.nac import nac_prob, update_results
from rag_docvqa_tpu_torch.ops.gather import (
    AssembleConfig,
    _flatten_tokens,
    assemble_concat,
    assemble_page_rows,
    assemble_per_chunk,
    compute_ownership,
    group_boxes,
)
from rag_docvqa_tpu_torch.ops.patches import concatenate_patches_grid, crop_box, resize_image
from rag_docvqa_tpu_torch.ops.topk import NEG_INF, masked_topk
from rag_docvqa_tpu_torch.profiling import count, device_count, span

STRATEGIES = (
    "oracle", "concat", "maxconf", "anyconf", "maxconfpage", "anyconfpage",
    "anyconforacle", "majorpage", "weightmajorpage", "none",
)


@dataclass(frozen=True)
class RAGConfig:
    page_retrieval: str = "concat"
    chunk_num: int = 10  # k
    include_surroundings: int = 0
    sep_token_id: int = 0  # nonzero enables <sep> between chunk groups
    max_source_length: int = 512
    per_chunk_seq_len: int = 256  # row length of the per-chunk strategies
    max_new_tokens: int = 100
    embed_backend: str = "VT5"
    use_visual: bool = False  # feed the DiT visual tokens of the retrieved chunks
    reorder_chunks: bool = False  # top-k chunks into reading order before assembly

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


def reading_order(ret: RetrievalResult, batch: ChunkedBatch) -> RetrievalResult:
    """The top-k chunks in document reading order, ascending (page,
    slot_start), invalid rows kept at the end (the JAX
    `reading_order_device`): a stable sort, so ties keep their rank order."""
    start = torch.take_along_dim(batch.chunk_slot_start, ret.top_k_idx.long(), dim=1)
    W = batch.slot_mask.shape[1]
    key = ret.top_k_page.to(torch.int64) * (W + 1) + start.to(torch.int64)  # lexicographic (page, position)
    key = torch.where(ret.top_k_valid, key, torch.full_like(key, torch.iinfo(torch.int32).max))
    order = torch.argsort(key, dim=1, stable=True)
    take = lambda x: torch.take_along_dim(x, order, dim=1)
    return RetrievalResult(
        top_k_idx=take(ret.top_k_idx), top_k_valid=take(ret.top_k_valid), top_k_score=take(ret.top_k_score),
        top_k_page=take(ret.top_k_page), top_k_label=take(ret.top_k_label),
        top_k_box=torch.take_along_dim(ret.top_k_box, order[..., None], dim=1),
        similarities=ret.similarities,
    )


def majority_page(ret: RetrievalResult, weighted: bool, n_pages: int) -> torch.Tensor:
    """(B,) the page with the most (similarity-weighted) votes of the top-k
    chunks; `n_pages` is the batch's page cap, and a sample with no valid
    chunk votes page 0. The votes add rank by rank in a fixed order (no
    atomics), and the first maximum wins, as `jnp.argmax` takes it."""
    B, K = ret.top_k_page.shape
    w = torch.where(ret.top_k_valid, ret.top_k_score if weighted else torch.ones_like(ret.top_k_score), 0.0)
    pages = torch.arange(n_pages, device=w.device)[None, :]
    votes = torch.zeros((B, n_pages), dtype=w.dtype, device=w.device)
    for r in range(K):
        votes = votes + torch.where(ret.top_k_page[:, r:r + 1] == pages, w[:, r:r + 1], 0.0)
    return votes.argmax(dim=1)


def _assemble_full_doc(batch: ChunkedBatch, cfg: AssembleConfig):
    """All raw words of the document as one generator row (no retrieval)."""
    ntok = torch.where(batch.raw_mask, batch.raw_ntok, 0)
    return _flatten_tokens(batch.raw_tokens, ntok, (batch.raw_box * 1000).to(torch.int64), batch.raw_label,
                           batch.prompt_tokens, batch.prompt_len, cfg)


def decode_answers(tokenizer, tokens: np.ndarray, eos_id: int, pad_id: int) -> List[str]:
    """(N, T) decoded ids -> N answer strings: each row up to its EOS,
    pads dropped."""
    out = []
    for row in tokens:
        ids = []
        for t in row:
            if t == eos_id:
                break
            if t != pad_id:
                ids.append(int(t))
        out.append(tokenizer.decode(ids))
    return out


def topk_texts(owner: np.ndarray, aux: Dict[str, Any], valid: np.ndarray) -> List[List[str]]:
    """Compacted top-k chunk texts including surroundings: each sample's
    valid rows, the words its `owner` slots hold."""
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


def _timings(t: Dict[str, float]) -> Dict[str, float]:
    """The stage split from a call's clock times; "visual_s" with the visual branch."""
    out = {"retrieve_assemble_s": t["assemble"] - t["start"], "encode_s": t["encode"] - t["assemble"],
           "decode_s": t["decode"] - t["encode"]}
    if "visual" in t:
        out["visual_s"] = t["visual"] - t["assemble"]  # host crops and grid + the tower; part of encode_s
    return out


class RAGVT5Engine:
    """Host-facing engine: owns the parameters and the tokenizer."""

    def __init__(self, rag_cfg: RAGConfig, vt5_cfg: vt5m.VT5Config, params: vt5m.VT5Params, tokenizer,
                 reranker=None, nac=None):
        self.cfg = rag_cfg
        self.vt5_cfg = vt5_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.reranker = reranker  # engine.reranker.Reranker, or None
        self.nac = nac  # (models.nac.NACParams, threshold), or None
        self.device = params.t5.shared.device

    def _generate(self, gen, visual=None):
        """Encode, then decode: (tokens, confidences). Ends the call's encode
        stage and notes the decode's end at the tokens' copy."""
        with span("engine.encode"):
            embeds, mask = vt5m.input_embeds(self.params, self.vt5_cfg, gen, visual)
            device_count("encode.tokens_valid", mask)
            count("encode.positions", mask.numel())
            enc = t5m.encode(self.params.t5, self.vt5_cfg.t5, embeds, mask)
            self._clock.end("encode")
        with span("engine.decode"):
            tokens, conf = greedy_decode(self.params.t5, self.vt5_cfg.t5, enc, mask, self.cfg.max_new_tokens)
            tokens_np = tokens.cpu().numpy()  # waits for the decode
        self._clock.note("decode")
        return tokens_np, conf

    @torch.inference_mode()
    def inference(self, batch: ChunkedBatch, aux: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """`batch` as numpy (from DocVQAIngestor.ingest) or already on the
        device. Returns answers, confidences, pages and retrieval details."""
        cfg, dev = self.cfg, self.device
        strategy = cfg.page_retrieval
        batch = on_device(batch, dev)
        B = batch.batch_size
        clock = self._clock = stages.StageClock(dev)  # on the engine for `_generate`, whose signature stays
        if strategy == "none":
            with span("engine.assemble"):
                gen = _assemble_full_doc(batch, cfg.assemble())
                clock.end("assemble")
            tokens, conf = self._generate(gen)
            with span("engine.answers"):
                result = self._result(self._decode(tokens), conf.cpu().tolist(), [[0] for _ in range(B)], None,
                                      batch, aux)
            result["timings"] = _timings(clock.times)
            return result

        oracle = strategy == "oracle"
        with span("engine.retrieve"):
            ret = retrieve(self.params.t5.shared, batch, k=cfg.chunk_num, oracle=oracle)
            if self.reranker is not None and not oracle:
                clock.end("topk")
                ret = self.reranker(batch, ret)
                clock.end("rerank")
            if cfg.reorder_chunks and not oracle:
                ret = reading_order(ret, batch)
            clock.end("retrieve")  # retrieval ends here; the assembly counts as generation
        K = ret.top_k_idx.shape[1]
        acfg = cfg.assemble()
        visual = nac_probs = major = None
        with span("engine.assemble"):
            if strategy in ("oracle", "concat"):
                gen, owner = assemble_concat(batch, ret.top_k_idx, ret.top_k_valid, acfg)
                row_valid = None
            elif strategy in ("maxconf", "anyconf", "anyconforacle"):
                gen, owner, row_valid = assemble_per_chunk(batch, ret.top_k_idx, ret.top_k_valid, acfg,
                                                           seq_len=cfg.per_chunk_seq_len)
            elif strategy in ("maxconfpage", "anyconfpage"):
                gen = assemble_page_rows(batch, ret.top_k_page, ret.top_k_valid,
                                         AssembleConfig(max_source_length=cfg.max_source_length))
                owner = compute_ownership(batch, ret.top_k_idx, ret.top_k_valid, cfg.include_surroundings)
                row_valid = ret.top_k_valid
            else:  # majorpage, weightmajorpage
                major = majority_page(ret, strategy == "weightmajorpage", batch.page_slot_start.shape[1])
                gen = assemble_page_rows(batch, major[:, None], torch.ones((B, 1), dtype=torch.bool, device=dev),
                                         AssembleConfig(max_source_length=cfg.max_source_length))
                owner = compute_ownership(batch, ret.top_k_idx, ret.top_k_valid, cfg.include_surroundings)
                row_valid = None
            clock.end("assemble")
        if strategy in ("oracle", "concat"):
            visual = self._visual(batch, aux, owner, ret)
        tokens, conf = self._generate(gen, visual)

        with span("engine.answers"):
            if row_valid is None:
                answers, confs = self._decode(tokens), conf.cpu().tolist()
                if self.nac is not None and strategy in ("oracle", "concat"):
                    answers, confs, nac_probs = self._apply_nac(gen, answers, confs)
            else:
                answers, confs = self._select_rows(tokens, conf, row_valid, B, K, strategy.startswith("any"))

            # predicted pages: the GT page for the oracle modes, the vote's winner
            # for the majority modes, else the top-k pages
            valid_np = ret.top_k_valid.cpu().numpy()
            if oracle:
                pages = [[int(p)] for p in batch.answer_page.cpu().tolist()]
            elif strategy == "anyconforacle":
                pages = [[int(p)] * int(valid_np[b].sum()) for b, p in enumerate(batch.answer_page.cpu().tolist())]
            elif major is not None:
                pages = [int(p) for p in major.cpu().tolist()]
            else:
                pages_np = ret.top_k_page.cpu().numpy()
                pages = [pages_np[b][valid_np[b]].tolist() for b in range(B)]
            result = self._result(answers, confs, pages, ret, batch, aux, owner, nac_probs)
        t = clock.times
        result["retrieval"]["retrieval_time"] = t["retrieve"] - t["start"]
        result["retrieval"]["generation_time"] = t["decode"] - t["retrieve"]
        if self.reranker is not None:
            result["retrieval"]["rerank_time"] = t["rerank"] - t["topk"] if "rerank" in t else 0.0
        result["timings"] = _timings(t)
        return result

    def _visual(self, batch, aux, owner, ret) -> Optional[torch.Tensor]:
        """Visual tokens of the retrieved chunks: the top-k chunk boxes are
        cropped from their pages and grid-packed into one image per sample,
        which goes through the DiT tower and the matcher. Returns
        (B, 197, D) features, or None when the visual branch is off or the
        batch carries no page images."""
        if not (self.cfg.use_visual and self.vt5_cfg.use_visual and self.params.visual is not None):
            return None
        if aux is None or not aux.get("images") or aux["images"][0] is None:
            return None
        with span("engine.encode"):  # a part of the encode stage, with an end of its own inside it
            boxes = group_boxes(batch, owner, ret.top_k_idx.shape[1]).cpu().numpy()
            pages = ret.top_k_page.cpu().numpy()
            valid = ret.top_k_valid.cpu().numpy()
            size = self.vt5_cfg.vit.image_size
            images = []
            for b in range(batch.batch_size):
                page_imgs = aux["images"][b]
                crops = []
                for r in range(boxes.shape[1]):
                    if not valid[b, r] or page_imgs is None:
                        continue
                    img = page_imgs[pages[b, r]]
                    if img is None:
                        continue
                    crops.append(crop_box(np.asarray(img), boxes[b, r]))
                # the DiT feature extractor's normalisation: (x / 255 - 0.5) / 0.5
                img = resize_image(concatenate_patches_grid(crops), size, size) / 255.0
                images.append((img - 0.5) / 0.5)
            pixels = torch.from_numpy(np.stack(images).astype(np.float32)).to(self.device)
            visual = vt5m.visual_features(self.params, self.vt5_cfg, pixels)
            self._clock.end("visual")
            return visual

    def _apply_nac(self, gen, answers: List[str], confs: List[float]):
        """Not-answerable gating: the NAC sees the generator's input
        embeddings (semantic + spatial) and the predicted answers embedded
        through the shared table; answers above the threshold are blanked."""
        nac_params, threshold = self.nac
        shared = self.params.t5.shared
        input_emb = shared[gen.input_ids] + spatial_embed(self.params.spatial, self.vt5_cfg.spatial, gen.input_boxes)
        encoded = [self.tokenizer.encode(a or "") for a in answers]
        max_t = max(1, max(len(ids) for ids in encoded))
        ans_ids = np.zeros((len(answers), max_t), np.int64)
        ans_mask = np.zeros((len(answers), max_t), bool)
        for i, ids in enumerate(encoded):
            ans_ids[i, :len(ids)] = ids
            ans_mask[i, :len(ids)] = True
        ans_emb = shared[torch.from_numpy(ans_ids).to(self.device)]
        probs = nac_prob(nac_params, input_emb, ans_emb, input_mask=gen.attention_mask,
                         answer_mask=torch.from_numpy(ans_mask).to(self.device))
        return update_results(probs.float().cpu().numpy(), answers, confs, threshold)

    def _decode(self, tokens: np.ndarray) -> List[str]:
        return decode_answers(self.tokenizer, tokens, self.vt5_cfg.t5.eos_id, self.vt5_cfg.t5.pad_id)

    def _select_rows(self, tokens: np.ndarray, conf: torch.Tensor, row_valid: torch.Tensor, B: int, K: int,
                     keep_all: bool):
        """Rows b * K + r of sample b: maxconf keeps the valid row of the
        highest confidence (the first of equal ones), anyconf every valid
        row's answer; a sample with no valid row answers None."""
        answers_flat = self._decode(tokens)
        conf_np = conf.cpu().numpy().reshape(B, K)
        valid_np = row_valid.cpu().numpy().reshape(B, K)
        answers, confs = [], []
        for b in range(B):
            rows = np.where(valid_np[b])[0]
            if len(rows) == 0:
                answers.append(None)
                confs.append(None)
            elif keep_all:
                answers.append([answers_flat[b * K + r] for r in rows])
                confs.append([float(conf_np[b, r]) for r in rows])
            else:
                best = rows[np.argmax(conf_np[b, rows])]
                answers.append(answers_flat[b * K + best])
                confs.append(float(conf_np[b, best]))
        return answers, confs

    def _result(self, answers, confidences, pred_answer_pages, ret, batch, aux, owner=None, nac_probs=None):
        retrieval: Dict[str, Any] = {"page_indices": pred_answer_pages}
        if nac_probs is not None:
            retrieval["not_answerable_probs"] = nac_probs
        if ret is not None:
            K = ret.top_k_idx.shape[1]
            retrieval["similarities"] = ret.top_k_score.float().cpu().numpy()
            retrieval["top_k_layout_labels"] = ret.top_k_label.cpu().tolist()
            retrieval["boxes"] = group_boxes(batch, owner, K).cpu().numpy()
            if aux is not None and "slot_words" in aux:
                retrieval["text"] = topk_texts(owner.cpu().numpy(), aux, ret.top_k_valid.cpu().numpy())
        return {
            "pred_answers": answers,
            "confidences": confidences,
            "pred_answer_pages": pred_answer_pages,
            "retrieval": retrieval,
        }
