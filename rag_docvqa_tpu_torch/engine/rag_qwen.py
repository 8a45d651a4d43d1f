"""RAG with a decoder-only generator (the reference's Qwen2.5-VL path).

Counterpart of `rag_docvqa_tpu/engine/rag_qwen.py`: `QwenRAGConfig`, the
ChatML constants, `build_prompt`, `RAGQwenEngine` (`_retrieve`,
`retrieve_texts`, `_encode_crops`, `_assemble_prompts`, `inference`,
`build_sft_batch`) and `sft_step_loss`. The retrieval stack of RAG-VT5
(engine/rag_vt5.py::retrieve over the LM's own embedding table, or a frozen
`embed_shared`) picks the top-k chunks; the host joins their words into a
ChatML prompt (question + retrieved context, then one <|image_pad|> span per
retrieved crop when the visual path is on); models/causal_lm.py generates
16 new tokens greedily; "assistant:" echoes are stripped. SFT batches put
the answer after the prompt with labels -100 on the prompt and padding.

The visual path cuts the top-k chunk boxes from their page images on the
host (slices), resizes them on the device (`ops/resize.py`, the host
resize's weights) and runs the valid crops through either tower: the
Qwen2.5-VL tower (models/qwen25_vision.py, a config with
`fullatt_block_indexes`) or the stand-in (models/qwen_vision.py, through
K14). The crop embeddings stay on the device; the prompt assembly gathers
them into the placeholder positions. With a causal LM whose config sets
`mrope_section` (Qwen2.5-VL's M-RoPE), the prompt's (3, B, T) positions go
to `generate` with it: HF's `get_rope_index` for one image a span, each
image token at (t 0, h row, w column) of its merged grid plus the running
index, the text after a span from the span's largest index + 1, text tokens
equal on all three; padding 1.

`inference` returns the JAX engine's keys and "timings", the stage split of
the wall time: "retrieve_s", "crops_s" (host cuts, the upload, the device
resize and the tower), "assemble_s", "prefill_s", "decode_s", each ended on
the call's clock (`engine/stages.py`; the retrieve stage on the visual path
only, so that the crops have a stage of their own). With the tracer on (`profiling.py`):
the spans `engine.retrieve`, `engine.crops`, `engine.assemble`,
`engine.prefill`, `engine.decode` (a `decode.step` a step, both in
`causal_lm.generate`) and `engine.answers`; the host counters
`vision.crops` and `vision.tokens` (valid crops and their merged tokens) and
`prefill.positions` (the prompt's B x T), the device counters
`prefill.tokens_valid` and `prefill.image_tokens`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, on_device
from rag_docvqa_tpu_torch.engine import stages
from rag_docvqa_tpu_torch.engine.rag_vt5 import decode_answers, retrieve, topk_texts
from rag_docvqa_tpu_torch.models import causal_lm as clm
from rag_docvqa_tpu_torch.models import qwen25_vision, qwen_vision
from rag_docvqa_tpu_torch.ops.gather import compute_ownership


@dataclass(frozen=True)
class QwenRAGConfig:
    chunk_num: int = 10
    include_surroundings: int = 0
    max_prompt_tokens: int = 512
    max_new_tokens: int = 16
    answer_max_tokens: int = 24
    use_visual: bool = False
    max_crops: int = 4  # crops a sample fed to the tower


# ChatML (the Qwen2.5 chat template)
CHATML_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
CHATML_USER_OPEN = "<|im_start|>user\n"
CHATML_VISION_OPEN = "<|vision_start|>"
CHATML_VISION_CLOSE = "<|vision_end|>"
CHATML_IMAGE_PAD = "<|image_pad|>"
CHATML_USER_CLOSE = "<|im_end|>\n<|im_start|>assistant\n"
USER_TEXT_TEMPLATE = (
    "question: {question}\n"
    "Directly provide only a short direct answer to the question. "
    "The answer appears in the following context. Context: {context}"
)


def build_prompt(question: str, context_chunks: Sequence[str]) -> str:
    """Text-only ChatML prompt (no images)."""
    return (CHATML_SYSTEM + CHATML_USER_OPEN
            + USER_TEXT_TEMPLATE.format(question=question, context=" ".join(context_chunks))
            + CHATML_USER_CLOSE)


def _tower(v) -> Tuple[Callable, int, int]:
    """(encode, crop side in pixels, side of the square grid of merged
    tokens) of either tower's config."""
    if isinstance(v, qwen25_vision.Qwen25VisionConfig):
        return qwen25_vision.encode_image, v.image_size, v.image_size // v.patch_size // v.spatial_merge_size
    return qwen_vision.encode_images, v.vit.image_size, v.vit.image_size // v.vit.patch_size // v.merge_size


class RAGQwenEngine:
    def __init__(self, cfg: QwenRAGConfig, lm_cfg: clm.CausalLMConfig, params: clm.CausalLMParams, tokenizer,
                 embed_shared: Optional[torch.Tensor] = None, vision_cfg=None, vision_params=None):
        """`embed_shared` is the retrieval table (the LM's own embedding table
        when None: a fine-tune must pass a frozen copy, since SFT moves the
        LM's); `vision_cfg` either tower's config with its `vision_params`
        (JAX's `params["vision"]`)."""
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.vision_cfg = vision_cfg
        self.vision_params = vision_params
        tower = _tower(vision_cfg) if vision_cfg is not None else (None, 0, 0)
        self._encode_tower, self._crop_side, self._grid_side = tower
        self.embed_shared = embed_shared if embed_shared is not None else params.embed
        self.image_pad_id = tokenizer.encode(CHATML_IMAGE_PAD)[0]
        self.device = params.device

    # ------------------------------------------------------------------ #
    def _retrieve(self, batch: ChunkedBatch, aux: Dict[str, Any]):
        ret = retrieve(self.embed_shared, batch, k=self.cfg.chunk_num)
        owner = compute_ownership(batch, ret.top_k_idx, ret.top_k_valid, self.cfg.include_surroundings).cpu().numpy()
        valid = ret.top_k_valid.cpu().numpy()
        pages = ret.top_k_page.cpu().numpy()
        return ret, topk_texts(owner, aux, valid), [pages[b][valid[b]].tolist() for b in range(batch.batch_size)]

    def retrieve_texts(self, batch: ChunkedBatch, aux: Dict[str, Any]) -> Tuple[List[List[str]], List[List[int]]]:
        _, texts, pages = self._retrieve(on_device(batch, self.device), aux)
        return texts, pages

    # ------------------------------------------------------------------ #
    def _visual(self) -> bool:
        return self.cfg.use_visual and self.vision_cfg is not None and self.vision_params is not None

    def _encode_crops(self, batch: ChunkedBatch, aux: Dict[str, Any], ret):
        """The top-k chunk boxes cut from their pages, resized on the device,
        normalised to [-1, 1], the valid ones run through the tower: ((B,
        max_crops, Tv, D) on the device, zero rows for missing crops; (B,
        max_crops) crop validity), or (None, None) when the visual path is
        off or there are no images."""
        if not self._visual():
            return None, None
        if not aux.get("images") or all(imgs is None for imgs in aux["images"]):
            return None, None
        from rag_docvqa_tpu_torch.ops.patches import crop_box  # looked up at the call: the benchmark's tests wrap it
        from rag_docvqa_tpu_torch.ops.resize import resize_crops

        with profiling.span("engine.crops"):
            B, M = batch.batch_size, self.cfg.max_crops
            boxes = ret.top_k_box.cpu().numpy()
            pages = ret.top_k_page.cpu().numpy()
            valid = ret.top_k_valid.cpu().numpy()
            crops, slots = [], []
            crop_valid = np.zeros((B, M), bool)
            for b in range(B):
                page_imgs = aux["images"][b]
                if page_imgs is None:
                    continue
                m = 0
                for r in range(boxes.shape[1]):
                    if m >= M or not valid[b, r]:
                        continue
                    img = page_imgs[pages[b, r]]
                    if img is None:
                        continue
                    crop = crop_box(np.asarray(img), boxes[b, r])
                    if crop.size == 0:
                        continue
                    crops.append(crop)
                    slots.append(b * M + m)
                    crop_valid[b, m] = True
                    m += 1
            Tv = self._grid_side ** 2
            profiling.count("vision.crops", len(crops))
            profiling.count("vision.tokens", len(crops) * Tv)
            if crops:
                px = (resize_crops(crops, self._crop_side, self._crop_side, self.device) / 255.0 - 0.5) / 0.5
                got = self._encode_tower(self.vision_params, self.vision_cfg, px)
                embeds = got.new_zeros((B * M,) + tuple(got.shape[1:]))
                embeds[torch.tensor(slots, device=got.device)] = got
            else:
                embeds = torch.zeros((B * M, Tv, self.lm_cfg.d_model), device=self.device)
            return embeds.reshape(B, M, Tv, -1), crop_valid

    def _assemble_prompts(self, questions: List[str], texts: List[List[str]],
                          crop_embeds: Optional[torch.Tensor], crop_valid: Optional[np.ndarray] = None,
                          total_len: Optional[int] = None):
        """ChatML prompt ids with <|image_pad|> spans after the text: (ids,
        mask, visual_embeds (B, T, D) on the device, visual_mask (B, T)
        numpy, lens (B,), positions (3, B, T) int64), with (None, None) in
        place of the visual pair without crops; ids, mask and the positions
        (M-RoPE's, module docstring) as numpy. A span is clipped to the
        truncated prompt, so crop embeddings never land on answer tokens of
        an SFT layout."""
        tk = self.tokenizer
        B = len(questions)
        T = total_len or self.cfg.max_prompt_tokens
        ids = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), bool)
        vmask = np.zeros((B, T), bool)
        src = np.zeros((B, T), np.int64)  # each visual position's row of the (M * Tv) crop embeddings
        lens = np.zeros((B,), np.int32)
        positions = np.ones((3, B, T), np.int64)
        open_ids = tk.encode(CHATML_SYSTEM + CHATML_USER_OPEN)
        vopen, vclose = tk.encode(CHATML_VISION_OPEN), tk.encode(CHATML_VISION_CLOSE)
        close_ids = tk.encode(CHATML_USER_CLOSE)
        Tv = crop_embeds.shape[2] if crop_embeds is not None else 0
        if Tv:
            g = self._grid_side
            cell = np.stack([np.zeros(Tv, np.int64), np.arange(Tv) // g, np.arange(Tv) % g])  # (t, h, w)
        for b in range(B):
            seq: List[int] = list(open_ids)
            spans: List[Tuple[int, int]] = []  # (start position, crop index)
            seq += tk.encode(USER_TEXT_TEMPLATE.format(question=questions[b], context=" ".join(texts[b])))
            if crop_embeds is not None:
                for m in range(crop_embeds.shape[1]):
                    if crop_valid is not None and not crop_valid[b, m]:
                        continue
                    seq += vopen
                    spans.append((len(seq), m))
                    seq += [self.image_pad_id] * Tv
                    seq += vclose
            seq += close_ids
            seq = seq[: min(T, self.cfg.max_prompt_tokens)]
            ids[b, : len(seq)] = seq
            mask[b, : len(seq)] = True
            lens[b] = len(seq)
            at = nxt = 0  # the next text position and its index
            for start, m in spans:
                end = min(start + Tv, len(seq))
                if end <= start:
                    continue
                vmask[b, start:end] = True
                src[b, start:end] = m * Tv + np.arange(end - start)
                positions[:, b, at:start] = nxt + np.arange(start - at)
                nxt += start - at
                positions[:, b, start:end] = nxt + cell[:, :end - start]
                nxt = int(positions[:, b, start:end].max()) + 1
                at = end
            positions[:, b, at:len(seq)] = nxt + np.arange(len(seq) - at)
        if crop_embeds is None:
            return ids, mask, None, None, lens, positions
        flat = crop_embeds.reshape(B, -1, crop_embeds.shape[-1])
        idx = torch.from_numpy(src).to(flat.device)[..., None].expand(B, T, flat.shape[-1])
        vm = torch.from_numpy(vmask).to(flat.device)
        vemb = torch.where(vm[..., None], torch.gather(flat, 1, idx), torch.zeros((), dtype=flat.dtype,
                                                                                   device=flat.device))
        return ids, mask, vemb, vmask, lens, positions

    def _answers(self, tokens: np.ndarray) -> List[str]:
        texts = decode_answers(self.tokenizer, tokens, self.lm_cfg.eos_id, self.lm_cfg.pad_id)
        return [t.split("assistant:")[-1].replace("<|im_end|>", "").strip() for t in texts]  # chat-template echoes

    @torch.inference_mode()
    def inference(self, batch: ChunkedBatch, aux: Dict[str, Any]) -> Dict[str, Any]:
        dev = self.device
        batch = on_device(batch, dev)
        clock = stages.StageClock(dev)
        with profiling.span("engine.retrieve"):
            ret, texts, pages = self._retrieve(batch, aux)
            (clock.end if self._visual() else clock.note)("retrieve")  # a stage of its own before crops only
        crop_embeds, crop_valid = self._encode_crops(batch, aux, ret)
        clock.end("crops")
        with profiling.span("engine.assemble"):
            ids, mask, vemb, vmask, _, positions = self._assemble_prompts(aux["questions"], texts, crop_embeds,
                                                                          crop_valid)
            ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
            vmask_t = torch.from_numpy(vmask).to(dev) if vemb is not None else None
            pos_t = torch.from_numpy(positions).to(dev) if self.lm_cfg.mrope_section else None
            profiling.count("prefill.positions", ids.size)
            profiling.device_count("prefill.tokens_valid", mask_t)
            if vmask_t is not None:
                profiling.device_count("prefill.image_tokens", vmask_t)
            clock.end("assemble")
        tokens, conf = clm.generate(self.params, self.lm_cfg, ids_t, mask_t, self.cfg.max_new_tokens,
                                    visual_embeds=vemb, visual_mask=vmask_t, end_stage=clock.end, positions=pos_t)
        with profiling.span("engine.answers"):
            answers = self._answers(tokens.cpu().numpy())
            confidences = conf.cpu().tolist()
        t = clock.times
        return {
            "pred_answers": answers,
            "confidences": confidences,
            "pred_answer_pages": pages,
            "retrieval": {"page_indices": pages, "text": texts},
            "timings": {"retrieve_s": t["retrieve"] - t["start"], "crops_s": t["crops"] - t["retrieve"],
                        "assemble_s": t["assemble"] - t["crops"], "prefill_s": t["prefill"] - t["assemble"],
                        "decode_s": t["decode"] - t["prefill"]},
        }

    # ------------------------------------------------------------------ #
    def build_sft_batch(self, batch: ChunkedBatch, aux: Dict[str, Any], seed: int = 0):
        """(ids, mask, labels[, visual_embeds, visual_mask]) on the device,
        labels -100 on the prompt: each sample's answer (one of its answers,
        drawn by numpy's RandomState(seed)), then EOS, after its prompt."""
        rng = np.random.RandomState(seed)
        batch = on_device(batch, self.device)
        ret, texts, _ = self._retrieve(batch, aux)
        crop_embeds, crop_valid = self._encode_crops(batch, aux, ret)
        T = self.cfg.max_prompt_tokens + self.cfg.answer_max_tokens
        B = batch.batch_size
        ids, mask, vemb, vmask, lens, _ = self._assemble_prompts(aux["questions"], texts, crop_embeds, crop_valid,
                                                                 total_len=T)
        if vemb is not None and self.lm_cfg.mrope_section:
            raise NotImplementedError("SFT batches with crops under M-RoPE: the loss takes no (3, B, T) positions")
        labels = np.full((B, T), -100, np.int32)
        for b in range(B):
            plen = min(int(lens[b]), self.cfg.max_prompt_tokens)
            answers = aux["answers"][b] or [""]
            ans = answers[rng.randint(len(answers))]
            ans_ids = self.tokenizer.encode(" " + ans)[: self.cfg.answer_max_tokens - 1] + [self.lm_cfg.eos_id]
            end = min(plen + len(ans_ids), T)
            ids[b, plen:end] = ans_ids[: end - plen]
            mask[b, plen:end] = True
            labels[b, plen:end] = ans_ids[: end - plen]
        out = tuple(torch.from_numpy(a).to(self.device) for a in (ids, mask, labels))
        if vemb is not None:
            return out + (vemb, torch.from_numpy(vmask).to(self.device))
        return out


def sft_step_loss(params: clm.CausalLMParams, lm_cfg: clm.CausalLMConfig, ids, mask, labels) -> torch.Tensor:
    return clm.sft_loss(params, lm_cfg, ids, mask, labels)
