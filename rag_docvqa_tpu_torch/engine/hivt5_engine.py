"""Hi-VT5 engine: the standard inference interface over the hierarchical model.

Counterpart of `rag_docvqa_tpu/engine/hivt5_engine.py` (`HiVT5Engine`:
`inference`, `_page_visual`), so the evaluation loop drives
Hi-VT5 exactly as it drives the RAG engines. The JAX engine turns its
`flash_encoder` option on for the per-page encode; the port's encoder always
runs K1's parts with K2 inside, so there is no flag to set. Encode and the
page head, then the greedy decode, run as eager calls on the parameters'
device through `models/hivt5.py::generate`; the result carries the JAX
engine's keys and, beside them, the stage split of the wall time under
"timings".
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, to_device
from rag_docvqa_tpu_torch.engine.rag_vt5 import _sync, decode_answers
from rag_docvqa_tpu_torch.models import hivt5 as hivt5m
from rag_docvqa_tpu_torch.ops.patches import resize_image
from rag_docvqa_tpu_torch.profiling import span


class HiVT5Engine:
    def __init__(self, cfg: hivt5m.HiVT5Config, params: hivt5m.HiVT5Params, tokenizer, max_new_tokens: int = 32):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.device = params.t5.shared.device

    def _page_visual(self, batch: ChunkedBatch, aux: Optional[Dict[str, Any]],
                     mark: Optional[Callable[[str], None]] = None):
        """Per-page visual tokens: ((B, P, Tv, D), (B, P) validity), or (None,
        None) when the visual branch is off or the batch carries no image.
        Every page render is resized and normalised on the host as the ViT
        feature extractor does, then the tower, the matcher and the
        visual-box spatial embedding run on the device; pages without a
        render are masked. `mark("visual_host")`, when given, is called
        between the two halves."""
        pixels = None
        if self.cfg.use_visual and self.params.visual is not None and aux is not None and aux.get("images") \
                and any(imgs is not None for imgs in aux["images"]):
            B, P = batch.batch_size, self.cfg.max_doc_pages
            size = self.cfg.vit.image_size
            pixels = np.zeros((B * P, size, size, 3), np.float32)
            valid = np.zeros((B, P), bool)
            for b in range(B):
                page_imgs = aux["images"][b] or []
                for p in range(min(P, len(page_imgs))):
                    if page_imgs[p] is None:
                        continue
                    img = resize_image(np.asarray(page_imgs[p]), size, size) / 255.0
                    pixels[b * P + p] = (img - 0.5) / 0.5
                    valid[b, p] = True
        if mark is not None:
            mark("visual_host")
        if pixels is None:
            return None, None
        vis = hivt5m.page_visual_features(self.params, self.cfg, torch.from_numpy(pixels).to(self.device))
        return vis.reshape(B, P, vis.shape[1], vis.shape[2]), torch.from_numpy(valid).to(self.device)

    @torch.inference_mode()
    def inference(self, batch: ChunkedBatch, aux: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """`batch` as numpy (from DocVQAIngestor.ingest) or already on the
        device. Returns answers, confidences, the predicted pages and the
        retrieval record of the JAX engine ("page_indices" are the predicted
        pages; "retrieval_time" is 0), with "timings": "visual_host_s" (the
        copy to the device and the host resize of the renders), "visual_s"
        (those and the tower), "encode_s" (all of that, the encode and the
        page head) and "decode_s"."""
        t0 = time.perf_counter()
        if not isinstance(batch.chunk_mask, torch.Tensor):
            batch = to_device(batch, self.device)
        marks = {}

        def mark(stage: str) -> None:
            _sync(self.device)
            marks[stage] = time.perf_counter()

        # a stage's spans: the visual branch and `generate`'s encode are
        # `engine.encode`; `generate`'s decode and the copy of its tokens,
        # `engine.decode`
        with span("engine.encode"):
            page_visual, page_visual_valid = self._page_visual(batch, aux, mark)
            mark("visual")
        tokens, conf, pred_page = hivt5m.generate(self.params, self.cfg, batch, self.max_new_tokens, page_visual,
                                                  page_visual_valid, mark=mark)
        with span("engine.decode"):
            tokens_np = tokens.cpu().numpy()  # waits for the decode
        t2 = time.perf_counter()
        with span("engine.answers"):
            pages = [int(p) for p in pred_page.cpu()]
            answers = decode_answers(self.tokenizer, self.cfg.t5, tokens_np)
            confidences = conf.cpu().tolist()
        return {
            "pred_answers": answers,
            "confidences": confidences,
            "pred_answer_pages": pages,
            "retrieval": {"page_indices": pages, "retrieval_time": 0.0,
                          "generation_time": time.perf_counter() - t0},
            "timings": {"visual_host_s": marks["visual_host"] - t0, "visual_s": marks["visual"] - t0,
                        "encode_s": marks["encode"] - t0, "decode_s": t2 - marks["encode"]},
        }
