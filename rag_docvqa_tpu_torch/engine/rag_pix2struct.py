"""RAG-Pix2Struct: the OCR-free visual retrieve-then-answer engine.

Counterpart of `rag_docvqa_tpu/engine/rag_pix2struct.py`, whole:
`P2SRAGConfig`, `PreparedDoc`, `VisualIndex`, `RAGPix2StructEngine` with
`prepare_doc(s)`, `retrieve`, `inference`, `inference_stream`,
`build_visual_index`, `inference_indexed` and `no_rag_max_conf`, and the host
geometry helpers. Pages -> image chunks -> Pix2Struct-encoder patch
embeddings -> late-interaction MaxSim against the rendered question -> top-k
chunks + surrounding pattern -> merged crops -> packed crops + question
header -> Pix2Struct generate.

Device work, on the parameters' device: the patch-set encoding
(models/pix2struct.py::vision_encode: K1 bias-free, K13 above 1024 patches),
MaxSim (ops/late_interaction.py, K15), the top-k and the generation (K3 in
the decoder when the config asks). Host work: image chunk grids, crop and
merge of retrieved regions, patch packing with row offsets (ops/patches.py).

The wire dtype of the patches is float16 when the weights are bf16 and the
patch budgets stay within 2048 (row and column ids ride in that array and
are exact integers up to 2048 in f16), else float32; `vision_encode` casts
to the parameter dtype on the device either way. `_indexed_retrieve_pack`
adds its chained row offsets in the wire dtype, as the JAX function does.

`inference_stream` prepares batch i+1 on a prefetch thread and fetches each
batch's tokens one batch late: the decode is enqueued on the device without
a host sync (ops/decode.py), so the `.cpu()` of `_finalize` is the only wait.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rag_docvqa_tpu_torch.data.contract import RawDocument
from rag_docvqa_tpu_torch.models import pix2struct as p2s
from rag_docvqa_tpu_torch.ops.late_interaction import late_interaction
from rag_docvqa_tpu_torch.ops.patches import (
    divide_image_into_layout_patches,
    divide_image_into_patches,
    extract_flattened_patches,
    pack_multi_image_patches,
    render_text,
)
from rag_docvqa_tpu_torch.ops.topk import masked_topk


@dataclass(frozen=True)
class P2SRAGConfig:
    chunk_num: int = 10  # k retrieved chunks
    include_surroundings: Union[int, Tuple[int, int]] = 0
    # square | horizontal | page grid modes, or "layout": crop layout regions
    # first (text regions subdivide at image_patch_size, figures and tables
    # stay whole); pages without layout info fall back to the grid mode below
    chunk_mode: str = "horizontal"
    layout_fallback_mode: str = "horizontal"
    image_patch_size: int = 256  # pixels per image chunk strip
    chunk_overlap: bool = True  # half-patch overlap
    patches_per_chunk: int = 128  # Pix2Struct patches per image chunk
    max_chunks: int = 64  # cap on image chunks per document
    max_total_patches: int = 1024  # generator patch budget
    max_new_tokens: int = 32
    use_rag: bool = True


@dataclass
class PreparedDoc:
    """Query-independent host preprocessing of one document: its image
    chunks extracted to flattened Pix2Struct patch sets, computed once per
    document (at ingest)."""

    coords: list  # (page, grid, row, col) per chunk
    xyxy: list  # page-frame pixel boxes per chunk
    shapes: list  # (rows, cols) per grid
    patches: np.ndarray  # (n, T, 2+D) wire dtype, n = min(chunks, max_chunks)
    tok_mask: np.ndarray  # (n, T) f32
    chunk_rows: np.ndarray  # (n,) int32: each chunk's patch-grid row count
    chunk_page: np.ndarray  # (n,) int32
    images: Sequence  # page renders (crop-merge and fallback path)

    @property
    def n_chunks(self) -> int:
        return self.patches.shape[0]


@dataclass
class VisualIndex:
    """Device-resident visual retrieval index over a corpus of prepared
    documents: the patch-token embeddings for MaxSim and the flattened patch
    pixels themselves, so a query never ships or extracts page imagery."""

    emb: torch.Tensor  # (Nd, mc, T, H)
    tok_mask: torch.Tensor  # (Nd, mc, T) f32
    patches: torch.Tensor  # (Nd, mc, T, 2+D) wire dtype
    chunk_valid: torch.Tensor  # (Nd, mc) bool
    chunk_rows: torch.Tensor  # (Nd, mc) int64
    chunk_page: torch.Tensor  # (Nd, mc) int64
    mc: int


def _score_topk(patch_emb, patch_tok_mask, q_emb, q_tok_mask, chunk_valid, k: int):
    scores = late_interaction(q_emb, patch_emb, query_mask=q_tok_mask, patch_mask=patch_tok_mask)
    return masked_topk(scores, chunk_valid, k)


def _indexed_retrieve_pack(params, cfg: p2s.Pix2StructConfig, index: VisualIndex, q_patches, q_mask, doc_ids,
                           header_rows, k: int, g: int, T: int):
    """Device-side query: encode the rendered questions (B, T, F), MaxSim
    against the resident index, top-k, and pack the generator input by
    gathering the g best chunks' resident patch sets with chained row offsets
    (header first, then each selected chunk's grid:
    `pack_multi_image_patches`' continued-row-offset rule). Returns
    (gen_patches (B, (g+1)*T, F), gen_mask, vals, idx, valid, pages)."""
    q_emb = p2s.vision_encode(params, cfg, q_patches, q_mask)
    tokm_d = index.tok_mask[doc_ids]  # (B, mc, T)
    scores = late_interaction(q_emb, index.emb[doc_ids], query_mask=q_mask, patch_mask=tokm_d)
    vals, idx, valid = masked_topk(scores, index.chunk_valid[doc_ids], k)

    sel, sel_valid = idx[:, :g], valid[:, :g]  # (B, g)
    B = q_patches.shape[0]
    wire = index.patches.dtype
    sel_patches = index.patches[doc_ids[:, None], sel]  # (B, g, T, F)
    sel_tokm = torch.gather(tokm_d, 1, sel[:, :, None].expand(-1, -1, T)) * sel_valid[:, :, None]
    sel_rows = torch.where(sel_valid, index.chunk_rows[doc_ids[:, None], sel], 0)
    offs = header_rows[:, None] + torch.cumsum(sel_rows, dim=1) - sel_rows  # (B, g)
    row_col = (sel_patches[..., 0] + offs[:, :, None].to(wire)) * sel_tokm.to(wire)  # padding rows stay 0
    sel_patches = torch.cat([row_col[..., None], sel_patches[..., 1:] * sel_tokm[..., None].to(wire)], dim=-1)
    gen_patches = torch.cat([q_patches, sel_patches.reshape(B, g * T, -1)], dim=1)
    gen_mask = torch.cat([q_mask, sel_tokm.reshape(B, g * T)], dim=1)
    pages = torch.where(sel_valid, index.chunk_page[doc_ids[:, None], sel], -1)
    return gen_patches, gen_mask, vals, idx, valid, pages


class RAGPix2StructEngine:
    def __init__(self, cfg: P2SRAGConfig, p2s_cfg: p2s.Pix2StructConfig, params: p2s.P2SParams, tokenizer):
        bf16_weights = params.vision.patch_w.dtype == torch.bfloat16
        budgets_ok = max(cfg.max_total_patches, cfg.patches_per_chunk) <= 2048
        self._xfer = np.float16 if (bf16_weights and budgets_ok) else np.float32
        self.cfg = cfg
        self.p2s_cfg = p2s_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params.vision.patch_w.device

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _generate(self, patches: torch.Tensor, masks: torch.Tensor):
        return p2s.generate(self.params, self.p2s_cfg, patches, masks, self.cfg.max_new_tokens)

    # ------------------------------------------------------------------ #
    def _chunk_pages(self, images: Sequence[np.ndarray], layouts=None):
        """Host: pages -> image chunks + (page, grid, row, col) coords +
        page-frame pixel boxes + per-grid matrix shapes. A grid is one patch
        matrix: the whole page in the grid modes, one layout region in
        layout mode. Surrounding-pattern expansion happens within a grid."""
        cfg = self.cfg
        chunks, coords, xyxy, shapes = [], [], [], []

        def add_grid(page_idx, patches, shape, boxes):
            gid = len(shapes)
            shapes.append(shape)
            cols = shape[1]
            for i, (patch, box) in enumerate(zip(patches, boxes)):
                chunks.append(patch)
                coords.append((page_idx, gid, i // cols, i % cols))
                xyxy.append(box)

        for page_idx, img in enumerate(images):
            img = np.asarray(img)
            lay = layouts[page_idx] if layouts is not None and page_idx < len(layouts) else None
            if cfg.chunk_mode == "layout" and lay and len(lay.get("boxes", [])):
                groups = divide_image_into_layout_patches(
                    img, lay["boxes"], lay["labels"], lay.get("clusters"),
                    patch_size=cfg.image_patch_size, overlap=cfg.chunk_overlap, mode=cfg.layout_fallback_mode)
                for patches, shape, boxes in groups:
                    add_grid(page_idx, patches, shape, boxes)
                if groups:
                    continue
            mode = cfg.chunk_mode if cfg.chunk_mode != "layout" else cfg.layout_fallback_mode
            patches, shape, boxes = divide_image_into_patches(img, cfg.image_patch_size, cfg.chunk_overlap, mode)
            add_grid(page_idx, patches, shape, boxes)
        return chunks, coords, xyxy, shapes

    # ------------------------------------------------------------------ #
    def prepare_doc(self, images: Sequence[np.ndarray], layouts=None) -> PreparedDoc:
        """Host: one document's query-independent preprocessing: chunk the
        page renders and extract flattened patch sets in the wire dtype."""
        cfg = self.cfg
        T = cfg.patches_per_chunk
        F = 2 + self.p2s_cfg.vision.patch_dim
        chunks, coords, xyxy, shapes = self._chunk_pages(images, layouts)
        n = min(len(chunks), cfg.max_chunks)
        patches = np.zeros((n, T, F), self._xfer)
        tok_mask = np.zeros((n, T), np.float32)
        chunk_rows = np.zeros((n,), np.int32)
        for i in range(n):
            flat, max_row = extract_flattened_patches(chunks[i], T, pad=True, normalize=True)
            patches[i] = flat
            tok_mask[i] = flat[:, 0] > 0
            chunk_rows[i] = max_row
        chunk_page = np.asarray([coords[i][0] for i in range(n)], np.int32)
        return PreparedDoc(coords=coords, xyxy=xyxy, shapes=shapes, patches=patches, tok_mask=tok_mask,
                           chunk_rows=chunk_rows, chunk_page=chunk_page, images=images)

    def prepare_docs(self, images_list, layouts_list=None) -> List[PreparedDoc]:
        return [self.prepare_doc(imgs, layouts_list[b] if layouts_list else None)
                for b, imgs in enumerate(images_list)]

    def _render_question(self, question: str):
        """(T, F) wire-dtype patch set, its mask and the grid row count of
        the rendered question."""
        T = self.cfg.patches_per_chunk
        q_flat, max_row = extract_flattened_patches(render_text(question), T, pad=True, normalize=True)
        return q_flat.astype(self._xfer, copy=False), (q_flat[:, 0] > 0).astype(np.float32), max_row

    def _chunk_cap(self, n_per_doc) -> int:
        """The chunk axis of a batch: the batch's largest real chunk count,
        at least 16 and chunk_num (the top-k needs k <= mc), rounded up to a
        power of two, at most max_chunks."""
        floor = max(16, self.cfg.chunk_num, max(n_per_doc), 1)
        return min(self.cfg.max_chunks, 1 << (floor - 1).bit_length())

    # ------------------------------------------------------------------ #
    def retrieve(self, question: str, images: Sequence[np.ndarray], layouts=None):
        """Single-document retrieval with step info. Returns (merged crops,
        page indices, scores, steps dict)."""
        crops, pages, vals, steps = self._retrieve_batch([question], [images], return_steps=True,
                                                         layouts_list=[layouts])
        return crops[0], pages[0], vals[0], steps[0]

    @torch.inference_mode()
    def _retrieve_batch(self, questions: Sequence[str], images_list: Sequence[Sequence[np.ndarray]],
                        return_steps: bool = False, layouts_list=None,
                        prepared: Optional[List[PreparedDoc]] = None):
        """Batched retrieval: one vision encode for every document's image
        chunks and every question, one batched MaxSim + top-k. `prepared`
        skips the chunk + extract host stage."""
        cfg = self.cfg
        B = len(questions)
        T = cfg.patches_per_chunk
        F = 2 + self.p2s_cfg.vision.patch_dim
        if prepared is None:
            prepared = self.prepare_docs(images_list, layouts_list)
        n_per_doc = [p.n_chunks for p in prepared]
        mc = self._chunk_cap(n_per_doc)

        # chunks and questions share one (B*mc + B, T, F) array in the wire dtype
        stacked = np.zeros((B * mc + B, T, F), self._xfer)
        stacked_mask = np.zeros((B * mc + B, T), np.float32)
        chunk_valid = np.zeros((B, mc), bool)
        for b, prep in enumerate(prepared):
            n = n_per_doc[b]
            stacked[b * mc: b * mc + n] = prep.patches[:n]
            stacked_mask[b * mc: b * mc + n] = prep.tok_mask[:n]
            chunk_valid[b, :n] = True
            q_flat, q_m, _ = self._render_question(questions[b])
            stacked[B * mc + b] = q_flat
            stacked_mask[B * mc + b] = q_m

        mask_d = self._dev(stacked_mask)
        emb = p2s.vision_encode(self.params, self.p2s_cfg, self._dev(stacked), mask_d)
        patch_emb = emb[: B * mc].reshape(B, mc, T, -1)
        vals, idx, valid = _score_topk(patch_emb, mask_d[: B * mc].reshape(B, mc, T), emb[B * mc:],
                                       mask_d[B * mc:], self._dev(chunk_valid), cfg.chunk_num)
        idx, valid, vals = idx.cpu().numpy(), valid.cpu().numpy(), vals.float().cpu().numpy()

        all_crops, all_pages, all_steps = [], [], []
        for b, prep in enumerate(prepared):
            # surrounding-pattern expansion within each patch grid (host)
            coords, xyxy, shapes = prep.coords, prep.xyxy, prep.shapes
            surround: set = set()
            for r in range(cfg.chunk_num):
                if not valid[b, r] or idx[b, r] >= len(coords):
                    continue
                page_idx, gid, row, col = coords[idx[b, r]]
                rows, cols = shapes[gid]
                for rc in _surrounding_coords((row, col), (rows, cols), cfg.include_surroundings):
                    surround.add((page_idx, gid, *rc))
            all_crops.append(_merge_overlapping(sorted(surround), xyxy, coords, prep.images))
            all_pages.append(sorted({p for p, _, _, _ in surround}))
            if return_steps:
                all_steps.append({"n_chunks": len(coords), "coords": coords, "xyxy": xyxy})
        return all_crops, all_pages, vals, all_steps

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _dispatch_batch(self, docs, prepared: Optional[List[PreparedDoc]] = None):
        """Retrieve + pack + enqueue generate, without fetching the result.
        Returns (tokens, conf, pred_pages) with tokens and conf still on the
        device, so a caller can overlap the decode with the next batch's host
        work."""
        cfg = self.cfg
        images_list = []
        for doc in docs:
            if doc.images is None:
                raise ValueError("RAGPix2Struct needs page images")
            images_list.append([np.asarray(im) for im in doc.images if im is not None])

        if cfg.use_rag:
            all_crops, pred_pages, _, _ = self._retrieve_batch(
                [d.question for d in docs], images_list, layouts_list=[d.layout for d in docs], prepared=prepared)
            for b, images in enumerate(images_list):
                if not all_crops[b]:
                    all_crops[b] = images  # fallback: all pages
                    pred_pages[b] = list(range(len(images)))
        else:
            all_crops = images_list
            pred_pages = [list(range(len(imgs))) for imgs in images_list]

        all_patches, all_masks = [], []
        for doc, crops in zip(docs, all_crops):
            flat, mask = pack_multi_image_patches(crops, cfg.max_total_patches, normalize=True,
                                                  header=render_text(doc.question))
            all_patches.append(flat)
            all_masks.append(mask)
        patches = self._dev(np.stack(all_patches).astype(self._xfer, copy=False))
        tokens, conf = self._generate(patches, self._dev(np.stack(all_masks)))
        return tokens, conf, pred_pages

    def _finalize(self, tokens, conf, pred_pages) -> Dict[str, Any]:
        return {
            "pred_answers": self._decode(tokens),
            "confidences": conf.cpu().tolist(),
            "pred_answer_pages": pred_pages,
            "retrieval": {"page_indices": pred_pages},
        }

    def inference(self, docs, aux: Optional[Dict[str, Any]] = None,
                  prepared: Optional[List[PreparedDoc]] = None) -> Dict[str, Any]:
        """Batch inference; each document needs `images` (page renders).
        Takes a list of RawDocuments, or the evaluate loop's (batch, aux)
        pair: then questions, images and layouts come from aux (the token
        batch is not used). `prepared` (from prepare_docs) skips the chunk +
        extract host stage."""
        if aux is not None:
            layouts_aux = aux.get("layouts", [None] * len(aux["questions"]))
            docs = [RawDocument(question=q, words=[[]], boxes=[[]], images=imgs, layout=lay)
                    for q, imgs, lay in zip(aux["questions"], aux["images"], layouts_aux)]
        return self._finalize(*self._dispatch_batch(docs, prepared=prepared))

    def inference_stream(self, doc_batches, depth: int = 2):
        """Pipelined serving over an iterable of RawDocument batches: the
        query-independent prepare runs on a prefetch thread for batch i+1
        while the main thread retrieves and packs batch i, and each batch's
        tokens are fetched one batch late, so its decode overlaps the next
        batch's host pack. Yields one `inference` result per batch, in order."""
        from rag_docvqa_tpu_torch.data.prefetch import prefetch

        def _prepare_stream():
            for docs in doc_batches:
                images_list = [[np.asarray(im) for im in d.images if im is not None] for d in docs]
                yield docs, self.prepare_docs(images_list, [d.layout for d in docs])

        pending = None
        for docs, prepared in prefetch(_prepare_stream(), depth=depth):
            handles = self._dispatch_batch(docs, prepared=prepared)
            if pending is not None:
                yield self._finalize(*pending)
            pending = handles
        if pending is not None:
            yield self._finalize(*pending)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def build_visual_index(self, prepared_docs: List[PreparedDoc]) -> VisualIndex:
        """Encode every prepared document's patch sets once into a
        device-resident index (embeddings for MaxSim and the patch pixels
        for generation); see `inference_indexed`."""
        T = self.cfg.patches_per_chunk
        F = 2 + self.p2s_cfg.vision.patch_dim
        Nd = len(prepared_docs)
        mc = self._chunk_cap([p.n_chunks for p in prepared_docs])

        patches = np.zeros((Nd, mc, T, F), self._xfer)
        tok_mask = np.zeros((Nd, mc, T), np.float32)
        chunk_valid = np.zeros((Nd, mc), bool)
        chunk_rows = np.zeros((Nd, mc), np.int64)
        chunk_page = np.zeros((Nd, mc), np.int64)
        for d, prep in enumerate(prepared_docs):
            n = min(prep.n_chunks, mc)
            patches[d, :n] = prep.patches[:n]
            tok_mask[d, :n] = prep.tok_mask[:n]
            chunk_valid[d, :n] = True
            chunk_rows[d, :n] = prep.chunk_rows[:n]
            chunk_page[d, :n] = prep.chunk_page[:n]

        dev_patches, dev_mask = self._dev(patches), self._dev(tok_mask)
        emb = p2s.vision_encode(self.params, self.p2s_cfg, dev_patches.reshape(Nd * mc, T, F),
                                dev_mask.reshape(Nd * mc, T)).reshape(Nd, mc, T, -1)
        return VisualIndex(emb=emb, tok_mask=dev_mask, patches=dev_patches, chunk_valid=self._dev(chunk_valid),
                           chunk_rows=self._dev(chunk_rows), chunk_page=self._dev(chunk_page), mc=mc)

    @torch.inference_mode()
    def inference_indexed(self, questions: Sequence[str], doc_ids: Sequence[int],
                          index: VisualIndex) -> Dict[str, Any]:
        """Query a prebuilt VisualIndex: the host renders the questions;
        retrieval, generator-input packing (gathers over the resident patch
        sets with chained row offsets) and generation run on the device. The
        packing reuses the strip-resolution patches as they are instead of
        re-extracting merged crops; the retrieval (MaxSim top-k) is the same.
        `include_surroundings` needs the host path."""
        cfg = self.cfg
        T = cfg.patches_per_chunk
        B = len(questions)
        if len(doc_ids) != B:
            raise ValueError(f"{B} questions for {len(doc_ids)} document ids")
        # generator budget: one T-slot grid for the question header + g chunk
        # grids; g is also capped by k (only k chunks are retrieved)
        g = min(max(cfg.max_total_patches // T - 1, 1), index.mc, cfg.chunk_num)

        q_patches = np.zeros((B, T, 2 + self.p2s_cfg.vision.patch_dim), self._xfer)
        q_mask = np.zeros((B, T), np.float32)
        header_rows = np.zeros((B,), np.int64)
        for b, q in enumerate(questions):
            q_patches[b], q_mask[b], header_rows[b] = self._render_question(q)

        gen_patches, gen_mask, vals, idx, valid, pages = _indexed_retrieve_pack(
            self.params, self.p2s_cfg, index, self._dev(q_patches), self._dev(q_mask),
            self._dev(np.asarray(doc_ids, np.int64)), self._dev(header_rows), cfg.chunk_num, g, T)
        tokens, conf = self._generate(gen_patches, gen_mask)
        pred_pages = [sorted({int(p) for p in row if p >= 0}) for row in pages.cpu().numpy()]
        return {
            "pred_answers": self._decode(tokens),
            "confidences": conf.cpu().tolist(),
            "pred_answer_pages": pred_pages,
            "retrieval": {
                "page_indices": pred_pages,
                "similarities": vals.float().cpu().numpy(),
                "chunk_indices": idx.cpu().numpy(),
                "valid": valid.cpu().numpy(),
            },
        }

    @torch.inference_mode()
    def no_rag_max_conf(self, doc: RawDocument) -> Tuple[str, float]:
        """Score every page separately, keep the answer of highest confidence."""
        cfg = self.cfg
        header = render_text(doc.question)
        flats, masks = [], []
        for img in doc.images:
            flat, mask = pack_multi_image_patches([np.asarray(img)], cfg.max_total_patches, normalize=True,
                                                  header=header)
            flats.append(flat)
            masks.append(mask)
        tokens, conf = self._generate(self._dev(np.stack(flats).astype(self._xfer, copy=False)),
                                      self._dev(np.stack(masks)))
        conf = conf.cpu().numpy()
        best = int(np.argmax(conf))
        return self._decode(tokens)[best], float(conf[best])

    def _decode(self, tokens: torch.Tensor) -> List[str]:
        text = self.p2s_cfg.text
        out = []
        for row in tokens.cpu().numpy():
            ids = []
            for t in row:
                if t == text.eos_id:
                    break
                if t != text.pad_id:
                    ids.append(int(t))
            out.append(self.tokenizer.decode(ids))
        return out


# --------------------------------------------------------------------------- #
# host geometry helpers (the reference's pattern / merge logic; plain Python)
# --------------------------------------------------------------------------- #
def _surrounding_coords(center, shape, include: Union[int, Tuple[int, int]]):
    """Spiral pattern for int `include`, rectangle for (x, y) tuple
    (src/_modules.py:2207-2282)."""
    row, col = center
    max_rows, max_cols = shape
    coords = set()
    if isinstance(include, tuple) and len(include) == 2:
        xr, yr = include
        for r in range(row - yr, row + yr + 1):
            for c in range(col - xr, col + xr + 1):
                coords.add((r, c))
    else:
        level, phase = include // 3, include % 3
        for r in range(row - level, row + level + 1):
            for c in range(col - level, col + level + 1):
                coords.add((r, c))
        if phase > 0:
            for r in range(row - level, row + level + 1):
                coords.add((r, col - level - 1))
                coords.add((r, col + level + 1))
        if phase > 1:
            for c in range(col - level, col + level + 1):
                coords.add((row - level - 1, c))
                coords.add((row + level + 1, c))
    return [(r, c) for r, c in coords if 0 <= r < max_rows and 0 <= c < max_cols]


def _rect_overlap(a, b) -> bool:
    return a[0] < b[2] and a[2] > b[0] and a[1] < b[3] and a[3] > b[1]


def _merge_overlapping(surround, xyxy, coords, images) -> List[np.ndarray]:
    """Connected components of overlapping retrieved patches -> one bbox-union
    crop each (src/_modules.py:2284-2384). Boxes are page-frame pixels, so
    patches from different layout grids on the same page merge when they
    overlap."""
    coord_to_flat = {c: i for i, c in enumerate(coords)}
    by_page: Dict[int, List[List[int]]] = {}
    for page_idx, gid, row, col in surround:
        flat = coord_to_flat.get((page_idx, gid, row, col))
        if flat is not None:
            by_page.setdefault(page_idx, []).append(xyxy[flat])

    crops: List[np.ndarray] = []
    for page_idx, rects in sorted(by_page.items()):
        n = len(rects)
        seen = [False] * n
        for i in range(n):
            if seen[i]:
                continue
            cluster, queue = [], [i]
            seen[i] = True
            while queue:
                u = queue.pop()
                cluster.append(rects[u])
                for v in range(n):
                    if not seen[v] and _rect_overlap(rects[u], rects[v]):
                        seen[v] = True
                        queue.append(v)
            x1 = min(r[0] for r in cluster)
            y1 = min(r[1] for r in cluster)
            x2 = max(r[2] for r in cluster)
            y2 = max(r[3] for r in cluster)
            img = np.asarray(images[page_idx])
            # clamp to >=1px: a degenerate (zero-area) union would otherwise
            # flow an empty crop into patch_grid_shape, which rejects it
            y2 = min(max(int(y2), int(y1) + 1), img.shape[0])
            x2 = min(max(int(x2), int(x1) + 1), img.shape[1])
            y1 = min(int(y1), y2 - 1)
            x1 = min(int(x1), x2 - 1)
            crops.append(img[y1:y2, x1:x2])
    return crops
