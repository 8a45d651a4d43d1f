"""Host ingestion: ragged OCR documents -> fixed-shape ChunkedBatch arrays.

A jax-free copy of `DocVQAIngestor` (`ingest`, `plan_caps`,
`answer_labels`) from
`rag_docvqa_tpu/data/ingest.py`, building this package's numpy
`ChunkedBatch`. It imports no jax and nothing of the JAX package: the
chunker is this package's own copy (`ops/chunking.py`). One change from the
original: when the doc-level
vectorized path does not apply, the per-page fallback reuses the page chunks
that path already computed instead of chunking every page a second time.

Does at ingest time work the reference does per forward pass: chunking,
chunk text compaction, per-word tokenization and prompt construction.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec, chunk_page
from rag_docvqa_tpu_torch.data.contract import Caps, ChunkedBatch, RawDocument
from rag_docvqa_tpu_torch.data.tokenizer import BaseTokenizer


def _next_bucket(n: int, minimum: int) -> int:
    """Round up to a power-of-two bucket so the set of shapes stays small."""
    b = minimum
    while b < n:
        b *= 2
    return b


class DocVQAIngestor:
    def __init__(
        self,
        tokenizer: BaseTokenizer,
        spec: Optional[ChunkSpec] = None,
        caps: Optional[Caps] = None,
    ) -> None:
        self.tokenizer = tokenizer
        self.spec = spec or ChunkSpec()
        self.caps = caps or Caps()
        # word -> row in a (n, tokens_per_word) token matrix; turns the
        # per-word tokenize loop (the measured ingest hot spot — ~50% of
        # wall) into one fancy-indexed gather per page. Unbounded across a
        # corpus by design: ~130 B/word, so even a 1M-word vocabulary costs
        # ~130 MB host RAM. Rebuilt if caps.tokens_per_word changes.
        self._wcache: Dict[str, int] = {}
        self._wcache_tw = -1

    # ------------------------------------------------------------------ #
    def _word_rows(self, words: List[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """Vectorized per-word tokenization via the word-matrix cache.

        Returns (page_tok (n, TW) int32, page_ntok (n,) int32, row_idx,
        concat_ok) where concat_ok mirrors the page_concat_ok condition: no
        word truncated to tokens_per_word and no word re-splits under
        str.split."""
        tw = self.caps.tokens_per_word
        if self._wcache_tw != tw:
            self._wcache = {}
            self._wcache_tw = tw
            cap = 4096
            self._wtok = np.zeros((cap, tw), np.int32)
            self._wntok = np.zeros((cap,), np.int32)
            self._wok = np.zeros((cap,), bool)
        wc = self._wcache
        try:
            idx = [wc[w] for w in words]
        except KeyError:
            tk = self.tokenizer
            idx = []
            for w in words:
                j = wc.get(w)
                if j is None:
                    j = len(wc)
                    if j >= self._wtok.shape[0]:
                        grow = lambda a: np.concatenate([a, np.zeros_like(a)])
                        self._wtok = grow(self._wtok)
                        self._wntok = grow(self._wntok)
                        self._wok = grow(self._wok)
                    full = tk.encode_word(w)
                    ids = full[:tw]
                    self._wtok[j, : len(ids)] = ids
                    self._wntok[j] = len(ids)
                    self._wok[j] = len(full) <= tw and w.split() == [w]
                    wc[w] = j
                idx.append(j)
        ia = np.asarray(idx, np.intp)
        return self._wtok[ia], self._wntok[ia], ia, bool(self._wok[ia].all())

    # ------------------------------------------------------------------ #
    def answer_labels(self, answers: List[List[str]], max_len: int = 32, seed: int = 0) -> np.ndarray:
        """One gold answer per sample, picked with a seeded RandomState and
        tokenized with EOS into (B, max_len) int32 labels, -100 as padding."""
        rng = np.random.RandomState(seed)
        out = np.full((len(answers), max_len), -100, np.int32)
        for b, ans in enumerate(answers):
            if not ans:
                continue
            text = ans[rng.randint(len(ans))]
            ids = self.tokenizer.encode(text)[: max_len - 1] + [self.tokenizer.eos_id]
            out[b, : len(ids)] = ids
        return out

    # ------------------------------------------------------------------ #
    def plan_caps(self, docs: List[RawDocument]) -> Caps:
        """Size Caps to fit `docs` without truncation (power-of-two buckets).

        The reference retrieves over ALL pages of a 100+-page MMLongBench doc
        (src/MMLongBenchDoc.py:44-71); fixed caps that silently drop pages
        break that. This plans exact chunk/slot counts by dry-running the
        chunker on word counts, so eval can retrieve from every page at the
        cost of one set of shapes per bucket set."""
        max_pages = max_chunks = max_slots = 1
        for doc in docs:
            n_chunks = n_chunk_slots = n_raw = 0
            for p in range(len(doc.words)):
                layout = (doc.layout[p] if doc.layout is not None and p < len(doc.layout) else None) or {}
                pc = chunk_page(
                    doc.words[p], doc.boxes[p], self.spec,
                    layout_boxes=layout.get("boxes"),
                    layout_labels=layout.get("labels"),
                    layout_clusters=layout.get("clusters"),
                )
                n_chunks += len(pc.word_indices)
                n_chunk_slots += sum(len(w) for w in pc.word_indices)
                n_raw += len(doc.words[p])
            max_pages = max(max_pages, len(doc.words))
            max_chunks = max(max_chunks, n_chunks)
            # slot arrays hold chunked (overlap-duplicated) words; raw arrays
            # hold original words — both share the max_slots cap
            max_slots = max(max_slots, n_chunk_slots, n_raw)
        c = self.caps
        return Caps(
            max_pages=max(_next_bucket(max_pages, 4), 4),
            max_chunks=_next_bucket(max_chunks, 16),
            max_slots=_next_bucket(max_slots, 256),
            tokens_per_word=c.tokens_per_word,
            embed_tokens=c.embed_tokens,
            question_tokens=c.question_tokens,
            prompt_tokens=c.prompt_tokens,
        )

    # ------------------------------------------------------------------ #
    def ingest(self, docs: List[RawDocument]) -> Tuple[ChunkedBatch, Dict[str, Any]]:
        """Returns the device batch plus a host-side aux dict (strings, images)."""
        B = len(docs)
        c = self.caps
        tk = self.tokenizer

        chunk_emb_tokens = np.zeros((B, c.max_chunks, c.embed_tokens), np.int32)
        chunk_emb_mask = np.zeros((B, c.max_chunks, c.embed_tokens), bool)
        q_tokens = np.zeros((B, c.question_tokens), np.int32)
        q_mask = np.zeros((B, c.question_tokens), bool)
        chunk_mask = np.zeros((B, c.max_chunks), bool)
        chunk_page_arr = np.zeros((B, c.max_chunks), np.int32)
        chunk_label = np.zeros((B, c.max_chunks), np.int32)
        chunk_box = np.zeros((B, c.max_chunks, 4), np.float32)
        chunk_slot_start = np.zeros((B, c.max_chunks), np.int32)
        chunk_slot_len = np.zeros((B, c.max_chunks), np.int32)
        slot_tokens = np.zeros((B, c.max_slots, c.tokens_per_word), np.int32)
        slot_ntok = np.zeros((B, c.max_slots), np.int32)
        slot_box = np.zeros((B, c.max_slots, 4), np.float32)
        slot_page = np.zeros((B, c.max_slots), np.int32)
        slot_label = np.zeros((B, c.max_slots), np.int32)
        slot_mask = np.zeros((B, c.max_slots), bool)
        page_slot_start = np.zeros((B, c.max_pages), np.int32)
        page_slot_end = np.zeros((B, c.max_pages), np.int32)
        raw_tokens = np.zeros((B, c.max_slots, c.tokens_per_word), np.int32)
        raw_ntok = np.zeros((B, c.max_slots), np.int32)
        raw_box = np.zeros((B, c.max_slots, 4), np.float32)
        raw_label = np.zeros((B, c.max_slots), np.int32)
        raw_mask = np.zeros((B, c.max_slots), bool)
        page_raw_start = np.zeros((B, c.max_pages), np.int32)
        page_raw_end = np.zeros((B, c.max_pages), np.int32)
        prompt_tokens = np.zeros((B, c.prompt_tokens), np.int32)
        prompt_len = np.zeros((B,), np.int32)
        num_pages = np.zeros((B,), np.int32)
        answer_page = np.zeros((B,), np.int32)

        aux: Dict[str, Any] = {
            "questions": [],
            "answers": [],
            "answer_types": [],
            "question_ids": [],
            "images": [],
            "layouts": [],  # per doc: per page {boxes, labels[, clusters]} or None
            "chunk_texts": [],  # (B, n_chunks) compacted text, for eval_retrieval
            "slot_words": [],  # (B, n_slots) word strings in slot order
        }

        # chunk_slots = chunked (overlap-duplicated) word occurrences dropped;
        # raw_words = original page words dropped from the raw arrays — they
        # describe different views of the same text, so report them separately
        overflow: Dict[str, int] = {"pages": 0, "chunks": 0, "chunk_slots": 0, "raw_words": 0}
        for b, doc in enumerate(docs):
            n_pages = min(len(doc.words), c.max_pages)
            overflow["pages"] += len(doc.words) - n_pages
            num_pages[b] = n_pages
            answer_page[b] = min(doc.answer_page_idx, max(n_pages - 1, 0))
            aux["questions"].append(doc.question)
            aux["answers"].append(list(doc.answers))
            aux["answer_types"].append(doc.answer_type)
            aux["question_ids"].append(doc.question_id)
            aux["images"].append(doc.images)
            # layout regions ride along so engines with a layout-guided
            # visual path (RAGPix2Struct chunk_mode="layout") see them from
            # the standard evaluate()/eval.py ingest, not only from direct
            # inference(docs) calls
            aux["layouts"].append(doc.layout)

            # question + prompt tokens
            q_ids = tk.encode(doc.question)[: c.question_tokens]
            q_tokens[b, : len(q_ids)] = q_ids
            q_mask[b, : len(q_ids)] = True
            p_ids = tk.encode(f"question: {doc.question}  context:")[: c.prompt_tokens]
            prompt_tokens[b, : len(p_ids)] = p_ids
            prompt_len[b] = len(p_ids)

            slot_cursor = 0
            raw_cursor = 0
            chunk_cursor = 0
            texts_b: List[str] = []
            slot_words_b: List[str] = []

            # ---- doc-level vectorized path --------------------------------
            # One _word_rows gather and ONE set of numpy ops for the whole
            # doc instead of per page: at typical page sizes (~120 words,
            # ~130 chunked slots) the per-page loop's cost is numpy CALL
            # overhead, not data — batching all pages of a doc through the
            # same ops amortizes it ~n_pages×. Exact under the same
            # conditions as the page path (concat-of-encode_word tokenizer,
            # nothing truncates); page boundaries survive because chunks
            # never cross pages, so every chunk's slice of the doc-level
            # concat order stays contiguous. Falls through to the per-page
            # loop whenever any page/cap condition fails.
            done_doc = False
            pcs = []  # page chunks of the doc-level attempt, reused on fallback
            if (
                n_pages
                and not getattr(self, "_force_page", False)
                and type(tk).encode is BaseTokenizer.encode
            ):
                nw_list = []
                lens_pp = []
                cat_pp = []
                woff = 0
                for p in range(n_pages):
                    layout = (doc.layout[p] if doc.layout is not None and p < len(doc.layout) else None) or {}
                    pc = chunk_page(
                        doc.words[p], doc.boxes[p], self.spec,
                        layout_boxes=layout.get("boxes"),
                        layout_labels=layout.get("labels"),
                        layout_clusters=layout.get("clusters"),
                    )
                    pcs.append(pc)
                    nw = len(doc.words[p])
                    nw_list.append(nw)
                    ncp = len(pc.word_indices)
                    lp = np.fromiter((len(w) for w in pc.word_indices), np.int32, ncp)
                    lens_pp.append(lp)
                    cp = np.fromiter(
                        itertools.chain.from_iterable(pc.word_indices),
                        np.int64, int(lp.sum()))
                    if woff:
                        cp += woff
                    cat_pp.append(cp)
                    woff += nw
                allwords = [w for p in range(n_pages) for w in doc.words[p]]
                NW = len(allwords)
                doc_tok, doc_ntok, _, words_ok = self._word_rows(allwords)
                n_ch_p = np.fromiter((len(pc.word_indices) for pc in pcs), np.int32, n_pages)
                n_ch = int(n_ch_p.sum())
                lens = np.concatenate(lens_pp) if n_pages > 1 else lens_pp[0]
                total = int(lens.sum())
                if (
                    words_ok
                    and n_ch
                    and n_ch <= c.max_chunks
                    and total <= c.max_slots
                    and NW <= c.max_slots
                    and int(lens.min()) > 0
                ):
                    done_doc = True
                    chunk_pageid = np.repeat(
                        np.arange(n_pages, dtype=np.int32), n_ch_p)
                    cat = np.concatenate(cat_pp) if n_pages > 1 else cat_pp[0]
                    starts = np.zeros(n_ch, np.int32)
                    np.cumsum(lens[:-1], out=starts[1:])
                    doc_box = (
                        np.concatenate([
                            np.asarray(doc.boxes[p], np.float32).reshape(nw_list[p], 4)
                            if nw_list[p] else np.zeros((0, 4), np.float32)
                            for p in range(n_pages)
                        ]) if NW else np.zeros((0, 4), np.float32)
                    )
                    rows = doc_tok[cat]
                    nts = doc_ntok[cat]
                    pb = doc_box[cat]
                    ch = slice(0, n_ch)
                    sl = slice(0, total)
                    labels_arr = np.concatenate(
                        [np.asarray(pc.labels, np.int32) for pc in pcs]) \
                        if n_pages > 1 else np.asarray(pcs[0].labels, np.int32)
                    chunk_mask[b, ch] = True
                    chunk_page_arr[b, ch] = chunk_pageid
                    chunk_label[b, ch] = labels_arr
                    chunk_box[b, ch, :2] = np.minimum.reduceat(pb[:, :2], starts, axis=0)
                    chunk_box[b, ch, 2:] = np.maximum.reduceat(pb[:, 2:], starts, axis=0)
                    chunk_slot_start[b, ch] = starts
                    chunk_slot_len[b, ch] = lens
                    slot_tokens[b, sl] = rows
                    slot_ntok[b, sl] = nts
                    slot_box[b, sl] = pb
                    slot_page[b, sl] = np.repeat(chunk_pageid, lens)
                    slot_label[b, sl] = np.repeat(labels_arr, lens)
                    slot_mask[b, sl] = True
                    tok_keep = np.arange(c.tokens_per_word, dtype=np.int32)[None, :] < nts[:, None]
                    flat = rows[tok_keep]
                    word_chunk = np.repeat(np.arange(n_ch, dtype=np.int32), lens)
                    tok_chunk = np.repeat(word_chunk, nts)
                    chunk_ntok = np.add.reduceat(nts, starts)
                    chunk_tok_start = np.zeros(n_ch, np.int64)
                    np.cumsum(chunk_ntok[:-1], out=chunk_tok_start[1:])
                    pos = np.arange(flat.shape[0], dtype=np.int64) - chunk_tok_start[tok_chunk]
                    keep = pos < c.embed_tokens
                    chunk_emb_tokens[b, tok_chunk[keep], pos[keep]] = flat[keep]
                    chunk_emb_mask[b, tok_chunk[keep], pos[keep]] = True
                    allw = np.asarray(allwords, dtype=object)[cat].tolist()
                    pos0 = 0
                    for ln in lens.tolist():
                        texts_b.append(" ".join(allw[pos0 : pos0 + ln]))
                        pos0 += ln
                    slot_words_b.extend(allw)
                    slot_cursor = total
                    chunk_cursor = n_ch
                    # per-page slot spans from the per-page chunk-slot totals
                    cend = np.cumsum(n_ch_p)
                    cum_slots = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
                    p_end = cum_slots[cend]
                    page_slot_end[b, :n_pages] = p_end
                    page_slot_start[b, 0] = 0
                    page_slot_start[b, 1:n_pages] = p_end[:-1]
                    # raw arrays: doc-level concat IS original page order
                    rl = slice(0, NW)
                    raw_tokens[b, rl] = doc_tok
                    raw_ntok[b, rl] = doc_ntok
                    raw_box[b, rl] = doc_box
                    raw_label[b, rl] = np.concatenate(
                        [np.asarray(pc.word_labels, np.int32) for pc in pcs]) \
                        if n_pages > 1 else np.asarray(pcs[0].word_labels, np.int32)
                    raw_mask[b, rl] = True
                    raw_cursor = NW
                    raw_off = np.concatenate(([0], np.cumsum(np.asarray(nw_list, np.int64))))
                    page_raw_start[b, :n_pages] = raw_off[:-1]
                    page_raw_end[b, :n_pages] = raw_off[1:]

            for p in () if done_doc else range(n_pages):
                words = doc.words[p]
                boxes = doc.boxes[p]
                page_slot_start[b, p] = slot_cursor
                if pcs:
                    pc = pcs[p]
                else:
                    layout = (doc.layout[p] if doc.layout is not None and p < len(doc.layout) else None) or {}
                    pc = chunk_page(
                        words,
                        boxes,
                        self.spec,
                        layout_boxes=layout.get("boxes"),
                        layout_labels=layout.get("labels"),
                        layout_clusters=layout.get("clusters"),
                    )
                # tokenize the page ONCE into a (n_words, TW) matrix; both the
                # chunked slot arrays and the raw arrays slice from it. The
                # word-matrix cache (_word_rows) makes this one gather per
                # page instead of a per-word Python loop (measured ~2x on the
                # whole ingest).
                nw = len(words)
                # chunk-text embed ids can be assembled from these per-word
                # rows (instead of re-encoding the joined chunk text) exactly
                # when the tokenizer's encode() IS concat-of-encode_word
                # (BaseTokenizer.encode), no word re-splits under str.split,
                # and no word's ids were truncated to tokens_per_word
                page_tok, page_ntok, _, words_ok = self._word_rows(list(words))
                page_concat_ok = words_ok and type(tk).encode is BaseTokenizer.encode
                page_box = np.asarray(boxes, np.float32).reshape(nw, 4) if nw else np.zeros((0, 4), np.float32)

                # ---- vectorized page path ---------------------------------
                # one numpy pass per PAGE instead of ~10 numpy calls per
                # chunk (call overhead dominated the loop); exact iff the
                # concat fast path applies and nothing on this page truncates
                # — otherwise the per-chunk loop below handles the edges
                n_ch = len(pc.word_indices)
                lens = np.fromiter((len(w) for w in pc.word_indices), np.int32, n_ch)
                total = int(lens.sum())
                if (
                    n_ch
                    and page_concat_ok
                    and chunk_cursor + n_ch <= c.max_chunks
                    and slot_cursor + total <= c.max_slots
                    and int(lens.min()) > 0
                ):
                    cat = np.fromiter(
                        itertools.chain.from_iterable(pc.word_indices), np.int32, total
                    )
                    starts = np.zeros(n_ch, np.int32)
                    np.cumsum(lens[:-1], out=starts[1:])
                    rows = page_tok[cat]
                    nts = page_ntok[cat]
                    pb = page_box[cat]
                    cc = chunk_cursor
                    ch = slice(cc, cc + n_ch)
                    sl = slice(slot_cursor, slot_cursor + total)
                    labels_arr = np.asarray(pc.labels, np.int32)
                    chunk_mask[b, ch] = True
                    chunk_page_arr[b, ch] = p
                    chunk_label[b, ch] = labels_arr
                    chunk_box[b, ch, :2] = np.minimum.reduceat(pb[:, :2], starts, axis=0)
                    chunk_box[b, ch, 2:] = np.maximum.reduceat(pb[:, 2:], starts, axis=0)
                    chunk_slot_start[b, ch] = slot_cursor + starts
                    chunk_slot_len[b, ch] = lens
                    slot_tokens[b, sl] = rows
                    slot_ntok[b, sl] = nts
                    slot_box[b, sl] = pb
                    slot_page[b, sl] = p
                    slot_label[b, sl] = np.repeat(labels_arr, lens)
                    slot_mask[b, sl] = True
                    # chunk embed ids: flatten each chunk's word rows (word-
                    # major == sequential concat) and keep the first
                    # embed_tokens per chunk
                    tok_keep = np.arange(c.tokens_per_word, dtype=np.int32)[None, :] < nts[:, None]
                    flat = rows[tok_keep]
                    word_chunk = np.repeat(np.arange(n_ch, dtype=np.int32), lens)
                    tok_chunk = np.repeat(word_chunk, nts)
                    chunk_ntok = np.add.reduceat(nts, starts)
                    chunk_tok_start = np.zeros(n_ch, np.int64)
                    np.cumsum(chunk_ntok[:-1], out=chunk_tok_start[1:])
                    pos = np.arange(flat.shape[0], dtype=np.int64) - chunk_tok_start[tok_chunk]
                    keep = pos < c.embed_tokens
                    chunk_emb_tokens[b, cc + tok_chunk[keep], pos[keep]] = flat[keep]
                    chunk_emb_mask[b, cc + tok_chunk[keep], pos[keep]] = True
                    # chunk texts + slot words via one object-array gather in
                    # cat (chunk-concatenated) order, then per-chunk joins on
                    # list slices — the per-element generator joins were ~10%
                    # of ingest
                    allw = np.asarray(words, dtype=object)[cat].tolist()
                    pos0 = 0
                    for ln in lens.tolist():
                        texts_b.append(" ".join(allw[pos0 : pos0 + ln]))
                        pos0 += ln
                    slot_words_b.extend(allw)
                    slot_cursor += total
                    chunk_cursor += n_ch
                    page_chunks = ()  # chunk work done; shared tail below
                else:
                    page_chunks = zip(pc.word_indices, pc.labels)

                for widx, label in page_chunks:
                    if chunk_cursor >= c.max_chunks:
                        overflow["chunks"] += 1
                        overflow["chunk_slots"] += len(widx)
                        continue
                    n_fit = min(len(widx), c.max_slots - slot_cursor)
                    overflow["chunk_slots"] += len(widx) - n_fit
                    widx = widx[:n_fit]
                    n = len(widx)
                    # chunk metadata
                    text = " ".join(words[i] for i in widx)
                    texts_b.append(text)
                    rows = page_tok[widx]
                    nts = page_ntok[widx]
                    pb = page_box[widx]
                    if page_concat_ok and n:
                        # exact fast path (see page_concat_ok above): gather
                        # the pre-tokenized word rows instead of re-encoding
                        # the joined text — the ingest hot spot (~20%)
                        emb_ids = rows[np.arange(c.tokens_per_word)[None, :] < nts[:, None]]
                        emb_ids = emb_ids[: c.embed_tokens]
                    else:
                        emb_ids = np.asarray(tk.encode(text)[: c.embed_tokens], np.int32)
                    chunk_emb_tokens[b, chunk_cursor, : len(emb_ids)] = emb_ids
                    chunk_emb_mask[b, chunk_cursor, : len(emb_ids)] = True
                    chunk_mask[b, chunk_cursor] = True
                    chunk_page_arr[b, chunk_cursor] = p
                    chunk_label[b, chunk_cursor] = label
                    # vectorized box union (== compact_chunk_box on the page's
                    # box matrix; the per-element generator was ~19% of ingest)
                    if n:
                        chunk_box[b, chunk_cursor, :2] = pb[:, :2].min(axis=0)
                        chunk_box[b, chunk_cursor, 2:] = pb[:, 2:].max(axis=0)
                    else:
                        chunk_box[b, chunk_cursor] = (0.0, 0.0, 1.0, 1.0)
                    chunk_slot_start[b, chunk_cursor] = slot_cursor
                    chunk_slot_len[b, chunk_cursor] = n
                    # word slots: one fancy-indexed scatter per chunk
                    sl = slice(slot_cursor, slot_cursor + n)
                    slot_tokens[b, sl] = rows
                    slot_ntok[b, sl] = nts
                    slot_box[b, sl] = pb
                    slot_page[b, sl] = p
                    slot_label[b, sl] = label
                    slot_mask[b, sl] = True
                    slot_words_b.extend(words[i] for i in widx)
                    slot_cursor += n
                    chunk_cursor += 1
                page_slot_end[b, p] = slot_cursor
                # raw word arrays in original page order (per-word labels from
                # the layout assignment, src/_modules.py:1023-1031)
                page_raw_start[b, p] = raw_cursor
                n_raw = min(nw, c.max_slots - raw_cursor)
                overflow["raw_words"] += nw - n_raw
                rl = slice(raw_cursor, raw_cursor + n_raw)
                raw_tokens[b, rl] = page_tok[:n_raw]
                raw_ntok[b, rl] = page_ntok[:n_raw]
                raw_box[b, rl] = page_box[:n_raw]
                raw_label[b, rl] = np.asarray(pc.word_labels[:n_raw], np.int32)
                raw_mask[b, rl] = True
                raw_cursor += n_raw
                page_raw_end[b, p] = raw_cursor
            # pages beyond n_pages keep start == end == cursor
            page_slot_start[b, n_pages:] = slot_cursor
            page_slot_end[b, n_pages:] = slot_cursor
            page_raw_start[b, n_pages:] = raw_cursor
            page_raw_end[b, n_pages:] = raw_cursor
            aux["chunk_texts"].append(texts_b)
            aux["slot_words"].append(slot_words_b)

        if any(overflow.values()):
            warnings.warn(
                f"ingest truncated content beyond Caps(max_pages={c.max_pages}, "
                f"max_chunks={c.max_chunks}, max_slots={c.max_slots}): dropped "
                f"{overflow['pages']} pages, {overflow['chunks']} chunks "
                f"({overflow['chunk_slots']} chunked word slots), "
                f"{overflow['raw_words']} raw words. Retrieval cannot see the dropped "
                f"content — size caps with DocVQAIngestor.plan_caps(docs) "
                f"(the reference retrieves over all pages, src/MMLongBenchDoc.py:44-71).",
                stacklevel=2,
            )
        batch = ChunkedBatch(
            chunk_emb_tokens=chunk_emb_tokens,
            chunk_emb_mask=chunk_emb_mask,
            q_tokens=q_tokens,
            q_mask=q_mask,
            chunk_mask=chunk_mask,
            chunk_page=chunk_page_arr,
            chunk_label=chunk_label,
            chunk_box=chunk_box,
            chunk_slot_start=chunk_slot_start,
            chunk_slot_len=chunk_slot_len,
            slot_tokens=slot_tokens,
            slot_ntok=slot_ntok,
            slot_box=slot_box,
            slot_page=slot_page,
            slot_label=slot_label,
            slot_mask=slot_mask,
            page_slot_start=page_slot_start,
            page_slot_end=page_slot_end,
            raw_tokens=raw_tokens,
            raw_ntok=raw_ntok,
            raw_box=raw_box,
            raw_label=raw_label,
            raw_mask=raw_mask,
            page_raw_start=page_raw_start,
            page_raw_end=page_raw_end,
            prompt_tokens=prompt_tokens,
            prompt_len=prompt_len,
            num_pages=num_pages,
            answer_page=answer_page,
        )
        return batch, aux
