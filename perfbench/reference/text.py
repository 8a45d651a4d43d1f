"""The plain reference of the host side: tokenizer, chunker, the document's
chunk table and the generator rows, in plain Python and numpy.

Frozen copies, independent of the program: the hash tokenizer (each word is
1-3 pieces, piece i the blake2b-8 hash of "word\\0i" over the content ids),
the reference chunker's fixed-stride mode with its tail merge
(src/_modules.py:907-943 of the reference), and the generator input of a
row: prompt "question: <q>  context:" ++ the words' tokens ++ EOS, cut to
the row length with the EOS kept, each token carrying its word's box times
1000 (truncated) and layout label, the prompt the box (0, 0, 1000, 1000) and
label 4, EOS and padding box 0 and label 4.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD, EOS, FIRST_CONTENT = 0, 1, 3
TEXT_LABEL, SPECIAL_LABEL = 1, 4


class HashTokenizer:
    def __init__(self, vocab_size: int, max_pieces: int = 3):
        self.vocab_size, self.max_pieces = vocab_size, max_pieces
        self._cache: Dict[str, List[int]] = {}

    def word(self, w: str) -> List[int]:
        ids = self._cache.get(w)
        if ids is None:
            n = min(1 + len(w) // 6, self.max_pieces)
            span = self.vocab_size - FIRST_CONTENT
            ids = [FIRST_CONTENT + int.from_bytes(hashlib.blake2b(f"{w}\x00{i}".encode(), digest_size=8).digest(),
                                                  "little") % span for i in range(n)]
            self._cache[w] = ids
        return ids

    def text(self, s: str) -> List[int]:
        return [i for w in s.split() for i in self.word(w)]


def chunk_indices(n_words: int, size: int, overlap: int, tol: float) -> List[List[int]]:
    """Fixed-stride chunks of `size` words with `overlap`; a chunk whose
    size, less the overlap, fits into its predecessor within (1 + tol) * size
    is merged into it."""
    chunks: List[List[int]] = []
    prev = 0
    for i in range(0, n_words, size - overlap):
        chunk = list(range(i, min(i + size, n_words)))
        this = len(chunk)
        if i > 0 and prev + this - overlap <= size * (1 + tol):
            chunks[-1].extend(chunk[overlap:])
            this = prev + this - overlap
        else:
            chunks.append(chunk)
        prev = this
    return chunks


@dataclass
class Doc:
    """A document as the reference reads it: its chunks in page order, each a
    list of (page, word) and its token ids, and the prompt and question."""

    words: List[List[str]]
    boxes: List[np.ndarray]
    chunks: List[List[Tuple[int, int]]] = field(default_factory=list)
    chunk_page: List[int] = field(default_factory=list)
    prompt: List[int] = field(default_factory=list)
    question: List[int] = field(default_factory=list)


def read_doc(doc, tok: HashTokenizer, c: Dict) -> Doc:
    """The chunk table of a `RawDocument` under the config `c` (chunk_size,
    overlap, chunk_size_tol, question_tokens, prompt_tokens)."""
    d = Doc(words=doc.words, boxes=[np.asarray(b, np.float32).reshape(-1, 4) for b in doc.boxes])
    for p, page in enumerate(doc.words):
        for ch in chunk_indices(len(page), c["chunk_size"], c["overlap"], c.get("chunk_size_tol", 0.2)):
            d.chunks.append([(p, w) for w in ch])
            d.chunk_page.append(p)
    d.question = tok.text(doc.question)[:c["question_tokens"]]
    d.prompt = tok.text(f"question: {doc.question}  context:")[:c["prompt_tokens"]]
    return d


def chunk_tokens(d: Doc, tok: HashTokenizer, i: int, limit: int) -> List[int]:
    """The first `limit` token ids of chunk i's words."""
    return [t for p, w in d.chunks[i] for t in tok.word(d.words[p][w])][:limit]


def row(prompt: Sequence[int], words: Sequence[Tuple[str, np.ndarray, int]], tok: HashTokenizer, length: int):
    """(ids, boxes (length, 4), labels, mask) of one generator row over
    `words`, each (word, box, label)."""
    ids = list(prompt)
    boxes = [(0, 0, 1000, 1000)] * len(prompt)
    labels = [SPECIAL_LABEL] * len(prompt)
    for w, box, label in words:
        b = tuple(int(v) for v in (np.asarray(box, np.float32) * np.float32(1000)).astype(np.int64))
        for t in tok.word(w):
            ids.append(t)
            boxes.append(b)
            labels.append(label)
    eos = min(len(ids), length - 1)
    ids = ids[:eos] + [EOS] + [PAD] * (length - 1 - eos)
    boxes = boxes[:eos] + [(0, 0, 0, 0)] * (length - eos)
    labels = labels[:eos] + [SPECIAL_LABEL] * (length - eos)
    mask = [True] * (eos + 1) + [False] * (length - 1 - eos)
    return np.array(ids), np.array(boxes, np.int64), np.array(labels), np.array(mask)


def concat_row(d: Doc, chosen: Sequence[int], tok: HashTokenizer, length: int, surroundings: int = 0):
    """The concat strategy's row: the chosen chunks' words, rank by rank, each
    slot once (the best-ranked chunk that covers it takes it), in the
    document's chunk order within a rank. A chunk covers its own word slots
    and `surroundings` slots on either side, within its page's slots (a slot
    is a word of a chunk, so the overlap's words have two)."""
    slots = [(i, k) for i, ch in enumerate(d.chunks) for k in range(len(ch))]
    starts = np.cumsum([0] + [len(ch) for ch in d.chunks])
    page_lo: Dict[int, int] = {}
    page_hi: Dict[int, int] = {}
    for i, p in enumerate(d.chunk_page):
        page_lo.setdefault(p, int(starts[i]))
        page_hi[p] = int(starts[i + 1])
    owner = [len(chosen)] * len(slots)
    for r, i in enumerate(chosen):
        p = d.chunk_page[i]
        lo = max(page_lo[p], int(starts[i]) - surroundings)
        hi = min(page_hi[p], int(starts[i + 1]) + surroundings)
        for g in range(lo, hi):
            if owner[g] == len(chosen):
                owner[g] = r
    ranks = [[] for _ in chosen]
    for g, (i, k) in enumerate(slots):
        if owner[g] < len(chosen):
            p, w = d.chunks[i][k]
            ranks[owner[g]].append((d.words[p][w], d.boxes[p][w], TEXT_LABEL))
    return row(d.prompt, [w for r in ranks for w in r], tok, length)


def page_row(d: Doc, p: int, tok: HashTokenizer, length: int):
    """The whole-page row of page p: its words in page order."""
    return row(d.prompt, [(w, d.boxes[p][k], TEXT_LABEL) for k, w in enumerate(d.words[p])], tok, length)
