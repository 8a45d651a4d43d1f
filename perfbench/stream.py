"""The benchmark's document stream: MP-DocVQA- and MMLongBench-Doc-shaped
synthetic documents from a traffic file and a seed.

An extended copy of the port's `data/synthetic.py` (one planted fact, "the
<key> is <value>", on a random page; the question asks for the value). Three
extensions:

- words come from a Zipf vocabulary of `vocab.size` word forms (exponent
  `vocab.zipf`), so a tokenizer's word cache hits about as often as on OCR
  text, and not always, as it would over a 33-word vocabulary;
- page counts and words per page follow the traffic file's distributions;
- every seed gets the same sizes. The stream is cut into blocks of
  `block_docs` documents. A block's page counts are the page distribution's
  quantiles at (i + 1/2) / block_docs, its pages' word counts the word
  distribution's quantiles over all of its pages, dealt to the documents
  once for the traffic file; the seed only orders a block's documents and
  draws their words. So two seeds do the same work in another order, and
  any run of whole blocks holds the distributions exactly.

Document i of a stream depends only on (seed, stream id, i): the window's
stream and the warm-up's are distinct, and a stream extends without
repeating a document.

Page images, only where the traffic file has `page_images` ({"width": W,
"height": H}): one H x W x 3 uint8 array a page, a light page with each
word's box filled in a dark shade of its own, so that a crop of a chunk's
box holds that chunk's words. The pixels depend only on (seed, stream id,
question id, page). The documents hold none: `with_images` gives copies
that do, which the harness makes on the prefetch thread (`IngestTap`), where
a deployment decodes its image files, and a family's check makes the same
pixels again with `page_image`. Without the key nothing of this runs and the
documents carry no images.
"""

from __future__ import annotations

import dataclasses
import functools
import string
import sys
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from rag_docvqa_tpu_torch.data.contract import RawDocument

KEYS = ["total", "date", "name", "amount", "city", "code", "title", "count"]
WINDOW, WARMUP = 0, 1  # stream ids


def _quantiles(dist: Dict, n: int) -> np.ndarray:
    """n integer sizes: `dist`'s quantiles at (i + 1/2) / n, clipped and
    rounded. "lognormal" takes median and sigma, "uniform" min and max."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


@functools.lru_cache(maxsize=4)
def word_forms(size: int, seed: int) -> np.ndarray:
    """`size` distinct lower-case word forms, more frequent ranks shorter
    (2-4 letters at rank 1, up to about 13 at rank 50,000), fixed by `seed`
    alone: the language, not the run."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    ranks = np.arange(size)
    lengths = 2 + (np.log2(ranks + 1) / 1.6).astype(np.int64) + rng.integers(0, 3, size)
    grid = letters[rng.integers(0, 26, (size, int(lengths.max())))]
    seen = {"the", "is", "what"}
    out = []
    for r in ranks:
        w = "".join(grid[r, :lengths[r]])
        while w in seen:  # a repeat: draw again
            w = "".join(rng.choice(letters, lengths[r]))
        seen.add(w)
        out.append(w)
    return np.array(out, dtype=object)


@functools.lru_cache(maxsize=4)
def zipf_table(size: int, exponent: float, bits: int = 22) -> np.ndarray:
    """Ranks at 2**bits evenly spaced points of the Zipf distribution's
    quantile function: a uniform draw from the table is a Zipf draw, to
    within 2**-bits of probability (the rarest of 50,000 forms at 1.1 has
    about 6e-7, above 2**-22)."""
    p = np.arange(1, size + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(p / p.sum())
    u = (np.arange(1 << bits) + 0.5) / (1 << bits)
    return np.searchsorted(cdf, u).clip(0, size - 1).astype(np.int32)


@dataclass
class Shape:
    pages: List[int]  # words on each page


class DocStream:
    """Documents of one traffic file, one seed and one stream id, taken in
    order by `take`."""

    def __init__(self, traffic: Dict, seed: int, stream: int = WINDOW):
        self.t, self.seed, self.stream = traffic, int(seed), stream
        v = traffic["vocab"]
        self.vocab = word_forms(v["size"], v["seed"])
        self.ranks = zipf_table(v["size"], float(v["zipf"]))
        self.block = int(traffic["block_docs"])
        # the block's document shapes, fixed by the traffic file alone (a
        # constant generator deals the word counts to the pages); a seed only
        # orders them, so every block and every seed has the same documents'
        # sizes, and one block's caps are the stream's
        pages = _quantiles(traffic["pages"], self.block)
        words = np.random.default_rng(0).permutation(_quantiles(traffic["words_per_page"], int(pages.sum())))
        ends = np.cumsum(pages)
        self._layout = [Shape(words[e - n:e].tolist()) for n, e in zip(pages.tolist(), ends.tolist())]
        self._shapes: Dict[int, List[Shape]] = {}
        self._grid: Dict[int, np.ndarray] = {}
        self.next = 0

    def _block_shapes(self, j: int) -> List[Shape]:
        if j not in self._shapes:
            order = np.random.default_rng([self.seed, self.stream, j, 1]).permutation(self.block)
            self._shapes = {j: [self._layout[k] for k in order]}
        return self._shapes[j]

    def shape(self, i: int) -> Shape:
        return self._block_shapes(i // self.block)[i % self.block]

    def _words(self, rng, n: int) -> List[str]:
        return self.vocab[self.ranks[rng.integers(0, len(self.ranks), n)]].tolist()

    def _boxes(self, n: int) -> np.ndarray:
        """The boxes of a page of n words: 8 columns, row by row (the same
        array for every page of n words; ingest only reads it)."""
        if n not in self._grid:
            k = np.arange(n)
            x0, y0 = (k % 8) / 8, (k // 8) / (n / 8 + 1)
            self._grid[n] = np.stack([x0, y0, x0 + 0.1, y0 + 0.02], axis=1).astype(np.float32)
        return self._grid[n]

    def document(self, i: int) -> RawDocument:
        shape = self.shape(i)
        rng = np.random.default_rng([self.seed, self.stream, i])
        key = f"{KEYS[int(rng.integers(len(KEYS)))]}{int(rng.integers(1000))}"
        value = f"val{int(rng.integers(100000))}"
        answer_page = int(rng.integers(len(shape.pages)))
        q = self.t["question_words"]
        extra = self._words(rng, int(rng.integers(q["min"], q["max"] + 1)) - 4)
        flat = self._words(rng, sum(shape.pages))
        ends = np.cumsum(shape.pages).tolist()
        words = [flat[e - n:e] for n, e in zip(shape.pages, ends)]
        n = shape.pages[answer_page]
        pos = int(rng.integers(max(1, n - 4)))
        words[answer_page][pos:pos + 4] = ["the", key, "is", value]
        return RawDocument(question=" ".join(["what", "is", "the", key, *extra]), words=words,
                           boxes=[self._boxes(n) for n in shape.pages], answers=[value], answer_page_idx=answer_page,
                           question_id=i)

    def page_image(self, doc: RawDocument, p: int) -> np.ndarray:
        """Page p of `doc`, a document of this stream, at the traffic's
        `page_images` size: a page of a light shade, each word's box filled
        with a dark shade drawn for that word (later words over earlier)."""
        size = self.t["page_images"]
        W, H = int(size["width"]), int(size["height"])
        boxes = np.asarray(doc.boxes[p], np.float32).reshape(-1, 4)
        rng = np.random.default_rng([self.seed, self.stream, doc.question_id, p, 2])
        img = np.full((H, W, 3), 224 + int(rng.integers(32)), np.uint8)
        shade = rng.integers(0, 128, len(boxes)).astype(np.uint8)
        c0, r0 = (boxes[:, 0] * W).astype(np.int64), (boxes[:, 1] * H).astype(np.int64)
        c1 = np.maximum(np.ceil(boxes[:, 2] * W).astype(np.int64), c0 + 1)
        r1 = np.maximum(np.ceil(boxes[:, 3] * H).astype(np.int64), r0 + 1)
        for k in range(len(boxes)):
            img[r0[k]:r1[k], c0[k]:c1[k]] = shade[k]
        return img

    def with_images(self, docs: List[RawDocument]) -> List[RawDocument]:
        """Copies of `docs`, documents of this stream, that carry their page
        images; `docs` themselves stay without."""
        return [dataclasses.replace(d, images=[self.page_image(d, p) for p in range(len(d.words))]) for d in docs]

    def take(self, n: int) -> List[RawDocument]:
        docs = [self.document(i) for i in range(self.next, self.next + n)]
        self.next += n
        return docs


class Pool:
    """The window's stream as the endless sequence that `evaluate` is given:
    its first `pool_docs` documents are made in set-up, and a slice past them
    makes the next documents of the same stream (`extended` counts them), so
    the one `evaluate` call of a run reads consecutive, never repeated,
    documents until the harness stops it."""

    def __init__(self, traffic: Dict, seed: int):
        self.stream = DocStream(traffic, seed, WINDOW)
        self.docs = self.stream.take(int(traffic["pool_docs"]))
        self.extended = 0
        self.by_id = {d.question_id: d for d in self.docs}

    def __len__(self) -> int:
        return sys.maxsize

    def __getitem__(self, i):
        stop = (i.stop if i.stop is not None else sys.maxsize) if isinstance(i, slice) else i + 1
        short = stop - len(self.docs)
        if short > 0:
            more = self.stream.take(short)
            self.docs.extend(more)
            self.by_id.update((d.question_id, d) for d in more)
            self.extended += short
        return self.docs[i]
