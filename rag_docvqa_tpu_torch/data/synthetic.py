"""Synthetic DocVQA corpus generator.

A jax-free copy of `rag_docvqa_tpu/data/synthetic.py` (`make_document`,
`make_corpus`) that builds this package's `RawDocument`. The same seed gives
the same documents as the original. Each document plants a fact ("the <key>
is <value>") on a known page; the question asks for the value.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from rag_docvqa_tpu_torch.data.contract import RawDocument

_VOCAB = [
    "lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing",
    "elit", "sed", "do", "eiusmod", "tempor", "incididunt", "labore",
    "dolore", "magna", "aliqua", "enim", "minim", "veniam", "quis",
    "nostrud", "exercitation", "ullamco", "laboris", "nisi", "aliquip",
    "commodo", "consequat", "duis", "aute", "irure", "reprehenderit",
]

_KEYS = ["total", "date", "name", "amount", "city", "code", "title", "count"]


def make_document(
    rng: random.Random,
    n_pages: int = 4,
    words_per_page: int = 120,
    question_id: int = 0,
) -> RawDocument:
    key = rng.choice(_KEYS) + str(rng.randrange(1000))
    value = f"val{rng.randrange(100000)}"
    answer_page = rng.randrange(n_pages)

    words: List[List[str]] = []
    boxes = []
    for p in range(n_pages):
        page_words = [rng.choice(_VOCAB) for _ in range(words_per_page)]
        if p == answer_page:
            pos = rng.randrange(max(1, words_per_page - 4))
            page_words[pos : pos + 4] = ["the", key, "is", value]
        cols = 8
        page_boxes = [
            [
                (i % cols) / cols,
                (i // cols) / (words_per_page / cols + 1),
                (i % cols) / cols + 0.1,
                (i // cols) / (words_per_page / cols + 1) + 0.02,
            ]
            for i in range(len(page_words))
        ]
        words.append(page_words)
        boxes.append(np.asarray(page_boxes, np.float32))

    return RawDocument(
        question=f"what is the {key} ?",
        words=words,
        boxes=boxes,
        answers=[value],
        answer_page_idx=answer_page,
        question_id=question_id,
    )


def make_corpus(
    n_docs: int, n_pages: int = 4, words_per_page: int = 120, seed: int = 0
) -> List[RawDocument]:
    rng = random.Random(seed)
    return [
        make_document(rng, n_pages=n_pages, words_per_page=words_per_page, question_id=i)
        for i in range(n_docs)
    ]
