"""Tokenizers for ingest-time token/box alignment.

A jax-free copy of `BaseTokenizer` and `HashTokenizer` from
`rag_docvqa_tpu/data/tokenizer.py`: that module imports no jax itself, but
importing it runs `rag_docvqa_tpu/data/__init__.py`, which does. The ids are
the same as the original's for every word (same blake2 hash), so a batch
ingested with either package is identical.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence


class BaseTokenizer:
    vocab_size: int
    pad_id: int = 0
    eos_id: int = 1
    unk_id: int = 2

    #: first id available for content tokens
    _first_content_id: int = 3

    def encode_word(self, word: str) -> List[int]:
        raise NotImplementedError

    def encode(self, text: str) -> List[int]:
        """Encode a whitespace-separated string (no EOS appended)."""
        out: List[int] = []
        for w in text.split():
            out.extend(self.encode_word(w))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def __call__(self, text: str) -> List[int]:
        return self.encode(text)


class HashTokenizer(BaseTokenizer):
    """Deterministic hash-based subword tokenizer at a T5-sized vocab.

    Words map to 1-3 subword ids via a stable blake2 hash of (word, piece_idx);
    the instance memoizes a reverse map so decode() recovers words it has
    seen in this process."""

    def __init__(self, vocab_size: int = 32128, max_pieces: int = 3) -> None:
        self.vocab_size = vocab_size
        self.max_pieces = max_pieces
        self._reverse: Dict[tuple, str] = {}
        self._word_cache: Dict[str, List[int]] = {}

    def _n_pieces(self, word: str) -> int:
        return min(1 + len(word) // 6, self.max_pieces)

    def _piece_id(self, word: str, idx: int) -> int:
        h = hashlib.blake2b(f"{word}\x00{idx}".encode("utf-8"), digest_size=8).digest()
        rng = self.vocab_size - self._first_content_id
        return self._first_content_id + int.from_bytes(h, "little") % rng

    def encode_word(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is None:
            n = self._n_pieces(word)
            ids = [self._piece_id(word, i) for i in range(n)]
            self._reverse[tuple(ids)] = word
            self._word_cache[word] = ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        ids = [i for i in ids if i >= self._first_content_id]
        words: List[str] = []
        i = 0
        while i < len(ids):
            matched = False
            for ln in range(self.max_pieces, 0, -1):
                key = tuple(ids[i : i + ln])
                if key in self._reverse:
                    words.append(self._reverse[key])
                    i += ln
                    matched = True
                    break
            if not matched:
                i += 1
        return " ".join(words)
