"""Tokenizers for ingest-time token/box alignment.

A jax-free copy of `BaseTokenizer`, `HashTokenizer`, `ByteTokenizer` and
`HFTokenizer` from `rag_docvqa_tpu/data/tokenizer.py`: that module imports no
jax itself, but importing it runs `rag_docvqa_tpu/data/__init__.py`, which
does. The ids are the same as the original's for every word (same blake2
hash, same bytes, same HF tokenizer), so a batch ingested with either package
is identical. `HFTokenizer` imports `transformers` when it is built, and
raises an ImportError naming that package where it is not installed.
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


class ByteTokenizer(BaseTokenizer):
    """Byte-level tokenizer with an exact round trip: ids are bytes + 3
    specials; a space byte separates words."""

    def __init__(self) -> None:
        self.vocab_size = 256 + self._first_content_id
        self._space_id = ord(" ") + self._first_content_id

    def encode_word(self, word: str) -> List[int]:
        return [b + self._first_content_id for b in word.encode("utf-8")]

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for i, w in enumerate(text.split()):
            if i > 0:
                out.append(self._space_id)
            out.extend(self.encode_word(w))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self._first_content_id for i in ids if self._first_content_id <= i < self.vocab_size)
        return data.decode("utf-8", errors="ignore")


class HashTokenizer(BaseTokenizer):
    """Deterministic hash-based subword tokenizer at a T5-sized vocab.

    Words map to 1-3 subword ids via a stable blake2 hash of (word, piece_idx);
    the instance memoizes a reverse map so decode() recovers words it has
    seen in this process, or that `load_vocab` read from a file."""

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

    def save_vocab(self, path: str) -> None:
        """Writes the reverse map (JSON, one [word, [ids...]] pair per word
        seen), so that another process can decode; the file is the JAX
        package's."""
        import json

        with open(path, "w") as f:
            json.dump([[w, ids] for w, ids in self._word_cache.items()], f)

    def load_vocab(self, path: str) -> None:
        """Merges a reverse map `save_vocab` wrote (ids are hash-stable, so
        entries from any process agree; a collision keeps the loaded word)."""
        import json

        with open(path) as f:
            for word, ids in json.load(f):
                self._word_cache[word] = list(ids)
                self._reverse[tuple(ids)] = word

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


class HFTokenizer(BaseTokenizer):
    """A Hugging Face tokenizer from a local directory (never the network)."""

    def __init__(self, path: str) -> None:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(f"HFTokenizer({path!r}) needs the `transformers` package, which is not installed; "
                              "use the hash or byte tokenizer instead") from e

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.pad_id = self._tok.pad_token_id or 0
        self.eos_id = self._tok.eos_token_id or 1
        self.unk_id = self._tok.unk_token_id or 2
        self._word_cache: Dict[str, List[int]] = {}

    def _ids(self, text: str) -> List[int]:
        """The tokenizer's ids without the EOS a T5 tokenizer appends."""
        ids = self._tok(text).input_ids
        return ids[:-1] if ids and ids[-1] == self.eos_id else ids

    def encode_word(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is None:
            ids = self._word_cache[word] = self._ids(word)
        return list(ids)

    def encode(self, text: str) -> List[int]:
        return self._ids(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)
