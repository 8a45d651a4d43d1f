"""Port parity, multi-process ingest (`rag_docvqa_tpu_torch/data/ingest_mp.py`):
the five cases of `tests/test_ingest_mp.py`, with the port's `MPIngestor`
held against the JAX package's single-process `DocVQAIngestor` on the same
seeded corpus: every array of the `ChunkedBatch` equal exactly, and the aux
lists equal. One pool of two spawned workers serves the module, as in the
JAX test. Its workers hide the card and never import torch."""

import dataclasses

import numpy as np
import pytest

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.ops.chunking import ChunkSpec as JChunkSpec
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.ingest_mp import MPIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

AUX_KEYS = ("questions", "answers", "question_ids", "chunk_texts", "slot_words")


@pytest.fixture(scope="module")
def pool():
    mp_ing = MPIngestor(HashTokenizer(vocab_size=4096), ChunkSpec(chunk_size=10, overlap=2), num_workers=2)
    yield mp_ing
    mp_ing.close()


def _jax_ingest(mp_ing, docs_args):
    """The JAX single-process ingest with the pool's spec and caps, on the JAX
    package's corpus drawn with the same arguments."""
    spec = JChunkSpec(**dataclasses.asdict(mp_ing.spec))
    caps = JCaps(**dataclasses.asdict(mp_ing.caps))
    return JIngestor(JHashTokenizer(vocab_size=4096), spec, caps).ingest(j_make_corpus(*docs_args[0], **docs_args[1]))


def _same_batch(got, want, keys=AUX_KEYS):
    b_mp, aux_mp = got
    b_ref, aux_ref = want
    for f in dataclasses.fields(b_ref):
        np.testing.assert_array_equal(np.asarray(getattr(b_mp, f.name)), np.asarray(getattr(b_ref, f.name)),
                                      err_msg=f"array mismatch: {f.name}")
    for k in keys:
        assert aux_mp[k] == aux_ref[k], k


def test_mp_ingest_matches_single_process(pool):
    args = ((8,), dict(n_pages=3, words_per_page=40, seed=7))
    docs = make_corpus(*args[0], **args[1])
    pool.caps = pool.plan_caps(docs)
    got = pool.ingest(docs)
    _same_batch(got, _jax_ingest(pool, args))
    assert len(got[1]["images"]) == len(docs) and len(got[1]["layouts"]) == len(docs)


def test_mp_ingest_small_batch_uses_local_path(pool):
    args = ((2,), dict(n_pages=2, words_per_page=30, seed=8))
    docs = make_corpus(*args[0], **args[1])
    pool.caps = pool.plan_caps(docs)
    _same_batch(pool.ingest(docs), _jax_ingest(pool, args))


def test_mp_imap_order_and_parity(pool):
    docs = make_corpus(12, n_pages=2, words_per_page=30, seed=9)
    jdocs = j_make_corpus(12, n_pages=2, words_per_page=30, seed=9)
    pool.caps = pool.plan_caps(docs)
    ref = JIngestor(JHashTokenizer(vocab_size=4096), JChunkSpec(**dataclasses.asdict(pool.spec)),
                    JCaps(**dataclasses.asdict(pool.caps)))
    got = list(pool.imap([docs[i: i + 4] for i in range(0, 12, 4)], depth=2))
    assert len(got) == 3
    for i, part in enumerate(got):
        _same_batch(part, ref.ingest(jdocs[4 * i: 4 * i + 4]))


def test_mp_caps_resync(pool):
    """Caps changed between calls reach the workers (they ride with each
    task): both batches equal the JAX ingest at their caps."""
    args = ((8,), dict(n_pages=2, words_per_page=30, seed=10))
    docs = make_corpus(*args[0], **args[1])
    pool.caps = pool.plan_caps(docs)
    b1 = pool.ingest(docs)
    _same_batch(b1, _jax_ingest(pool, args))
    pool.caps = dataclasses.replace(pool.caps, max_chunks=pool.caps.max_chunks * 2)
    b2 = pool.ingest(docs)
    _same_batch(b2, _jax_ingest(pool, args))
    assert b2[0].chunk_mask.shape[1] == b1[0].chunk_mask.shape[1] * 2


def test_word_matrix_cache_consistency():
    """The port's single-process ingest (the workers' own) is insensitive to
    a warm word-matrix cache and to caps changes: a warm and a cold ingestor
    give the JAX arrays, and a wider tokens_per_word rebuilds the matrix."""
    docs = make_corpus(6, n_pages=2, words_per_page=40, seed=11)
    spec = ChunkSpec(chunk_size=10, overlap=2)
    a, b = DocVQAIngestor(HashTokenizer(vocab_size=4096), spec), DocVQAIngestor(HashTokenizer(vocab_size=4096), spec)
    a.caps = b.caps = a.plan_caps(docs)
    ref = JIngestor(JHashTokenizer(vocab_size=4096), JChunkSpec(chunk_size=10, overlap=2),
                    JCaps(**dataclasses.asdict(a.caps)))
    want = ref.ingest(j_make_corpus(6, n_pages=2, words_per_page=40, seed=11))
    a.ingest(docs)
    _same_batch(a.ingest(docs), want)
    _same_batch(b.ingest(docs), want)
    a.caps = dataclasses.replace(a.caps, tokens_per_word=a.caps.tokens_per_word + 2)
    ref.caps = JCaps(**dataclasses.asdict(a.caps))
    wide = a.ingest(docs)
    _same_batch(wide, ref.ingest(j_make_corpus(6, n_pages=2, words_per_page=40, seed=11)))
    assert wide[0].slot_tokens.shape[2] == want[0].slot_tokens.shape[2] + 2


def test_workers_hide_the_card_and_skip_torch(pool):
    """A worker sees no CUDA device (`CUDA_VISIBLE_DEVICES` empty) and has not
    imported torch: the host data layer it runs needs numpy only."""
    pool.caps = pool.plan_caps(make_corpus(4, n_pages=2, words_per_page=20, seed=12))
    pool.ingest(make_corpus(4, n_pages=2, words_per_page=20, seed=12))  # every worker has started
    probe = "(__import__('os').environ.get('CUDA_VISIBLE_DEVICES'), 'torch' in __import__('sys').modules)"
    seen = {pool._pool.submit(eval, probe).result() for _ in range(4)}
    assert seen == {("", False)}
