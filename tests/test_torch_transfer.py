"""Port parity, the host -> device batch transfer (`rag_docvqa_tpu_torch/
data/transfer.py`): the two single-device cases of `tests/test_transfer.py`
on the CPU. Every field of `device_put_batch` equals `to_device`'s bit for
bit, dtype included, whether the token ids travel as int16 (a vocabulary
below 2**15) or as they are (2**15 and above, or an id out of range); the
JAX function narrows in the same cases. `evaluate`, which copies its batches
with it, gives the outputs it gave with `to_device`. Exact."""

import dataclasses

import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.data.transfer import device_put_batch as j_device_put_batch
from rag_docvqa_tpu.ops.chunking import ChunkSpec as JChunkSpec
from rag_docvqa_tpu_torch.data import contract
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.data.transfer import TOKEN_FIELDS, device_put_batch, device_put_batch_async, narrow_tokens
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

torch.set_num_threads(2)


def _batch(vocab: int, n: int, seed: int):
    ing = DocVQAIngestor(HashTokenizer(vocab_size=vocab), ChunkSpec(chunk_size=10, overlap=2))
    docs = make_corpus(n, n_pages=2, words_per_page=30, seed=seed)
    ing.caps = ing.plan_caps(docs)
    return ing.ingest(docs)[0]


def _same_as_to_device(got, batch):
    want = contract.to_device(batch, "cpu")
    for f in dataclasses.fields(batch):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name


@pytest.mark.parametrize("vocab,n,seed", [(2048, 4, 7), (151936, 2, 8)], ids=["int16", "big_vocab_passthrough"])
def test_device_put_batch_equals_to_device(vocab, n, seed):
    batch = _batch(vocab, n, seed)
    _same_as_to_device(device_put_batch(batch, vocab, "cpu"), batch)
    pending = device_put_batch_async(batch, vocab, "cpu")
    sizes = {f.name: np.asarray(getattr(batch, f.name)).nbytes for f in dataclasses.fields(batch)}
    tokens = sum(sizes[f] for f in TOKEN_FIELDS)
    narrow = vocab < (1 << 15)
    # one staging buffer: int16 ids are half their int32 bytes; every field padded to 16 bytes
    assert sum(sizes.values()) - (tokens // 2 if narrow else 0) <= pending.nbytes
    assert pending.nbytes <= sum(sizes.values()) - (tokens // 2 if narrow else 0) + 16 * len(sizes)
    _same_as_to_device(pending.wait(), batch)

    # the JAX function narrows in the same cases: its batch equals the host batch
    jing = JIngestor(JHashTokenizer(vocab_size=vocab), JChunkSpec(chunk_size=10, overlap=2))
    jdocs = j_make_corpus(n, n_pages=2, words_per_page=30, seed=seed)
    jing.caps = jing.plan_caps(jdocs)
    jbatch = jing.ingest(jdocs)[0]
    jdev = j_device_put_batch(jbatch, vocab)
    for f in dataclasses.fields(batch):
        np.testing.assert_array_equal(np.asarray(getattr(jdev, f.name)), np.asarray(getattr(batch, f.name)),
                                      err_msg=f.name)
    assert narrow_tokens(batch, vocab) == narrow


def test_device_put_batch_out_of_range_id_passes_through():
    """A tokenizer whose ids exceed its stated vocabulary (an added special
    above 2**15, or a negative id) leaves every field unnarrowed, as JAX's
    min/max scan does; the copy still equals to_device's."""
    for bad in ((1 << 15) + 3, -1):
        batch = _batch(2048, 2, 9)
        batch.slot_tokens[0, 0, 0] = bad
        assert not narrow_tokens(batch, 2048)
        _same_as_to_device(device_put_batch(batch, 2048, "cpu"), batch)


def test_evaluate_outputs_unchanged_by_the_transfer(monkeypatch):
    """`evaluate` over a seeded corpus with the transfer in place and with
    `to_device` in its place: the same answers, confidences, pages and
    scores."""
    from rag_docvqa_tpu_torch.engine import evaluate as ev
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5, vt5
    from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig

    tok = HashTokenizer(4096)
    cfg = vt5.VT5Config(t5=t5.T5Config(vocab_size=4096, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                                       num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0),
                        spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    engine = RAGVT5Engine(RAGConfig(chunk_num=3, max_source_length=160, max_new_tokens=4), cfg,
                          vt5.init_vt5_params(torch.Generator().manual_seed(0), cfg), tok)
    docs = make_corpus(6, n_pages=2, words_per_page=30, seed=3)
    ing = DocVQAIngestor(tok, ChunkSpec(chunk_size=12, overlap=2))
    ing.caps = ing.plan_caps(docs)
    got = ev.evaluate(engine, docs, ing, batch_size=4)
    seen = []

    class ToDevice:
        def __init__(self, batch, vocab, device):
            seen.append(vocab)
            self.batch = contract.to_device(batch, device)

        def wait(self):
            return self.batch

    monkeypatch.setattr(ev, "device_put_batch_async", ToDevice)
    want = ev.evaluate(engine, docs, ing, batch_size=4)
    assert seen == [4096, 4096]
    assert got["pred_answers"] == want["pred_answers"]
    assert got["scores_by_samples"] == want["scores_by_samples"]
    for k in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples"):
        assert got[k] == want[k], k
