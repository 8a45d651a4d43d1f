"""Port parity, host ingest and device retrieval + concat assembly: the
port's jax-free ingest copy builds the same arrays as the JAX ingest, and
top-k, ownership, group boxes and the assembled generator inputs match the
JAX package exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.ingest import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import RetrievalResult as JRetrievalResult
from rag_docvqa_tpu.engine.rag_vt5 import reading_order_device, retrieve_device
from rag_docvqa_tpu.ops import gather as j_gather
from rag_docvqa_tpu.ops import topk as j_topk
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch.data.contract import Caps, RetrievalResult, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.rag_vt5 import reading_order, retrieve
from rag_docvqa_tpu_torch.ops import gather as p_gather
from rag_docvqa_tpu_torch.ops import topk as p_topk

torch.set_num_threads(2)

CAPS = dict(max_pages=4, max_chunks=32, max_slots=512, tokens_per_word=6, embed_tokens=48)
SPEC = ChunkSpec(chunk_size=15, overlap=3)


def _batches(n_docs=3, seed=7, force_page=False):
    jdocs = j_make_corpus(n_docs, n_pages=3, words_per_page=50, seed=seed)
    pdocs = make_corpus(n_docs, n_pages=3, words_per_page=50, seed=seed)
    jing = JIngestor(JHashTokenizer(4096), SPEC, JCaps(**CAPS))
    ping = DocVQAIngestor(HashTokenizer(4096), SPEC, Caps(**CAPS))
    if force_page:
        ping._force_page = True
    jb, jaux = jing.ingest(jdocs)
    pb, paux = ping.ingest(pdocs)
    return jb, jaux, pb, paux


@pytest.mark.parametrize("force_page", [False, True])
def test_ingest_copy_matches_jax_ingest(force_page):
    jb, jaux, pb, paux = _batches(force_page=force_page)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(pb, f.name), np.asarray(getattr(jb, f.name)), err_msg=f.name)
    assert paux["chunk_texts"] == jaux["chunk_texts"] and paux["slot_words"] == jaux["slot_words"]


def test_fallback_reuses_doc_level_chunks(monkeypatch):
    """A doc the doc-level path refuses (a word that re-splits) is chunked
    once per page, not twice, and still matches the JAX ingest."""
    import rag_docvqa_tpu_torch.data.ingest as p_ingest

    jdocs = j_make_corpus(2, n_pages=3, words_per_page=40, seed=3)
    pdocs = make_corpus(2, n_pages=3, words_per_page=40, seed=3)
    for d in (jdocs[0], pdocs[0]):
        d.words[1][5] = "two words"  # re-splits under str.split
    calls = []
    real = p_ingest.chunk_page
    monkeypatch.setattr(p_ingest, "chunk_page", lambda *a, **k: calls.append(1) or real(*a, **k))
    pb, _ = DocVQAIngestor(HashTokenizer(4096), SPEC, Caps(**CAPS)).ingest(pdocs)
    jb, _ = JIngestor(JHashTokenizer(4096), SPEC, JCaps(**CAPS)).ingest(jdocs)
    assert len(calls) == 6  # 2 docs x 3 pages
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(pb, f.name), np.asarray(getattr(jb, f.name)), err_msg=f.name)


def test_masked_topk_ties_break_to_lowest_index():
    rng = np.random.RandomState(0)
    scores = rng.randint(0, 4, size=(5, 40)).astype(np.float32)  # many ties
    mask = rng.rand(5, 40) > 0.3
    mask[4] = False  # no valid candidate
    mask[3, :3] = True
    mask[3, 3:] = False  # fewer valid than k
    vj, ij, okj = j_topk.masked_topk(jnp.asarray(scores), jnp.asarray(mask), 6)
    vp, ip, okp = p_topk.masked_topk(torch.from_numpy(scores), torch.from_numpy(mask), 6)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    x = rng.randn(3, 7).astype(np.float32)
    np.testing.assert_allclose(p_topk.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j_topk.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def _jbatch(jb):
    return jax.tree.map(jnp.asarray, jb)


@pytest.mark.parametrize("oracle", [False, True])
def test_retrieve_matches(oracle):
    jb, _, pb, _ = _batches()
    rng = np.random.RandomState(1)
    shared = rng.randn(4096, 16).astype(np.float32)
    rj = retrieve_device(jnp.asarray(shared), _jbatch(jb), k=4, oracle=oracle)
    rp = retrieve(torch.from_numpy(shared), to_device(pb, "cpu"), k=4, oracle=oracle)
    for name in ("top_k_idx", "top_k_valid", "top_k_page", "top_k_label"):
        np.testing.assert_array_equal(getattr(rp, name).numpy(), np.asarray(getattr(rj, name)), err_msg=name)
    np.testing.assert_array_equal(rp.top_k_box.numpy(), np.asarray(rj.top_k_box))
    np.testing.assert_allclose(rp.top_k_score.numpy(), np.asarray(rj.top_k_score), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rp.similarities.numpy(), np.asarray(rj.similarities), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reading_order_matches_jax(seed):
    """`reorder_chunks`: seeded top-k sets with the chunks in random order, one
    chunk drawn twice (a tie in (page, slot_start): the stable sort keeps its
    rank order), invalid rows in the middle and a row with no valid chunk.
    Everything is moved, nothing computed: all outputs equal exactly."""
    jb, _, pb, _ = _batches(seed=7 + seed)
    rng = np.random.RandomState(seed)
    B, C = jb.chunk_mask.shape
    K = 6
    idx = np.stack([rng.permutation(C)[:K] for _ in range(B)]).astype(np.int32)
    idx[:, 4] = idx[:, 1]
    valid = jb.chunk_mask[np.arange(B)[:, None], idx] & (rng.rand(B, K) > 0.25)
    valid[-1] = False
    rows = np.arange(B)[:, None]
    fields = dict(top_k_idx=idx, top_k_valid=valid, top_k_score=rng.rand(B, K).astype(np.float32),
                  top_k_page=jb.chunk_page[rows, idx], top_k_label=jb.chunk_label[rows, idx],
                  top_k_box=jb.chunk_box[rows, idx], similarities=rng.rand(B, C).astype(np.float32))
    want = reading_order_device(JRetrievalResult(**{k: jnp.asarray(v) for k, v in fields.items()}), _jbatch(jb))
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    tfields["top_k_idx"] = tfields["top_k_idx"].long()
    got = reading_order(RetrievalResult(**tfields), to_device(pb, "cpu"))
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # the sort did something, and invalid rows went to the end
    assert not np.array_equal(got.top_k_idx.numpy(), idx)
    v = got.top_k_valid.numpy()
    assert all(not v[b, i] or v[b, :i].all() for b in range(B) for i in range(K))


@pytest.mark.parametrize("surround,sep,max_len", [(0, 0, 160), (2, 0, 160), (1, 7, 160), (3, 7, 48)])
def test_assemble_concat_exact(surround, sep, max_len):
    jb, _, pb, _ = _batches(n_docs=4, seed=11)
    rng = np.random.RandomState(surround + sep)
    B, C = jb.chunk_mask.shape
    K = 5
    idx = np.stack([rng.permutation(C)[:K] for _ in range(B)]).astype(np.int32)
    valid = jb.chunk_mask[np.arange(B)[:, None], idx] & (rng.rand(B, K) > 0.2)
    jcfg = j_gather.AssembleConfig(max_source_length=max_len, include_surroundings=surround, sep_token_id=sep)
    pcfg = p_gather.AssembleConfig(max_source_length=max_len, include_surroundings=surround, sep_token_id=sep)
    gj, oj = j_gather.assemble_concat(_jbatch(jb), jnp.asarray(idx), jnp.asarray(valid), jcfg)
    pbd = to_device(pb, "cpu")
    gp, op = p_gather.assemble_concat(pbd, torch.from_numpy(idx).long(), torch.from_numpy(valid), pcfg)
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    for name in ("input_ids", "input_boxes", "input_labels", "attention_mask"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(), np.asarray(getattr(gj, name)), err_msg=name)
    np.testing.assert_array_equal(p_gather.group_boxes(pbd, op, K).numpy(),
                                  np.asarray(j_gather.group_boxes(_jbatch(jb), oj, K)))


def _topk_sets(jb, K, seed):
    """Seeded top-k sets: distinct chunks, a few invalid ranks, and the last
    sample with no valid rank at all."""
    rng = np.random.RandomState(seed)
    B = jb.chunk_mask.shape[0]
    idx = np.stack([rng.permutation(np.flatnonzero(jb.chunk_mask[b]))[:K] for b in range(B)]).astype(np.int32)
    valid = rng.rand(B, K) > 0.2
    valid[0, 0] = True
    valid[-1] = False
    return idx, valid


def _same_rows(gp, gj):
    for name in ("input_ids", "input_boxes", "input_labels", "attention_mask"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(), np.asarray(getattr(gj, name)), err_msg=name)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("surround,seq_len", [(0, 96), (2, 96), (2, 24)])
def test_assemble_per_chunk_exact(K, surround, seq_len):
    """One row per (sample, rank) of `seq_len` (24 truncates, keeping the
    EOS), the rank's own slots after first-cover ownership, exactly."""
    jb, _, pb, _ = _batches(n_docs=4, seed=13)
    idx, valid = _topk_sets(jb, K, seed=K + surround)
    jcfg = j_gather.AssembleConfig(max_source_length=160, include_surroundings=surround, sep_token_id=7)
    pcfg = p_gather.AssembleConfig(max_source_length=160, include_surroundings=surround, sep_token_id=7)
    gj, oj, vj = j_gather.assemble_per_chunk(_jbatch(jb), jnp.asarray(idx), jnp.asarray(valid), jcfg, seq_len=seq_len)
    gp, op, vp = p_gather.assemble_per_chunk(to_device(pb, "cpu"), torch.from_numpy(idx).long(),
                                             torch.from_numpy(valid), pcfg, seq_len=seq_len)
    assert gp.input_ids.shape == (4 * K, seq_len)
    _same_rows(gp, gj)
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    assert not vp[-1].any() and vp.any()


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("surround", [0, 2])
def test_assemble_page_rows_exact(K, surround):
    """Whole-page rows from the raw words, one per (sample, rank), an invalid
    rank's row the prompt alone; the pages of the top-k, exactly."""
    jb, _, pb, _ = _batches(n_docs=4, seed=17)
    idx, valid = _topk_sets(jb, K, seed=10 + K)
    pages = jb.chunk_page[np.arange(idx.shape[0])[:, None], idx]
    jcfg = j_gather.AssembleConfig(max_source_length=160, include_surroundings=surround)
    pcfg = p_gather.AssembleConfig(max_source_length=160, include_surroundings=surround)
    gj = j_gather.assemble_page_rows(_jbatch(jb), jnp.asarray(pages), jnp.asarray(valid), jcfg)
    gp = p_gather.assemble_page_rows(to_device(pb, "cpu"), torch.from_numpy(pages).long(), torch.from_numpy(valid),
                                     pcfg)
    assert gp.input_ids.shape == (4 * K, 160)
    _same_rows(gp, gj)


@pytest.mark.parametrize("weighted", [False, True])
def test_majority_page_and_full_document_match_jax(weighted):
    """The (weighted) page vote, with ranks of one page, negative weights and
    a sample with no valid rank (page 0), and the no-retrieval row of every
    raw word of the document."""
    from rag_docvqa_tpu.engine import rag_vt5 as j_rag
    from rag_docvqa_tpu_torch.engine import rag_vt5 as p_rag

    jb, _, pb, _ = _batches(n_docs=5, seed=19)
    idx, valid = _topk_sets(jb, 6, seed=3)
    B, K = idx.shape
    rows = np.arange(B)[:, None]
    rng = np.random.RandomState(4)
    fields = dict(top_k_idx=idx, top_k_valid=valid, top_k_score=rng.randn(B, K).astype(np.float32),
                  top_k_page=jb.chunk_page[rows, idx], top_k_label=jb.chunk_label[rows, idx],
                  top_k_box=jb.chunk_box[rows, idx], similarities=rng.rand(B, jb.chunk_mask.shape[1]).astype(np.float32))
    P = jb.page_slot_start.shape[1]
    want = j_rag.majority_page_device(JRetrievalResult(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                      weighted=weighted, n_pages=P)
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    got = p_rag.majority_page(RetrievalResult(**tfields), weighted, P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[-1]) == 0
    cfg = p_gather.AssembleConfig(max_source_length=200)
    _same_rows(p_rag._assemble_full_doc(to_device(pb, "cpu"), cfg),
               j_rag._assemble_full_doc(_jbatch(jb), j_gather.AssembleConfig(max_source_length=200)))
