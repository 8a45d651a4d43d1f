"""Golden engine-level parity of the port's per-chunk and page-vote
strategies against the independent re-assembly of the original reference
pipeline in `tests/test_engine_golden_parity.py` (its oracle helpers and
setup are imported: chunking, table-embedding retrieval, surrounding
expansion with first-cover dedup, prompt + words + EOS rows, HF greedy
generate with the confidence product).

maxconf: each retrieved rank's own generator row, exactly; the answer of the
most confident row, by HF generate over the same rows. weightmajorpage: the
page vote with the top-k-aligned similarities as weights (the JAX package's
semantics), the page's whole-page row from its original words, exactly; the
answer and its confidence (1e-4 relative) by HF generate.

The HF model's encoder rel-pos table is rounded to bf16 here (a copy of the
setup's model): the port's encoder takes the bias in bf16 on every path,
the HF oracle in f32."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from test_engine_golden_parity import (  # the reference re-assembly's oracle helpers and setup
    CAPS,
    RAG,
    SPEC,
    TOK,
    _truncate,
    oracle_chunks,
    oracle_generate,
    oracle_retrieve,
    setup,  # noqa: F401  (a fixture)
)
from rag_docvqa_tpu.models.convert import convert_t5_state_dict, torch_state_dict_to_numpy
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine, majority_page, retrieve
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops import gather as p_gather
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

pytestmark = pytest.mark.parity
torch.set_num_threads(2)

T5_KW = dict(vocab_size=TOK.vocab_size, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)


@pytest.fixture(scope="module")
def port(setup):
    """The setup's HF model with a bf16-exact encoder rel-pos table, the
    port's parameters converted from it, and the setup's documents ingested
    by the port (with the setup's tokenizer: tokenization is not under test)."""
    hf, params, spatial, docs, _, _ = setup
    hf = copy.deepcopy(hf)
    rb = hf.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    with torch.no_grad():
        rb.copy_(rb.bfloat16().float())
    t5_tree = convert_t5_state_dict(torch_state_dict_to_numpy(hf), j_t5.T5Config(**T5_KW))
    tree = {"t5": t5_tree, "spatial": {k: np.asarray(v) for k, v in spatial.items() if k != "matcher"}}
    tree["spatial"]["matcher"] = {k: np.asarray(v) for k, v in spatial["matcher"].items()}
    pparams = p_params.from_jax(tree)
    cfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    caps = Caps(**{f.name: getattr(CAPS, f.name) for f in dataclasses.fields(CAPS)})
    spec = ChunkSpec(chunk_size=SPEC.chunk_size, overlap=SPEC.overlap, chunk_size_tol=SPEC.chunk_size_tol)
    batch, aux = DocVQAIngestor(TOK, spec, caps).ingest(docs)
    return hf, spatial, docs, pparams, cfg, batch, aux


def _rag(**kw):
    return RAGConfig(chunk_num=RAG.chunk_num, include_surroundings=RAG.include_surroundings,
                     max_source_length=RAG.max_source_length, max_new_tokens=RAG.max_new_tokens, **kw)


def _row(prompt, words_boxes, S):
    """prompt ++ word tokens (per-token boxes) ++ EOS, truncated keeping the
    EOS, padded to S."""
    ids, boxes = [], []
    for t in prompt:
        ids.append(t)
        boxes.append([0, 0, 1000, 1000])
    for word, box in words_boxes:
        wb = (np.asarray(box, np.float32) * 1000).astype(np.int32).tolist()
        for t in TOK.encode_word(word)[: CAPS.tokens_per_word]:
            ids.append(t)
            boxes.append(wb)
    ids, boxes = ids[: S - 1] + [TOK.eos_id], boxes[: S - 1] + [[0, 0, 0, 0]]
    n = len(ids)
    return ids + [TOK.pad_id] * (S - n), boxes + [[0, 0, 0, 0]] * (S - n)


def test_maxconf_engine_matches_reference_reassembly(port):
    hf, spatial, docs, params, cfg, batch, aux = port
    shared = params.t5.shared.numpy()
    rag = _rag(page_retrieval="maxconf", per_chunk_seq_len=96)
    out = RAGVT5Engine(rag, cfg, params, TOK).inference(batch, aux)
    dbatch = to_device(batch, "cpu")
    ret = retrieve(params.t5.shared, dbatch, k=rag.chunk_num)
    gen, _, row_valid = p_gather.assemble_per_chunk(dbatch, ret.top_k_idx, ret.top_k_valid, rag.assemble(),
                                                    seq_len=rag.per_chunk_seq_len)
    gen_ids, gen_boxes = gen.input_ids.numpy(), gen.input_boxes.numpy()
    K, s = rag.chunk_num, rag.include_surroundings
    for b, doc in enumerate(docs):
        chunks, o_topk = oracle_retrieve(doc, shared)
        np.testing.assert_array_equal(ret.top_k_idx[b, :len(o_topk)].numpy(), o_topk)
        # each rank's new words after the first-cover dedup form its own row
        page_words, chunk_pos = {}, {}
        for ci, (p, widx) in enumerate(oracle_chunks(doc)):
            lst = page_words.setdefault(p, [])
            start = len(lst)
            lst.extend((doc.words[p][i], doc.boxes[p][i]) for i in widx)
            chunk_pos[ci] = (p, start, len(lst))
        included = {p: set() for p in page_words}
        prompt = TOK.encode(f"question: {doc.question}  context:")[: CAPS.prompt_tokens]
        for rank, ci in enumerate(o_topk):
            p, start, end = chunk_pos[int(ci)]
            new = [i for i in range(max(0, start - s), min(len(page_words[p]), end + s)) if i not in included[p]]
            included[p].update(new)
            ids, boxes = _row(prompt, [page_words[p][i] for i in new], rag.per_chunk_seq_len)
            np.testing.assert_array_equal(gen_ids[b * K + rank], np.asarray(ids, np.int32))
            np.testing.assert_array_equal(gen_boxes[b * K + rank], np.asarray(boxes, np.int32))
    o_seqs, o_conf = oracle_generate(hf, spatial, gen_ids, gen_boxes, gen.attention_mask.sum(dim=1).tolist())
    valid = row_valid.numpy()
    for b in range(len(docs)):
        rows = np.where(valid[b])[0]
        best = rows[np.argmax(o_conf[b * K + rows])]
        assert out["pred_answers"][b] == TOK.decode(_truncate(o_seqs[b * K + best], TOK.eos_id, TOK.pad_id))
        np.testing.assert_allclose(out["confidences"][b], o_conf[b * K + best], rtol=1e-4, atol=1e-5)


def test_weightmajorpage_engine_matches_reference_reassembly(port):
    hf, spatial, docs, params, cfg, batch, aux = port
    shared = params.t5.shared.numpy()
    rag = _rag(page_retrieval="weightmajorpage")
    out = RAGVT5Engine(rag, cfg, params, TOK).inference(batch, aux)
    o_pages, o_rows, o_boxes = [], [], []
    for doc in docs:
        chunks, o_topk, o_sims = oracle_retrieve(doc, shared, with_sims=True)
        votes = {}
        for ci, w in zip(o_topk, o_sims / o_sims.sum()):
            votes[chunks[int(ci)][0]] = votes.get(chunks[int(ci)][0], 0.0) + w
        page = max(sorted(votes), key=lambda p: votes[p])  # the lowest page on an exact tie
        o_pages.append(page)
        prompt = TOK.encode(f"question: {doc.question}  context:")[: CAPS.prompt_tokens]
        ids, boxes = _row(prompt, list(zip(doc.words[page], doc.boxes[page])), rag.max_source_length)
        o_rows.append(ids)
        o_boxes.append(boxes)
    assert out["pred_answer_pages"] == o_pages
    dbatch = to_device(batch, "cpu")
    ret = retrieve(params.t5.shared, dbatch, k=rag.chunk_num)
    major = majority_page(ret, True, dbatch.page_slot_start.shape[1])
    gen = p_gather.assemble_page_rows(dbatch, major[:, None], torch.ones((len(docs), 1), dtype=torch.bool),
                                      rag.assemble())
    np.testing.assert_array_equal(gen.input_ids.numpy(), np.asarray(o_rows, np.int32))
    np.testing.assert_array_equal(gen.input_boxes.numpy(), np.asarray(o_boxes, np.int32))
    o_seqs, o_conf = oracle_generate(hf, spatial, gen.input_ids.numpy(), gen.input_boxes.numpy(),
                                     gen.attention_mask.sum(dim=1).tolist())
    for b in range(len(docs)):
        assert out["pred_answers"][b] == TOK.decode(_truncate(o_seqs[b], TOK.eos_id, TOK.pad_id))
    np.testing.assert_allclose(np.asarray(out["confidences"]), o_conf, rtol=1e-4, atol=1e-5)
