"""Port parity, the rerank stage: `engine/reranker.py` against the JAX
package on the same ingested batch, and `RAGVT5Engine` with a reranker
against the JAX engine.

Integer work is exact: pair token ids and masks, the rerank permutation and
validity (ties and invalid ranks included), the decoded answers and pages.
Scores are f32 within 2e-5 (the encoder's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.contract import RetrievalResult as JRetrievalResult
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
from rag_docvqa_tpu.engine import reranker as j_rr
from rag_docvqa_tpu.engine.rag_vt5 import retrieve_device as j_retrieve
from rag_docvqa_tpu.models import bert as j_bert
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps, RetrievalResult, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import reranker as p_rr
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine, retrieve
from rag_docvqa_tpu_torch.models import bert as p_bert
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig

torch.set_num_threads(2)

VOCAB = 4096
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
CAPS = dict(max_pages=4, max_chunks=32, max_slots=384, tokens_per_word=8, embed_tokens=48)
SPEC = ChunkSpec(chunk_size=12, overlap=2)
# the reranker's form at a small width: RoBERTa positions, one token type, one label
BERT_KW = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               max_position_embeddings=130, type_vocab_size=1, position_offset=2, pad_id=1, num_labels=1)
K = 5


@pytest.fixture(scope="module")
def world():
    """One ingested batch in both packages, VT5 and reranker weights, and
    the retrieval result each package computes from them."""
    jtok, ptok = JHashTokenizer(VOCAB), HashTokenizer(VOCAB)
    jb, jaux = JIngestor(jtok, SPEC, JCaps(**CAPS)).ingest(j_make_corpus(3, n_pages=3, words_per_page=40, seed=5))
    pb_np, paux = DocVQAIngestor(ptok, SPEC, Caps(**CAPS)).ingest(make_corpus(3, n_pages=3, words_per_page=40, seed=5))
    pb = to_device(pb_np, "cpu")
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           use_visual=False)
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    rb = tree["t5"]["encoder"]["rel_bias"]  # bf16-exact, as tests/test_torch_engine.py explains
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    jbert = j_bert.BertConfig(**BERT_KW)
    btree = jax.tree.map(np.array, j_bert.init_bert_params(jax.random.PRNGKey(1), jbert))
    rng = np.random.RandomState(1)
    for n in ("q", "k", "v", "o", "fc1", "fc2"):  # scores that spread around the 0.4 threshold
        btree["blocks"][n]["kernel"] = btree["blocks"][n]["kernel"] * 5.0
    btree["cls_dense"]["kernel"] = btree["cls_dense"]["kernel"] * 20.0
    btree["cls_out"]["kernel"] = (rng.randn(64, 1) * 1.5).astype(np.float32)
    jret = j_retrieve(jnp.asarray(tree["t5"]["shared"]), jb, k=K)
    pret = retrieve(torch.from_numpy(np.array(tree["t5"]["shared"])), pb, k=K)
    np.testing.assert_array_equal(pret.top_k_idx.numpy(), np.asarray(jret.top_k_idx))
    return dict(jtok=jtok, ptok=ptok, jb=jb, jaux=jaux, pb=pb, pb_np=pb_np, paux=paux, jcfg=jcfg, pcfg=pcfg, tree=tree,
                jbert=jbert, pbert=p_bert.BertConfig(**BERT_KW), btree=btree, jret=jret, pret=pret)


PAIR_CASES = {"default": {}, "short_question": dict(question_len=3), "clipped_pair": dict(pair_len=24),
              "other_ids": dict(cls_id=7, sep_id=9, pair_len=64)}


@pytest.mark.parametrize("case", PAIR_CASES)
def test_build_pair_tokens_exact(world, case):
    kw = PAIR_CASES[case]
    want_ids, want_mask = j_rr.build_pair_tokens(world["jb"], world["jret"].top_k_idx, j_rr.RerankerConfig(**kw))
    ids, mask = p_rr.build_pair_tokens(world["pb"], world["pret"].top_k_idx, p_rr.RerankerConfig(**kw))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert ids.shape == (3 * K, kw.get("pair_len", 192)) and mask.dtype == torch.bool


@pytest.mark.parametrize("surroundings", [0, 2])
@pytest.mark.parametrize("pair_len", [192, 40])
def test_build_pair_tokens_surround_exact(world, surroundings, pair_len):
    kw = dict(rerank_on_surroundings=True, include_surroundings=surroundings, pair_len=pair_len)
    jret, pret = world["jret"], world["pret"]
    want_ids, want_mask = j_rr.build_pair_tokens_surround(world["jb"], jret.top_k_idx, jret.top_k_valid,
                                                          j_rr.RerankerConfig(**kw))
    ids, mask = p_rr.build_pair_tokens_surround(world["pb"], pret.top_k_idx, pret.top_k_valid,
                                                p_rr.RerankerConfig(**kw))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


SELECT_CASES = {
    # name: (scores (B, K), valid (B, K), config)
    "spread": ([[0.9, 0.1, 0.5, 0.7, 0.45]], [[1, 1, 1, 1, 1]], {}),
    "ties_keep_rank_order": ([[0.5, 0.5, 0.5, 0.5, 0.5], [0.7, 0.2, 0.7, 0.2, 0.7]], [[1] * 5] * 2, {}),
    "invalid_ranks_sort_last": ([[0.9, 0.95, 0.5, 0.99, 0.6]], [[1, 0, 1, 0, 1]], {}),
    "invalid_tie_with_valid": ([[0.5, 0.5, 0.5, 0.5, 0.5]], [[0, 1, 0, 1, 1]], {}),
    "none_passes_min_one": ([[0.1, 0.3, 0.2, 0.0, 0.39]], [[1] * 5], {}),
    "none_passes_none_valid": ([[0.1, 0.3, 0.2, 0.0, 0.39]], [[0] * 5], {}),
    "more_pass_than_max": ([[0.9, 0.8, 0.7, 0.6, 0.5]], [[1] * 5], dict(max_chunk_num=2)),
    "min_above_valid": ([[0.1, 0.2, 0.3, 0.1, 0.2]], [[1, 1, 0, 0, 0]], dict(min_chunk_num=3)),
    "at_the_threshold": ([[0.4, 0.39999, 0.4, 0.41, 0.0]], [[1] * 5], {}),
}


@pytest.mark.parametrize("case", SELECT_CASES)
def test_rerank_select_exact(case):
    scores, valid, kw = SELECT_CASES[case]
    scores, valid = np.asarray(scores, np.float32), np.asarray(valid, bool)
    want = j_rr.rerank_select(jnp.asarray(scores), jnp.asarray(valid), j_rr.RerankerConfig(**kw))
    perm, new_valid, sorted_scores = p_rr.rerank_select(torch.from_numpy(scores), torch.from_numpy(valid),
                                                        p_rr.RerankerConfig(**kw))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(new_valid.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(sorted_scores.numpy(), np.asarray(want[2]))  # -inf on invalid ranks in both


def test_rerank_select_random_ties_exact():
    """Many rows of scores drawn from few values, random validity: the
    stable descending sort agrees with `jnp.argsort(-x, stable=True)`."""
    rng = np.random.RandomState(0)
    scores = rng.choice(np.array([0.1, 0.39, 0.4, 0.6, 0.6, 0.9], np.float32), size=(64, 10))
    valid = rng.rand(64, 10) < 0.7
    want = j_rr.rerank_select(jnp.asarray(scores), jnp.asarray(valid), j_rr.RerankerConfig())
    got = p_rr.rerank_select(torch.from_numpy(scores), torch.from_numpy(valid), p_rr.RerankerConfig())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_apply_rerank_permutes_every_field(world):
    jret, pret = world["jret"], world["pret"]
    rng = np.random.RandomState(2)
    perm = np.stack([rng.permutation(K) for _ in range(3)])
    valid = np.arange(K)[None, :] < np.array([3, 1, 5])[:, None]
    scores = -np.sort(-rng.rand(3, K).astype(np.float32), axis=1)
    want = j_rr.apply_rerank(jret, jnp.asarray(perm), jnp.asarray(valid), jnp.asarray(scores))
    got = p_rr.apply_rerank(pret, torch.from_numpy(perm), torch.from_numpy(valid), torch.from_numpy(scores))
    for f in ("top_k_idx", "top_k_valid", "top_k_score", "top_k_page", "top_k_label", "top_k_box", "similarities"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    assert isinstance(got, RetrievalResult) and isinstance(want, JRetrievalResult)


@pytest.mark.parametrize("on_surroundings", [False, True])
def test_reranker_matches_jax(world, on_surroundings):
    kw = dict(pair_len=96, rerank_on_surroundings=on_surroundings, include_surroundings=2 if on_surroundings else 0,
              max_chunk_num=3)
    want = j_rr.Reranker(j_rr.RerankerConfig(**kw), world["jbert"], jax.tree.map(jnp.asarray, world["btree"]))(
        world["jb"], world["jret"])
    got = p_rr.Reranker(p_rr.RerankerConfig(**kw), world["pbert"], p_params.bert_from_jax(world["btree"]))(
        world["pb"], world["pret"])
    for f in ("top_k_idx", "top_k_valid", "top_k_page", "top_k_label"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.top_k_score.numpy(), np.asarray(want.top_k_score), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.top_k_box.numpy(), np.asarray(want.top_k_box), atol=1e-6)
    kept = got.top_k_valid.sum(dim=1)
    assert bool((kept >= 1).all()) and bool((kept <= 3).all())
    assert not np.array_equal(got.top_k_idx.numpy(), world["pret"].top_k_idx.numpy())  # it did reorder


@pytest.mark.parametrize("strategy", ["concat", "oracle"])
def test_engine_with_reranker_matches_jax(world, strategy):
    """The whole slice: retrieve -> rerank -> assemble -> encode -> decode.
    The oracle strategy skips the reranker in both packages."""
    rag_kw = dict(page_retrieval=strategy, chunk_num=K, include_surroundings=2, max_source_length=160, max_new_tokens=4)
    rkw = dict(pair_len=96, max_chunk_num=3)
    jrr = j_rr.Reranker(j_rr.RerankerConfig(**rkw), world["jbert"], jax.tree.map(jnp.asarray, world["btree"]))
    prr = p_rr.Reranker(p_rr.RerankerConfig(**rkw), world["pbert"], p_params.bert_from_jax(world["btree"]))
    want = JEngine(JRAGConfig(**rag_kw), world["jcfg"], jax.tree.map(jnp.asarray, world["tree"]), world["jtok"],
                   reranker=jrr).inference(world["jb"], world["jaux"])
    got = RAGVT5Engine(RAGConfig(**rag_kw), world["pcfg"], p_params.from_jax(world["tree"]), world["ptok"],
                       reranker=prr).inference(world["pb_np"], world["paux"])
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-4)
    r, w = got["retrieval"], want["retrieval"]
    assert r["top_k_layout_labels"] == w["top_k_layout_labels"] and r["text"] == w["text"]
    np.testing.assert_allclose(r["similarities"], np.asarray(w["similarities"]), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(r["boxes"], np.asarray(w["boxes"]))
    assert r["rerank_time"] >= 0.0 and set(got["timings"]) == {"retrieve_assemble_s", "encode_s", "decode_s"}
    if strategy == "concat":
        assert all(1 <= len(p) <= 3 for p in got["pred_answer_pages"])


def test_build_reranker_and_engine_from_config(world):
    c = dict(rerank=True, rerank_filter_tresh=0.3, rerank_max_chunk_num=4, rerank_pair_len=64, reranker_d_model=32,
             reranker_num_layers=1, reranker_num_heads=2, reranker_d_ff=48, include_surroundings=[2], seed=3,
             chunk_num=K, max_source_length=160, max_new_tokens=2, d_model=32, d_kv=8, num_heads=4, d_ff=64,
             num_layers=2, dropout_rate=0.0)
    rr = p_config.build_reranker(c, world["ptok"], seed=3)
    assert rr.cfg == p_rr.RerankerConfig(filter_thresh=0.3, max_chunk_num=4, pair_len=64, include_surroundings=2)
    assert rr.bert_cfg == p_bert.BertConfig(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2,
                                            intermediate_size=48, num_labels=1)
    assert rr.params.has_head and rr.params.word_emb.shape == (VOCAB, 32)
    again = p_config.build_reranker(c, world["ptok"], seed=3)
    assert torch.equal(rr.params.layers[0].fc1_w, again.params.layers[0].fc1_w)  # weights from the seed
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        p_config.build_reranker(dict(c, reranker_weights="BAAI/bge-reranker-v2-gemma"), world["ptok"])

    params = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), p_config.build_vt5_config(c, VOCAB))
    engine = p_config.build_engine(c, params, world["ptok"])
    assert isinstance(engine.reranker, p_rr.Reranker)
    out = engine.inference(world["pb_np"], world["paux"])
    assert len(out["pred_answers"]) == 3 and all(1 <= len(p) <= 4 for p in out["pred_answer_pages"])
    assert p_config.build_engine(dict(c, rerank=False), params, world["ptok"]).reranker is None
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        p_config.build_engine(dict(c, model_name="Hi-VT5"), params, world["ptok"])
