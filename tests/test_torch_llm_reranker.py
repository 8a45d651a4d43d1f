"""Port parity, the LLM pair reranker: `engine/reranker.py`'s
`build_llm_pair_tokens`, `_llm_pair_yes_logits` and `FlagLLMReranker`
against the JAX package on the same ingested batch, retrieval and Gemma-arch
weights (head_dim 16 and 256, MQA), and the "gemma" branch of
`config.build_reranker` (random weights, and a local Hugging Face Gemma
directory under tmp_path) against JAX's.

Exact: pair ids, masks and last positions (a pair_len that clamps the chunk
too), the rerank permutation and validity. The yes logits within 2e-5 of
their largest value (f32 sums in another order), the sigmoid scores within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import reranker as j_rr
from rag_docvqa_tpu.engine.rag_vt5 import retrieve_device as j_retrieve
from rag_docvqa_tpu.models import causal_lm as j_clm
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import reranker as p_rr
from rag_docvqa_tpu_torch.engine.rag_vt5 import retrieve
from rag_docvqa_tpu_torch.models import causal_lm as p_clm

torch.set_num_threads(2)

VOCAB, K = 512, 5
CAPS = dict(max_pages=2, max_chunks=8, max_slots=64)
SPEC = ChunkSpec(chunk_size=8, overlap=2)
GEMMA = {hd: dict(vocab_size=VOCAB, d_model=32, num_layers=2, num_heads=4, num_kv_heads=1, d_ff=64, qkv_bias=False,
                  arch="gemma", head_dim_override=hd) for hd in (16, 256)}


@pytest.fixture(scope="module")
def world():
    jb, jaux = JIngestor(JHashTokenizer(VOCAB), SPEC, JCaps(**CAPS)).ingest(
        j_make_corpus(3, n_pages=2, words_per_page=24, seed=3))
    pb, paux = DocVQAIngestor(HashTokenizer(VOCAB), SPEC, Caps(**CAPS)).ingest(
        make_corpus(3, n_pages=2, words_per_page=24, seed=3))
    pb = to_device(pb, "cpu")
    table = np.random.RandomState(1).randn(VOCAB, 32).astype(np.float32)
    jret = j_retrieve(jnp.asarray(table), jb, k=K)
    pret = retrieve(torch.from_numpy(table), pb, k=K)
    np.testing.assert_array_equal(pret.top_k_idx.numpy(), np.asarray(jret.top_k_idx))
    return dict(jb=jb, pb=pb, jret=jret, pret=pret)


def _rerankers(hd, **cfg_kw):
    jl = j_clm.CausalLMConfig(**GEMMA[hd])
    tree = j_clm.init_causal_lm_params(jax.random.PRNGKey(0), jl)
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.RandomState(2)  # off the unit norms, so that Gemma's (1 + w) matters
    tree = jax.tree.unflatten(treedef, [jnp.asarray(np.asarray(x) + 0.1 * rng.randn(*x.shape), jnp.float32)
                                        for x in leaves])
    jr = j_rr.FlagLLMReranker(j_rr.RerankerConfig(**cfg_kw), jl, tree, JHashTokenizer(VOCAB))
    pr = p_rr.FlagLLMReranker(p_rr.RerankerConfig(**cfg_kw), p_clm.CausalLMConfig(**GEMMA[hd]),
                              p_params.causal_lm_from_jax(jax.tree.map(np.asarray, tree)), HashTokenizer(VOCAB))
    return jr, pr


@pytest.mark.parametrize("pair_len", [96, 44])
def test_llm_pair_tokens_exact(world, pair_len):
    """prefix ++ question ++ mid ++ chunk ++ suffix; at pair_len 44 the chunk
    is clamped to keep the suffix."""
    jr, pr = _rerankers(16, pair_len=pair_len)
    assert pr.yes_id == jr.yes_id
    want = j_rr.build_llm_pair_tokens(world["jb"], world["jret"].top_k_idx, jr._prefix, jr._mid, jr._suffix, jr.cfg,
                                      n_prefix=int(jr._prefix.shape[0]), n_mid=int(jr._mid.shape[0]),
                                      n_suffix=int(jr._suffix.shape[0]))
    got = p_rr.build_llm_pair_tokens(world["pb"], world["pret"].top_k_idx, pr._prefix, pr._mid, pr._suffix, pr.cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int32 and got[0].shape == (3 * K, pair_len)
    with pytest.raises(ValueError, match="pair_len"):
        p_rr.build_llm_pair_tokens(world["pb"], world["pret"].top_k_idx, pr._prefix, pr._mid, pr._suffix,
                                   p_rr.RerankerConfig(pair_len=len(pr._suffix)))


@pytest.mark.parametrize("hd", [16, 256])
def test_yes_logits_and_rerank_match_jax(world, hd):
    jr, pr = _rerankers(hd, pair_len=96, filter_thresh=0.5, max_chunk_num=3)
    ids, mask, last = p_rr.build_llm_pair_tokens(world["pb"], world["pret"].top_k_idx, pr._prefix, pr._mid,
                                                 pr._suffix, pr.cfg)
    got = p_rr._llm_pair_yes_logits(pr.params, pr.lm_cfg, ids, mask, last, pr.yes_id)
    want = np.asarray(j_rr._llm_pair_yes_logits(jr.params, jr.lm_cfg, jnp.asarray(ids.numpy()),
                                                jnp.asarray(mask.numpy()), jnp.asarray(last.numpy()), jr.yes_id))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * max(1.0, np.abs(want).max()))
    jout, pout = jr(world["jb"], world["jret"]), pr(world["pb"], world["pret"])
    for name in ("top_k_idx", "top_k_valid", "top_k_page", "top_k_label", "top_k_box"):
        np.testing.assert_array_equal(getattr(pout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    s, w = pout.top_k_score.numpy(), np.asarray(jout.top_k_score)
    np.testing.assert_allclose(s[np.isfinite(w)], w[np.isfinite(w)], rtol=0, atol=1e-5)
    assert int(pout.top_k_valid.sum(dim=1).max()) <= 3


def _same_lm_cfg(port, jax_cfg):
    """Field for field on the fields JAX's config has; the port's one more,
    `mrope_section`, at its default (off)."""
    want = vars(jax_cfg)
    assert {k: v for k, v in vars(port).items() if k in want} == want and port.mrope_section == ()


def test_build_reranker_gemma_branch_matches_jax(tmp_path):
    """The "gemma" weight name: random weights of the `reranker_*` widths
    (the JAX config), and a local
    HF Gemma directory: its config.json's widths, its weights converted as
    JAX converts them."""
    c = dict(reranker_weights="BAAI/bge-reranker-v2-gemma", reranker_d_model=32, reranker_num_layers=2,
             reranker_num_heads=4, reranker_num_kv_heads=1, reranker_d_ff=64, reranker_head_dim=16,
             rerank_pair_len=96, rerank_filter_tresh=0.3)
    rr = p_config.build_reranker(c, HashTokenizer(VOCAB), seed=3, device="cpu")
    jrr = j_config.build_reranker(c, JHashTokenizer(VOCAB), seed=3)
    assert isinstance(rr, p_rr.FlagLLMReranker) and vars(rr.cfg) == vars(jrr.cfg)
    _same_lm_cfg(rr.lm_cfg, jrr.lm_cfg)
    transformers = pytest.importorskip("transformers", reason="the local-directory case writes an HF Gemma")
    hf_cfg = transformers.GemmaConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=1, head_dim=16, rope_theta=10000.0)
    torch.manual_seed(0)
    directory = tmp_path / "bge-reranker-v2-gemma"
    transformers.GemmaForCausalLM(hf_cfg).save_pretrained(str(directory), safe_serialization=True)
    c = dict(c, reranker_weights=str(directory))
    rr = p_config.build_reranker(c, HashTokenizer(VOCAB), device="cpu")
    jrr = j_config.build_reranker(c, JHashTokenizer(VOCAB))
    _same_lm_cfg(rr.lm_cfg, jrr.lm_cfg)
    for a, b in zip(jax.tree.leaves(p_params.causal_lm_to_jax(rr.params)), jax.tree.leaves(jrr.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
