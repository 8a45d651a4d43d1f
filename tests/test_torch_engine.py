"""Port parity, the whole slice: `RAGVT5Engine.inference` with the concat
and oracle strategies on the VT5_tiny.yml dims against the JAX engine on
the same ingested batch and weights, with `reorder_chunks` down to the
assembled token ids, and where its `retrieval_time` clock stops; the port
running with jax, flax, optax and orbax unimportable; and chip_smoke.py
refusing to run without a GPU."""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
from rag_docvqa_tpu.engine import rag_vt5 as j_rag
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import rag_vt5 as p_rag
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# configs/VT5_tiny.yml: d_model 32, d_kv 8, 4 heads, d_ff 64, 2 layers,
# chunk_num 3, chunk_size 12, overlap 2, include_surroundings 2,
# max_source_length 160, max_new_tokens 4
T5_KW = dict(vocab_size=4096, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
RAG_KW = dict(chunk_num=3, include_surroundings=2, max_source_length=160, max_new_tokens=4)
CAPS = dict(max_pages=4, max_chunks=32, max_slots=384, tokens_per_word=8, embed_tokens=48)
SPEC = ChunkSpec(chunk_size=12, overlap=2)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           use_visual=False)
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    # bf16-exact encoder rel-pos table: the port's engine encodes through the
    # whole-layer path (bias in bf16), the JAX engine on the CPU through the
    # plain blocks (bias in f32); with this table both see the same bias
    rb = tree["t5"]["encoder"]["rel_bias"]
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    return jcfg, tree, pcfg, p_params.from_jax(tree)


def _capture_rows(monkeypatch):
    """Wraps both engines' encode-and-decode step to keep, per call, the
    generator rows it was given and the decoded ids and confidences of every
    row."""
    jseen, pseen = [], []
    j_inner = j_rag.generate_device

    def j_wrapped(params, cfg, gen, max_new_tokens, visual=None):
        tokens, conf = j_inner(params, cfg, gen, max_new_tokens, visual=visual)
        jseen.append(dict(gen=jax.tree.map(np.asarray, gen), tokens=np.asarray(tokens), conf=np.asarray(conf)))
        return tokens, conf

    p_inner = RAGVT5Engine._generate

    def p_wrapped(self, gen, visual=None):
        tokens, conf = p_inner(self, gen, visual)
        pseen.append(dict(gen={k: np.asarray(v) for k, v in vars(gen).items()}, tokens=tokens,
                          conf=conf.cpu().numpy()))
        return tokens, conf

    monkeypatch.setattr(j_rag, "generate_device", j_wrapped)
    monkeypatch.setattr(RAGVT5Engine, "_generate", p_wrapped)
    return jseen, pseen


def _near_tie(values, rel=1e-5) -> bool:
    """Whether the two largest of `values` lie within `rel` of the largest."""
    top = np.sort(np.asarray(values, np.float64))[::-1]
    return len(top) > 1 and top[0] - top[1] <= rel * abs(top[0])


def _check_choice(strategy, got, want, jrows, jb):
    """maxconf, maxconfpage and weightmajorpage choose one row or page by a
    float: where the top two are more than 1e-5 (relative) apart the port's
    answer and page must be JAX's; closer than that, its answer (or page)
    one of JAX's tied candidates'."""
    B = len(want["pred_answers"])
    K = RAG_KW["chunk_num"]
    for b in range(B):
        if strategy in ("maxconf", "maxconfpage"):
            conf = jrows["conf"].reshape(B, K)[b]
            if strategy == "maxconf":
                valid = np.asarray(want["_row_valid"])[b]
            else:
                valid = np.asarray(want["_top_k_valid"])[b]
            rows = np.where(valid)[0]
            if len(rows) and _near_tie(conf[rows]):
                tied = [r for r in rows if conf[r] >= conf[rows].max() * (1 - 1e-5)]
                assert got["pred_answers"][b] in [want["_row_answers"][b * K + r] for r in tied], b
                continue
        elif strategy == "weightmajorpage":
            w = np.where(want["_top_k_valid"][b], want["retrieval"]["similarities"][b], 0.0).astype(np.float64)
            votes = np.zeros(jb.page_slot_start.shape[1])
            np.add.at(votes, np.asarray(want["_top_k_page"])[b], w)
            if _near_tie(votes):
                tied = np.where(votes >= votes.max() - 1e-5 * abs(votes.max()))[0].tolist()
                assert got["pred_answer_pages"][b] in tied, b
                continue
        assert got["pred_answers"][b] == want["pred_answers"][b], (strategy, b)
        assert got["pred_answer_pages"][b] == want["pred_answer_pages"][b], (strategy, b)


@pytest.mark.parametrize("strategy", j_rag.STRATEGIES)
def test_engine_matches_jax(weights, strategy, monkeypatch):
    """Every strategy on the same ingested batch and weights: the generator
    rows (ids, boxes, labels, mask) of the concat, per-chunk, page-row and
    full-document assembly exactly, each row's decoded ids exactly and its
    confidence to 1e-4, then the answers, pages and retrieval details."""
    jcfg, tree, pcfg, port = weights
    assert p_rag.STRATEGIES == j_rag.STRATEGIES
    jtok, ptok, jb, jaux, pb, paux = _ingested()
    jseen, pseen = _capture_rows(monkeypatch)
    jeng = JEngine(JRAGConfig(page_retrieval=strategy, **RAG_KW), jcfg, jax.tree.map(jax.numpy.asarray, tree), jtok)
    want = jeng.inference(jb, jaux)
    got = RAGVT5Engine(RAGConfig(page_retrieval=strategy, **RAG_KW), pcfg, port, ptok).inference(pb, paux)
    assert len(jseen) == len(pseen) == 1
    jr, pr = jseen[0], pseen[0]
    n_rows = {"maxconf": 3 * 3, "anyconf": 3 * 3, "anyconforacle": 3 * 3, "maxconfpage": 3 * 3,
              "anyconfpage": 3 * 3}.get(strategy, 3)
    seq = 256 if strategy in ("maxconf", "anyconf", "anyconforacle") else RAG_KW["max_source_length"]
    assert pr["gen"]["input_ids"].shape == (n_rows, seq)
    for k in ("input_ids", "input_boxes", "input_labels", "attention_mask"):
        np.testing.assert_array_equal(pr["gen"][k], getattr(jr["gen"], k), err_msg=k)
    np.testing.assert_array_equal(pr["tokens"], jr["tokens"])
    np.testing.assert_allclose(pr["conf"], jr["conf"], rtol=1e-4)

    if strategy in ("maxconf", "maxconfpage", "weightmajorpage"):
        jret = jeng.retrieve(jb)
        want["_top_k_valid"], want["_top_k_page"] = np.asarray(jret.top_k_valid), np.asarray(jret.top_k_page)
        if strategy == "maxconf":
            from rag_docvqa_tpu.ops.gather import assemble_per_chunk as j_per_chunk

            want["_row_valid"] = np.asarray(j_per_chunk(jb, jret.top_k_idx, jret.top_k_valid, jeng.cfg.assemble(),
                                                        seq_len=256)[2])
        want["_row_answers"] = jeng._decode(jr["tokens"])
        _check_choice(strategy, got, want, jr, jb)
    else:
        assert got["pred_answers"] == want["pred_answers"]
        assert got["pred_answer_pages"] == want["pred_answer_pages"]
    # a tied choice (within 1e-5) moves the confidence by less than this too
    if strategy.startswith("any"):
        for g, w in zip(got["confidences"], want["confidences"]):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_allclose(g, w, rtol=1e-4)
    else:
        np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-4)
    r, w = got["retrieval"], want["retrieval"]
    assert r.keys() == w.keys()
    if strategy != "none":
        np.testing.assert_allclose(r["similarities"], w["similarities"], rtol=1e-5, atol=1e-5)
        assert r["top_k_layout_labels"] == w["top_k_layout_labels"]
        np.testing.assert_array_equal(r["boxes"], np.asarray(w["boxes"]))
        assert r["text"] == w["text"]
    assert set(got["timings"]) == {"retrieve_assemble_s", "encode_s", "decode_s"}


def _ingested(seed=5):
    jdocs = j_make_corpus(3, n_pages=3, words_per_page=40, seed=seed)
    pdocs = make_corpus(3, n_pages=3, words_per_page=40, seed=seed)
    jtok, ptok = JHashTokenizer(4096), HashTokenizer(4096)
    jb, jaux = JIngestor(jtok, SPEC, JCaps(**CAPS)).ingest(jdocs)
    pb, paux = DocVQAIngestor(ptok, SPEC, Caps(**CAPS)).ingest(pdocs)
    return jtok, ptok, jb, jaux, pb, paux


def _capture_assembled(monkeypatch, module):
    """Wraps the module's `assemble_concat` to keep the token ids it returns."""
    seen = []
    inner = module.assemble_concat

    def wrapped(*args, **kwargs):
        gen, owner = inner(*args, **kwargs)
        seen.append(np.asarray(gen.input_ids))
        return gen, owner

    monkeypatch.setattr(module, "assemble_concat", wrapped)
    return seen


def test_reorder_chunks_engine_matches_jax(weights, monkeypatch):
    """A config with `reorder_chunks: true` gives the JAX engine's assembled
    token ids exactly (reading order after retrieval, never for oracle)."""
    jcfg, tree, pcfg, port = weights
    jtok, ptok, jb, jaux, pb, paux = _ingested()
    kw = dict(RAG_KW, chunk_num=5, include_surroundings=1)
    c = dict(kw, reorder_chunks=True, page_retrieval="concat")
    prag = p_config.build_rag_config(c)
    assert prag.reorder_chunks and j_config.build_rag_config(c).reorder_chunks
    assert not p_config.build_rag_config({}).reorder_chunks
    jseen, pseen = _capture_assembled(monkeypatch, j_rag), _capture_assembled(monkeypatch, p_rag)
    want = JEngine(JRAGConfig(reorder_chunks=True, **kw), jcfg, jax.tree.map(jax.numpy.asarray, tree),
                   jtok).inference(jb, jaux)
    got = RAGVT5Engine(prag, pcfg, port, ptok).inference(pb, paux)
    np.testing.assert_array_equal(pseen[0], jseen[0])
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    assert got["retrieval"]["top_k_layout_labels"] == want["retrieval"]["top_k_layout_labels"]
    np.testing.assert_array_equal(got["retrieval"]["boxes"], np.asarray(want["retrieval"]["boxes"]))
    # the key changes what the generator reads: without it the ids differ
    RAGVT5Engine(RAGConfig(**kw), pcfg, port, ptok).inference(pb, paux)
    assert not np.array_equal(pseen[1], pseen[0])
    a = RAGVT5Engine(RAGConfig(reorder_chunks=True, page_retrieval="oracle", **kw), pcfg, port, ptok).inference(pb, paux)
    b = RAGVT5Engine(RAGConfig(page_retrieval="oracle", **kw), pcfg, port, ptok).inference(pb, paux)
    np.testing.assert_array_equal(pseen[2], pseen[3])
    assert a["pred_answers"] == b["pred_answers"]


def test_retrieval_time_ends_before_assembly(weights, monkeypatch):
    """The assembly counts as generation, as in the JAX engine: a slow
    `assemble_concat` lengthens `generation_time` and `retrieve_assemble_s`,
    not `retrieval_time`."""
    _, _, pcfg, port = weights
    _, ptok, _, _, pb, paux = _ingested()
    engine = RAGVT5Engine(RAGConfig(**RAG_KW), pcfg, port, ptok)
    engine.inference(pb, paux)  # warm
    pause = 0.4
    inner = p_rag.assemble_concat

    def slow(*args, **kwargs):
        time.sleep(pause)
        return inner(*args, **kwargs)

    monkeypatch.setattr(p_rag, "assemble_concat", slow)
    slowed = engine.inference(pb, paux)
    r, t = slowed["retrieval"], slowed["timings"]
    assert r["retrieval_time"] < pause
    assert r["generation_time"] >= pause
    assert t["retrieve_assemble_s"] >= pause
    assert r["generation_time"] >= t["encode_s"] + t["decode_s"]


def test_evaluate_matches_jax(weights, tmp_path):
    """The port's `evaluate` against the JAX one: 5 documents in batches of
    2 (a ragged last batch), the same summary, per-sample scores and saved
    file."""
    from rag_docvqa_tpu.engine.evaluate import evaluate as j_evaluate
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate

    jcfg, tree, pcfg, port = weights
    jtok, ptok = JHashTokenizer(4096), HashTokenizer(4096)
    jeng = JEngine(JRAGConfig(**RAG_KW), jcfg, jax.tree.map(jax.numpy.asarray, tree), jtok)
    peng = RAGVT5Engine(RAGConfig(**RAG_KW), pcfg, port, ptok)
    want = j_evaluate(jeng, j_make_corpus(5, n_pages=2, words_per_page=30, seed=7),
                      JIngestor(jtok, SPEC, JCaps(**CAPS)), batch_size=2, save_path=str(tmp_path / "jax.json"))
    got = evaluate(peng, make_corpus(5, n_pages=2, words_per_page=30, seed=7),
                   DocVQAIngestor(ptok, SPEC, Caps(**CAPS)), batch_size=2, save_path=str(tmp_path / "port.json"))
    assert got["n_samples"] == want["n_samples"] == 5
    for k in ("accuracy", "anls", "retrieval_precision", "chunk_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["pred_answers"] == want["pred_answers"]
    assert got["scores_by_samples"].keys() == want["scores_by_samples"].keys()
    for qid, w in want["scores_by_samples"].items():
        g = got["scores_by_samples"][qid]
        assert g.keys() == w.keys()
        for k in ("pred_answer", "pred_answer_pages", "gt_answer_page", "accuracy", "anls", "retrieval_precision",
                  "chunk_score"):
            assert g[k] == w[k], (qid, k)
        np.testing.assert_allclose(g["pred_answer_conf"], w["pred_answer_conf"], rtol=1e-4)
    saved, jsaved = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert saved.keys() == jsaved.keys() and saved["scores_by_samples"].keys() == jsaved["scores_by_samples"].keys()


JAX_FREE = textwrap.dedent("""
    import json, sys
    for name in ("jax", "flax", "optax", "orbax"):
        sys.modules[name] = None   # any import of them now fails
    import torch
    torch.set_num_threads(2)
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
    from rag_docvqa_tpu_torch.metrics.anls import anls
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5, vt5
    from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
    # every module of the port imports without them
    import rag_docvqa_tpu_torch.config, rag_docvqa_tpu_torch.train, rag_docvqa_tpu_torch.engine.evaluate
    import rag_docvqa_tpu_torch.training.trainer, rag_docvqa_tpu_torch.training.checkpoint
    import rag_docvqa_tpu_torch.training.logger, rag_docvqa_tpu_torch.data.prefetch
    import rag_docvqa_tpu_torch.precompute, rag_docvqa_tpu_torch.params, rag_docvqa_tpu_torch.native
    import rag_docvqa_tpu_torch.parallel.index, rag_docvqa_tpu_torch.ops.quant, rag_docvqa_tpu_torch.ops.topk
    import rag_docvqa_tpu_torch.metrics.evaluator, rag_docvqa_tpu_torch.metrics.mmlongbench
    import rag_docvqa_tpu_torch.models.bert, rag_docvqa_tpu_torch.models.embedder, rag_docvqa_tpu_torch.engine.reranker
    import rag_docvqa_tpu_torch.training.contrastive, rag_docvqa_tpu_torch.train_cl, rag_docvqa_tpu_torch.kernels
    import rag_docvqa_tpu_torch.models.nac, rag_docvqa_tpu_torch.eval, rag_docvqa_tpu_torch.utils_stats
    import rag_docvqa_tpu_torch.profiling
    import pkgutil, importlib, rag_docvqa_tpu_torch
    for mod in pkgutil.walk_packages(rag_docvqa_tpu_torch.__path__, "rag_docvqa_tpu_torch."):
        importlib.import_module(mod.name)   # whatever a later slice adds is covered too
    tok = HashTokenizer(4096)
    docs = make_corpus(2, n_pages=2, words_per_page=30, seed=1)
    batch, aux = DocVQAIngestor(tok, ChunkSpec(chunk_size=12, overlap=2), Caps(max_pages=4, max_chunks=16,
                                max_slots=256, embed_tokens=48)).ingest(docs)
    cfg = vt5.VT5Config(t5=t5.T5Config(vocab_size=4096, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                        num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0,
                        decode_kv_int8=True, fused_decode_attn=True),
                        spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    params = vt5.init_vt5_params(torch.Generator().manual_seed(0), cfg).to(torch.bfloat16)
    out = RAGVT5Engine(RAGConfig(chunk_num=3, max_source_length=160, max_new_tokens=4), cfg, params,
                       tok).inference(batch, aux)
    score = sum(anls(a[0], p) for a, p in zip(aux["answers"], out["pred_answers"]))
    # the other strategies on the same batch: per-chunk rows, page rows, the vote, the whole document
    served = {}
    for strategy in ("maxconf", "anyconf", "maxconfpage", "weightmajorpage", "none"):
        o = RAGVT5Engine(RAGConfig(page_retrieval=strategy, chunk_num=3, max_source_length=160, max_new_tokens=4,
                                   per_chunk_seq_len=64), cfg, params, tok).inference(batch, aux)
        served[strategy] = len(o["pred_answers"])
    # the eval entry point on the CPU
    from rag_docvqa_tpu_torch import eval as port_eval
    summary = port_eval.main(["-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--device", "cpu",
                              "page_retrieval=anyconf", "compute_stats=true", "n_val_docs=2"])[0]
    # nothing of jax, flax, optax or orbax was imported
    assert not any(m.split(".")[0] in ("jax", "flax", "jaxlib", "optax", "orbax")
                   for m in sys.modules if sys.modules[m] is not None)
    # nor any module of the JAX package, not even one that imports no jax
    assert not [m for m in sys.modules if m == "rag_docvqa_tpu" or m.startswith("rag_docvqa_tpu.")]
    # the index path, end to end on the CPU: build, query in every precision
    import numpy as np
    from rag_docvqa_tpu_torch.parallel import ShardedIndex, single_device_query
    rng = np.random.RandomState(0)
    emb, q = rng.randn(600, 32).astype(np.float32), rng.randn(3, 32).astype(np.float32)
    want = single_device_query(torch.from_numpy(emb), torch.from_numpy(q), 5)[1]
    agree = {}
    for dtype, refine in (("f32", False), ("bf16", False), ("int8", False), ("int4", False), ("int4", True)):
        idx = ShardedIndex.build(emb, n_shards=2, tile_n=128, dtype=dtype, refine=refine).query(q, 5)[1]
        idx = torch.as_tensor(idx)
        agree[dtype + ("_refine" if refine else "")] = float(np.mean(
            [len(set(idx[b].tolist()) & set(want[b].tolist())) / 5 for b in range(3)]))
    assert not [m for m in sys.modules if m == "rag_docvqa_tpu" or m.startswith("rag_docvqa_tpu.")]
    # the BERT family, end to end on the CPU: a reranked batch and two contrastive steps
    from rag_docvqa_tpu_torch.config import build_reranker
    from rag_docvqa_tpu_torch.models import bert
    from rag_docvqa_tpu_torch.training.contrastive import ContrastiveConfig, train_contrastive
    rr = build_reranker({"rerank_pair_len": 64, "rerank_max_chunk_num": 2}, tok, device="cpu")
    rr.params.to(torch.bfloat16)
    reranked = RAGVT5Engine(RAGConfig(chunk_num=3, max_source_length=160, max_new_tokens=4), cfg, params, tok,
                            reranker=rr).inference(batch, aux)
    kept = [len(p) for p in reranked["pred_answer_pages"]]
    bcfg = bert.BertConfig(vocab_size=4096, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                           max_position_embeddings=16)
    pairs = [(f"question {i}", f"chunk {i} text") for i in range(8)]
    _, losses = train_contrastive(lambda p, ids, mask: bert.bert_sentence_embed(p, bcfg, ids, mask),
                                  bert.init_bert_params(torch.Generator().manual_seed(0), bcfg), tok, pairs,
                                  ContrastiveConfig(lr=1e-3, epochs=2, batch_size=8, max_tokens=16))
    assert not [m for m in sys.modules if m == "rag_docvqa_tpu" or m.startswith("rag_docvqa_tpu.")]
    assert not any(m.split(".")[0] in ("jax", "flax", "jaxlib", "optax", "orbax")
                   for m in sys.modules if sys.modules[m] is not None)
    print(json.dumps({"n": len(out["pred_answers"]), "conf": out["confidences"], "anls": score, "agree": agree,
                      "kept": kept, "cl_losses": losses, "served": served, "eval": summary}))
""")


def test_port_runs_without_jax_or_flax():
    proc = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] == 2 and all(np.isfinite(res["conf"]))
    assert res["agree"]["f32"] == 1.0 and res["agree"]["int4_refine"] >= 0.9 and res["agree"]["int8"] >= 0.8
    assert all(1 <= k <= 2 for k in res["kept"]) and len(res["kept"]) == 2
    assert all(np.isfinite(res["cl_losses"])) and res["cl_losses"][1] < res["cl_losses"][0]
    assert res["served"] == {"maxconf": 2, "anyconf": 2, "maxconfpage": 2, "weightmajorpage": 2, "none": 2}
    assert res["eval"]["n_samples"] == 2 and res["eval"]["page_retrieval"] == "anyconf"


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device here: chip_smoke.py exits non-zero with no result
    line, both in the repo and alone in an empty directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    (tmp_path / "chip_smoke.py").write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
                           timeout=300, env=dict(env, PYTHONPATH=""))
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
