"""Port parity, the whole slice: `RAGVT5Engine.inference` with the concat
and oracle strategies on the VT5_tiny.yml dims against the JAX engine on
the same ingested batch and weights; the port running with jax and flax
unimportable; and chip_smoke.py refusing to run without a GPU."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
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


@pytest.mark.parametrize("strategy", ["concat", "oracle"])
def test_engine_matches_jax(weights, strategy):
    jcfg, tree, pcfg, port = weights
    jdocs = j_make_corpus(3, n_pages=3, words_per_page=40, seed=5)
    pdocs = make_corpus(3, n_pages=3, words_per_page=40, seed=5)
    jtok, ptok = JHashTokenizer(4096), HashTokenizer(4096)
    jb, jaux = JIngestor(jtok, SPEC, JCaps(**CAPS)).ingest(jdocs)
    pb, paux = DocVQAIngestor(ptok, SPEC, Caps(**CAPS)).ingest(pdocs)
    want = JEngine(JRAGConfig(page_retrieval=strategy, **RAG_KW), jcfg, jax.tree.map(jax.numpy.asarray, tree),
                   jtok).inference(jb, jaux)
    got = RAGVT5Engine(RAGConfig(page_retrieval=strategy, **RAG_KW), pcfg, port, ptok).inference(pb, paux)
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-4)
    r, w = got["retrieval"], want["retrieval"]
    np.testing.assert_allclose(r["similarities"], w["similarities"], rtol=1e-5, atol=1e-5)
    assert r["top_k_layout_labels"] == w["top_k_layout_labels"]
    np.testing.assert_array_equal(r["boxes"], np.asarray(w["boxes"]))
    assert r["text"] == w["text"]
    assert set(got["timings"]) == {"retrieve_assemble_s", "encode_s", "decode_s"}


def test_engine_refuses_unported_strategies(weights):
    _, _, pcfg, port = weights
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        RAGVT5Engine(RAGConfig(page_retrieval="maxconf"), pcfg, port, HashTokenizer(4096))


JAX_FREE = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None      # any import of jax or flax now fails
    sys.modules["flax"] = None
    import torch
    torch.set_num_threads(2)
    from rag_docvqa_tpu.ops.chunking import ChunkSpec
    from rag_docvqa_tpu.metrics.anls import anls
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
    from rag_docvqa_tpu_torch.models import t5, vt5
    from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
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
    # nothing of jax or flax was imported
    assert not any(m.split(".")[0] in ("jax", "flax", "jaxlib")
                   for m in sys.modules if sys.modules[m] is not None)
    print(json.dumps({"n": len(out["pred_answers"]), "conf": out["confidences"], "anls": score}))
""")


def test_port_runs_without_jax_or_flax():
    proc = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] == 2 and all(np.isfinite(res["conf"]))


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
