"""Port parity, the multi-device layer: `parallel/mesh.py` process groups,
the sharded index and MaxSim collectives, the sharded VT5 and Hi-VT5 train
steps, the decode under the (data, model) layout and data-parallel
`evaluate`, against the JAX package.

For each world size (2 and 4) one spawn of gloo ranks on the CPU
(`parallel/mesh.py::spawn`, a FileStore under tmp_path) runs every case
(tests/torch_multichip_worker.py: torch only). The JAX side runs in this
process: its sharded functions on as many of conftest.py's 8 virtual CPU
devices (shard_map and its all-gather really execute), and its unsharded
ones. The 2-D cases use a (world/2, 2) mesh: a (1, 2) model-only mesh at 2
ranks, (2, 2) at 4. The training labels of the second half of the batch
are shorter, so the data ranks' valid-label counts differ.

Tolerances: index and MaxSim ids exact, values 1e-5; decode ids exact,
confidences 1e-4; evaluate answers, statistics and per-sample results
equal, metrics 1e-6. Train steps: loss and grad norms 1e-5 relative at the
first step, 1e-4 at the next two (after a step the rel-pos table is no
longer bf16-exact, and JAX's CPU blocks keep it in f32 where the port's
layer takes it in bf16, tests/test_torch_training.py); JAX runs with its
fused-train gate on (the TPU path, interpret mode), which takes the bias
in bf16 as the port does. Every leaf after three AdamW steps of lr 1e-3
within 3e-5 (3 % of a step: AdamW divides each gradient by its own size,
so an element whose gradient is near 0 takes a step that rounding sizes)
of JAX's for VT5 and of the port's
unsharded step for Hi-VT5 (tests/test_torch_hivt5.py holds that step to
JAX's losses, not leaf for leaf); the encoder's rel-pos table within 2e-4
(its gradient comes through the bf16 bias, and each data rank's batch sum
is rounded to bf16 before the ranks' sum)."""

import contextlib
import io
import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.data.synthetic import make_document as j_make_document
from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
from rag_docvqa_tpu.engine.evaluate import evaluate as j_evaluate
from rag_docvqa_tpu.metrics import Evaluator as JEvaluator
from rag_docvqa_tpu.models import hivt5 as j_hivt5
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec as JChunkSpec
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu.ops.decode import greedy_decode as j_greedy_decode
from rag_docvqa_tpu.parallel import ShardedIndex as JShardedIndex
from rag_docvqa_tpu.parallel import create_mesh as j_create_mesh
from rag_docvqa_tpu.parallel.index import sharded_maxsim_topk as j_sharded_maxsim_topk
from rag_docvqa_tpu.training import TrainState as JTrainState
from rag_docvqa_tpu.training import build_optimizer as j_build_optimizer
from rag_docvqa_tpu.training import make_train_step as j_make_train_step
from rag_docvqa_tpu.training.train_step import make_hivt5_train_step as j_make_hivt5_train_step
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus, make_document
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.eval import SUMMARY_KEYS
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch.parallel.mesh import spawn

import torch_multichip_worker as worker

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
VOCAB = 512
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
RAG_KW = dict(page_retrieval="concat", chunk_num=2, max_source_length=32, max_new_tokens=4)
SPEC_KW = dict(chunk_size=8, overlap=2)
HI_KW = dict(page_tokens=4, max_doc_pages=4, page_seq_len=48)
HI_CAPS = dict(max_pages=4, max_chunks=16, max_slots=128)
EVAL_CAPS = dict(max_pages=4, max_chunks=32, max_slots=384, tokens_per_word=8, embed_tokens=48)
EVAL_RAG = dict(page_retrieval="concat", chunk_num=3, max_source_length=96, max_new_tokens=4)
OPT_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3
VALUE_TOL = 1e-5
LEAF_TOL, REL_BIAS_TOL = 3e-5, 2e-4
COLLECTIVE_TIMEOUT_S = 60  # a collective waiting longer fails
SPAWN_DEADLINE_S = 240  # a spawn still running this long is stopped (one takes under 10 s on an idle CPU)
CLI_MODEL, CLI_DATA = os.path.join(REPO, "configs", "VT5_tiny.yml"), os.path.join(REPO, "configs", "Synthetic.yml")
CLI_QUESTION = "what is the total?"
CLI_QUERY_MODES = {"f32": ["--index-dtype", "f32"], "int4_refine": ["--index-dtype", "int4", "--refine"]}


def _bf16_exact_rel_bias(tree):
    rb = tree["t5"]["encoder"]["rel_bias"]
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    return tree


def _short_tail(labels):
    labels = labels.copy()
    labels[labels.shape[0] // 2:, 1:] = -100
    return labels


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's inputs and the JAX side's batches, from seeds."""
    rng = np.random.RandomState(5)
    emb = rng.randn(700, 32).astype(np.float32)
    emb[650] = emb[10]  # a tie across shards: the lower row must win
    emb[300] = emb[40]
    queries = rng.randn(6, 32).astype(np.float32)
    queries[0], queries[1] = emb[10], emb[40]

    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           use_visual=False)
    tree = _bf16_exact_rel_bias(jax.tree.map(np.array, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg)))
    jing, ping = JIngestor(JHashTokenizer(VOCAB), JChunkSpec(**SPEC_KW)), DocVQAIngestor(HashTokenizer(VOCAB),
                                                                                          ChunkSpec(**SPEC_KW))
    jdocs, pdocs = j_make_corpus(4, n_pages=2, words_per_page=20, seed=9), make_corpus(4, n_pages=2,
                                                                                        words_per_page=20, seed=9)
    jing.caps, ping.caps = jing.plan_caps(jdocs), ping.plan_caps(pdocs)
    (jb, _), (pb, paux) = jing.ingest(jdocs), ping.ingest(pdocs)
    labels = _short_tail(ping.answer_labels(paux["answers"], max_len=6, seed=3))

    hcfg = j_hivt5.HiVT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                               **HI_KW)
    htree = _bf16_exact_rel_bias(jax.tree.map(np.array, j_hivt5.init_hivt5_params(jax.random.PRNGKey(1), hcfg)))
    hjing, hping = JIngestor(JHashTokenizer(VOCAB), JChunkSpec(**SPEC_KW), JCaps(**HI_CAPS)), DocVQAIngestor(
        HashTokenizer(VOCAB), ChunkSpec(**SPEC_KW), Caps(**HI_CAPS))
    hjdocs = [j_make_document(random.Random(7 + i), n_pages=n, words_per_page=20, question_id=i)
              for i, n in enumerate((4, 2, 3, 1))]
    hpdocs = [make_document(random.Random(7 + i), n_pages=n, words_per_page=20, question_id=i)
              for i, n in enumerate((4, 2, 3, 1))]
    (hjb, _), (hpb, hpaux) = hjing.ingest(hjdocs), hping.ingest(hpdocs)
    hlabels = _short_tail(hping.answer_labels(hpaux["answers"], max_len=6, seed=3))

    enc = rng.randn(4, 12, 32).astype(np.float32)
    emask = np.ones((4, 12), bool)
    emask[1, 7:] = False
    emask[3, 3:] = False
    patches = rng.randn(64, 6, 32).astype(np.float32)
    pmask = rng.rand(64, 6) < 0.8
    qtok = rng.randn(5, 32).astype(np.float32)
    patches[5, :5], pmask[5, :5] = qtok, True  # row 5 holds every query token: the best score
    patches[60], pmask[60] = patches[5], pmask[5]  # and a tie with it across shards

    jax_rows = {}  # the JAX-built padded rows, the same for every shard count here (700 rows -> 768)
    for mode, kw in worker.INDEX_MODES.items():
        jidx = JShardedIndex.build(jnp.asarray(emb), _jax_mesh(2), tile_n=64, refine_kprime=24, **kw)
        jax_rows[mode] = dict(embeddings=np.asarray(jidx.embeddings.astype(jnp.float32) if kw["dtype"] == "bf16"
                                                    else jidx.embeddings),
                              scales=None if jidx.scales is None else np.asarray(jidx.scales),
                              host_rows=jidx.host_rows)
    cases = {
        "index": dict(emb=emb, queries=queries, tile_n=64, k=7, kprime=24, jax_rows=jax_rows),
        "maxsim": dict(patches=patches, mask=pmask, query=qtok, n_valid=61, k=5),
        "vt5_train": dict(tree=tree, t5=T5_KW, rag=RAG_KW, batch=pb, labels=labels, opt=OPT_KW, steps=STEPS),
        "hivt5_train": dict(tree=htree, t5=T5_KW, hi=HI_KW, batch=hpb, labels=hlabels, opt=OPT_KW, steps=STEPS),
        "decode": dict(tree=tree["t5"], t5=T5_KW, enc=enc, mask=emask, steps=5),
        "evaluate": dict(tree=tree, t5=T5_KW, rag=EVAL_RAG, spec=SPEC_KW, caps=EVAL_CAPS, n_docs=7, seed=8,
                         batch_size=4, save_path=str(tmp_path_factory.mktemp("evaluate") / "scores")),
    }
    jax_side = dict(jcfg=jcfg, jb=jb, hcfg=hcfg, hjb=hjb)
    return cases, jax_side


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, inputs, tmp_path_factory):
    """Each rank's results for one world size."""
    world = request.param
    results = spawn(worker.run, world, args=(inputs[0],), workdir=str(tmp_path_factory.mktemp(f"world{world}")),
                    timeout_s=COLLECTIVE_TIMEOUT_S, deadline_s=SPAWN_DEADLINE_S)
    return world, results


def _jax_mesh(n):
    return j_create_mesh((n,), ("data",), devices=jax.devices()[:n])


# --------------------------------------------------------------------------- #
# the index and MaxSim
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", list(worker.INDEX_MODES))
def test_index_group_matches_jax_and_the_row_ranges(ranks, inputs, mode):
    """One shard a rank: the port's own build equals its row-range form bit
    for bit; the JAX-built rows carried over give the JAX sharded query's
    ids and values (the port's normalization can move a bf16 or quantized
    row by its last bit, so only the f32 own build is held to JAX too)."""
    world, results = ranks
    case = inputs[0]["index"]
    kw = worker.INDEX_MODES[mode]
    jidx = JShardedIndex.build(jnp.asarray(case["emb"]), _jax_mesh(world), tile_n=case["tile_n"], use_pallas=False,
                               refine_kprime=case["kprime"], **kw)
    np.testing.assert_array_equal(np.asarray(jidx.embeddings.astype(jnp.float32) if kw["dtype"] == "bf16"
                                             else jidx.embeddings), case["jax_rows"][mode]["embeddings"])
    wv, wi, wok = map(np.asarray, jidx.query(jnp.asarray(case["queries"]), case["k"]))
    for r in results:
        got = r["index"][mode]
        for a, b in zip(got["group"], got["ranges"]):
            np.testing.assert_array_equal(a, b)
        for form in ("carried", "group") if mode == "f32" else ("carried",):
            gv, gi, gok = got[form]
            np.testing.assert_array_equal(gok, wok, err_msg=form)
            np.testing.assert_array_equal(gi, wi, err_msg=form)
            np.testing.assert_allclose(gv, wv, atol=VALUE_TOL, rtol=0, err_msg=form)
    if mode == "f32":  # the planted ties: the lower global row
        assert wi[0, 0] == 10 and wi[1, 0] == 40


def test_each_rank_holds_its_index_shard(ranks):
    world, results = ranks
    for r in results:
        for mode, got in r["index"].items():
            assert got["resident_bytes"] * world == got["padded_bytes"], mode
            assert got["held_rows"] * world == got["carried_rows"] * world == 768, mode  # 700 rows -> 768


def test_sharded_maxsim_matches_jax(ranks, inputs):
    world, results = ranks
    case = inputs[0]["maxsim"]
    want = map(np.asarray, j_sharded_maxsim_topk(jnp.asarray(case["patches"]), jnp.asarray(case["mask"]),
                                                 jnp.asarray(case["query"]), mesh=_jax_mesh(world),
                                                 n_valid=case["n_valid"], k=case["k"]))
    wv, wi, wok = want
    for r in results:
        gv, gi, gok = r["maxsim"]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_allclose(gv, wv, atol=VALUE_TOL, rtol=0)
    assert wi[0] == 5 and wi[1] == 60  # the tie resolves to the lower row


# --------------------------------------------------------------------------- #
# the train steps
# --------------------------------------------------------------------------- #
def _jax_steps(step, state, batch, labels):
    """STEPS JAX steps with its fused-train gate on (the TPU path, its
    kernels in interpret mode): the rel-pos bias in bf16, as the port's
    layer takes it."""
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_feb, "fused_t5_train_wanted", lambda *a, **k: True)
        for _ in range(STEPS):
            state, m = step(state, batch, jnp.asarray(labels))
            rows.append({k: float(v) for k, v in m.items()})
    return rows, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def jax_vt5_steps(inputs):
    cases, js = inputs
    case = cases["vt5_train"]
    tx = j_build_optimizer(**OPT_KW)
    state = JTrainState.create(jax.tree.map(jnp.asarray, case["tree"]), tx)
    return _jax_steps(j_make_train_step(js["jcfg"], JRAGConfig(**RAG_KW), tx), state, js["jb"], case["labels"])


@pytest.fixture(scope="module")
def jax_hivt5_steps(inputs):
    cases, js = inputs
    case = cases["hivt5_train"]
    tx = j_build_optimizer(**OPT_KW)
    state = JTrainState.create(jax.tree.map(jnp.asarray, case["tree"]), tx)
    return _jax_steps(j_make_hivt5_train_step(js["hcfg"], tx), state, js["hjb"], case["labels"])


def _check_steps(results, key, want_rows, want_params):
    for r in results:
        got = r[key]
        for i, (g, w) in enumerate(zip(got["metrics"], want_rows)):
            assert set(w) <= set(g), (set(w), set(g))
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5 if i == 0 else 1e-4, err_msg=f"{k} step {i}")
        want = jax.tree_util.tree_flatten_with_path(want_params)[0]
        have = jax.tree_util.tree_flatten_with_path(got["params"])[0]
        assert [p for p, _ in want] == [p for p, _ in have]
        for (path, w), (_, g) in zip(want, have):
            name = jax.tree_util.keystr(path)
            tol = REL_BIAS_TOL if name == "['t5']['encoder']['rel_bias']" else LEAF_TOL
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_sharded_vt5_train_step_matches_jax(ranks, jax_vt5_steps):
    _check_steps(ranks[1], "vt5_train", *jax_vt5_steps)


@pytest.fixture(scope="module")
def port_hivt5_leaves(inputs):
    """The port's unsharded Hi-VT5 step from the same weights: its leaves
    after STEPS steps (tests/test_torch_hivt5.py holds this step to JAX's
    losses, not leaf for leaf)."""
    from rag_docvqa_tpu_torch import params as p_params
    from rag_docvqa_tpu_torch.models import hivt5 as p_hivt5
    from rag_docvqa_tpu_torch.models import t5 as p_t5
    from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step

    case = inputs[0]["hivt5_train"]
    cfg = p_hivt5.HiVT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0),
                              **HI_KW)
    params = p_params.hivt5_from_jax(case["tree"])
    opt = build_optimizer(**OPT_KW, mask=trainable_mask(params, ("t5", "spatial", "page_emb", "page_head")))
    state, step = TrainState.create(params, opt), make_hivt5_train_step(cfg, opt)
    for _ in range(STEPS):
        state, _ = step(state, case["batch"], case["labels"])
    return p_params.hivt5_to_jax(state.params)


def test_sharded_hivt5_train_step_matches_jax(ranks, jax_hivt5_steps, port_hivt5_leaves):
    """Losses and grad norms against JAX's steps; the leaves against the
    port's unsharded step."""
    _check_steps(ranks[1], "hivt5_train", jax_hivt5_steps[0], port_hivt5_leaves)


@pytest.mark.parametrize("key", ["vt5_train", "hivt5_train"])
def test_split_leaves_and_moments_are_slices(ranks, key):
    """Each rank stores 1/model of every leaf the spec splits, and of its
    AdamW moments; the whole leaves stay whole; the spec splits the word
    table, q/k/v/o and the FFN of every layer."""
    _, results = ranks
    for r in results:
        got = r[key]
        split = {n for n, d in got["spec"].items() if d is not None}
        assert {"t5.shared", "t5.encoder.layers.0.attn.q", "t5.decoder.layers.1.ffn.wo", "spatial.x_emb"} <= split
        assert "t5.encoder.rel_bias" not in split and "spatial.matcher_w" not in split
        for n, full in got["full"].items():
            assert got["held"][n] * (2 if n in split else 1) == full, n
        for n, held in got["moments"].items():
            assert held == got["held"][n], n


# --------------------------------------------------------------------------- #
# decode, evaluate
# --------------------------------------------------------------------------- #
def test_decode_under_the_layout_matches_jax(ranks, inputs):
    case = inputs[0]["decode"]
    params = jax.tree.map(jnp.asarray, case["tree"])
    wt, wc = jax.jit(lambda p, e, m: j_greedy_decode(p, j_t5.T5Config(**T5_KW), e, m, case["steps"]))(
        params, jnp.asarray(case["enc"]), jnp.asarray(case["mask"]))
    for r in ranks[1]:
        gt, gc = r["decode"]
        np.testing.assert_array_equal(gt, np.asarray(wt))
        np.testing.assert_allclose(gc, np.asarray(wc), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_evaluate(inputs):
    cases, js = inputs
    case = cases["evaluate"]
    tok = JHashTokenizer(VOCAB)
    engine = JEngine(JRAGConfig(**EVAL_RAG), js["jcfg"], jax.tree.map(jnp.asarray, case["tree"]), tok)

    def run(mesh=None):
        return j_evaluate(engine, j_make_corpus(case["n_docs"], n_pages=3, words_per_page=30, seed=case["seed"]),
                          JIngestor(tok, JChunkSpec(**SPEC_KW), JCaps(**EVAL_CAPS)), JEvaluator(),
                          batch_size=case["batch_size"], compute_stats=True, mesh=mesh)

    return {None: run(), **{w: run(j_create_mesh((w, 1), ("data", "model"), devices=jax.devices()[:w]))
                            for w in WORLDS}}


def test_data_parallel_evaluate_matches_jax(ranks, jax_evaluate, inputs):
    """Against JAX `evaluate` without a mesh and with one of as many
    devices: 7 documents in batches of 4, the last padded to the data axis."""
    world, results = ranks
    for want in (jax_evaluate[None], jax_evaluate[world]):
        assert want["n_samples"] == 7
        for r in results:
            got = r["evaluate"]
            assert got["pred_answers"] == want["pred_answers"]
            assert got["retrieval_stats"] == want["retrieval_stats"]
            assert got["retrieval_stats_examples"] == want["retrieval_stats_examples"]
            for k in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples"):
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
            assert list(got["scores_by_samples"]) == list(want["scores_by_samples"])
    written = sorted(os.listdir(os.path.dirname(inputs[0]["evaluate"]["save_path"])))
    assert "scores.rank0.json" in written and not any(f"rank{i}." in f for f in written for i in range(1, world))


def test_every_rank_returns_the_same(ranks):
    world, results = ranks
    assert sorted(r["coords"] for r in results) == [(d, m) for d in range(world // 2) for m in range(2)]
    first = results[0]
    for r in results[1:]:
        assert r["vt5_train"]["metrics"] == first["vt5_train"]["metrics"]
        assert r["hivt5_train"]["metrics"] == first["hivt5_train"]["metrics"]
        np.testing.assert_array_equal(r["decode"][0], first["decode"][0])
        assert r["evaluate"]["pred_answers"] == first["evaluate"]["pred_answers"]


def test_dryrun_on_two_cpu_ranks():
    out = subprocess.run([sys.executable, "-m", "rag_docvqa_tpu_torch.dryrun", "2", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun_multichip(2) OK: loss=") and "sharded_eval_parity=ok" in last, last
    for key in ("loss=", "hivt5_loss="):
        assert np.isfinite(float(last.split(key, 1)[1].split()[0]))


# --------------------------------------------------------------------------- #
# the CLIs under a launcher's group
# --------------------------------------------------------------------------- #
def _json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The eval CLI with `--data-parallel` and `precompute index|query` on
    two gloo ranks, each rank started as `torchrun` starts it
    (tests/torch_multichip_worker.py::run_clis), and the same commands in
    one process without a launcher (the plain run). 8 documents in batches
    of 3 for eval (the last padded to the data axis), of 2 for index (every
    second batch on a rank); the group's query reads the plain index file."""
    tmp = tmp_path_factory.mktemp("clis")
    common = ["-m", CLI_MODEL, "--device", "cpu"]
    eval_argv = lambda out: ["-d", CLI_DATA, *common, "--save-path", str(tmp / out), "batch_size=3",
                             "compute_stats=true"]
    index_argv = lambda out: ["index", "-d", CLI_DATA, *common, "--out", str(tmp / out), "batch_size=2"]
    query_argv = lambda mode: ["query", "--index", str(tmp / "plain.npz"), *common, "-q", CLI_QUESTION, "--k", "5",
                               *CLI_QUERY_MODES[mode]]
    plain_runs = [("eval", eval_argv("plain_scores.json")), ("precompute", index_argv("plain.npz"))]
    plain_runs += [("precompute", query_argv(mode)) for mode in CLI_QUERY_MODES]
    group_runs = [("eval", eval_argv("group_scores.json") + ["--data-parallel"]),
                  ("precompute", index_argv("group.npz"))]
    group_runs += [("precompute", query_argv(mode)) for mode in CLI_QUERY_MODES]

    from rag_docvqa_tpu_torch import eval as p_eval
    from rag_docvqa_tpu_torch import precompute as p_precompute

    plain = []
    with pytest.MonkeyPatch.context() as mp:
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            mp.delenv(var, raising=False)
        for module, argv in plain_runs:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                ret = {"eval": p_eval.main, "precompute": p_precompute.main}[module](argv)
            plain.append((ret, printed.getvalue()))
    group = spawn(worker.run_clis, 2, args=(group_runs, str(tmp)), workdir=str(tmp),
                  timeout_s=COLLECTIVE_TIMEOUT_S, deadline_s=SPAWN_DEADLINE_S)
    return tmp, plain, group


def test_eval_cli_data_parallel_under_a_group(cli_runs):
    """The first rank prints the plain run's summary and writes its scores
    file; the other prints and writes nothing; both return the summary. The
    answers' confidences within 1e-5 relative: a rank's batch holds its
    rows and the padding, so the decoder's sums take other shapes."""
    tmp, plain, group = cli_runs
    (want,), want_out = plain[0]
    (line,) = _json_lines(want_out)
    for rank, ranks_runs in enumerate(group):
        (got,), out = ranks_runs[0]
        for k in SUMMARY_KEYS + ("page_retrieval",):
            assert got[k] == want[k], k
        if rank == 0:
            (printed,) = _json_lines(out)
            assert {k: v for k, v in printed.items() if k != "wall_time"} == {
                k: v for k, v in line.items() if k != "wall_time"}
        else:
            assert out == ""
    with open(tmp / "plain_scores.json") as f, open(tmp / "group_scores.json") as g:
        want_file, got_file = json.load(f), json.load(g)
    assert list(got_file["scores_by_samples"]) == list(want_file["scores_by_samples"])
    for qid, w in want_file["scores_by_samples"].items():  # the confidence's sums take other batch shapes
        g = got_file["scores_by_samples"][qid]
        assert {k: v for k, v in g.items() if k != "pred_answer_conf"} == {
            k: v for k, v in w.items() if k != "pred_answer_conf"}, qid
        np.testing.assert_allclose(g["pred_answer_conf"], w["pred_answer_conf"], rtol=1e-5, err_msg=qid)
    for k in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples"):
        assert got_file[k] == want_file[k], k


def test_precompute_index_cli_under_a_group(cli_runs):
    """Each rank embeds every second batch; the first writes the file the
    plain run writes (rows in document order) and prints its line."""
    tmp, plain, group = cli_runs
    want, got = np.load(tmp / "plain.npz"), np.load(tmp / "group.npz")
    assert json.loads(str(got["meta"])) == json.loads(str(want["meta"]))
    assert len(json.loads(str(want["meta"]))) > 8  # several chunks a document, over four batches
    np.testing.assert_array_equal(got["embeddings"], want["embeddings"])
    (want_line,) = _json_lines(plain[1][1])
    (got_line,) = _json_lines(group[0][1][1])
    assert got_line["n_chunks"] == want_line["n_chunks"] and got_line["n_docs"] == want_line["n_docs"] == 8
    assert group[1][1][1] == ""


@pytest.mark.parametrize("mode", list(CLI_QUERY_MODES))
def test_precompute_query_cli_under_a_group(cli_runs, mode):
    """One shard of the index a rank: the first rank prints the plain run's
    ranking, the other nothing."""
    _, plain, group = cli_runs
    at = 2 + list(CLI_QUERY_MODES).index(mode)
    want = _json_lines(plain[at][1])
    assert [r["rank"] for r in want] == list(range(5))
    assert _json_lines(group[0][at][1]) == want
    assert group[1][at][1] == ""


# --------------------------------------------------------------------------- #
# the layout itself, in this process
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("coord", [0, 1])
@pytest.mark.parametrize("model", ["vt5", "hivt5"])
def test_param_spec_slices_are_the_jax_shards(inputs, model, coord):
    """The slice `shard_params` keeps at model coordinate `coord` of a (1, 2)
    mesh, carried to the JAX layout, is the shard the JAX `vt5_param_spec`
    puts on the device at that coordinate, leaf for leaf."""
    from jax.sharding import NamedSharding

    from rag_docvqa_tpu.training import vt5_param_spec as j_vt5_param_spec
    from rag_docvqa_tpu_torch import params as p_params
    from rag_docvqa_tpu_torch.parallel.mesh import Mesh, shard_params
    from rag_docvqa_tpu_torch.training.train_step import vt5_param_spec

    tree = inputs[0]["vt5_train" if model == "vt5" else "hivt5_train"]["tree"]
    from_jax, to_jax = ((p_params.from_jax, p_params.to_jax) if model == "vt5"
                        else (p_params.hivt5_from_jax, p_params.hivt5_to_jax))
    jmesh = j_create_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
    placed = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jax.tree.map(lambda s: NamedSharding(jmesh, s), j_vt5_param_spec(tree)))
    device = jmesh.devices[0, coord]
    want = jax.tree.map(lambda a: next(np.asarray(s.data) for s in a.addressable_shards if s.device == device), placed)
    port = from_jax(tree)
    shard_params(port, vt5_param_spec(port), Mesh((1, 2), ("data", "model"), (0, coord), {}, torch.device("cpu")))
    got = to_jax(port)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in want_leaves] == [p for p, _ in got_leaves]
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
