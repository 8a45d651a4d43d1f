"""Port parity, the evaluation entry point: `python -m
rag_docvqa_tpu_torch.eval --device cpu` against the root `eval.py
--platform cpu` on configs/VT5_tiny.yml + configs/Synthetic.yml with the
same weights (the root CLI's own seeded init, with a bf16-exact encoder
rel-pos table, carried to the port as a checkpoint of its trainer and read
back with `--ckpt`); `evaluate(compute_stats=True)` against the JAX one; the
sweep expansion and the RAG config keys against the JAX config; what the CLI
refuses; and the port's own `utils_stats` and `profiling`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
from rag_docvqa_tpu_torch.training.train_step import TrainState

torch.set_num_threads(2)

MODEL, DATA = "configs/VT5_tiny.yml", "configs/Synthetic.yml"


def _root_then_port(tmp_path, monkeypatch, capsys, args, overrides):
    """Runs the root eval, keeps the weights its seeded init made, writes them
    as a checkpoint of the port's trainer and runs the port's eval from it.
    Returns both lists of summaries and both printed lines."""
    import eval as root_eval
    from rag_docvqa_tpu_torch import eval as p_eval

    trees = []
    j_init = j_vt5.init_vt5_params

    def rounded(key, cfg):
        tree = jax.tree.map(np.asarray, j_init(key, cfg))
        rb = tree["t5"]["encoder"]["rel_bias"]
        tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
        trees.append(tree)
        return jax.tree.map(jnp.asarray, tree)

    monkeypatch.setattr(j_vt5, "init_vt5_params", rounded)
    want = root_eval.main(["-m", MODEL, "-d", DATA, "--platform", "cpu",
                           "--save-path", str(tmp_path / "jax.json")] + args + overrides)
    jlines = capsys.readouterr().out.strip().splitlines()
    ckpt = tmp_path / "ckpt"
    port = p_params.from_jax(trees[0])
    CheckpointManager(str(ckpt)).save(0, TrainState(params=port, opt_state={}, step=0))
    got = p_eval.main(["-m", MODEL, "-d", DATA, "--device", "cpu", "--ckpt", str(ckpt),
                       "--save-path", str(tmp_path / "port.json")] + args + overrides)
    plines = capsys.readouterr().out.strip().splitlines()
    return want, got, jlines, plines


def _same_summary(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "wall_time":
            continue
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("strategy", ["concat", "maxconf", "anyconf"])
def test_eval_cli_matches_root_eval(strategy, tmp_path, monkeypatch, capsys):
    want, got, jlines, plines = _root_then_port(
        tmp_path, monkeypatch, capsys, [], [f"page_retrieval={strategy}", "compute_stats=true", "n_val_docs=5"])
    assert len(want) == len(got) == 1
    _same_summary(got[0], want[0])
    assert got[0]["n_samples"] == 5 and got[0]["page_retrieval"] == strategy
    _same_summary(json.loads(plines[-1]), json.loads(jlines[-1]))
    saved, jsaved = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert saved["scores_by_samples"].keys() == jsaved["scores_by_samples"].keys()
    for qid, w in jsaved["scores_by_samples"].items():
        g = saved["scores_by_samples"][qid]
        for k in ("pred_answer", "pred_answer_pages", "accuracy", "anls", "retrieval_precision", "chunk_score"):
            assert g[k] == w[k], (qid, k)


def test_eval_cli_sweep_matches_root_eval(tmp_path, monkeypatch, capsys):
    """A list-valued key expands into one run a value, each with its own
    summary line and its own `<stem>_<i>.json`."""
    want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, ["--sweep"],
                                                ["chunk_num=[1,3]", "page_retrieval=maxconfpage", "n_val_docs=3"])
    assert len(got) == len(want) == 2 and len(plines) == 2
    for g, w in zip(got, want):
        _same_summary(g, w)
    for i in range(2):
        assert (tmp_path / f"port_{i}.json").exists() and (tmp_path / f"jax_{i}.json").exists()


def test_evaluate_compute_stats_matches_jax():
    """The ingest statistics of `compute_stats`: the same distributions and
    example ids, merged over a ragged last batch."""
    import test_torch_engine as te
    from rag_docvqa_tpu.engine.evaluate import evaluate as j_evaluate
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate

    jcfg, tree, pcfg, port = te.weights.__wrapped__()
    jtok, ptok = te.JHashTokenizer(4096), te.HashTokenizer(4096)
    jeng = te.JEngine(te.JRAGConfig(page_retrieval="anyconf", **te.RAG_KW), jcfg, jax.tree.map(jnp.asarray, tree),
                      jtok)
    peng = te.RAGVT5Engine(te.RAGConfig(page_retrieval="anyconf", **te.RAG_KW), pcfg, port, ptok)
    want = j_evaluate(jeng, te.j_make_corpus(5, n_pages=3, words_per_page=30, seed=8),
                      te.JIngestor(jtok, te.SPEC, te.JCaps(**te.CAPS)), batch_size=2, compute_stats=True)
    got = evaluate(peng, te.make_corpus(5, n_pages=3, words_per_page=30, seed=8),
                   te.DocVQAIngestor(ptok, te.SPEC, te.Caps(**te.CAPS)), batch_size=2, compute_stats=True)
    assert got["retrieval_stats"] == want["retrieval_stats"]
    assert got["retrieval_stats_examples"] == want["retrieval_stats_examples"]
    assert set(got["retrieval_stats"]) == {"chunk_size_dist", "n_chunks_per_page_dist", "n_chunks_per_doc_dist"}
    assert sum(got["retrieval_stats"]["n_chunks_per_doc_dist"].values()) == 5
    for k in ("accuracy", "anls", "retrieval_precision", "chunk_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_config_sweep_and_rag_keys_match_jax():
    c = {"a": [1, 2], "b": ["x", "y", "z"], "c": 5, "page_retrieval": "maxconf", "per_chunk_seq_len": 96,
         "embed_model": "BGE", "chunk_num": 4}
    assert list(p_config.expand_sweep(c)) == list(j_config.expand_sweep(c))
    assert list(p_config.expand_sweep(c, ["b"])) == list(j_config.expand_sweep(c, ["b"]))
    assert list(p_config.expand_sweep({"c": 1})) == [{"c": 1}]
    p, j = p_config.build_rag_config(c), j_config.build_rag_config(c)
    for k in ("page_retrieval", "chunk_num", "per_chunk_seq_len", "embed_backend", "max_source_length",
              "max_new_tokens", "include_surroundings", "sep_token_id", "reorder_chunks"):
        assert getattr(p, k) == getattr(j, k), k
    assert (p.per_chunk_seq_len, p.embed_backend) == (96, "BGE")
    d = p_config.build_rag_config({})
    assert (d.per_chunk_seq_len, d.embed_backend) == (256, "VT5")


@pytest.mark.parametrize("argv,match", [
    (["--hf-weights", "x"], "item 18a"),
    (["--ingest-workers", "2"], "item 18a"),
    (["--data-parallel"], "item 17"),
    (["-m", "configs/HiVT5_tiny.yml"], "item 12"),
    (["-m", "configs/Qwen_tiny.yml"], "item 15"),
    (["-m", "configs/Pix2Struct_tiny.yml"], "item 18a"),
])
def test_eval_cli_refuses_what_is_not_ported(argv, match):
    from rag_docvqa_tpu_torch import eval as p_eval

    base = ["-m", MODEL, "-d", DATA, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        p_eval.main(base + argv)


def test_eval_cli_runs_on_the_card_unless_asked(monkeypatch):
    from rag_docvqa_tpu_torch import eval as p_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        p_eval.main(["-m", MODEL, "-d", DATA])


def test_utils_stats_and_stage_timer():
    """StatsCollector's counting and bounded examples, merged; StageTimer
    counts a stage and lets an exception inside one through uncounted."""
    from rag_docvqa_tpu_torch.profiling import StageTimer, annotate, trace
    from rag_docvqa_tpu_torch.utils_stats import StatsCollector

    a, b = StatsCollector(compute_examples=True, n_examples=2), StatsCollector(compute_examples=True, n_examples=2)
    for i in range(3):
        a.add("s", 1, example=f"a{i}")
    b.add("s", 2, value=4, example="b0")
    b.add("s", 1, example="b1")
    a.merge(b)
    assert a.summary() == {"s": {1: 4, 2: 4}} and a.stats_examples["s"] == {1: ["a0", "a1"], 2: ["b0"]}
    off = StatsCollector(compute_stats=False)
    off.add("s", 1)
    assert off.summary() == {}

    timer = StageTimer()
    with trace(None), timer.stage("work", sync=torch.zeros(2)):
        with annotate("inner"):
            torch.ones(4).sum()
    with pytest.raises(ValueError):
        with timer.stage("fails"):
            raise ValueError("propagates")
    s = timer.summary()
    assert set(s) == {"work"} and s["work"]["pct"] == 100.0 and timer.counts["work"] == 1
