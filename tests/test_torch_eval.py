"""Port parity, the evaluation entry point: `python -m
rag_docvqa_tpu_torch.eval --device cpu` against the root `eval.py
--platform cpu` on configs/VT5_tiny.yml + configs/Synthetic.yml with the
same weights (the root CLI's own seeded init, with a bf16-exact encoder
rel-pos table, carried to the port as a checkpoint of its trainer and read
back with `--ckpt`); `evaluate(compute_stats=True)` against the JAX one; the
sweep expansion and the RAG config keys against the JAX config; what the CLI
refuses; and the port's own `utils_stats`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.models import vt5 as j_vt5
from chip_smoke import write_mp_docvqa  # the MP-DocVQA directory phase 11e serves from
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
from rag_docvqa_tpu_torch.training.train_step import TrainState

torch.set_num_threads(2)

MODEL, DATA = "configs/VT5_tiny.yml", "configs/Synthetic.yml"


def _root_then_port(tmp_path, monkeypatch, capsys, args, overrides, model=MODEL, data=DATA, kind="vt5",
                    port_args=()):
    """Runs the root eval, keeps the weights its seeded init made (`kind`:
    vt5, hivt5 or pix2struct), writes them as a checkpoint of the port's
    trainer and runs the port's eval from it (with `port_args` besides).
    Returns both lists of summaries and both printed lines."""
    import eval as root_eval
    from rag_docvqa_tpu.models import hivt5 as j_hivt5
    from rag_docvqa_tpu.models import pix2struct as j_p2s
    from rag_docvqa_tpu_torch import eval as p_eval

    module, name, convert = {"vt5": (j_vt5, "init_vt5_params", p_params.from_jax),
                             "hivt5": (j_hivt5, "init_hivt5_params", p_params.hivt5_from_jax),
                             "pix2struct": (j_p2s, "init_p2s_params", p_params.p2s_from_jax)}[kind]
    trees = []
    j_init = getattr(module, name)

    def rounded(key, cfg):
        tree = jax.tree.map(np.array, j_init(key, cfg))
        if "t5" in tree:  # the port's encoder takes its rel-pos bias in bf16
            rb = tree["t5"]["encoder"]["rel_bias"]
            tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
        trees.append(tree)
        return jax.tree.map(jnp.asarray, tree)

    monkeypatch.setattr(module, name, rounded)
    want = root_eval.main(["-m", model, "-d", data, "--platform", "cpu",
                           "--save-path", str(tmp_path / "jax.json")] + args + overrides)
    jlines = capsys.readouterr().out.strip().splitlines()
    ckpt = tmp_path / "ckpt"
    port = convert(trees[0])
    CheckpointManager(str(ckpt)).save(0, TrainState(params=port, opt_state={}, step=0))
    got = p_eval.main(["-m", model, "-d", data, "--device", "cpu", "--ckpt", str(ckpt),
                       "--save-path", str(tmp_path / "port.json")] + args + list(port_args) + overrides)
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


def _same_saved(tmp_path):
    saved, jsaved = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert saved["scores_by_samples"].keys() == jsaved["scores_by_samples"].keys()
    for qid, w in jsaved["scores_by_samples"].items():
        g = saved["scores_by_samples"][qid]
        for k in ("pred_answer", "pred_answer_pages", "accuracy", "anls", "retrieval_precision", "chunk_score"):
            assert g[k] == w[k], (qid, k)


@pytest.mark.parametrize("workers", [0, 2])
def test_eval_cli_reads_a_local_mp_docvqa_directory(workers, tmp_path, monkeypatch, capsys):
    """`-d configs/MP-DocVQA.yml imdb_dir=... images_dir=... use_images=true`
    against the root eval (in-process ingest) on the same files: the port's
    summary and per-sample scores equal with in-process ingest and with two
    ingest workers (`MPIngestor`, closed at the end of the run)."""
    imdb, images = write_mp_docvqa(str(tmp_path / "mp"))
    overrides = [f"imdb_dir={imdb}", f"images_dir={images}", "use_images=true", "page_retrieval=maxconf"]
    want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, [], overrides,
                                                data="configs/MP-DocVQA.yml",
                                                port_args=["--ingest-workers", str(workers)])
    assert len(want) == len(got) == 1 and got[0]["n_samples"] == 6
    _same_summary(got[0], want[0])
    _same_summary(json.loads(plines[-1]), json.loads(jlines[-1]))
    _same_saved(tmp_path)


def test_build_docs_matches_root_train(tmp_path):
    """The port's `train.build_docs` against the root `train.py`'s: the
    synthetic corpus with seeded page images (the same uint8 arrays, bit for
    bit, for both splits) and an MP-DocVQA directory through the loaders."""
    import train as root_train
    from rag_docvqa_tpu_torch import train as p_train

    imdb, images = write_mp_docvqa(str(tmp_path / "mp"))
    configs = [{"dataset_name": "Synthetic", "n_train_docs": 3, "n_val_docs": 2, "n_pages": 3, "words_per_page": 20,
                "synthetic_images": True, "synthetic_image_size": 32},
               {"dataset_name": "Synthetic", "n_val_docs": 2, "n_pages": 2, "words_per_page": 20,
                "synthetic_images": True},
               {"dataset_name": "MP-DocVQA", "imdb_dir": imdb, "images_dir": images, "use_images": True,
                "page_retrieval": "custom", "max_pages": 2}]
    for config in configs:
        for split in ("train", "val") if config["dataset_name"] == "Synthetic" else ("val",):
            got, want = p_train.build_docs(dict(config), split), root_train.build_docs(dict(config), split)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for f in ("question", "words", "answers", "answer_page_idx", "question_id"):
                    assert getattr(g, f) == getattr(w, f), f
                for a, b in zip(g.boxes, w.boxes):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                assert len(g.images) == len(g.words) == len(w.images)
                for a, b in zip(g.images, w.images):
                    assert a.dtype == b.dtype == np.uint8
                    np.testing.assert_array_equal(a, b)
    size = p_train.build_docs(dict(configs[1]), "val")[0].images[0].shape
    assert size == (256, 256, 3)


def test_eval_cli_pix2struct_matches_root_eval(tmp_path, monkeypatch, capsys):
    """configs/Pix2Struct_tiny.yml (the synthetic corpus's seeded page
    images, RAG-Pix2Struct) against the root eval on the root CLI's weights."""
    want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, [],
                                                ["n_val_docs=3", "n_pages=2", "batch_size=2"],
                                                model="configs/Pix2Struct_tiny.yml", kind="pix2struct")
    assert len(want) == len(got) == 1 and got[0]["n_samples"] == 3
    _same_summary(got[0], want[0])
    _same_saved(tmp_path)


def test_eval_cli_hivt5_page_images_match_root_eval(tmp_path, monkeypatch, capsys):
    """configs/HiVT5_tiny.yml with `synthetic_images` and the per-page visual
    branch (a 2-layer ViT on 32 px renders) against the root eval."""
    overrides = ["n_val_docs=3", "synthetic_images=true", "synthetic_image_size=48", "use_visual=true",
                 "visual_hidden_size=16", "visual_num_layers=1", "visual_num_heads=2", "visual_mlp_dim=32",
                 "visual_patch_size=8", "visual_image_size=32"]
    want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, [], overrides,
                                                model="configs/HiVT5_tiny.yml", kind="hivt5")
    assert len(want) == len(got) == 1 and got[0]["n_samples"] == 3
    _same_summary(got[0], want[0])
    _same_saved(tmp_path)


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


@pytest.mark.parametrize("argv,error,match", [
    # F10 lifted: the Qwen engine with use_visual builds the Qwen2.5-VL tower from the tree's `vision`
    # (the JAX branch calls a function it never defines); the CLI's seeded tree carries none
    (["-m", "configs/Qwen_tiny.yml", "use_visual=true"], ValueError, "no `vision` tower"),
])
def test_eval_cli_refuses_what_is_not_ported(argv, error, match):
    from rag_docvqa_tpu_torch import eval as p_eval

    base = ["-m", MODEL, "-d", DATA, "--device", "cpu"]
    with pytest.raises(error, match=match):
        p_eval.main(base + argv)


def test_eval_cli_data_parallel_without_torchrun_is_the_plain_run(monkeypatch, capsys):
    """`--data-parallel` in one CPU process with no torchrun: the plain run's
    summary (the root CLI's flag with one device), no process group."""
    import torch.distributed as dist

    from rag_docvqa_tpu_torch import eval as p_eval

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    base = ["-m", MODEL, "-d", DATA, "--device", "cpu", "compute_stats=true"]
    plain, dp = p_eval.main(base)[0], p_eval.main(base + ["--data-parallel"])[0]
    assert not dist.is_initialized()
    for k in p_eval.SUMMARY_KEYS + ("page_retrieval",):
        assert dp[k] == plain[k], k
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 2


def test_eval_cli_runs_on_the_card_unless_asked(monkeypatch):
    from rag_docvqa_tpu_torch import eval as p_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        p_eval.main(["-m", MODEL, "-d", DATA])


def test_utils_stats_and_stage_timer():
    """StatsCollector's counting and bounded examples, merged (the tracer
    that replaced the stage timer has `tests/test_torch_profiling.py`)."""
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
