"""Port parity, the not-answerable classifier (NAC): `mlp_relu_stack`,
`nac_prob`, `nac_bce_loss` and `update_results` against the JAX package on
the same weights (`params.from_jax`), the engine with a NAC against the JAX
engine (probabilities, blanked answers and zeroed confidences), the config
and the trainer that build it, and three train steps with the NAC term
against the JAX `make_train_step(use_nac=True)`.

Tolerances: probabilities 1e-6 absolute (f32 sums in another order); the
train step's loss and NAC loss 1e-5 relative and its grad norms 2e-5
relative, as `test_torch_training.py` holds the step without the NAC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import layers as j_layers
from rag_docvqa_tpu.models import nac as j_nac
from rag_docvqa_tpu.training import TrainState as JTrainState
from rag_docvqa_tpu.training import build_optimizer as j_build_optimizer
from rag_docvqa_tpu.training import make_train_step as j_make_train_step
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import layers as p_layers
from rag_docvqa_tpu_torch.models import nac as p_nac
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step

torch.set_num_threads(2)


def _nac_tree(seed=1, emb_dim=32, hidden=16, layers=2):
    cfg = j_nac.NACConfig(emb_dim=emb_dim, hidden_dim=hidden, num_layers=layers)
    return jax.tree.map(np.asarray, j_nac.init_nac_params(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_mlp_and_nac_prob_match_jax(layers):
    tree = _nac_tree(layers=layers)
    port = p_params.nac_from_jax(tree)
    assert [tuple(l.weight.shape) for l in port.mlp] == [tuple(l["kernel"].shape[::-1]) for l in tree["mlp"]]
    rng = np.random.RandomState(layers)
    x = rng.randn(5, 64).astype(np.float32)
    np.testing.assert_allclose(p_layers.mlp_relu_stack(port.mlp, torch.from_numpy(x)).numpy(),
                               np.asarray(j_layers.mlp_relu_stack(tree["mlp"], jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    inp, ans = rng.randn(4, 9, 32).astype(np.float32), rng.randn(4, 3, 32).astype(np.float32)
    imask, amask = rng.rand(4, 9) > 0.3, rng.rand(4, 3) > 0.4
    amask[1] = False  # an answer with no token: the mean's clip keeps it finite
    for masks in ((None, None), (imask, amask)):
        want = j_nac.nac_prob(tree, jnp.asarray(inp), jnp.asarray(ans),
                              *(None if m is None else jnp.asarray(m) for m in masks))
        got = p_nac.nac_prob(port, torch.from_numpy(inp), torch.from_numpy(ans),
                             *(None if m is None else torch.from_numpy(m) for m in masks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    back = p_params.nac_to_jax(port)
    for w, g in zip(tree["mlp"], back["mlp"]):
        np.testing.assert_array_equal(g["kernel"], w["kernel"])
        np.testing.assert_array_equal(g["bias"], w["bias"])


def test_bce_and_update_results_match_jax():
    probs = np.asarray([0.999999, 1e-9, 0.3, 0.5, 0.71], np.float32)
    labels = np.asarray([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    for pw in (1.0, 2.5):
        np.testing.assert_allclose(
            float(p_nac.nac_bce_loss(torch.from_numpy(probs), torch.from_numpy(labels), pos_weight=pw)),
            float(j_nac.nac_bce_loss(jnp.asarray(probs), jnp.asarray(labels), pos_weight=pw)), rtol=1e-6)
    answers, confs = ["a", None, "c", "", "e"], [0.9, None, 0.2, 0.0, 0.4]
    for thr in (0.5, 0.3, 1.0):
        assert p_nac.update_results(probs, answers, confs, thr) == j_nac.update_results(jnp.asarray(probs), answers,
                                                                                        confs, thr)
    cfg = p_nac.NACConfig(emb_dim=8, hidden_dim=4, num_layers=2)
    init = p_nac.init_nac_params(torch.Generator().manual_seed(0), cfg)
    jinit = j_nac.init_nac_params(jax.random.PRNGKey(0), j_nac.NACConfig(emb_dim=8, hidden_dim=4, num_layers=2))
    assert [tuple(l.weight.shape) for l in init.mlp] == [tuple(l["kernel"].shape[::-1]) for l in jinit["mlp"]]
    assert all(float(l.bias.abs().sum()) == 0 for l in init.mlp)


def _engine_fixture():
    import test_torch_engine as te

    jcfg, tree, pcfg, _ = te.weights.__wrapped__()
    tree = dict(tree, nac=_nac_tree(seed=3))
    return te, jcfg, tree, pcfg, p_params.from_jax(tree)


@pytest.mark.parametrize("strategy", ["concat", "oracle", "maxconf"])
def test_engine_with_nac_matches_jax(strategy):
    """The NAC gates the concat and oracle answers (probabilities within 1e-6,
    the same answers blanked, their confidences zeroed) and leaves the other
    strategies alone, as in JAX."""
    from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
    from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine

    te, jcfg, tree, pcfg, port = _engine_fixture()
    jtok, ptok, jb, jaux, pb, paux = te._ingested()
    jparams = jax.tree.map(jnp.asarray, tree)
    kw = dict(te.RAG_KW, page_retrieval=strategy)
    free = JEngine(JRAGConfig(**kw), jcfg, jparams, jtok).inference(jb, jaux)
    # a threshold between the probabilities, so that some answers are blanked and some are not
    probe = JEngine(JRAGConfig(**kw), jcfg, jparams, jtok, nac=(jparams["nac"], 2.0)).inference(jb, jaux)
    thr = float(np.median(probe["retrieval"].get("not_answerable_probs", [0.5])))
    want = JEngine(JRAGConfig(**kw), jcfg, jparams, jtok, nac=(jparams["nac"], thr)).inference(jb, jaux)
    got = RAGVT5Engine(RAGConfig(**kw), pcfg, port, ptok, nac=(port.nac, thr)).inference(pb, paux)
    assert got["pred_answers"] == want["pred_answers"]
    if strategy == "maxconf":
        assert "not_answerable_probs" not in got["retrieval"] and "not_answerable_probs" not in want["retrieval"]
        np.testing.assert_allclose(got["confidences"], free["confidences"], rtol=1e-4)
        return
    gp, wp = got["retrieval"]["not_answerable_probs"], want["retrieval"]["not_answerable_probs"]
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-6)
    blanked = [p > thr for p in wp]
    assert any(blanked) and not all(blanked)
    assert [c == 0.0 for c in got["confidences"]] == blanked == [c == 0.0 for c in want["confidences"]]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-4)


def test_build_engine_builds_the_nac():
    """`use_not_answerable_classifier` builds the NAC from the parameters'
    own `nac`, else from seed + 1, at `not_answerable_threshold`."""
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer

    c = p_config.load_config("configs/VT5_tiny.yml", "configs/Synthetic.yml",
                             {"use_not_answerable_classifier": True, "not_answerable_threshold": 0.3})
    tok = HashTokenizer(4096)
    vcfg = p_config.build_vt5_config(c, tok.vocab_size)
    from rag_docvqa_tpu_torch.models import vt5 as p_vt5

    params = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), vcfg)
    engine = p_config.build_engine(c, params, tok)
    nac, thr = engine.nac
    assert thr == 0.3 and nac is not params.nac and params.nac is None
    want = p_nac.init_nac_params(torch.Generator().manual_seed(c["seed"] + 1), p_nac.NACConfig(emb_dim=32))
    assert all(torch.equal(a, b) for a, b in zip(nac.parameters(), want.parameters()))
    params.nac = want
    assert p_config.build_engine(c, params, tok).nac[0] is want
    assert p_config.build_engine(dict(c, use_not_answerable_classifier=False), params, tok).nac is None


@pytest.mark.parametrize("fused_gate", ["on", "off"])
def test_nac_train_step_matches_jax(fused_gate, monkeypatch):
    """Three steps with the NAC term (a 16-token greedy decode of the frozen
    weights, its answers' embeddings into the NAC, weighted BCE) against
    JAX's: the loss, the NAC loss, its accuracy and the grad norms, "nac"
    among the roots."""
    import test_torch_training as tt
    from rag_docvqa_tpu.engine.rag_vt5 import RAGConfig as JRAGConfig
    from rag_docvqa_tpu.models import vt5 as j_vt5
    from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig

    jcfg, pcfg = tt._configs()
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    if fused_gate == "on":
        monkeypatch.setattr(j_feb, "fused_t5_train_wanted", lambda *a, **k: True)
    # the greedy decode encodes through JAX's plain blocks (an f32 bias): a
    # bf16-exact table makes it agree with the port's bf16 bias
    rb = tree["t5"]["encoder"]["rel_bias"]
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    tree["nac"] = _nac_tree(seed=2)
    jb, pb, labels = tt._batches()
    nac_labels = np.asarray([1.0, 0.0], np.float32)
    kw = dict(use_nac=True, nac_loss_weight=0.7, nac_pos_weight=2.0)

    tx = j_build_optimizer(**tt.OPT_KW)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    jstep = j_make_train_step(jcfg, JRAGConfig(**tt.RAG_KW), tx, **kw)
    port = p_params.from_jax(tree)
    opt = build_optimizer(**tt.OPT_KW, mask=trainable_mask(port, ("t5", "spatial", "nac")))
    pstate = TrainState.create(port, opt)
    pstep = make_train_step(pcfg, RAGConfig(**tt.RAG_KW), opt, **kw)
    for i in range(3):
        jstate, jm = jstep(jstate, jb, jnp.asarray(labels), jnp.asarray(nac_labels))
        pstate, pm = pstep(pstate, pb, labels, nac_labels)
        assert set(pm) == set(jm) == {"loss", "grad_norm", "grad_norm/t5", "grad_norm/spatial", "grad_norm/nac",
                                      "nac_loss", "nac_accuracy"}
        for k in ("loss", "nac_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k} step {i}")
        assert float(pm["nac_accuracy"]) == float(jm["nac_accuracy"])
        for k in ("grad_norm", "grad_norm/t5", "grad_norm/spatial", "grad_norm/nac"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-5, err_msg=f"{k} step {i}")
    for w, g in zip(jax.tree.map(np.asarray, jstate.params["nac"])["mlp"], p_params.to_jax(pstate.params)["nac"]["mlp"]):
        np.testing.assert_allclose(g["kernel"], w["kernel"], rtol=2e-5, atol=2e-5)


def test_trainer_trains_and_evaluates_with_nac(tmp_path):
    """`use_nac` through the loop: "nac" trains (initialised from seed + 1),
    the NAC metrics are logged, the evaluation engine gates at
    `nac_threshold`, and the checkpoint carries the NAC."""
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.models import vt5 as p_vt5
    from rag_docvqa_tpu_torch.training.trainer import TrainLoopConfig, Trainer

    c = p_config.load_config("configs/VT5_tiny.yml", "configs/Synthetic.yml")
    tok = HashTokenizer()
    vcfg = p_config.build_vt5_config(c, tok.vocab_size)
    params = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), vcfg)
    logged = []

    class Log:
        def log(self, m):
            logged.append(m)

    loop = TrainLoopConfig(epochs=1, batch_size=4, lr=2e-3, warmup_steps=1, log_every=1, use_nac=True,
                           nac_threshold=0.2, eval_start=False, save_dir=str(tmp_path), seed=5, prefetch_depth=0)
    trainer = Trainer(vcfg, p_config.build_rag_config(c), params, tok,
                      DocVQAIngestor(tok, p_config.build_chunk_spec(c), p_config.build_caps(c)), loop, logger=Log())
    before = p_nac.init_nac_params(torch.Generator().manual_seed(6), p_nac.NACConfig(emb_dim=32))
    out = trainer.fit(make_corpus(8, n_pages=2, words_per_page=30, seed=0), make_corpus(4, n_pages=2,
                                                                                      words_per_page=30, seed=1))
    steps = [m for m in logged if "nac_loss" in m]
    assert len(steps) == 2 and all(np.isfinite(m["nac_loss"]) and 0 <= m["nac_accuracy"] <= 1 for m in steps)
    assert params.nac is not None and not torch.equal(params.nac.mlp[0].weight, before.mlp[0].weight)
    assert trainer.engine().nac == (params.nac, 0.2)
    assert np.isfinite(out["history"][0]["train_loss"])
    blob = torch.load(next(tmp_path.glob("step_*.pt")), weights_only=True)
    assert "nac.mlp.0.weight" in blob["params"]
