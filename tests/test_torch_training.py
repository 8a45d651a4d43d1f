"""Port parity, the training slice: the port's train step against the JAX
`make_train_step` on the same weights and batch, with the JAX fused-train
gate forced on (its kernels in interpret mode, the TPU path) and off (its
plain XLA blocks); the optimizer against optax; the teacher-forced decoder
against JAX's; checkpoints; and the port's train CLI in a process where
jax, flax, optax and orbax cannot be imported.

Tolerances: loss 1e-5 relative, grad norms 2e-5 relative (f32 sums in
another order). Params after 3 steps (lr 1e-2, Adam) within 2e-5, except
the encoder rel-pos table on the JAX blocks path: there JAX keeps the
bias and its gradient in f32 while the port's layer takes it in bf16 (as
the JAX fused path does), so the table's gradient differs by a bf16
rounding and the table, after Adam, by up to 2e-3."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine.rag_vt5 import RAGConfig as JRAGConfig
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu.training import TrainState as JTrainState
from rag_docvqa_tpu.training import build_optimizer as j_build_optimizer
from rag_docvqa_tpu.training import make_train_step as j_make_train_step
from rag_docvqa_tpu.training.optimizer import trainable_mask as j_trainable_mask
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_train_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

T5_KW = dict(vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
RAG_KW = dict(page_retrieval="concat", chunk_num=2, max_source_length=32, max_new_tokens=4)
SPEC = ChunkSpec(chunk_size=8, overlap=2)
OPT_KW = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _configs():
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           use_visual=False)
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    return jcfg, pcfg


def _batches():
    jing, ping = JIngestor(JHashTokenizer(256), SPEC), DocVQAIngestor(HashTokenizer(256), SPEC)
    jdocs, pdocs = j_make_corpus(2, n_pages=2, words_per_page=20, seed=9), make_corpus(2, n_pages=2,
                                                                                        words_per_page=20, seed=9)
    jing.caps, ping.caps = jing.plan_caps(jdocs), ping.plan_caps(pdocs)
    (jb, jaux), (pb, paux) = jing.ingest(jdocs), ping.ingest(pdocs)
    labels = ping.answer_labels(paux["answers"], max_len=4, seed=3)
    np.testing.assert_array_equal(labels, jing.answer_labels(jaux["answers"], max_len=4, seed=3))
    return jb, pb, labels


@pytest.mark.parametrize("fused_gate", ["on", "off"])
def test_train_step_matches_jax(fused_gate, monkeypatch):
    jcfg, pcfg = _configs()
    tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(0), jcfg))
    if fused_gate == "on":
        # the TPU path: whole-layer forward + hand-written backward, interpret mode
        monkeypatch.setattr(j_feb, "fused_t5_train_wanted", lambda *a, **k: True)
    else:
        # the JAX blocks path keeps the rel-pos bias in f32: a bf16-exact
        # table makes the forward agree with the port's bf16 bias
        rb = tree["t5"]["encoder"]["rel_bias"]
        tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    jb, pb, labels = _batches()

    tx = j_build_optimizer(**OPT_KW)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    jstep = j_make_train_step(jcfg, JRAGConfig(**RAG_KW), tx)
    port = p_params.from_jax(tree)
    opt = build_optimizer(**OPT_KW, mask=trainable_mask(port, ("t5", "spatial")))
    pstate = TrainState.create(port, opt)
    pstep = make_train_step(pcfg, RAGConfig(**RAG_KW), opt)

    for i in range(3):
        jstate, jm = jstep(jstate, jb, jnp.asarray(labels))
        pstate, pm = pstep(pstate, pb, labels)
        assert set(pm) == set(jm) == {"loss", "grad_norm", "grad_norm/t5", "grad_norm/spatial"}
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5, err_msg=f"step {i}")
        for k in ("grad_norm", "grad_norm/t5", "grad_norm/spatial"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-5, err_msg=f"{k} step {i}")
    assert pstate.step == 3 and pstate.opt_state["count"] == 3

    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jstate.params))[0]
    got = jax.tree_util.tree_flatten_with_path(p_params.to_jax(pstate.params))[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        key = jax.tree_util.keystr(path)
        tol = 2e-3 if fused_gate == "off" and key == "['t5']['encoder']['rel_bias']" else 2e-5
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=key)


def test_optimizer_matches_optax():
    """Clip by global norm (trainable leaves only), AdamW with the warmup ->
    decay schedule (lr 0 at the first update), frozen roots untouched."""
    rng = np.random.RandomState(0)
    tree = {"a": {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)},
            "f": {"w": rng.randn(2, 2).astype(np.float32)}}

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v)) for k, v in tree["a"].items()})
            self.f = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v)) for k, v in tree["f"].items()})

    toy = Toy()
    kw = dict(lr=0.1, warmup_steps=2, total_steps=6)
    tx = j_build_optimizer(**kw, mask=j_trainable_mask(tree, ("a",)))
    opt = build_optimizer(**kw, mask=trainable_mask(toy, ("a",)))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate, state = tx.init(jp), opt.init(toy)
    assert toy.a["w"].requires_grad and not toy.f["w"].requires_grad
    for i, scale in enumerate([0.1, 5.0, 1.0, 20.0, 0.5]):  # norms below and above the clip at 3.0
        g = {"a": {"w": rng.randn(4, 3).astype(np.float32) * scale, "b": rng.randn(3).astype(np.float32) * scale},
             "f": {"w": rng.randn(2, 2).astype(np.float32)}}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(opt.trainable(toy), {"a.w": torch.tensor(g["a"]["w"]), "a.b": torch.tensor(g["a"]["b"])}, state)
        if i == 0:  # schedule(0) = 0: the first update moves nothing
            np.testing.assert_array_equal(toy.a["w"].detach().numpy(), tree["a"]["w"])
        for root, name in (("a", "w"), ("a", "b"), ("f", "w")):
            np.testing.assert_allclose(getattr(toy, root)[name].detach().numpy(), np.asarray(jp[root][name]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{root}.{name} step {i}")
    np.testing.assert_array_equal(toy.f["w"].detach().numpy(), tree["f"]["w"])


def test_decode_train_and_shift_match_jax():
    jcfg, pcfg = _configs()
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(2), jcfg.t5))
    rng = np.random.RandomState(1)
    labels = rng.randint(2, 256, (3, 6)).astype(np.int32)
    labels[1, 3:] = -100
    enc = rng.randn(3, 10, 32).astype(np.float32)
    mask = np.arange(10)[None, :] < np.array([10, 7, 2])[:, None]
    jdec = j_t5.shift_tokens_right(jnp.asarray(labels), 0, 0)
    pdec = p_t5.shift_tokens_right(torch.from_numpy(labels).long(), 0, 0)
    np.testing.assert_array_equal(pdec.numpy(), np.asarray(jdec))
    want = j_t5.decode_train(jax.tree.map(jnp.asarray, tree), jcfg.t5, jdec, jnp.asarray(enc), jnp.asarray(mask))
    got = p_t5.decode_train(p_params.from_jax(tree), pcfg.t5, pdec, torch.from_numpy(enc), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_checkpoints_keep_the_best_three(tmp_path):
    _, pcfg = _configs()
    params = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), pcfg)
    opt = build_optimizer(mask=trainable_mask(params, ("t5",)))
    state = TrainState.create(params, opt)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step, (acc, anls) in enumerate([(0.5, 0.1), (0.2, 0.9), (0.5, 0.3), (0.0, 0.0), (0.7, 0.0)], start=1):
        state.step = step
        mgr.save(step, state, metrics={"accuracy": acc, "anls": anls})
    # kept: steps 5 (0.7), 3 (0.5 + ANLS 0.3), 1 (0.5 + ANLS 0.1)
    assert sorted(int(p.name[5:-3]) for p in tmp_path.glob("step_*.pt")) == [1, 3, 5]
    assert mgr.best_step() == 5 and mgr.latest_step() == 5
    with torch.no_grad():
        params.t5.shared.zero_()
    restored = CheckpointManager(str(tmp_path)).restore(state, step=3)
    assert restored.step == 3 and restored.params.t5.shared.abs().sum() > 0


CLI_JAX_FREE = """
import runpy, sys
for name in ("jax", "flax", "optax", "orbax", "jaxlib"):
    sys.modules[name] = None       # any import of them now fails
sys.argv = ["train", "-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "train_epochs=1",
            "n_train_docs=8", "n_val_docs=4", "--no-eval-start", "--device", "cpu"]
runpy.run_module("rag_docvqa_tpu_torch.train", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "jaxlib",
                                                             "rag_docvqa_tpu") and sys.modules[m] is not None)
print("JAX_MODULES", loaded)
"""


def test_train_cli_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", CLI_JAX_FREE], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "JAX_MODULES []"
    epoch = next(l for l in lines if l.startswith("epoch=0 "))
    fields = dict(kv.split("=") for kv in epoch.split())
    assert np.isfinite(float(fields["train_loss"])) and 0.0 <= float(fields["anls"]) <= 1.0
    assert any(l.startswith("best_accuracy=") for l in lines)
