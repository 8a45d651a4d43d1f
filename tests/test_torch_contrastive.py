"""Port parity, the contrastive fine-tune: `training/contrastive.py` and the
`train_cl` CLI against the JAX package.

Tolerances (f32): losses 1e-5 relative; after three `train_contrastive`
steps (lr 1e-4, Adam: every element moves by about lr a step, whatever its
gradient's size, so an element whose gradient is near rounding noise can
move a fraction of lr differently) the loss of each step within 2e-5
relative and every parameter within 2e-5 absolute, except that an element
whose gradient is rounding residue on both sides (the key bias) moves by
+-lr in either: those are held to 3 * lr. bf16 compute is checked for what it promises: f32
masters, finite falling losses."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.models import bert as j_bert
from rag_docvqa_tpu.models.embedder import vt5_table_embed as j_table_embed
from rag_docvqa_tpu.training import contrastive as j_cl
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.models import bert as p_bert
from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed
from rag_docvqa_tpu_torch.models.layers import frozen
from rag_docvqa_tpu_torch.training import contrastive as p_cl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512
BERT_KW = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               max_position_embeddings=32)
PAIRS = [(f"what is the total of invoice {i}?", f"invoice {i} lists a total amount of {i * 37 % 101} euros due in march")
         for i in range(12)]


@pytest.mark.parametrize("loss", ["mnrl", "clip"])
@pytest.mark.parametrize("B", [2, 9])
def test_losses_match_jax(loss, B):
    rng = np.random.RandomState(B)
    a, b = rng.randn(B, 24).astype(np.float32), rng.randn(B, 24).astype(np.float32)
    if loss == "mnrl":
        want = j_cl.multiple_negatives_ranking_loss(jnp.asarray(a), jnp.asarray(b), scale=20.0)
        got = p_cl.multiple_negatives_ranking_loss(torch.from_numpy(a), torch.from_numpy(b), scale=20.0)
    else:
        want = j_cl.clip_style_loss(jnp.asarray(a), jnp.asarray(b), temperature=0.07)
        got = p_cl.clip_style_loss(torch.from_numpy(a), torch.from_numpy(b), temperature=0.07)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # matched pairs score below mismatched ones
    fn = p_cl.multiple_negatives_ranking_loss if loss == "mnrl" else p_cl.clip_style_loss
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) < float(got)


def test_loss_gradients_match_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(5, 16).astype(np.float32), rng.randn(5, 16).astype(np.float32)
    for j_fn, p_fn in ((j_cl.multiple_negatives_ranking_loss, p_cl.multiple_negatives_ranking_loss),
                       (j_cl.clip_style_loss, p_cl.clip_style_loss)):
        want = jax.grad(lambda x, y: j_fn(x, y), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
        got = torch.autograd.grad(p_fn(ta, tb), [ta, tb])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_pairs_round_trip_and_interchange(tmp_path):
    pairs = PAIRS[:3] + [("naïve café?", 'a "quoted" chunk\nwith a newline')]
    p_cl.save_pairs(str(tmp_path / "port.jsonl"), pairs)
    j_cl.save_pairs(str(tmp_path / "jax.jsonl"), pairs)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert p_cl.load_pairs(str(tmp_path / "jax.jsonl")) == pairs == j_cl.load_pairs(str(tmp_path / "port.jsonl"))


class _Doc:
    def __init__(self, question, answers):
        self.question, self.answers = question, answers


class _PerChunkEngine:
    """An engine of the shape mining needs: one answer per retrieved chunk."""

    def inference(self, batch, aux):
        return {"pred_answers": [["42 euros", "nothing"], None, ["paris", "Paris", "london"]][: len(batch)],
                "retrieval": {"text": [["total 42 euros", "other"], ["x"], ["in paris", "PARIS again", "uk"]]}}


class _Ingestor:
    def ingest(self, docs):
        return docs, {}


def test_mine_positive_pairs_matches_jax():
    docs = [_Doc("total?", ["42 euros"]), _Doc("skipped?", ["x"]), _Doc("city?", ["Paris"])]
    want = j_cl.mine_positive_pairs(_PerChunkEngine(), docs, _Ingestor(), batch_size=8)
    got = p_cl.mine_positive_pairs(_PerChunkEngine(), docs, _Ingestor(), batch_size=8)
    assert got == want == [("total?", "total 42 euros"), ("city?", "in paris"), ("city?", "PARIS again")]


def test_contrastive_optimizer_matches_optax_adamw():
    """`optax.adamw(lr)`: weight decay 1e-4, no clip, a constant rate from
    the first update on."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 4).astype(np.float32)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = frozen(torch.tensor(w0))

    toy, opt = Toy(), p_cl.contrastive_optimizer(1e-2)
    state = opt.init(toy)
    tx = optax.adamw(1e-2)
    jp = {"w": jnp.asarray(w0)}
    jstate = tx.init(jp)
    for scale in (100.0, 1e-3, 5.0):  # large gradients are not clipped
        g = rng.randn(6, 4).astype(np.float32) * scale
        updates, jstate = tx.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(opt.trainable(toy), {"w": torch.tensor(g)}, state)
        np.testing.assert_allclose(toy.w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-6)
    assert not np.allclose(toy.w.detach().numpy(), w0)


def _bert_tree(jcfg):
    tree = jax.tree.map(np.array, j_bert.init_bert_params(jax.random.PRNGKey(0), jcfg))
    for n in ("q", "k", "v", "o", "fc1", "fc2"):
        tree["blocks"][n]["kernel"] = tree["blocks"][n]["kernel"] * 5.0
    return tree


@pytest.mark.parametrize("loss", ["mnrl", "clip"])
def test_train_contrastive_bert_matches_jax(loss):
    """Three steps of the BGE bi-encoder (forward K9's plain version,
    backward K10's) against the JAX trainer on its XLA blocks: the same
    batches, losses and parameters."""
    lr = 1e-4
    jcfg, pcfg = j_bert.BertConfig(**BERT_KW), p_bert.BertConfig(**BERT_KW)
    tree = _bert_tree(jcfg)
    kw = dict(lr=lr, epochs=3, batch_size=8, loss=loss, max_tokens=16, seed=1)

    def j_embed(p, ids, mask):
        return j_bert.bert_sentence_embed(p, jcfg, ids, mask)

    jparams, jlosses = j_cl.train_contrastive(j_embed, jax.tree.map(jnp.asarray, tree), JHashTokenizer(VOCAB), PAIRS,
                                              j_cl.ContrastiveConfig(**kw))
    port = p_params.bert_from_jax(tree)
    p_out, plosses = p_cl.train_contrastive(lambda p, ids, mask: p_bert.bert_sentence_embed(p, pcfg, ids, mask), port,
                                            HashTokenizer(VOCAB), PAIRS, p_cl.ContrastiveConfig(**kw))
    assert p_out is port and len(plosses) == 3  # one batch of 8 of the 12 pairs per epoch
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-5)
    assert plosses[-1] < plosses[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    got = jax.tree_util.tree_flatten_with_path(p_params.bert_to_jax(port))[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        key = jax.tree_util.keystr(path)
        # the key bias's gradient is rounding residue in both: Adam moves it by +-lr a step, either way
        tol = 3 * lr if key == "['blocks']['k']['bias']" else 2e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)
    assert float(port.layers[0].attn_ln_b.abs().max()) > lr  # zero at the start: the parameters did train


def test_train_contrastive_table_embedder_matches_jax():
    """The VT5 shared-table embedder, as the `train_cl` CLI trains it."""
    rng = np.random.RandomState(0)
    shared = rng.randn(VOCAB, 32).astype(np.float32)
    kw = dict(lr=1e-2, epochs=3, batch_size=4, loss="mnrl", max_tokens=16, seed=2)
    jparams, jlosses = j_cl.train_contrastive(lambda p, ids, mask: j_table_embed(p["shared"], ids, mask),
                                              {"shared": jnp.asarray(shared)}, JHashTokenizer(VOCAB), PAIRS,
                                              j_cl.ContrastiveConfig(**kw))
    module = torch.nn.Module()
    module.shared = frozen(torch.tensor(shared))
    _, plosses = p_cl.train_contrastive(lambda p, ids, mask: vt5_table_embed(p.shared, ids, mask), module,
                                        HashTokenizer(VOCAB), PAIRS, p_cl.ContrastiveConfig(**kw))
    assert len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-5)
    np.testing.assert_allclose(module.shared.detach().numpy(), np.asarray(jparams["shared"]), rtol=0, atol=2e-5)


def test_bf16_compute_keeps_f32_masters_and_learns():
    pcfg = p_bert.BertConfig(**BERT_KW)
    port = p_bert.init_bert_params(torch.Generator().manual_seed(0), pcfg)
    cfg = p_cl.ContrastiveConfig(lr=1e-3, epochs=4, batch_size=12, max_tokens=16, bf16_compute=True)
    seen = []

    def embed(p, ids, mask):
        seen.append(p.layers[0].q_w.dtype)
        return p_bert.bert_sentence_embed(p, pcfg, ids, mask)

    _, losses = p_cl.train_contrastive(embed, port, HashTokenizer(VOCAB), PAIRS, cfg)
    assert set(seen) == {torch.bfloat16} and len(seen) == 8  # two embeds a step, both on the bf16 copy
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_encode_texts_pads_and_truncates():
    tok = HashTokenizer(VOCAB)
    ids, mask = p_cl.encode_texts(tok, ["one two three", "", "a b c d e f g h i j k l"], 6)
    assert ids.shape == mask.shape == (3, 6) and ids.dtype == np.int32 and mask.dtype == bool
    assert mask.sum(axis=1).tolist() == [min(len(tok.encode(t)), 6) for t in ("one two three", "", "a b c d e f g h i j k l")]
    assert not ids[~mask].any()


CLI_JAX_FREE = """
import runpy, sys
for name in ("jax", "flax", "optax", "orbax", "jaxlib"):
    sys.modules[name] = None       # any import of them now fails
sys.argv = ["train_cl", "train", "-m", "configs/VT5_tiny.yml", "--pairs", sys.argv[1], "--out", sys.argv[2],
            "train_epochs=3", "batch_size=4", "lr=0.01", "--device", "cpu"]
runpy.run_module("rag_docvqa_tpu_torch.train_cl", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "jaxlib",
                                                             "rag_docvqa_tpu") and sys.modules[m] is not None)
print("JAX_MODULES", loaded)
"""


def test_train_cl_cli_runs_without_jax(tmp_path):
    pairs, out = tmp_path / "pairs.jsonl", tmp_path / "ckpt"
    p_cl.save_pairs(str(pairs), PAIRS)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", CLI_JAX_FREE, str(pairs), str(out)], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "JAX_MODULES []"
    res = json.loads(lines[0])
    assert res["n_pairs"] == 12 and np.isfinite(res["loss_first"]) and res["loss_last"] < res["loss_first"]
    blob = torch.load(out / "step_3.pt", weights_only=True)
    assert blob["step"] == 3 and blob["params"]["shared"].shape == (32128, 32)


def test_train_cl_cli_refuses_what_is_not_ported(monkeypatch, tmp_path, capsys):
    """`mine` runs on the CPU when asked for it (it needs the anyconf
    strategy, which the engine has), and `train` without a card raises."""
    from rag_docvqa_tpu_torch import train_cl

    out = tmp_path / "pairs.jsonl"
    pairs = train_cl.main(["mine", "-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--pairs", str(out),
                           "--anls-threshold", "-1", "n_train_docs=4", "--device", "cpu"])
    assert pairs and p_cl.load_pairs(str(out)) == [tuple(p) for p in pairs]
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == {"n_pairs": len(pairs), "n_docs": 4, "out": str(out)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cl.main(["mine", "-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--pairs", str(out)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cl.main(["train", "-m", "configs/VT5_tiny.yml", "--pairs", "x.jsonl"])


@pytest.mark.parametrize("threshold", ["0.8", "-1"])
def test_train_cl_mine_matches_jax(threshold, tmp_path, monkeypatch):
    """`train_cl mine` against the root `train_cl.py mine --platform cpu` on
    the same weights (the root CLI's own seeded init, with a bf16-exact
    encoder rel-pos table, carried over by `params.from_jax`): the same pairs
    in the same order and the same file. At threshold -1 every valid chunk of
    every anyconf row is a pair, so the retrieval, the per-chunk assembly and
    the texts are compared; at 0.8 the answers of random weights score
    below it on both sides."""
    import train_cl as root_train_cl
    from rag_docvqa_tpu.models import vt5 as j_vt5
    from rag_docvqa_tpu_torch import train_cl
    from rag_docvqa_tpu_torch.models import vt5 as p_vt5

    trees = []
    j_init = j_vt5.init_vt5_params

    def rounded(key, cfg):
        tree = jax.tree.map(np.asarray, j_init(key, cfg))
        rb = tree["t5"]["encoder"]["rel_bias"]
        tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
        trees.append(tree)
        return jax.tree.map(jnp.asarray, tree)

    monkeypatch.setattr(j_vt5, "init_vt5_params", rounded)
    monkeypatch.setattr(p_vt5, "init_vt5_params", lambda g, cfg: p_params.from_jax(trees[0]))
    common = ["mine", "-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--anls-threshold", threshold,
              "n_train_docs=6"]
    want = root_train_cl.main(common + ["--pairs", str(tmp_path / "jax.jsonl"), "--platform", "cpu"])
    got = train_cl.main(common + ["--pairs", str(tmp_path / "port.jsonl"), "--device", "cpu"])
    assert [tuple(p) for p in got] == [tuple(p) for p in want]
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    assert (len(got) > 6) if threshold == "-1" else (got == [])
