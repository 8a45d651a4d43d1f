"""Port parity, LoRA: `models/lora.py` against the JAX package's on the same
weights and adapters (carried with `params.causal_lm_from_jax` and
`params.lora_from_jax`), and the port's `train_lora` CLI against the root
`train_lora.py --platform cpu` on configs/Qwen_tiny.yml.

`merge_lora` gives JAX's merged kernels within 1e-6 (an f32 rank-r product
summed in another order); the identity at init exactly; the adapter count
exactly. The SFT loss's gradient in every adapter through the merge, K2's
and K6's plain versions on the CPU, within 1e-4 of `jax.grad` (the JAX side
runs its XLA attention). The CLIs from the
same base weights and adapter init print the same epoch loss to their four
decimals, and their adapters agree within 1e-5 after the epoch's 16 AdamW
steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import causal_lm as j_clm
from rag_docvqa_tpu.models import lora as j_lora
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import causal_lm as p_clm
from rag_docvqa_tpu_torch.models import lora as p_lora

torch.set_num_threads(2)

KW = dict(vocab_size=160, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=64, tie_word_embeddings=True)


def _world(rank=4, b_scale=0.05):
    """JAX weights and adapters (b moved off zero, so that a's gradient is
    not zero), and the port's copies."""
    jc = j_clm.CausalLMConfig(**KW)
    tree = j_clm.init_causal_lm_params(jax.random.PRNGKey(0), jc)
    lora = j_lora.init_lora(jax.random.PRNGKey(1), tree, targets=("q", "v"), rank=rank)
    rng = np.random.RandomState(0)
    lora = jax.tree.map(lambda x: x + b_scale * jnp.asarray(rng.randn(*x.shape), jnp.float32), lora)
    return (jc, tree, lora, p_clm.CausalLMConfig(**KW), p_params.causal_lm_from_jax(jax.tree.map(np.asarray, tree)),
            p_params.lora_from_jax(jax.tree.map(np.asarray, lora)))


def test_init_merge_and_count_match_jax():
    jc, tree, jl, pc, params, pl = _world()
    merged = p_lora.merge_lora(params, pl)
    want = j_lora.merge_lora(tree, jl)
    for a, b in zip(jax.tree.leaves(p_params.causal_lm_to_jax(merged)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert p_lora.lora_param_count(pl) == j_lora.lora_param_count(jl)
    # at init (b = 0) the merge is the identity, and the port's init has JAX's shapes
    fresh = p_lora.init_lora(torch.Generator().manual_seed(1), params, targets=("q", "v"), rank=4)
    assert [tuple(np.shape(x)) for x in jax.tree.leaves(p_params.lora_to_jax(fresh))] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(j_lora.init_lora(jax.random.PRNGKey(1), tree, rank=4))]
    same = p_lora.merge_lora(params, fresh)
    for merged_layer, layer in zip(same.layers, params.layers):
        for name in p_clm.PROJ_NAMES:
            assert torch.equal(getattr(merged_layer, name).weight, getattr(layer, name).weight), name
    # adapters that train: the merged weight carries the graph back to them
    assert same.layers[0].q.weight.grad_fn is not None and same.layers[0].k.weight is params.layers[0].k.weight
    a = fresh.layers[0]["q"].a
    assert abs(a.std().item() - 0.5) < 0.15 and not fresh.layers[0]["q"].b.any()  # A ~ N(0, 1/r), B = 0
    # int8 projections take no adapter
    assert len(p_lora.init_lora(torch.Generator(), p_clm.quantize_weights_int8(params)).layers[0]) == 0


def test_lora_gradients_match_jax_grad():
    jc, tree, jl, pc, params, pl = _world()
    rng = np.random.RandomState(3)
    ids = rng.randint(2, 160, (3, 12)).astype(np.int32)
    mask = np.arange(12)[None] < np.asarray([12, 9, 6])[:, None]
    labels = np.where(mask, ids, -100)
    labels[:, :4] = -100
    loss_fn = lambda l: j_clm.sft_loss(j_lora.merge_lora(tree, l), jc, jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(labels))
    jloss, jgrad = jax.value_and_grad(loss_fn)(jl)
    loss = p_clm.sft_loss(p_lora.merge_lora(params, pl), pc, torch.from_numpy(ids), torch.from_numpy(mask),
                          torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(pl.parameters()))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = p_params.lora_to_jax(p_params.lora_from_jax(jax.tree.map(np.asarray, jgrad)))
    named = dict(zip((n for n, _ in pl.named_parameters()), grads))
    for l in range(jc.num_layers):
        for t in ("q", "v"):
            for f in ("a", "b"):
                got = named[f"layers.{l}.{t}.{f}"].numpy()
                np.testing.assert_allclose(got, want["blocks"][t][f][l], rtol=0, atol=1e-4,
                                           err_msg=f"layer {l} {t}.{f}")
    assert all(p.grad is None for p in params.parameters())  # the base stays frozen


def test_train_lora_cli_matches_root_cli(tmp_path, monkeypatch, capsys):
    """`python -m rag_docvqa_tpu_torch.train_lora` against root
    `train_lora.py --platform cpu` on configs/Qwen_tiny.yml: the root CLI's
    seeded base weights go to the port as a checkpoint of its trainer
    (--ckpt), and its adapter init replaces the port's draw; then the same
    epoch line and, read back from --save-dir, the same adapters."""
    import train_lora as root_lora

    from rag_docvqa_tpu_torch import train_lora as p_train_lora
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
    from rag_docvqa_tpu_torch.training.train_step import TrainState

    kept = {}
    j_init, j_init_lora = j_clm.init_causal_lm_params, j_lora.init_lora

    def keep_base(key, cfg):
        kept["base"] = jax.tree.map(np.asarray, j_init(key, cfg))
        return jax.tree.map(jnp.asarray, kept["base"])

    def keep_lora(*a, **kw):
        kept["lora"] = jax.tree.map(np.asarray, j_init_lora(*a, **kw))
        return jax.tree.map(jnp.asarray, kept["lora"])

    monkeypatch.setattr(j_clm, "init_causal_lm_params", keep_base)
    monkeypatch.setattr(j_lora, "init_lora", keep_lora)
    args = ["-m", "configs/Qwen_tiny.yml", "-d", "configs/Synthetic.yml"]
    want = root_lora.main(args + ["--platform", "cpu"])
    want_line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("epoch=")]

    ckpt = tmp_path / "base"
    CheckpointManager(str(ckpt)).save(0, TrainState(params=p_params.causal_lm_from_jax(kept["base"]), opt_state={},
                                                    step=0))
    monkeypatch.setattr(p_lora, "init_lora", lambda *a, **kw: p_params.lora_from_jax(kept["lora"]))
    got = p_train_lora.main(args + ["--device", "cpu", "--ckpt", str(ckpt), "--save-dir", str(tmp_path / "ad")])
    out = capsys.readouterr().out.splitlines()
    got_line = [x for x in out if x.startswith("epoch=")]
    assert [x.split(" wall=")[0] for x in got_line] == [x.split(" wall=")[0] for x in want_line], (got_line, want_line)
    assert any("adapters saved to" in x for x in out)
    restored = CheckpointManager(str(tmp_path / "ad")).restore_params(p_params.lora_from_jax(kept["lora"]))
    for a, b in zip(restored.state_dict().values(), got.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(p_params.lora_to_jax(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
