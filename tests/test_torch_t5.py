"""Port parity, the T5 stack: encode (through K1) against the JAX encode
on each of its paths (whole-layer kernel, plain blocks, flash), decode steps,
greedy decoding with f32 and int8 cross caches, K3 on and off, the step
index as a device tensor, and the graph path's state, key and cache through
a stand-in for the CUDA capture (the capture itself runs on the card:
tests/test_torch_decode_graph.py)."""

import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.ops.decode import greedy_decode as j_greedy
from rag_docvqa_tpu_torch import kernels, profiling
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.ops import decode as p_decode
from rag_docvqa_tpu_torch.ops.decode import greedy_decode as p_greedy

torch.set_num_threads(2)

J_CFG = j_t5.T5Config(vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
                      num_decoder_layers=2, dropout_rate=0.0)


def port_cfg(jcfg):
    return p_t5.T5Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _setup(jcfg=J_CFG, seed=0):
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), p_params.from_jax(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _enc_inputs(B=3, T=20, d=32, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, min(13, T - 2), 6][:B])[:, None]
    return x, mask


def test_config_fields_match():
    assert [f.name for f in dataclasses.fields(p_t5.T5Config)] == [f.name for f in dataclasses.fields(j_t5.T5Config)]


@pytest.mark.parametrize("path", ["fused", "blocks", "flash"])
def test_encode_matches_jax_per_path(path):
    """The port's one encoder path (K1, bias in bf16 even for f32 x) against
    each JAX path: the whole-layer kernel and flash (bias in bf16 too) and
    the plain blocks (bias in f32, so the table is made bf16-exact there)."""
    jcfg = dataclasses.replace(J_CFG, flash_encoder=path == "flash")
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(0), jcfg))
    if path == "blocks":
        rb = tree["encoder"]["rel_bias"]
        tree["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(np.array(rb)).bfloat16().float())
    jp, pp = jax.tree.map(jnp.asarray, tree), p_params.from_jax(tree)
    x, mask = _enc_inputs()
    want = j_t5.encode(jp, jcfg, jnp.asarray(x), jnp.asarray(mask), fused=path == "fused")
    got = p_t5.encode(pp, port_cfg(jcfg), _t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_steps_match_jax():
    jp, pp = _setup()
    x, mask = _enc_inputs(B=2, T=9)
    enc_j = j_t5.encode(jp, J_CFG, jnp.asarray(x), jnp.asarray(mask))
    enc_p = _t(np.asarray(enc_j))
    ids = np.random.RandomState(2).randint(3, 128, size=(2, 5))
    cj = j_t5.init_decode_cache(jp, J_CFG, enc_j, 5)
    cp = p_t5.init_decode_cache(pp, port_cfg(J_CFG), enc_p, 5)
    for t in range(5):
        lj, cj = j_t5.decode_step(jp, J_CFG, cj, jnp.asarray(ids[:, t]), jnp.int32(t), jnp.asarray(mask))
        lp, cp = p_t5.decode_step(pp, port_cfg(J_CFG), cp, _t(ids[:, t]).long(), t, _t(mask))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cp.self_k.numpy(), np.asarray(cj.self_k), rtol=1e-5, atol=1e-5)


def _bf16_tree(jp, pp):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp), pp.to(torch.bfloat16)


@pytest.mark.parametrize("cache_dtype", ["f32", "int8", "bf16", "int8_bf16"])
def test_greedy_decode_ids_match_jax_k3_on_and_off(cache_dtype):
    """H*dk = 128 and Te = 128 pass the JAX package's alignment gate, so its
    packed-cache kernel path runs too; the decoded ids of all four runs are
    identical. The bf16 caches come with bf16 weights and a bf16 encoder
    output (JAX takes no mix of the two); their logits are bf16, so their
    confidences agree to bf16 precision, 2e-2, where the f32 ones agree to
    1e-4. With bf16 weights and an int8 cache the reference confidences are
    JAX's decode run op by op: compiled, XLA's CPU backend keeps some values
    the source rounds to bf16 in f32 (excess precision), which moves one
    confidence by ~11 %; run op by op, every op rounds where the source says."""
    int8 = cache_dtype.startswith("int8")
    bf16 = cache_dtype.endswith("bf16")
    conf_rtol = 2e-2 if bf16 else 1e-4
    jcfg = j_t5.T5Config(vocab_size=128, d_model=32, d_kv=32, num_heads=4, d_ff=64, num_encoder_layers=2,
                         num_decoder_layers=2, dropout_rate=0.0, decode_kv_int8=int8)
    jp, pp = _setup(jcfg)
    rng = np.random.RandomState(0)
    enc = rng.randn(2, 128, 32).astype(np.float32)
    emask = np.arange(128)[None, :] < np.array([128, 77])[:, None]
    j_enc, p_enc = jnp.asarray(enc), _t(enc)
    if bf16:
        j_enc, p_enc = j_enc.astype(jnp.bfloat16), p_enc.bfloat16()
        jp, pp = _bf16_tree(jp, pp)
    t_ref, c_ref = j_greedy(jp, jcfg, j_enc, jnp.asarray(emask), max_new_tokens=6)
    if cache_dtype == "int8_bf16":
        with jax.disable_jit():
            t_eager, c_ref = j_greedy(jp, jcfg, j_enc, jnp.asarray(emask), max_new_tokens=6)
        np.testing.assert_array_equal(np.asarray(t_eager), np.asarray(t_ref))
    j_fused = dataclasses.replace(jcfg, fused_decode_attn=True)
    t_jf, _ = j_greedy(jp, j_fused, j_enc, jnp.asarray(emask), max_new_tokens=6)
    np.testing.assert_array_equal(np.asarray(t_jf), np.asarray(t_ref))
    want_dtype = torch.int8 if int8 else torch.bfloat16 if bf16 else torch.float32
    for fused in (False, True):
        pcfg = port_cfg(dataclasses.replace(jcfg, fused_decode_attn=fused))
        cache = p_t5.init_decode_cache(pp, pcfg, p_enc, 6)
        assert cache.cross_k.dim() == (4 if fused else 5)
        assert cache.cross_k.dtype == want_dtype
        toks, conf = p_greedy(pp, pcfg, p_enc, _t(emask), max_new_tokens=6)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(conf.numpy(), np.asarray(c_ref), rtol=conf_rtol, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_int8_decode_steps_match_jax_op_by_op(fused):
    """bf16 weights, an int8 cross cache: each step's bf16 logits equal those
    of JAX's `decode_step` run op by op, bit for bit, K3 on and off. This
    holds the cast points, the tied head's scale among them: JAX multiplies
    by d_model**-0.5 rounded to bf16 (a weak-typed scalar), which moved a
    third of the logits by one bf16 step while the port kept it in f32."""
    jcfg = j_t5.T5Config(vocab_size=128, d_model=32, d_kv=32, num_heads=4, d_ff=64, num_encoder_layers=2,
                         num_decoder_layers=2, dropout_rate=0.0, decode_kv_int8=True)
    jp, pp = _bf16_tree(*_setup(jcfg))
    enc = np.random.RandomState(0).randn(2, 128, 32).astype(np.float32)
    emask = np.arange(128)[None, :] < np.array([128, 77])[:, None]
    j_enc, p_enc = jnp.asarray(enc).astype(jnp.bfloat16), _t(enc).bfloat16()
    pcfg = port_cfg(dataclasses.replace(jcfg, fused_decode_attn=fused))
    cp = p_t5.init_decode_cache(pp, pcfg, p_enc, 4)
    tok = np.zeros(2, np.int32)
    with jax.disable_jit():
        cj = j_t5.init_decode_cache(jp, jcfg, j_enc, 4)
        for t in range(4):
            lj, cj = j_t5.decode_step(jp, jcfg, cj, jnp.asarray(tok), jnp.int32(t), jnp.asarray(emask))
            lp, cp = p_t5.decode_step(pp, pcfg, cp, _t(tok).long(), t, _t(emask))
            assert lp.dtype == torch.bfloat16
            np.testing.assert_array_equal(lp.float().numpy(), np.asarray(lj.astype(jnp.float32)))
            tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)


def test_greedy_decode_pads_after_eos():
    """Emitted ids after a sequence's EOS are pad, the confidence product
    skips finished steps and the last step, as in JAX."""
    jp, pp = _setup(seed=3)
    # reweight the tied table so that one row emits EOS (id 1) at once and
    # the others keep going
    shared = np.asarray(jp["shared"]).copy()
    shared[0] *= 0.1
    shared[1] *= 4.0
    jp = dict(jp, shared=jnp.asarray(shared))
    pp.shared.data = _t(shared)
    x, mask = _enc_inputs(B=3, T=7, seed=4)
    enc = j_t5.encode(jp, J_CFG, jnp.asarray(x), jnp.asarray(mask))
    tj, cj = j_greedy(jp, J_CFG, enc, jnp.asarray(mask), max_new_tokens=5)
    tp, cp = p_greedy(pp, port_cfg(J_CFG), _t(np.asarray(enc)), _t(mask), max_new_tokens=5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-6)
    toks = tp.numpy()
    assert (toks == J_CFG.eos_id).any() and not (toks == J_CFG.eos_id).any(axis=1).all()
    for row in toks:
        hits = np.where(row == J_CFG.eos_id)[0]
        if len(hits):
            assert (row[hits[0] + 1:] == J_CFG.pad_id).all()


# --------------------------------------------------------------------------- #
# the step index on the device, and the graph path's state and cache
# --------------------------------------------------------------------------- #
def _eos_early_setup(cache):
    """bf16 weights with a bf16 (or int8) cross cache and a bf16 encoder
    output, the tied table reweighted so that some rows emit EOS early."""
    jcfg = j_t5.T5Config(vocab_size=128, d_model=32, d_kv=32, num_heads=4, d_ff=64, num_encoder_layers=2,
                         num_decoder_layers=2, dropout_rate=0.0, decode_kv_int8=cache == "int8")
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(3), jcfg))
    tree["shared"] = tree["shared"].copy()
    tree["shared"][0] *= 0.1
    tree["shared"][1] *= 4.0
    jp, pp = _bf16_tree(jax.tree.map(jnp.asarray, tree), p_params.from_jax(tree))
    rng = np.random.RandomState(4)
    enc = rng.randn(4, 24, 32).astype(np.float32)
    emask = np.arange(24)[None, :] < np.array([24, 17, 9, 3])[:, None]
    return jcfg, jp, pp, jnp.asarray(enc).astype(jnp.bfloat16), _t(enc).bfloat16(), emask


def _int_step_greedy(params, cfg, enc, mask, T):
    """The decode loop with a Python int step: tokens gathered in a list, the
    last step left out of the confidence by a host branch."""
    B = enc.shape[0]
    cache = p_t5.init_decode_cache(params, cfg, enc, T)
    bias = p_t5.decoder_self_bias(params, cfg, T)
    token = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int64)
    done = torch.zeros((B,), dtype=torch.bool)
    conf = torch.ones((B,), dtype=torch.float32)
    tokens = []
    for t in range(T):
        logits, cache = p_t5.decode_step(params, cfg, cache, token, t, mask, self_bias=bias[:, :, t, :])
        emitted = torch.where(done, cfg.pad_id, logits.argmax(dim=-1))
        if t < T - 1:
            conf = conf * torch.where(done, 1.0, torch.softmax(logits.float(), dim=-1).amax(dim=-1))
        done = done | (emitted == cfg.eos_id)
        token = emitted
        tokens.append(emitted)
    return torch.stack(tokens, dim=1), conf


@pytest.mark.parametrize("cache", ["bf16", "int8", "f32_weights"])
def test_decode_step_tensor_step_equals_int_step(cache):
    """`decode_step` with the step as a 0-d int64 tensor gives the int step's
    logits and writes the same self K/V, bit for bit, with the bias row given
    and computed inside; "f32_weights": f32 weights over the bf16 encoder
    output, so the f32 K/V are cast into the bf16 self cache."""
    jcfg, _, pp, _, p_enc, emask = _eos_early_setup("int8" if cache == "int8" else "bf16")
    if cache == "f32_weights":
        pp = pp.float()
    cfg = port_cfg(jcfg)
    mask = _t(emask)
    caches = [p_t5.init_decode_cache(pp, cfg, p_enc, 5) for _ in range(3)]
    bias = p_t5.decoder_self_bias(pp, cfg, 5)
    tok = torch.zeros(4, dtype=torch.int64)
    for t in range(5):
        step = torch.tensor(t)
        want, _ = p_t5.decode_step(pp, cfg, caches[0], tok, t, mask, self_bias=bias[:, :, t, :])
        given, _ = p_t5.decode_step(pp, cfg, caches[1], tok, step, mask,
                                    self_bias=bias.index_select(2, step.view(1))[:, :, 0, :])
        inside, _ = p_t5.decode_step(pp, cfg, caches[2], tok, step, mask)
        for got in (given, inside):
            assert torch.equal(got, want)
        tok = want.argmax(-1)
    for c in caches[1:]:
        assert torch.equal(c.self_k, caches[0].self_k) and torch.equal(c.self_v, caches[0].self_v)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_tensor_step_greedy_matches_int_step_and_jax(cache, T):
    """`greedy_decode` (the step, token, flags, confidence and tokens on the
    device) against the int-step loop: tokens exact, confidences bit-equal
    (the last step's factor is exactly 1); against JAX's `greedy_decode` run
    op by op: tokens exact, confidences to 1e-6. Rows hit EOS early."""
    jcfg, jp, pp, j_enc, p_enc, emask = _eos_early_setup(cache)
    cfg = port_cfg(jcfg)
    toks, conf = p_greedy(pp, cfg, p_enc, _t(emask), max_new_tokens=T)
    want_t, want_c = _int_step_greedy(pp, cfg, p_enc, _t(emask), T)
    assert torch.equal(toks, want_t) and torch.equal(conf, want_c)
    with jax.disable_jit():
        jt, jc = j_greedy(jp, jcfg, j_enc, jnp.asarray(emask), max_new_tokens=T)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    if T == 8:
        hit = (toks == cfg.eos_id).any(dim=1)
        assert hit.any() and not hit.all()


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: `_capture` replaced by a stand-in that runs
    the warm-up steps (they dirty the state, as on the card) and then
    "replays" the step eagerly; it counts its captures and reports 3
    `t5_gemm` launches a step. A fresh graph cache for the test."""
    captured = []

    def capture(run_step, reset):
        for _ in range(p_decode._WARMUP_STEPS):
            reset()
            run_step()
        captured.append(run_step)
        return run_step, [{"t5_gemm": 3}, {}]

    monkeypatch.setattr(p_decode, "_capture", capture)
    monkeypatch.setattr(p_decode, "_graphs", OrderedDict())
    return captured


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_graph_path_state_matches_eager_on_a_stand_in(cache, stand_in):
    """Two calls of one key with different encoder states: each returns the
    eager decode's tokens and confidences bit for bit (no stale cross K/V,
    self K/V, mask, token, flag or step), the first call's outputs survive
    the second (copies, not the static buffers); one capture, T replays a
    call, T x 3 launches a call added to `kernels.LAUNCHES`."""
    jcfg, _, pp, _, p_enc, emask = _eos_early_setup(cache)
    cfg = port_cfg(jcfg)
    T = 8
    other_enc = torch.flip(p_enc, dims=[1]) * 1.5
    other_mask = _t(emask[::-1].copy())
    profiling.reset()
    profiling.enable()
    try:
        gemm0 = kernels.LAUNCHES["t5_gemm"]
        first = p_decode._replayed(pp, cfg, p_enc, _t(emask), T)
        kept = [x.clone() for x in first]
        second = p_decode._replayed(pp, cfg, other_enc, other_mask, T)
        launched = kernels.LAUNCHES["t5_gemm"] - gemm0
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    for got, (enc, mask) in ((first, (p_enc, _t(emask))), (second, (other_enc, other_mask))):
        want = p_greedy(pp, cfg, enc, mask, max_new_tokens=T)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert len(stand_in) == 1 and launched == 2 * T * 3
    assert profiling.total(counts, "decode.graph_captures") == 1
    assert profiling.total(counts, "decode.graph_replays") == 2 * T
    assert profiling.total(counts, "decode.eager_steps") == 0


def test_graph_key_and_lru_eviction(stand_in):
    """A capture for each new batch size, encoder length, step count, dtype,
    config, inference mode or parameter address, none for a key seen before;
    the cache keeps `_GRAPH_ENTRIES`, dropping the least recently used."""
    _, pp, = _setup()
    cfg = port_cfg(J_CFG)
    x, mask = _enc_inputs(B=3, T=20)
    enc, m = _t(x), _t(mask)

    def graph(params=pp, c=cfg, e=enc, mk=m, T=4):
        return p_decode._graph_for(params, c, e, mk, T)

    a = graph()
    assert graph() is a and len(stand_in) == 1
    variants = [lambda: graph(e=enc[:2], mk=m[:2]), lambda: graph(e=enc[:, :9], mk=m[:, :9]), lambda: graph(T=5),
                lambda: graph(e=enc.bfloat16()), lambda: graph(c=dataclasses.replace(cfg, decode_kv_int8=True)),
                lambda: graph(params=p_params.from_jax(jax.tree.map(np.asarray, _setup()[0])))]
    for i, make in enumerate(variants):
        graph()  # `a` the most recently used before each new key
        assert make() is not a and len(stand_in) == 2 + i
        assert len(p_decode._graphs) == min(2 + i, p_decode._GRAPH_ENTRIES)
    assert graph() is a and len(stand_in) == 1 + len(variants)
    with torch.inference_mode():
        assert graph() is not a
    evicted = len(stand_in)
    variants[0]()  # the oldest key: dropped, so captured again
    assert len(stand_in) == evicted + 1
