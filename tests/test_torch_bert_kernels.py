"""Port parity, the BERT layer kernels (K9, K10) on the CPU: the plain
versions the wrappers run on CPU tensors against the JAX package's Pallas
kernels in interpret mode, on the same numpy-seeded inputs.

Tolerances: K9 2e-5 in f32 (the JAX tests' own bound for the kernel against
its XLA blocks); K10 3e-4 of the largest value of each gradient (the JAX
tests' own bound for its backward kernels; weight gradients sum B*T rows in
another order); `_erf32` 1e-6 against `jax.lax.erf`; bf16 0.07 absolute on
values of magnitude up to ~5 (a few bf16 ulps: the port rounds the
probabilities before normalising, the TPU kernel after)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models.layers import layer_norm as j_layer_norm
from rag_docvqa_tpu.ops import fused_encoder as j_fe
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops import fused_encoder as fe

torch.set_num_threads(2)

EPS = 1e-12
D, H, DFF = 64, 4, 128


def _jax_layer(seed, d=D, dff=DFF):
    """One layer in the JAX kernels' form: (in, out) kernels, (1, n) biases,
    (2, d) LayerNorm pairs; weights of unit-variance outputs."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    ln = lambda: np.stack([rng.rand(d).astype(np.float32) + 0.5, f(d) * 0.1])
    return {"wqkv": f(d, 3 * d) * d**-0.5, "bqkv": f(1, 3 * d) * 0.1, "wo": f(d, d) * d**-0.5, "bo": f(1, d) * 0.1,
            "ln1": ln(), "w1": f(d, dff) * d**-0.5, "b1": f(1, dff) * 0.1, "w2": f(dff, d) * dff**-0.5,
            "b2": f(1, d) * 0.1, "ln2": ln()}


def _port_layer(jl, dtype=torch.float32):
    """The same layer in the port's form: (out, in) weights, (n,) biases."""
    out = {}
    for k, v in jl.items():
        t = torch.from_numpy(np.array(v))
        out[k] = (t.t().contiguous() if k.startswith("w") else t[0] if k.startswith("b") else t).to(dtype)
    return out


def _grads_to_jax_form(grads):
    """Port gradients by name -> the JAX layout."""
    return {k: (v.t() if k.startswith("w") else v[None] if k.startswith("b") else v).numpy()
            for k, v in grads.items()}


def _inputs(seed, B, T, lens, d=D):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    return x, mask, rng.randn(B, T, d).astype(np.float32)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all(), name
    assert float(np.abs(got - want).max()) <= tol * scale, (name, float(np.abs(got - want).max()), scale)


RAGGED = [(4, 16, [16, 9, 3, 1]), (6, 24, [24, 17, 9, 3, 1, 24]), (2, 8, [8, 8])]


@pytest.mark.parametrize("lo,hi", [(-6.0, 6.0), (-1.0, 1.0), (-1e-3, 1e-3), (3.5, 4.5)])
def test_erf32_matches_jax_lax_erf(lo, hi):
    x = np.linspace(lo, hi, 20001).astype(np.float32)
    got = fe._erf32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.lax.erf(jnp.asarray(x))), atol=1e-6, rtol=0)
    # and the JAX package's own spelling of the polynomial, to rounding
    np.testing.assert_allclose(got, np.asarray(j_fe._erf32(jnp.asarray(x))), atol=2e-7, rtol=0)


@pytest.mark.parametrize("B,T,lens", RAGGED)
@pytest.mark.parametrize("save_x1", [False, True])
def test_bert_layer_matches_jax_kernel(B, T, lens, save_x1):
    jl = _jax_layer(B + T)
    x, mask, _ = _inputs(1, B, T, lens)
    want = j_fe.fused_bert_layer_parts(jnp.asarray(x), jnp.asarray(mask), jax.tree.map(jnp.asarray, jl),
                                       num_heads=H, eps=EPS, interpret=True, save_x1=save_x1)
    before = dict(kernels.LAUNCHES)
    got = fe.fused_bert_layer_parts(torch.from_numpy(x), torch.from_numpy(mask), _port_layer(jl), num_heads=H,
                                    eps=EPS, save_x1=save_x1)
    assert kernels.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    if save_x1:
        assert isinstance(got, tuple) and len(got) == 2
        for g, w, name in zip(got, want, ("out", "x1")):
            _close(g, w, 2e-5, name)
    else:
        _close(got, want, 2e-5)
    ref = fe.bert_layer_reference(torch.from_numpy(x), torch.from_numpy(mask), _port_layer(jl), num_heads=H, eps=EPS,
                                  save_x1=save_x1)
    for g, r in zip(got if save_x1 else (got,), ref if save_x1 else (ref,)):
        assert torch.equal(g, r)  # on the CPU the wrappers are their plain versions


def test_bert_layer_bf16_close_to_jax_kernel():
    jl = _jax_layer(3)
    x, mask, _ = _inputs(2, 4, 16, [16, 9, 3, 1])
    to_bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = j_fe.fused_bert_layer_parts(to_bf(x), jnp.asarray(mask), jax.tree.map(to_bf, jl), num_heads=H, eps=EPS,
                                       interpret=True)
    got = fe.fused_bert_layer_parts(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask),
                                    _port_layer(jl, torch.bfloat16), num_heads=H, eps=EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=0.07, rtol=0)


def test_sequence_without_valid_key_is_finite_and_leaves_the_others_alone():
    """A padded chunk slot (all-False mask): the TPU kernel gives it a uniform
    softmax, the port a zero attention output; both finite, and every
    sequence with a valid key equals JAX."""
    jl = _jax_layer(5)
    x, mask, cot = _inputs(3, 4, 16, [16, 0, 5, 0])
    want = j_fe.fused_bert_layer_parts(jnp.asarray(x), jnp.asarray(mask), jax.tree.map(jnp.asarray, jl), num_heads=H,
                                       eps=EPS, interpret=True)
    xt = torch.from_numpy(x).requires_grad_()
    pl = {k: v.requires_grad_() for k, v in _port_layer(jl).items()}
    got = fe.bert_layer_train(xt, torch.from_numpy(mask), pl, num_heads=H, eps=EPS)
    assert torch.isfinite(got).all()
    _close(got.detach()[[0, 2]], np.asarray(want)[[0, 2]], 2e-5)
    grads = torch.autograd.grad(got, [xt, *pl.values()], torch.from_numpy(cot))
    assert all(torch.isfinite(g).all() for g in grads)
    # and the hand-written backward equals autograd through the plain layer there too
    only_valid = torch.autograd.grad(
        fe.bert_layer_reference(xt, torch.from_numpy(mask), pl, num_heads=H, eps=EPS), [xt], torch.from_numpy(cot))[0]
    _close(grads[0], only_valid, 3e-4)


@pytest.mark.parametrize("epilogue", ["bias", "bias_gelu", "bias_residual_f32"])
def test_gemm_bias_epilogues(epilogue):
    rng = np.random.RandomState(0)
    a, w, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((7, 12), (10, 12), (10,)))
    aux = torch.from_numpy(rng.randn(7, 10).astype(np.float32)) if epilogue == "bias_residual_f32" else None
    got = fe.gemm(a, w, epilogue, aux, b)
    lin = a @ w.t() + b
    want = {"bias": lin, "bias_gelu": torch.nn.functional.gelu(lin), "bias_residual_f32": lin if aux is None else aux + lin}
    np.testing.assert_allclose(got.numpy(), want[epilogue].numpy(), atol=2e-6, rtol=0)
    got16 = fe.gemm(a.bfloat16(), w.bfloat16(), epilogue, None if aux is None else aux.bfloat16(), b.bfloat16())
    assert got16.dtype == (torch.float32 if epilogue == "bias_residual_f32" else torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):
        fe.gemm(a, w, epilogue, aux)
    with pytest.raises(ValueError, match="bias"):
        fe.gemm(a, w, "none", None, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_rows_matches_jax_layer_norm(dtype):
    rng = np.random.RandomState(1)
    y = (rng.randn(9, 48) * 3 + 1).astype(np.float32)
    y[4] = 2.5  # a constant row: variance 0, eps 1e-12 alone under the root
    ln = np.stack([rng.rand(48) + 0.5, rng.randn(48)]).astype(np.float32)
    want = np.asarray(j_layer_norm(jnp.asarray(y), jnp.asarray(ln[0]), jnp.asarray(ln[1]), EPS))
    got = fe.layer_norm_rows(torch.from_numpy(y), torch.from_numpy(ln).to(dtype), EPS, dtype)
    assert got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
        np.testing.assert_allclose(got[4].numpy(), ln[1], atol=1e-6, rtol=0)  # n = 0: the bias alone
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0)


@pytest.mark.parametrize("B,T,lens", RAGGED[:2])
def test_bert_ffn_bwd_matches_jax_kernel(B, T, lens):
    jl = _jax_layer(7)
    x1, _, g = _inputs(4, B, T, lens)
    want = j_feb.bert_ffn_bwd(jnp.asarray(x1), jnp.asarray(g), *(jnp.asarray(jl[k]) for k in ("ln2", "w1", "b1", "w2", "b2")),
                              eps=EPS, interpret=True)
    pl = _port_layer(jl)
    got = fe.bert_ffn_bwd(torch.from_numpy(x1), torch.from_numpy(g), pl["ln2"], pl["w1"], pl["b1"], pl["w2"], pl["b2"],
                          eps=EPS)
    dx1, dln2, dw1, db1, dw2, db2 = got
    assert all(t.dtype == torch.float32 for t in got)
    for name, a, b in zip(("dx1", "dln2", "dw1", "db1", "dw2", "db2"), (dx1, dln2, dw1.t(), db1[None], dw2.t(), db2[None]),
                          want):
        _close(a, b, 3e-4, name)


@pytest.mark.parametrize("B,T,lens", RAGGED[:2])
def test_bert_attn_bwd_matches_jax_kernel(B, T, lens):
    jl = _jax_layer(8)
    x, mask, dy = _inputs(5, B, T, lens)
    want = j_feb.bert_attn_bwd(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(mask),
                               *(jnp.asarray(jl[k]) for k in ("wqkv", "bqkv", "wo", "bo", "ln1")), num_heads=H, eps=EPS,
                               interpret=True)
    pl = _port_layer(jl)
    dx, dln1, dwqkv, dbqkv, dwo, dbo = fe.bert_attn_bwd(torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(mask),
                                                         pl["wqkv"], pl["bqkv"], pl["wo"], pl["bo"], pl["ln1"],
                                                         num_heads=H, eps=EPS)
    for name, a, b in zip(("dx", "dln1", "dwqkv", "dbqkv", "dwo", "dbo"),
                          (dx, dln1, dwqkv.t(), dbqkv[None], dwo.t(), dbo[None]), want):
        _close(a, b, 3e-4, name)


@pytest.mark.parametrize("B,T,lens", RAGGED[:2])
def test_bert_layer_train_matches_jax_grad(B, T, lens):
    """`BertLayerTrain` against `jax.grad` through the JAX layer-level custom
    VJP (its forward and backward kernels in interpret mode) and against
    autograd through the port's plain layer."""
    jl = _jax_layer(9)
    x, mask, cot = _inputs(6, B, T, lens)
    layer = j_feb.make_fused_bert_layer_train(H, EPS, True)
    loss = lambda xx, l: jnp.sum(layer(xx, jnp.asarray(mask), l) * jnp.asarray(cot))
    want_x, want_l = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, jl))

    xt = torch.from_numpy(x).requires_grad_()
    pl = {k: v.requires_grad_() for k, v in _port_layer(jl).items()}
    ins = [xt] + [pl[k] for k in fe.BERT_KEYS]
    got = torch.autograd.grad(fe.bert_layer_train(xt, torch.from_numpy(mask), pl, num_heads=H, eps=EPS), ins,
                              torch.from_numpy(cot))
    _close(got[0], want_x, 3e-4, "dx")
    for k, v in _grads_to_jax_form(dict(zip(fe.BERT_KEYS, got[1:]))).items():
        _close(v, want_l[k], 3e-4, k)
    plain = torch.autograd.grad(fe.bert_layer_reference(xt, torch.from_numpy(mask), pl, num_heads=H, eps=EPS), ins,
                                torch.from_numpy(cot))
    for name, a, b in zip(["x", *fe.BERT_KEYS], got, plain):
        _close(a, b, 3e-4, name)


def test_bert_layer_train_keeps_weight_dtypes_under_bf16_compute():
    """f32 masters, bf16 activations: each gradient comes back in its
    weight's dtype, and only x and x1 are saved beside the weights."""
    jl = _jax_layer(10)
    x, mask, cot = _inputs(7, 2, 8, [8, 5])
    pl = {k: v.requires_grad_() for k, v in _port_layer(jl).items()}
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = fe.bert_layer_train(xt, torch.from_numpy(mask), pl, num_heads=H, eps=EPS)
    assert out.dtype == torch.bfloat16
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 + len(fe.BERT_KEYS)  # x, x1, key_mask and the ten weights
    grads = torch.autograd.grad(out, [xt] + [pl[k] for k in fe.BERT_KEYS], torch.from_numpy(cot).bfloat16())
    assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[1:])
    assert all(torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.parametrize("pair", sorted(fe.BWD_PAIRS))
def test_gemm_bwd_pairs_and_operand_checks(pair):
    """Every (layout, epilogue) pair runs on the CPU with the operands its
    spec names and refuses any other count of them."""
    layout, epi = pair
    outs, auxs = fe.BWD_PAIRS[pair]
    rng = np.random.RandomState(0)
    M, N, K = 6, 8, 5
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    a = f(K, M) if layout == "tn" else f(M, K)
    b = f(N, K) if layout == "nt" else f(K, N)
    aux = [f(N) if kind == "b" else f(M, N) for kind in auxs]
    acc = f(M, N) if epi == "acc_f32" else None
    got = fe.gemm_bwd(a, b, layout, epi, *aux, acc=acc)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(outs) and all(t.shape == (M, N) and torch.isfinite(t).all() for t in got)
    wrong = aux[:-1] if len(aux) == 2 else aux + [f(M, N)]  # one operand too few or too many
    with pytest.raises(ValueError, match="wrong aux/acc"):
        fe.gemm_bwd(a, b, layout, epi, *wrong, acc=acc)
    with pytest.raises(ValueError, match="no kernel"):
        fe.gemm_bwd(a, b, "tn", "relu_bwd", f(M, N))


def test_layer_norm_bwd_and_col_sum_against_autograd():
    rng = np.random.RandomState(2)
    y = torch.from_numpy((rng.randn(11, 40) * 2 + 0.3).astype(np.float32)).requires_grad_()
    ln = torch.from_numpy(np.stack([rng.rand(40) + 0.5, rng.randn(40)]).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(11, 40).astype(np.float32))
    out = torch.nn.functional.layer_norm(y, (40,), ln[0], ln[1], EPS)
    want_dy, want_dln = torch.autograd.grad(out, [y, ln], g)
    dy, dyc, dln, dsum = fe.layer_norm_bwd(y.detach(), g, ln.detach(), EPS)
    np.testing.assert_allclose(dy.numpy(), want_dy.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dln.numpy(), want_dln.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dsum.numpy(), want_dy.sum(0).numpy(), atol=1e-5, rtol=0)
    assert torch.equal(dyc, dy)
    x = torch.from_numpy(rng.randn(130, 7).astype(np.float32))
    np.testing.assert_allclose(fe.col_sum(x).numpy(), x.sum(0).numpy(), atol=1e-5, rtol=0)
    assert fe.col_sum(x.bfloat16()).dtype == torch.float32
