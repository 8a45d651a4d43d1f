"""Port parity, the training kernels: the plain versions of K6 (flash
backward), K7 (FFN + LN1 backward) and K8 (attention + LN0 backward) against
the JAX kernels they replace, run in Pallas interpret mode as the JAX
package's own tests run them on the CPU, and `T5LayerTrain` against
`jax.grad` of the JAX fused train stack. The CUDA kernels are held to these
plain versions on the card by chip_smoke.py (phase 6).

Tolerances: f32 results within 2e-5 (K6) and 1e-4 (K7, K8, the layer
stack) absolute and relative, the sums running in another order; bf16 within
2e-2 of the largest reference value, one bf16 rounding of a product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.ops import flash_attention as j_fa
from rag_docvqa_tpu.ops import fused_encoder as j_fe
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.ops import flash_attention as p_fa
from rag_docvqa_tpu_torch.ops import fused_encoder as p_fe

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# K6: the flash backward
# --------------------------------------------------------------------------- #
FLASH_CASES = {
    "shared_bias": dict(bias="shared"),
    "per_batch_bias": dict(bias="batched", scale=0.5),
    "no_bias": dict(),
    "causal": dict(causal=True, bias="shared"),
    "gqa_rep2": dict(hkv=2, bias="shared"),
    "fully_masked_row": dict(dead_row=True, bias="shared"),
}


def _flash_inputs(case, B=3, T=32, H=4, dh=8):
    rng = np.random.RandomState(0)
    hkv = case.get("hkv", H)
    q = rng.randn(B, T, H, dh).astype(np.float32)
    k = rng.randn(B, T, hkv, dh).astype(np.float32)
    v = rng.randn(B, T, hkv, dh).astype(np.float32)
    g = rng.randn(B, T, H, dh).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, 21, 9])[:, None]
    if case.get("dead_row"):
        mask[2] = False
    bias = None
    if case.get("bias"):
        bias = rng.randn(B if case["bias"] == "batched" else 1, H, T, T).astype(np.float32)
    return q, k, v, g, mask, bias


def _port_bwd(q, k, v, g, mask, bias, scale, causal, mask_value):
    args = (_t(mask), None if bias is None else _t(bias), scale, causal, mask_value)
    out, lse = p_fa.flash_attention_reference(_t(q), _t(k), _t(v), *args)
    return p_fa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(g), *args)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_jax_vjp(name):
    """mask value -1e30: against jax.vjp of the JAX flash_attention (its
    custom VJP is the TPU backward kernels), two blocks a side (and one, for
    the shared bias: the single-block dK/dV kernel)."""
    case = FLASH_CASES[name]
    q, k, v, g, mask, bias = _flash_inputs(case)
    scale, causal = case.get("scale", 1.0), case.get("causal", False)
    got = _port_bwd(q, k, v, g, mask, bias, scale, causal, p_fa.NEG_INF)
    T = q.shape[1]
    for blk in ((T, T // 2) if name == "shared_bias" else (T // 2,)):
        def f(q_, k_, v_, b_):
            return j_fa.flash_attention(q_, k_, v_, jnp.asarray(mask), b_, scale=scale, causal=causal,
                                        block_q=blk, block_k=blk, interpret=True)

        jb = None if bias is None else jnp.asarray(bias)
        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
        want = vjp(jnp.asarray(g))
        for name_, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5, err_msg=f"{name_} blk {blk}")


@pytest.mark.parametrize("name", ["shared_bias", "per_batch_bias", "gqa_rep2", "fully_masked_row"])
def test_flash_bwd_t5_mask_value_matches_softmax_vjp(name):
    """mask value -1e9 (the T5 layer's): against jax.vjp of a plain softmax
    that masks with -1e9, where a row with no valid key is uniform and its
    cotangent reaches the masked keys' v."""
    case = FLASH_CASES[name]
    q, k, v, g, mask, bias = _flash_inputs(case)
    scale = case.get("scale", 1.0)
    rep = q.shape[2] // k.shape[2]

    def f(q_, k_, v_, b_):
        k_, v_ = jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q_, k_) * scale + b_
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], s, -1e9)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v_)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    got = _port_bwd(q, k, v, g, mask, bias, scale, False, -1e9)
    for name_, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5, err_msg=name_)


def test_flash_autograd_function_runs_k6():
    """FlashAttention (K2 forward, K6 backward) gives the plain backward's
    gradients, the bias gradient cast to the bias dtype."""
    q, k, v, g, mask, bias = _flash_inputs({"bias": "shared", "hkv": 2})
    qs, ks, vs = (_t(a).requires_grad_() for a in (q, k, v))
    b = _t(bias).bfloat16().requires_grad_()
    out = p_fa.flash_attention(qs, ks, vs, _t(mask), b, 0.5, True, -1e9)
    grads = torch.autograd.grad(out, (qs, ks, vs, b), _t(g))
    want = _port_bwd(q, k, v, g, mask, np.asarray(b.detach().float()), 0.5, True, -1e9)
    for a, w in zip(grads[:3], want[:3]):
        assert torch.equal(a, w)
    assert grads[3].dtype == torch.bfloat16 and torch.equal(grads[3], want[3].bfloat16())


# --------------------------------------------------------------------------- #
# K7 and K8
# --------------------------------------------------------------------------- #
def _layer_setup(gated, n_layers=1):
    cfg = j_t5.T5Config(vocab_size=32, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=n_layers,
                        num_decoder_layers=1, dropout_rate=0.0, gated_ffn=gated)
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(2)
    for name in ("ln0", "ln1"):  # non-trivial norm weights
        tree["encoder"][name] = (rng.rand(*tree["encoder"][name].shape) + 0.5).astype(np.float32)
    enc = tree["encoder"]
    stacked = {"ln0": enc["ln0"], "ln1": enc["ln1"], "attn": enc["attn"], "ffn": enc["ffn"]}
    return cfg, tree, stacked


def _inputs(B=3, T=16, d=32, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    g = rng.randn(B, T, d).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([16, 11, 5])[:, None]
    return x, g, mask


def _close(got, want, dtype, err_msg=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=err_msg)
    else:
        assert np.abs(got - want).max() <= 2e-2 * max(np.abs(want).max(), 1.0), err_msg


@pytest.mark.parametrize("gated,dtype", [(False, "f32"), (True, "f32"), (False, "bf16")])
def test_ffn_bwd_plain_matches_jax(gated, dtype):
    cfg, tree, stacked = _layer_setup(gated)
    jl = jax.tree.map(lambda a: jnp.asarray(a)[0], j_fe.fuse_t5_blocks(jax.tree.map(jnp.asarray, stacked), gated))
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x1, g, _ = _inputs()
    names = ("wi_0", "wi_1", "wof") if gated else ("wi", "wof")
    jws = tuple(jl[n].astype(jdt) for n in names)
    want = j_feb.t5_ffn_bwd(jnp.asarray(x1, jdt), jnp.asarray(g, jdt), jl["ln1"].astype(jdt), jws,
                            eps=cfg.layer_norm_eps, gated=gated, interpret=True)
    pws = tuple(_t(np.asarray(w.astype(jnp.float32)).T).to(pdt) for w in jws)
    args = (_t(x1).to(pdt), _t(g).to(pdt), _t(np.asarray(jl["ln1"].astype(jdt).astype(jnp.float32))[0]).to(pdt), pws)
    kw = dict(eps=cfg.layer_norm_eps, gated=gated)
    got = p_fe.t5_ffn_bwd_reference(*args, **kw)
    _close(got[0], want[0], dtype, "dx1")
    _close(got[1], want[1][0], dtype, "dln1")
    for n, a, b in zip(names, got[2], want[2]):
        _close(a.t(), b, dtype, n)
    wrapped = p_fe.t5_ffn_bwd(*args, **kw)  # on the CPU the wrapper is the plain version
    assert torch.equal(wrapped[0], got[0]) and all(torch.equal(a, b) for a, b in zip(wrapped[2], got[2]))


@pytest.mark.parametrize("with_bias,dtype", [(True, "f32"), (False, "f32"), (True, "bf16")])
def test_attn_bwd_plain_matches_jax(with_bias, dtype):
    cfg, tree, stacked = _layer_setup(False)
    jl = jax.tree.map(lambda a: jnp.asarray(a)[0], j_fe.fuse_t5_blocks(jax.tree.map(jnp.asarray, stacked), False))
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x, dy, mask = _inputs()
    T = x.shape[1]
    bias = jnp.asarray(np.random.RandomState(4).randn(cfg.num_heads, T, T), jnp.bfloat16) if with_bias else None
    want = j_feb.t5_attn_bwd(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jnp.asarray(mask), bias,
                             jl["wqkv"].astype(jdt), jl["wo"].astype(jdt), jl["ln0"].astype(jdt),
                             num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, interpret=True)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    pbias = None if bias is None else _t(f32(bias)).bfloat16()
    args = (_t(x).to(pdt), _t(dy).to(pdt), _t(mask), pbias, _t(f32(jl["wqkv"].astype(jdt)).T).to(pdt),
            _t(f32(jl["wo"].astype(jdt)).T).to(pdt), _t(f32(jl["ln0"].astype(jdt))[0]).to(pdt))
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps)
    got = p_fe.t5_attn_bwd_reference(*args, **kw)
    _close(got[0], want[0], dtype, "dx")
    _close(got[1], want[1][0], dtype, "dln0")
    _close(got[2].t(), want[2], dtype, "dwqkv")
    _close(got[3].t(), want[3], dtype, "dwo")
    if with_bias:
        _close(got[4], want[4], dtype, "dbias")
    else:
        assert got[4] is None and want[4] is None
    wrapped = p_fe.t5_attn_bwd(*args, **kw)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("gated", [False, True])
def test_t5_layer_train_grads_match_jax_stack(gated):
    """Two layers through T5LayerTrain against jax.grad of the JAX fused
    train stack (interpret mode): gradients of x, the bias and every weight
    (q, k and v each, through the port's cat of wqkv)."""
    cfg, tree, stacked = _layer_setup(gated, n_layers=2)
    B, T = 4, 16
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, cfg.d_model).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([16, 11, 3, 8])[:, None]
    bias = rng.randn(cfg.num_heads, T, T).astype(np.float32) * 0.3
    jmask = jnp.asarray(mask)

    def loss_j(s, x_, b):
        out = j_t5._fused_t5_stack_train(cfg)(s, x_, jmask, b)
        return jnp.sum(jnp.where(jmask[..., None], out, 0.0) ** 2)

    vj, (gs, gx, gb) = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x), jnp.asarray(bias))

    port = p_params.from_jax(tree)
    layers = list(port.encoder.layers)
    for p in port.encoder.parameters():
        p.requires_grad_(True)
    xs, bs = _t(x).requires_grad_(), _t(bias).requires_grad_()
    out = xs
    for l in p_fe.fuse_t5_blocks(layers, gated):
        out = p_fe.t5_layer_train(out, _t(mask), bs, l, num_heads=cfg.num_heads, eps=cfg.layer_norm_eps,
                                  gated=gated)
    vp = (torch.where(_t(mask)[..., None], out, 0.0) ** 2).sum()
    np.testing.assert_allclose(vp.item(), float(vj), rtol=1e-5)
    ffn_names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
    named = [(("x",), xs, gx), (("bias",), bs, gb)]
    for i, L in enumerate(layers):
        named += [(("ln0", i), L.ln0, gs["ln0"][i]), (("ln1", i), L.ln1, gs["ln1"][i])]
        named += [((n, i), getattr(L.attn, n), gs["attn"][n][i].T) for n in ("q", "k", "v", "o")]
        named += [((n, i), getattr(L.ffn, n), gs["ffn"][n][i].T) for n in ffn_names]
    grads = torch.autograd.grad(vp, [t for _, t, _ in named])
    for (key, _, want), got in zip(named, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=str(key))


# --------------------------------------------------------------------------- #
# the building blocks and the wrappers' device rule
# --------------------------------------------------------------------------- #
def test_gemm_bwd_epilogues_cast_where_the_tpu_kernel_casts():
    rng = np.random.RandomState(6)
    h = _t(rng.randn(5, 16).astype(np.float32)).bfloat16()
    w = _t(rng.randn(7, 16).astype(np.float32)).bfloat16()
    df = _t(rng.randn(5, 7).astype(np.float32)).bfloat16()
    u = _t(rng.randn(5, 7).astype(np.float32)).bfloat16()
    pre = h.float() @ w.float().t()
    dpre, f = p_fe.gemm_bwd(h, w, "nt", "relu_bwd", df)
    assert torch.equal(dpre, torch.where(pre > 0, df, torch.zeros_like(df)))
    assert torch.equal(f, pre.clamp(min=0).bfloat16())
    f2, du, dgl = p_fe.gemm_bwd(h, w, "nt", "gelu_bwd", u, df)
    gl = pre.bfloat16().float().requires_grad_()
    ge = torch.nn.functional.gelu(gl, approximate="tanh")
    (dge,) = torch.autograd.grad(ge.sum(), gl)
    assert torch.equal(f2, (ge.detach().bfloat16().float() * u.float()).bfloat16())
    assert torch.equal(du, (df.float() * ge.detach()).bfloat16())
    np.testing.assert_allclose(dgl.float().numpy(), (df.float() * u.float() * dge).bfloat16().float().numpy(),
                               rtol=1e-2, atol=1e-3)
    a = _t(rng.randn(6, 5).astype(np.float32))
    b = _t(rng.randn(6, 4).astype(np.float32))
    np.testing.assert_allclose(p_fe.gemm_bwd(a, b, "tn", "store_f32").numpy(), (a.t() @ b).numpy(), rtol=1e-6)
    acc = torch.ones(5, 4)
    out = p_fe.gemm_bwd(a[:5, :5].contiguous(), b[:5], "nn", "acc_f32", acc=acc)
    assert out is acc
    np.testing.assert_allclose(out.numpy(), (1.0 + a[:5, :5] @ b[:5]).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        p_fe.gemm_bwd(a, b, "tn", "store")  # no kernel for that pair


def test_rms_norm_bwd_matches_autograd():
    rng = np.random.RandomState(7)
    x = _t(rng.randn(9, 24).astype(np.float32)).requires_grad_()
    w = _t(rng.rand(24).astype(np.float32) + 0.5).requires_grad_()
    dh = _t(rng.randn(9, 24).astype(np.float32))
    resid = _t(rng.randn(9, 24).astype(np.float32))
    from rag_docvqa_tpu_torch.models.layers import rms_norm

    gx, gw = torch.autograd.grad(rms_norm(x, w, 1e-6), (x, w), dh)
    dx, dw = p_fe.rms_norm_bwd(x.detach(), dh, w.detach(), resid, 1e-6)
    np.testing.assert_allclose(dx.numpy(), (resid + gx).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), rtol=1e-5, atol=1e-5)


def test_backward_wrappers_refuse_tensors_off_cpu_and_cuda():
    m = lambda *s: torch.zeros(*s, device="meta")
    with pytest.raises(ValueError):
        p_fe.gemm_bwd(m(4, 8), m(8, 3), "nn", "store")
    with pytest.raises(ValueError):
        p_fe.gemm_bwd(torch.zeros(4, 8), m(8, 3), "nn", "store")
    with pytest.raises(ValueError):
        p_fe.rms_norm_bwd(m(4, 8), m(4, 8), m(8), m(4, 8), 1e-6)
    q = m(1, 4, 2, 8)
    with pytest.raises(ValueError):
        p_fa.flash_attention_bwd(q, q, q, q, m(1, 2, 4), q)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
