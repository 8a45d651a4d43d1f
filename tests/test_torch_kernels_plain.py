"""Port parity, the plain versions of the Hopper kernels against the JAX
kernels they replace (run in Pallas interpret mode, as the JAX package's own
tests run them on the CPU), plus the wrappers' device rule and the build's
source hash. The CUDA kernels themselves are checked against these plain
versions on the card by chip_smoke.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.ops import decode_attention as j_dec
from rag_docvqa_tpu.ops import flash_attention as j_fa
from rag_docvqa_tpu.ops import fused_encoder as j_fe
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.ops import decode_attention as p_dec
from rag_docvqa_tpu_torch.ops import flash_attention as p_fa
from rag_docvqa_tpu_torch.ops import fused_encoder as p_fe

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# K2: flash attention forward
# --------------------------------------------------------------------------- #
FLASH_CASES = {
    "pad_shared_bias": dict(bias="shared"),
    "per_batch_bias_bf16": dict(bias="batched", bias_bf16=True, scale=0.5),
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
    mask = np.arange(T)[None, :] < np.array([T, 21, 9])[:, None]
    if case.get("dead_row"):
        mask[2] = False
    bias = None
    if case.get("bias"):
        bias = rng.randn(B if case["bias"] == "batched" else 1, H, T, T).astype(np.float32)
        if case.get("bias_bf16"):
            bias = np.asarray(jnp.asarray(bias, jnp.bfloat16).astype(jnp.float32))
    return q, k, v, mask, bias


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(name):
    case = FLASH_CASES[name]
    q, k, v, mask, bias = _flash_inputs(case)
    scale, causal = case.get("scale", 1.0), case.get("causal", False)
    B, T, H, dh = q.shape
    jb = None if bias is None else (jnp.asarray(bias, jnp.bfloat16) if case.get("bias_bf16") else jnp.asarray(bias))
    pb = None if bias is None else (_t(bias).bfloat16() if case.get("bias_bf16") else _t(bias))
    out, lse = p_fa.flash_attention_reference(_t(q), _t(k), _t(v), _t(mask), pb, scale, causal)
    want_ref = j_fa.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jb,
                                        scale, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_fa.attention_reference(_t(q), _t(k), _t(v), _t(mask), pb, scale, causal).numpy(),
                               np.asarray(want_ref), rtol=1e-5, atol=1e-5)
    # the Pallas kernel in interpret mode: one key block and two key blocks
    hkv = k.shape[2]
    rep = H // hkv
    qT = jnp.transpose(jnp.asarray(q), (0, 2, 1, 3)).reshape(B, hkv, rep, T, dh)
    kT = jnp.transpose(jnp.asarray(k), (0, 2, 1, 3))
    vT = jnp.transpose(jnp.asarray(v), (0, 2, 1, 3))
    b5 = None if jb is None else jb.reshape(jb.shape[0], hkv, rep, T, T)
    alive = mask.any(axis=1)
    for blk in (T, T // 2):
        jout = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jb,
                                    scale=scale, causal=causal, block_q=blk, block_k=blk, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        _, jlse = j_fa._fwd_call_impl(qT, kT, vT, jnp.asarray(mask)[:, None, :], b5, scale=scale, causal=causal,
                                      bq=blk, bk=blk, rep=rep, interpret=True)
        jlse = np.asarray(jlse).reshape(B, H, T)
        np.testing.assert_allclose(lse.numpy()[alive], jlse[alive], rtol=1e-5, atol=1e-5)
        # a row with no valid key: zeros, and an lse below NEG_INF/2 in both
        assert (out.numpy()[~alive] == 0).all()
        assert (lse.numpy()[~alive] < p_fa.NEG_INF / 2).all() and (jlse[~alive] <= p_fa.NEG_INF / 2).all()


def test_flash_t5_mask_value_gives_uniform_rows():
    """mask_value -1e9 (K1's and _attend's) gives a uniform softmax on a row
    with no valid key, where the flash default gives zeros."""
    q, k, v, mask, bias = _flash_inputs({"dead_row": True, "bias": "shared"})
    out, _ = p_fa.flash_attention_reference(_t(q), _t(k), _t(v), _t(mask), _t(bias), mask_value=-1e9)
    np.testing.assert_allclose(out.numpy()[2], np.broadcast_to(v[2].mean(axis=0), out.shape[1:]),
                               rtol=1e-5, atol=1e-5)


# The shapes where a kernel tiled 64 x 64 breaks (one short of a tile, a full
# tile, one over, two tiles and one), at head dims that fill a 64-wide
# instantiation and that do not: on the card the plain version is the
# tensor-core kernel's yardstick there, so it is held to the JAX kernel here.
EDGE_CASES = {f"T{T}_dh{dh}": dict(Tq=T, Tk=T, dh=dh) for T in (63, 64, 65, 129) for dh in (40, 64)}
EDGE_CASES.update({
    "causal_gqa_T129": dict(Tq=129, Tk=129, dh=64, hkv=2, causal=True),
    "Tq65_Tk129": dict(Tq=65, Tk=129, dh=40),
    "Tq129_Tk65": dict(Tq=129, Tk=65, dh=64),
    "t5_mask_value_T65": dict(Tq=65, Tk=65, dh=64, mask_value=-1e9),
    "t5_mask_value_T129_dh40": dict(Tq=129, Tk=129, dh=40, mask_value=-1e9),
})


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_flash_plain_matches_jax_at_tile_edges(name):
    """out within 1e-5 of the JAX flash forward (interpret mode, 64-wide
    blocks, so the edge falls inside its padding too) and of its
    `attention_reference`; lse within 1e-5 of the JAX kernel's; one batch row
    has no valid key. With mask_value -1e9 (K1's) that row is a uniform
    average in the plain version and in the JAX arithmetic it stands for."""
    case = EDGE_CASES[name]
    Tq, Tk, dh, H = case["Tq"], case["Tk"], case["dh"], 4
    hkv, causal, mask_value = case.get("hkv", H), case.get("causal", False), case.get("mask_value", p_fa.NEG_INF)
    rng = np.random.RandomState(Tq + Tk + dh)
    B = 3
    q = rng.randn(B, Tq, H, dh).astype(np.float32)
    k = rng.randn(B, Tk, hkv, dh).astype(np.float32)
    v = rng.randn(B, Tk, hkv, dh).astype(np.float32)
    mask = np.arange(Tk)[None, :] < np.array([Tk, Tk // 2 + 1, 0])[:, None]
    bias = rng.randn(1, H, Tq, Tk).astype(np.float32)
    scale = dh ** -0.5
    out, lse = p_fa.flash_attention_reference(_t(q), _t(k), _t(v), _t(mask), _t(bias), scale, causal, mask_value)
    assert out.shape == (B, Tq, H, dh) and lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    jq, jk, jv, jm, jb = (jnp.asarray(a) for a in (q, k, v, mask, bias))
    alive = mask.any(axis=1)
    if mask_value == p_fa.NEG_INF:
        want = j_fa.flash_attention(jq, jk, jv, jm, jb, scale=scale, causal=causal, block_q=64, block_k=64,
                                    interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        ref = j_fa.attention_reference(jq, jk, jv, jm, jb, scale, causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert (out.numpy()[~alive] == 0).all() and (lse.numpy()[~alive] < p_fa.NEG_INF / 2).all()
        if Tq == Tk:  # the JAX kernel's own lse, one block over the whole length
            rep = H // hkv
            qT = jnp.transpose(jq, (0, 2, 1, 3)).reshape(B, hkv, rep, Tq, dh)
            kT, vT = jnp.transpose(jk, (0, 2, 1, 3)), jnp.transpose(jv, (0, 2, 1, 3))
            _, jlse = j_fa._fwd_call_impl(qT, kT, vT, jm[:, None, :], jb.reshape(1, hkv, rep, Tq, Tk), scale=scale,
                                          causal=causal, bq=Tq, bk=Tk, rep=rep, interpret=True)
            np.testing.assert_allclose(lse.numpy()[alive], np.asarray(jlse).reshape(B, H, Tq)[alive], rtol=1e-5, atol=1e-5)
    else:
        # K1's arithmetic (`_t5_layer_kernel`, `_attend`): masked scores at -1e9, a plain softmax
        kk, vv = (jnp.repeat(a, H // hkv, axis=2) for a in (jk, jv))
        sc = jnp.einsum("bqhd,bkhd->bhqk", jq, kk) * scale + jb
        sc = jnp.where(jm[:, None, None, :], sc, mask_value)
        want = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(sc, axis=-1), vv)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(sc, axis=-1)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy()[~alive], np.broadcast_to(v[~alive].mean(axis=1, keepdims=True),
                                                                        out.numpy()[~alive].shape), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# K1: the T5 encoder layer
# --------------------------------------------------------------------------- #
def _layer_setup(gated):
    cfg = j_t5.T5Config(vocab_size=32, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=1,
                        num_decoder_layers=1, dropout_rate=0.0, gated_ffn=gated)
    tree = jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(2)
    for name in ("ln0", "ln1"):  # non-trivial norm weights
        tree["encoder"][name] = (rng.rand(*tree["encoder"][name].shape) + 0.5).astype(np.float32)
    enc = tree["encoder"]
    stacked = {"ln0": enc["ln0"], "ln1": enc["ln1"], "attn": enc["attn"], "ffn": enc["ffn"]}
    jl = jax.tree.map(lambda a: jnp.asarray(a)[0], j_fe.fuse_t5_blocks(jax.tree.map(jnp.asarray, stacked), gated))
    port = p_params.from_jax(tree)
    pl = p_fe.fuse_t5_blocks(port.encoder.layers, gated)[0]
    return cfg, jl, pl, port


@pytest.mark.parametrize("gated,with_bias,dead_row", [
    (False, True, False), (True, True, False), (False, False, False), (False, True, True)])
def test_t5_layer_plain_matches_jax(gated, with_bias, dead_row):
    cfg, jl, pl, port = _layer_setup(gated)
    rng = np.random.RandomState(3)
    B, T = 3, 16
    x = rng.randn(B, T, cfg.d_model).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([16, 11, 5])[:, None]
    if dead_row:
        mask[1] = False
    bias = jnp.asarray(rng.randn(cfg.num_heads, T, T), jnp.bfloat16) if with_bias else None
    want = j_fe.fused_t5_layer_parts(jnp.asarray(x), jnp.asarray(mask), bias, jl, num_heads=cfg.num_heads,
                                     eps=cfg.layer_norm_eps, gated=gated, interpret=True)
    pbias = None if bias is None else _t(np.asarray(bias.astype(jnp.float32))).bfloat16()
    got = p_fe.fused_t5_layer_parts(_t(x), _t(mask), pbias, pl, num_heads=cfg.num_heads,
                                    eps=cfg.layer_norm_eps, gated=gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    ref = p_fe.t5_layer_reference(_t(x), _t(mask), pbias, pl, num_heads=cfg.num_heads,
                                  eps=cfg.layer_norm_eps, gated=gated)
    assert torch.equal(got, ref)  # on the CPU the wrappers run exactly the plain versions
    one = p_fe.fused_t5_layer(_t(x), _t(mask), pbias, port.encoder.layers[0], num_heads=cfg.num_heads,
                              eps=cfg.layer_norm_eps, gated=gated)
    assert torch.equal(one, got)


def test_gemm_epilogues_cast_before_residual():
    rng = np.random.RandomState(4)
    a = _t(rng.randn(5, 16).astype(np.float32)).bfloat16()
    w = _t(rng.randn(7, 16).astype(np.float32)).bfloat16()
    aux = _t(rng.randn(5, 7).astype(np.float32)).bfloat16()
    acc = a.float() @ w.float().t()
    assert torch.equal(p_fe.gemm(a, w), acc.bfloat16())
    assert torch.equal(p_fe.gemm(a, w, "relu"), acc.clamp(min=0).bfloat16())
    assert torch.equal(p_fe.gemm(a, w, "residual", aux), acc.bfloat16() + aux)
    g = acc.bfloat16()
    assert torch.equal(p_fe.gemm(a, w, "gelu_mul", aux),
                       torch.nn.functional.gelu(g.float(), approximate="tanh").bfloat16() * aux)
    with pytest.raises(ValueError):
        p_fe.gemm(a, w, "residual")


def _jax_epilogue(epi, acc, aux, bias, scale, cdt):
    """The JAX layer kernels' own arithmetic after a product `acc` (f32):
    `_t5_layer_kernel` (none, relu, residual, gelu_mul), `_layer_kernel`
    (bias, bias_gelu, bias_residual_f32) and `_vit_layer_kernel`
    (bias_scale_residual), each with its casts to the compute dtype."""
    f32 = jnp.float32
    if epi == "none":
        return acc.astype(cdt)
    if epi == "relu":
        return jnp.maximum(acc, 0.0).astype(cdt)
    if epi == "residual":
        return aux + acc.astype(cdt)
    if epi == "gelu_mul":
        return jax.nn.gelu(acc.astype(cdt).astype(f32), approximate=True).astype(cdt) * aux
    h = acc + bias.astype(f32)
    if epi == "bias":
        return h.astype(cdt)
    if epi == "bias_gelu":
        return (0.5 * h * (1.0 + j_fe._erf32(h * (2.0 ** -0.5)))).astype(cdt)
    if epi == "bias_residual_f32":
        return aux.astype(f32) + h
    y = h.astype(cdt)
    if scale is not None:
        y = y * scale
    return y + aux


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("epi", sorted(p_fe.EPILOGUES))
def test_gemm_plain_epilogues_at_tile_tails(epi, dtype):
    """Every epilogue of `gemm_reference` at (M, N, K) = (129, 136, 72), past a
    128-wide tile in M and N and past a 64-deep step in K, against the JAX
    layer kernels' arithmetic on the same product. f32: 1e-5. bf16: the two
    frameworks sum the f32 product in another order, so a value on a rounding
    boundary may land one bf16 step apart: 2^-7 of its size."""
    M, N, K = 129, 136, 72
    rng = np.random.RandomState(len(epi))
    a, w = rng.randn(M, K).astype(np.float32), (rng.randn(N, K) * K ** -0.5).astype(np.float32)
    aux = rng.randn(M, N).astype(np.float32) if epi in p_fe._AUX_EPILOGUES else None
    bias = rng.randn(N).astype(np.float32) if epi.startswith("bias") else None
    scale = rng.randn(N).astype(np.float32) if epi == "bias_scale_residual" else None
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    pt = lambda x: None if x is None else _t(x).to(tdt)
    jx = lambda x: None if x is None else jnp.asarray(x).astype(jdt)
    got = p_fe.gemm_reference(pt(a), pt(w), epi, pt(aux), pt(bias), pt(scale))
    acc = jnp.dot(jx(a), jx(w).T, preferred_element_type=jnp.float32)
    want = _jax_epilogue(epi, acc, jx(aux), jx(bias), jx(scale), jdt)
    assert got.shape == (M, N)
    assert got.dtype == (torch.float32 if epi == "bias_residual_f32" else tdt)
    tol = 1e-5 if dtype == "f32" or epi == "bias_residual_f32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)
    # the wrappers run exactly this on CPU tensors
    run = p_fe.vit_gemm if epi == "bias_scale_residual" else p_fe.gemm
    args = (pt(a), pt(w), epi, pt(aux), pt(bias)) + ((pt(scale),) if epi == "bias_scale_residual" else ())
    assert torch.equal(run(*args), got)


# --------------------------------------------------------------------------- #
# K3: decode cross-attention
# --------------------------------------------------------------------------- #
def _decode_seed_case():
    """f32 query, f32 and int8 caches, f32 output: the first case this test had."""
    rng = np.random.RandomState(0)
    B, H, Te, dk = 3, 4, 24, 8
    q = rng.randn(B, H, dk).astype(np.float32)
    k = rng.randn(B, H, Te, dk).astype(np.float32)
    v = rng.randn(B, H, Te, dk).astype(np.float32)
    mask = np.arange(Te)[None, :] < np.array([24, 11, 5])[:, None]
    k2j, v2j = j_dec.pack_decode_kv(jnp.asarray(k), jnp.asarray(v))
    k2p, v2p = p_dec.pack_decode_kv(_t(k), _t(v))
    np.testing.assert_array_equal(k2p.numpy(), np.asarray(k2j))
    np.testing.assert_array_equal(v2p.numpy(), np.asarray(v2j))
    got = p_dec.fused_cross_attention(_t(q), k2p, v2p, _t(mask))
    want = j_dec.fused_cross_attention(jnp.asarray(q), k2j, v2j, jnp.asarray(mask), interpret=True, exact=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    want_b = j_dec.fused_cross_attention(jnp.asarray(q), k2j, v2j, jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_b), rtol=2e-2, atol=2e-2)

    ks = rng.rand(B, H, dk).astype(np.float32) + 0.5
    vs = rng.rand(B, H, dk).astype(np.float32) + 0.5
    ki = np.clip(np.round(k / ks[:, :, None, :]), -127, 127).astype(np.int8)
    vi = np.clip(np.round(v / vs[:, :, None, :]), -127, 127).astype(np.int8)
    ki2j, vi2j = j_dec.pack_decode_kv(jnp.asarray(ki), jnp.asarray(vi))
    ki2p, vi2p = p_dec.pack_decode_kv(_t(ki), _t(vi))
    got8 = p_dec.fused_cross_attention(_t(q), ki2p, vi2p, _t(mask), k_scale=_t(ks), v_scale=_t(vs))
    want8 = j_dec.fused_cross_attention(jnp.asarray(q), ki2j, vi2j, jnp.asarray(mask), k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs), interpret=True, exact=True)
    np.testing.assert_allclose(got8.numpy(), np.asarray(want8), rtol=2e-4, atol=2e-4)


# query dtype, cache dtype, output dtype, shape and masks: the kernel's edges
# (one key, dk 40 and 128, a row with no valid key) with the scales and the
# cast folded in
DECODE_CASES = {
    "te1": dict(Te=1, lens=[1, 1, 1]),
    "dk40_int8_bf16_query_bf16_out": dict(dk=40, cache="int8", q="bf16", out="bf16"),
    "dk128_bf16_cache_bf16_query": dict(H=2, dk=128, cache="bf16", q="bf16"),
    "no_valid_key_int8": dict(cache="int8", lens=[24, 0, 5]),
    "no_valid_key_bf16_cache_bf16_out": dict(cache="bf16", out="bf16", lens=[0, 11, 1]),
    "one_valid_key_f32": dict(lens=[1, 24, 2]),
}


def _decode_case(case):
    rng = np.random.RandomState(1)
    B, H, dk, Te = 3, case.get("H", 4), case.get("dk", 8), case.get("Te", 24)
    q = rng.randn(B, H, dk).astype(np.float32)
    k = rng.randn(B, H, Te, dk).astype(np.float32)
    v = rng.randn(B, H, Te, dk).astype(np.float32)
    mask = np.arange(Te)[None, :] < np.array(case.get("lens", [Te, 11, 5]))[:, None]
    jbf = jnp.bfloat16
    jq, pq = jnp.asarray(q), _t(q)
    if case.get("q") == "bf16":
        jq, pq = jq.astype(jbf), pq.bfloat16()
    ks = vs = None
    cache = case.get("cache", "f32")
    if cache == "int8":
        ks = (rng.rand(B, H, dk) * 0.03 + 0.01).astype(np.float32)
        vs = (rng.rand(B, H, dk) * 0.03 + 0.01).astype(np.float32)
        k = np.clip(np.round(k / ks[:, :, None, :]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[:, :, None, :]), -127, 127).astype(np.int8)
    jk, jv, pk, pv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    if cache == "bf16":
        jk, jv, pk, pv = jk.astype(jbf), jv.astype(jbf), pk.bfloat16(), pv.bfloat16()
    out = {"f32": (jnp.float32, torch.float32), "bf16": (jbf, torch.bfloat16)}[case.get("out", "f32")]
    k2j, v2j = j_dec.pack_decode_kv(jk, jv)
    k2p, v2p = p_dec.pack_decode_kv(pk, pv)
    want = j_dec.fused_cross_attention(jq, k2j, v2j, jnp.asarray(mask),
                                       k_scale=None if ks is None else jnp.asarray(ks),
                                       v_scale=None if vs is None else jnp.asarray(vs),
                                       interpret=True, exact=True).astype(out[0])
    got = p_dec.fused_cross_attention(pq, k2p, v2p, _t(mask), None if ks is None else _t(ks),
                                      None if vs is None else _t(vs), out_dtype=out[1])
    return got, np.asarray(want.astype(jnp.float32)), out[1], mask


@pytest.mark.parametrize("name", ["seed"] + sorted(DECODE_CASES))
def test_decode_attention_plain_matches_jax(name):
    """The plain K3 (the CPU path of `fused_cross_attention`) against the JAX
    kernel in interpret mode, exact=True, cast to the output dtype. f32 output
    within 2e-5; bf16 output within one bf16 step (2**-7 relative): both sides
    round their f32 results, which differ in the last f32 bits."""
    if name == "seed":
        _decode_seed_case()
        return
    got, want, out_dtype, mask = _decode_case(DECODE_CASES[name])
    assert got.dtype == out_dtype and got.shape == want.shape
    rtol = 2e-5 if out_dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=2e-5)
    dead = ~mask.any(axis=1)
    assert np.isfinite(got.float().numpy()).all()
    if dead.any():  # a row with no valid key averages all Te keys, as softmax under -1e9 does
        assert np.abs(want[dead]).max() > 0.0


def test_decode_split_len_fills_the_card():
    """K3 takes 512 bytes of every K2 row a block where that gives one to
    three blocks an SM (the B 32 Te 512 int8 cache and the B 8 Pix2Struct
    caches: one wave, and at Te 512 no merge kernel), else 256 bytes, and 128
    where the card would hold fewer than two blocks an SM."""
    assert p_dec.split_len(32, 12, 512, 1) == 512
    assert p_dec.split_len(8, 12, 1024, 1) == p_dec.split_len(8, 12, 2048, 1) == 512
    assert p_dec.split_len(32, 12, 512, 2) == 128  # bf16: 256 bytes, 1,536 blocks
    assert p_dec.split_len(32, 12, 709, 1) == 256
    assert p_dec.split_len(1, 12, 1, 4) == 32
    for B, Te, itemsize in itertools.product((1, 8, 32), (1, 77, 512, 709, 2048), (1, 2, 4)):
        assert p_dec.split_len(B, 12, Te, itemsize) * itemsize in (128, 256, 512)


# --------------------------------------------------------------------------- #
# K1's row RMSNorm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [40, 100, 768])
@pytest.mark.parametrize("x_dtype,w_dtype", [("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16")])
def test_rms_norm_rows_plain_matches_jax(d, x_dtype, w_dtype):
    """`rms_norm_rows` on CPU tensors (its plain version) against JAX
    `rms_norm` for every (x, weight) dtype pair the kernel takes, at widths
    that are and are not a multiple of its 16-byte vector. f32 within 1e-5;
    bf16 output within one bf16 step (2**-7 relative)."""
    from rag_docvqa_tpu.models.layers import rms_norm as j_rms_norm

    rng = np.random.RandomState(d)
    x = (rng.randn(77, d) * 3.0).astype(np.float32)
    w = (rng.rand(d) + 0.5).astype(np.float32)
    dt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    jx, jw = jnp.asarray(x).astype(dt[x_dtype][0]), jnp.asarray(w).astype(dt[w_dtype][0])
    px, pw = _t(x).to(dt[x_dtype][1]), _t(w).to(dt[w_dtype][1])
    want = j_rms_norm(jx, jw, 1e-6)
    got = p_fe.rms_norm_rows(px, pw, 1e-6)
    assert got.dtype == px.dtype and want.dtype == jx.dtype
    rtol = 1e-5 if x_dtype == "f32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=1e-6)


# --------------------------------------------------------------------------- #
# the wrappers' device rule and the build
# --------------------------------------------------------------------------- #
def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """CPU tensors run the plain version; a tensor on neither the CPU nor a
    CUDA device, or a mix of devices, raises -- nothing falls back."""
    a = torch.zeros(4, 8, device="meta")
    w = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError):
        p_fe.gemm(a, w)
    with pytest.raises(ValueError):
        p_fe.gemm(torch.zeros(4, 8), w)
    with pytest.raises(ValueError):
        p_fe.rms_norm_rows(a, torch.zeros(8, device="meta"), 1e-6)
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        p_fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        p_dec.fused_cross_attention(torch.zeros(1, 2, 8, device="meta"), torch.zeros(1, 16, 4, device="meta"),
                                    torch.zeros(1, 4, 16, device="meta"), torch.ones(1, 4, dtype=torch.bool))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_build_hash_follows_sources(tmp_path, monkeypatch):
    for p in kernels.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    h0 = kernels._source_hash()
    assert {p.name for p in kernels._sources()} >= {"flash_fwd.cu", "t5_layer.cu", "decode_attention.cu"}
    (tmp_path / "t5_layer.cu").write_text((tmp_path / "t5_layer.cu").read_text() + "\n// edit\n")
    assert kernels._source_hash() != h0
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._nvcc()


NEW_WRAPPERS = {
    "vit_layer_norm_rows": lambda m: p_fe.vit_layer_norm_rows(m(4, 8), m(2, 8), 1e-12),
    "vit_gemm": lambda m: p_fe.vit_gemm(m(4, 8), m(3, 8), "bias", bias=m(3)),
    "vit_attention": lambda m: p_fe.vit_attention(m(1, 4, 3, 2, 8), m(1, 4).bool(), None, 1.0),
    "fused_vit_layer_parts": lambda m: p_fe.fused_vit_layer_parts(
        m(1, 4, 8), m(1, 4).bool(), {k: m(1) for k in p_fe.VIT_KEYS}, num_heads=2, eps=1e-12),
    "fused_t5_layer_qtiled": lambda m: p_fe.fused_t5_layer_qtiled(
        m(1, 4, 8), torch.ones(1, 4, dtype=torch.bool), {}, num_heads=2, eps=1e-6, gated=True),
    "late_interaction": lambda m: __import__("rag_docvqa_tpu_torch.ops.late_interaction", fromlist=["x"])
    .late_interaction(m(4, 8), m(2, 3, 8)),
}


@pytest.mark.parametrize("name", sorted(NEW_WRAPPERS))
def test_visual_wrappers_refuse_tensors_off_cpu_and_cuda(name):
    """The wrappers of K13, K14 and K15 keep the device rule: a tensor that is
    on neither the CPU nor a CUDA device raises, nothing falls back, and no
    launch is counted off the card."""
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        NEW_WRAPPERS[name](lambda *s: torch.zeros(*s, device="meta"))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_kernel_table_covers_every_source():
    """Every C entry point has a launch counter and a signature, no counter
    stands for anything but a C entry point, and the sources of the visual
    paths are in the build. The bias-free attention kernel of K13 is gone:
    its rows take K2."""
    assert set(kernels._SIGNATURES) == set(kernels.LAUNCHES)
    assert {"vit_layer_norm", "vit_gemm", "vit_attention", "maxsim"} <= set(kernels._SIGNATURES)
    assert "t5_qtiled_attention" not in kernels._SIGNATURES
    assert {"vit_layer.cu", "maxsim.cu"} <= {p.name for p in kernels._sources()}
    assert "t5_layer_qtiled.cu" not in {p.name for p in kernels._sources()}
    text = {p.name: p.read_text() for p in kernels._sources()}
    for entry in kernels._SIGNATURES:
        assert any(f'extern "C" int {entry}(' in t for t in text.values()), entry
