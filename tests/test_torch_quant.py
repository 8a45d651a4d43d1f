"""Port parity, the corpus-index ops: `ops/topk.py` and `ops/quant.py` of the
port against the JAX package on the same numpy inputs, on the CPU.

The JAX kernels run in interpret mode, as tests/test_topk.py and
tests/test_quant.py run them; the port runs the plain versions that stand
beside its CUDA kernels (K4, K5, K11, K12). Tolerances: float scores 1e-5
(two CPU matmuls in another order), indices equal. On the integer indexes
the kernels' maxima, `quantize_rows` and flat against two-phase are exact;
across the packages a query's values agree to 1e-6 relative, because each
package normalizes the f32 query itself (see the test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rag_docvqa_tpu.ops import quant as j_quant
from rag_docvqa_tpu.ops import topk as j_topk
from rag_docvqa_tpu_torch.ops import quant as p_quant
from rag_docvqa_tpu_torch.ops import topk as p_topk

torch.set_num_threads(2)

FLOAT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _index(n, d, seed, dups=(), n_valid=None):
    """Normalized (n, d) f32 rows; `dups` = (src, dst) row copies that force
    exact ties; rows >= n_valid zeroed like padding."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    for src, dst in dups:
        x[dst] = x[src]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if n_valid is not None:
        x[n_valid:] = 0.0
    q = rng.randn(5, d).astype(np.float32)
    q[0] = x[dups[0][0]] if dups else q[0]
    return x, q


def _same_topk(got, want, tol=FLOAT_TOL, exact=False, rtol=0.0):
    gv, gi, gok = (np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy() for a in got)
    wv, wi, wok = (np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy() for a in want)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi[wok], wi[wok])
    if exact:
        np.testing.assert_array_equal(gv, wv)
    else:
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=tol)


# --------------------------------------------------------------------------- #
# ops/topk.py
# --------------------------------------------------------------------------- #
DUPS = ((3, 7), (3, 130), (3, 1029), (3, 2047))

TOPK_CASES = {
    # name: (n, n_valid, d, k, dups)
    "plain": (2048, 2048, 64, 10, ()),
    "duplicates": (2048, 2048, 64, 10, DUPS),
    "padding": (2048, 1500, 32, 10, DUPS[:2]),
    "k_exceeds_valid": (512, 7, 32, 10, ()),
}


@pytest.mark.parametrize("case", TOPK_CASES)
def test_cosine_topk_flat_matches_xla(case):
    n, n_valid, d, k, dups = TOPK_CASES[case]
    x, q = _index(n, d, 1, dups, n_valid)
    mask = np.arange(n) < n_valid
    want = j_topk.cosine_topk_xla(jnp.asarray(x), jnp.asarray(q), k, index_mask=jnp.asarray(mask))
    got = p_topk.cosine_topk_flat(_t(x), _t(q), k, index_mask=_t(mask))
    _same_topk(got, want)


@pytest.mark.parametrize("case", TOPK_CASES)
def test_cosine_topk_fused_matches_pallas(case):
    n, n_valid, d, k, dups = TOPK_CASES[case]
    x, q = _index(n, d, 2, dups, n_valid)
    want = j_topk.cosine_topk_pallas(jnp.asarray(x), jnp.asarray(q), jnp.int32(n_valid), k, tile_n=512,
                                     interpret=True)
    got = p_topk.cosine_topk_fused(_t(x), _t(q), n_valid, k, tile_n=512)
    _same_topk(got, want)
    # the slots without a valid row hold (NEG_INF, 0) in both
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cosine_topk_fused_bf16_index():
    x, q = _index(1024, 64, 3, DUPS[:2])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = j_topk.cosine_topk_pallas(xb, jnp.asarray(q), jnp.int32(1000), 10, tile_n=512, interpret=True)
    got = p_topk.cosine_topk_fused(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), _t(q), 1000, 10,
                                   tile_n=512)
    _same_topk(got, want)


TWOPHASE_CASES = {
    # name: (n, n_valid, d, k, tile_n, group, sgroups, dups)
    "flat": (2048, 2048, 64, 10, 512, 16, 1, ()),
    "flat_duplicates": (2048, 2048, 64, 10, 512, 16, 16, DUPS),
    "flat_padding": (2048, 1500, 32, 10, 512, 8, 16, DUPS[:2]),
    "hier": (8192, 8192, 64, 10, 2048, 16, 16, ()),
    "hier_ties_padding": (8192, 7000, 64, 10, 2048, 16, 8, DUPS + ((3, 4100), (3, 6999))),
    "k_exceeds_valid": (2048, 7, 32, 10, 512, 8, 16, ()),
    "tiny_index": (128, 100, 32, 10, 64, 16, 16, ()),
}


@pytest.mark.parametrize("case", TWOPHASE_CASES)
def test_cosine_topk_twophase_matches_jax(case):
    n, n_valid, d, k, tile_n, group, sgroups, dups = TWOPHASE_CASES[case]
    x, q = _index(n, d, 4, dups, n_valid)
    want = j_topk.cosine_topk_twophase(jnp.asarray(x), jnp.asarray(q), jnp.int32(n_valid), k, tile_n=tile_n,
                                       group=group, sgroups=sgroups, interpret=True)
    got = p_topk.cosine_topk_twophase(_t(x), _t(q), n_valid, k, tile_n=tile_n, group=group, sgroups=sgroups)
    _same_topk(got, want)
    # and both are the flat function's answer
    flat = p_topk.cosine_topk_flat(_t(x), _t(q), k, index_mask=_t(np.arange(n) < n_valid))
    _same_topk(got, [a.numpy() for a in flat])


def test_cosine_topk_auto_and_pad_index():
    rng = np.random.RandomState(5)
    x = rng.randn(700, 32).astype(np.float32)
    q = rng.randn(3, 32).astype(np.float32)
    jp, jn = j_topk.pad_index(jnp.asarray(x), 512)
    pp, pn = p_topk.pad_index(_t(x), 512)
    assert pn == int(jn) == 700 and pp.shape == (1024, 32)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    want = j_topk.cosine_topk_auto(jp, jnp.asarray(q), jn, 5)  # not on a TPU: the flat XLA version
    got = p_topk.cosine_topk_auto(pp, _t(q), pn, 5)  # CPU tensors: the flat version
    _same_topk(got, want)


def _jax_segmax(kernel, n, b, s_rows, tile_n, ins, in_blocks, n_out=1):
    """Phase 1 of a JAX two-phase function alone: its kernel body through
    `pl.pallas_call` in interpret mode, blocked as the function blocks it.
    Returns the (rows, B) outputs transposed to (B, rows)."""
    from jax.experimental.pallas import tpu as pltpu

    in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM)]
    for shape, tiled in in_blocks:
        in_specs.append(pl.BlockSpec(shape, (lambda t: (t, 0)) if tiled else (lambda t: (0, 0)),
                                     memory_space=pltpu.VMEM))
    out_specs = [pl.BlockSpec((tile_n // r, b), lambda t: (t, 0), memory_space=pltpu.VMEM) for r in s_rows]
    out_shape = [jax.ShapeDtypeStruct((n // r, b), jnp.float32) for r in s_rows]
    outs = pl.pallas_call(kernel, grid=(n // tile_n,), in_specs=in_specs,
                          out_specs=out_specs if n_out > 1 else out_specs[0],
                          out_shape=out_shape if n_out > 1 else out_shape[0], interpret=True)(*ins)
    return [np.asarray(o).T for o in (outs if n_out > 1 else [outs])]


def test_segment_max_reference_matches_k5():
    """The plain version of K5 against the JAX kernel's own segment and
    supergroup maxima (N 4096, tile 2048, group 8, sgroups 16, padding)."""
    n, n_valid, d, b, tile_n, group, sgroups = 4096, 3500, 64, 5, 2048, 8, 16
    x, q = _index(n, d, 6, DUPS, n_valid)
    qn = np.asarray(j_topk.l2_normalize(jnp.asarray(q)))
    kernel = functools.partial(j_topk._segmax_kernel, tile_n=tile_n, group=group, sgroups=sgroups)
    seg, sup = _jax_segmax(kernel, n, b, (group, group * sgroups), tile_n,
                           (jnp.asarray([n_valid], jnp.int32), jnp.asarray(qn), jnp.asarray(x)),
                           [((b, d), False), ((tile_n, d), True)], n_out=2)
    pseg, psup = p_topk.segment_max_reference(_t(x), _t(qn), n_valid, group, sgroups)
    np.testing.assert_allclose(pseg.numpy(), seg, rtol=0, atol=FLOAT_TOL)
    np.testing.assert_allclose(psup.numpy(), sup, rtol=0, atol=FLOAT_TOL)
    assert (pseg.numpy()[:, -(n - n_valid) // group + 1:] == np.float32(-1e30)).all()
    # segment_max on CPU tensors is the plain version
    s2, _ = p_topk.segment_max(_t(x), _t(qn), n_valid, group, 1)
    np.testing.assert_array_equal(s2.numpy(), pseg.numpy())


# --------------------------------------------------------------------------- #
# ops/quant.py
# --------------------------------------------------------------------------- #
def test_quantize_rows_bit_for_bit():
    rng = np.random.RandomState(7)
    x = rng.randn(300, 96).astype(np.float32)
    x[5] = 0.0  # the 1e-12 floor
    x[6, 0] = 0.5 * np.abs(x[6]).max() / 127.0 * 3  # lands near a half
    jq, js = j_quant.quantize_rows(jnp.asarray(x))
    pq, ps = p_quant.quantize_rows(_t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(p_quant.dequantize_rows(pq, ps).numpy(),
                                  np.asarray(j_quant.dequantize_rows(jq, js)))
    # build_int8_index normalizes first: the two frameworks sum the squared
    # norm in another order, so the scales agree to the last bit or two
    # (1e-6 relative) and a value may land on the neighbouring level
    bq, bs = p_quant.build_int8_index(_t(x * 3.0))
    jbq, jbs = j_quant.build_int8_index(jnp.asarray(x * 3.0))
    np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), rtol=1e-6, atol=0)
    off = np.abs(bq.numpy().astype(np.int32) - np.asarray(jbq).astype(np.int32))
    assert off.max() <= 1 and int((off > 0).sum()) <= 4


def test_quantize_rows_int4_and_unpack():
    """`torch.quantile` and `jnp.percentile` agree to the last bits only:
    scales within 1e-6 relative; packed bytes equal except at counted
    positions, each nibble there off by one level."""
    rng = np.random.RandomState(8)
    x = rng.randn(400, 64).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jp, js = j_quant.quantize_rows_int4(jnp.asarray(x))
    pp, ps = p_quant.quantize_rows_int4(_t(x))
    assert pp.dtype == torch.int8 and pp.shape == (400, 32)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    # unpack: exact on the same bytes
    jlo, jhi = j_quant.unpack_int4(jp)
    plo, phi = p_quant.unpack_int4(_t(np.asarray(jp)))
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi))
    # every byte value unpacks by sign-extending shifts
    allb = np.arange(-128, 128, dtype=np.int8)[None, :]
    alo, ahi = p_quant.unpack_int4(_t(allb))
    jalo, jahi = j_quant.unpack_int4(jnp.asarray(allb))
    np.testing.assert_array_equal(alo.numpy(), np.asarray(jalo))
    np.testing.assert_array_equal(ahi.numpy(), np.asarray(jahi))
    # the port's own bytes
    qlo, qhi = p_quant.unpack_int4(pp)
    dlo = np.abs(qlo.numpy().astype(np.int32) - np.asarray(jlo).astype(np.int32))
    dhi = np.abs(qhi.numpy().astype(np.int32) - np.asarray(jhi).astype(np.int32))
    assert dlo.max() <= 1 and dhi.max() <= 1
    n_off = int((dlo > 0).sum() + (dhi > 0).sum())
    assert n_off <= 4, f"{n_off} of {x.size} nibbles round to the neighbouring level"
    bp, bs = p_quant.build_int4_index(_t(x * 2.0))
    np.testing.assert_allclose(bs.numpy(), np.asarray(j_quant.build_int4_index(jnp.asarray(x * 2.0))[1]), rtol=1e-6)


def _jax_int8_index(n, d, seed, dups=()):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32)
    for src, dst in dups:
        emb[dst] = emb[src]
    q = rng.randn(6, d).astype(np.float32)
    if dups:
        q[0] = emb[dups[0][0]]
    return emb, q


QUANT_CASES = {
    # name: (n, n_valid, d, k, tile_n, group, dups)
    "plain": (2048, 2048, 64, 10, 512, 16, ()),
    "duplicates": (2048, 2048, 64, 10, 512, 16, DUPS),
    "padding": (2048, 1500, 32, 10, 512, 16, DUPS[:2]),
    "sentinel_unscaled": (2048, 7, 32, 10, 512, 16, ()),
    "tiny_index": (128, 100, 32, 10, 64, 16, ()),
}


@pytest.mark.parametrize("case", QUANT_CASES)
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantized_queries_exact_on_jax_built_index(bits, case):
    """Flat and two-phase queries of both packages on one JAX-built index.
    Within a package the two functions agree bit for bit (integer dots, one
    order of the scales). Across the packages the indices are equal and the
    values agree to 1e-6 relative: each normalizes the f32 query itself, the
    two sum the squared norm in another order, and the query's scale, a
    factor of every score, moves by a last bit with it. Slots without a valid
    row keep the raw -1e30."""
    n, n_valid, d, k, tile_n, group, dups = QUANT_CASES[case]
    emb, q = _jax_int8_index(n, d, 9, dups)
    build = j_quant.build_int8_index if bits == "int8" else j_quant.build_int4_index
    jflat = j_quant.cosine_topk_int8 if bits == "int8" else j_quant.cosine_topk_int4
    jtwo = j_quant.cosine_topk_int8_twophase if bits == "int8" else j_quant.cosine_topk_int4_twophase
    pflat = p_quant.cosine_topk_int8 if bits == "int8" else p_quant.cosine_topk_int4
    ptwo = p_quant.cosine_topk_int8_twophase if bits == "int8" else p_quant.cosine_topk_int4_twophase
    pauto = p_quant.cosine_topk_int8_auto if bits == "int8" else p_quant.cosine_topk_int4_auto
    jq, js = build(jnp.asarray(emb))
    pq, ps = _t(np.asarray(jq)), _t(np.asarray(js))
    want_flat = jflat(jq, js, jnp.asarray(q), jnp.int32(n_valid), k)
    want_two = jtwo(jq, js, jnp.asarray(q), jnp.int32(n_valid), k, tile_n=tile_n, group=group, interpret=True)
    got_flat = pflat(pq, ps, _t(q), n_valid, k)
    got_two = ptwo(pq, ps, _t(q), n_valid, k, tile_n=tile_n, group=group)
    _same_topk(got_two, got_flat, exact=True)
    _same_topk(want_two, want_flat, exact=True)
    _same_topk(pauto(pq, ps, _t(q), n_valid, k), got_flat, exact=True)  # CPU tensors: flat
    _same_topk(got_flat, want_flat, tol=0.0, rtol=1e-6)
    _same_topk(got_two, want_two, tol=0.0, rtol=1e-6)
    if n_valid < k:
        assert (got_two[0].numpy()[:, n_valid:] == np.float32(-1e30)).all()
        assert (np.asarray(want_two[0])[:, n_valid:] == np.float32(-1e30)).all()


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_segment_max_quant_reference_matches_k11_k12(bits):
    """The plain versions of K11 and K12 against the JAX kernels' own
    maxima: exact."""
    n, n_valid, d, b, tile_n, group = 4096, 3500, 64, 6, 2048, 16
    emb, q = _jax_int8_index(n, d, 10, DUPS)
    q8, _ = j_quant.quantize_rows(j_topk.l2_normalize(jnp.asarray(q)))
    nv = jnp.asarray([n_valid], jnp.int32)
    if bits == "int8":
        jq, js = j_quant.build_int8_index(jnp.asarray(emb))
        kernel = functools.partial(j_quant._segmax_int8_kernel, tile_n=tile_n, group=group)
        (want,) = _jax_segmax(kernel, n, b, (group,), tile_n, (nv, q8, js, jq),
                              [((b, d), False), ((tile_n, 1), True), ((tile_n, d), True)])
        got = p_quant.segment_max_int8(_t(np.asarray(jq)), _t(np.asarray(js)), _t(np.asarray(q8)), n_valid, group)
    else:
        jq, js = j_quant.build_int4_index(jnp.asarray(emb))
        kernel = functools.partial(j_quant._segmax_int4_kernel, tile_n=tile_n, group=group)
        (want,) = _jax_segmax(kernel, n, b, (group,), tile_n, (nv, q8[:, : d // 2], q8[:, d // 2:], js, jq),
                              [((b, d // 2), False), ((b, d // 2), False), ((tile_n, 1), True),
                               ((tile_n, d // 2), True)])
        got = p_quant.segment_max_int4(_t(np.asarray(jq)), _t(np.asarray(js)), _t(np.asarray(q8)), n_valid, group)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_refined_and_pipelined_match_jax():
    """`cosine_topk_int4_refined` and `refined_query_batches` on a JAX-built
    int4 index: the JAX functions' indices exactly, values to 1e-6 (one
    numpy rescore in both), pipelined equal to serial."""
    rng = np.random.RandomState(11)
    n, d, k, kprime = 4096, 64, 10, 32
    emb = rng.randn(n, d).astype(np.float32)
    jp, js = j_quant.build_int4_index(jnp.asarray(emb))
    pp, ps = _t(np.asarray(jp)), _t(np.asarray(js))
    batches = [rng.randn(8, d).astype(np.float32) for _ in range(3)]
    rows = p_quant.normalize_host_rows(emb)
    np.testing.assert_array_equal(rows, j_quant.normalize_host_rows(emb))
    jpiped = list(j_quant.refined_query_batches(jp, js, batches, jnp.int32(n - 100), k, host_rows=emb, kprime=kprime))
    piped = list(p_quant.refined_query_batches(pp, ps, batches, n - 100, k, host_rows=emb, kprime=kprime))
    pairs = list(p_quant.refined_query_batches(pp, ps, [(_t(b), b) for b in batches], n - 100, k, host_rows=rows,
                                               kprime=kprime, rows_normalized=True))
    assert len(piped) == len(pairs) == 3
    for qb, got, got_pair, want in zip(batches, piped, pairs, jpiped):
        serial = p_quant.cosine_topk_int4_refined(pp, ps, qb, n - 100, k, host_rows=emb, kprime=kprime)
        jserial = j_quant.cosine_topk_int4_refined(jp, js, jnp.asarray(qb), jnp.int32(n - 100), k, host_rows=emb,
                                                   kprime=kprime)
        for a in (got, serial):
            np.testing.assert_array_equal(a[1], want[1])
            np.testing.assert_array_equal(a[1], jserial[1])
            np.testing.assert_allclose(a[0], want[0], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a[2], want[2])
        np.testing.assert_array_equal(got_pair[1], want[1])
        assert (got[1][got[2]] < n - 100).all()


def test_kernel_wrappers_refuse_mixed_devices_and_bad_bounds():
    """No fallback: a wrapper takes CPU tensors to its plain version and
    raises on what neither it nor its kernel takes."""
    x, q = _index(256, 32, 12)
    with pytest.raises(ValueError):
        p_topk.cosine_topk_fused(_t(x)[:200], _t(q), 200, 5, tile_n=128)  # unpadded
    with pytest.raises(ValueError):
        p_quant.cosine_topk_int8(_t(np.zeros((4, 2048), np.int8)), _t(np.ones((4, 1), np.float32)),
                                 _t(np.ones((1, 2048), np.float32)), 4, 2)  # f32 stand-in no longer exact
    with pytest.raises(ValueError):
        p_quant._twophase_tile(700, 2048)
    assert p_quant._twophase_tile(4096, 2048) == 2048 and p_quant._twophase_tile(1536, 2048) == 512
