"""The arithmetic of the corpus-index score tiles (csrc/topk_common.cuh), on
the CPU: what the CUDA kernels compute, written out in plain torch, against
exact references, and the launch plan the wrappers hand them.

  * the f32 tile (K4/K5 on an f32 index) splits rows and queries into three
    exact bf16 terms (`split_bf16x3`) and makes the six products x_i q_j with
    i + j <= 2, a 64-deep step at a time, each step in a fresh accumulator
    that the tensor cores add each 16-deep product group into with a
    truncation toward zero at the larger magnitude of the sum before and
    after, and the step's sum added into the score in f32: within 2^-22 of
    sum |x_d q_d| of the float64 product, where one bf16 product is not, nor
    the same six products truncated into one accumulator across all of D;
  * MaxSim (K15) is that arithmetic with the patch rows as x and the query
    tokens as q, then the masked maximum of each token and the weighted sum
    in f32: each token's maximum within 2^-22 of the largest sum |q_d p_d| of
    the f64 one, where one bf16 product is not;
  * K12 unpacks four packed int4 bytes a 32-bit word with byte permutes
    (`prmt` with sign replication) and bit selects: equal to `unpack_int4` of
    both packages for every byte value;
  * `_tile_plan` and the argument lists the wrappers pass match the C entry
    points' signatures (a recording stand-in for the library, so these run
    without a card).
"""

import contextlib

import numpy as np
import pytest
import torch

from rag_docvqa_tpu.ops import quant as j_quant
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops import quant as p_quant
from rag_docvqa_tpu_torch.ops import topk as p_topk

torch.set_num_threads(2)

STEP = 64  # elements of D a stage of the f32 tile holds
GROUP = 16  # elements of D one wgmma product takes
# (i, j) of the products x_i q_j, in the order the f32 tile issues them: the
# five small ones for each 16-deep group of a step, then x0 q0 for each
SIX = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0), (0, 0))
ONE = ((0, 0),)


def _rows_and_queries(d: int, seed: int):
    """Unit rows and queries, f32: Gaussian rows, rows with one dominant
    entry, and rows with components near 1e-30 among normal ones."""
    rng = np.random.RandomState(seed)
    x = rng.randn(48, d).astype(np.float32)
    x[16:24] *= 1e-3
    x[16:24, rng.randint(0, d, 8)] = 1.0  # one dominant entry (some may share a column)
    tiny = rng.rand(48, d) < 0.25
    x[24:40][tiny[24:40]] = (rng.randn(int(tiny[24:40].sum())) * 1e-30).astype(np.float32)
    q = rng.randn(6, d).astype(np.float32)
    x, q = torch.from_numpy(x), torch.from_numpy(q)
    return p_topk.l2_normalize(x), p_topk.l2_normalize(q)


def _truncating_add(acc: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """acc + s as the tensor cores add a product group into an f32
    accumulator: the exact sum cut toward zero to 24 bits at the exponent of
    the larger of |acc| and |acc + s| (float64 holding f32 values)."""
    t = acc + s
    m = torch.maximum(acc.abs(), t.abs())
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m)))) - 23)
    return torch.where(m > 0, torch.trunc(t / quantum) * quantum, t)


def _tile_scores(x: torch.Tensor, q: torch.Tensor, products, fresh: bool = True) -> torch.Tensor:
    """The f32 tile's arithmetic: per 64-deep step, the chosen products of
    the bf16 terms (each exact: a bf16 x bf16 product fits f32), each
    16-deep group's sum added by `_truncating_add` in the tile's order into a
    fresh accumulator, then the step's sum added into the score in f32.
    `fresh=False`: one accumulator across all of D, as the tile had first."""
    xs, qs = p_topk.split_bf16x3(x).double(), p_topk.split_bf16x3(q).double()
    small = [p for p in products if p != (0, 0)]
    score = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    acc = torch.zeros(score.shape, dtype=torch.float64)
    for k0 in range(0, x.shape[1], STEP):
        if fresh:
            acc = torch.zeros_like(acc)
        groups = [slice(k, k + GROUP) for k in range(k0, min(x.shape[1], k0 + STEP), GROUP)]
        for (i, j), g in [(p, g) for g in groups for p in small] + [((0, 0), g) for g in groups if (0, 0) in products]:
            acc = _truncating_add(acc, qs[j, :, g] @ xs[i, :, g].t())
        if fresh:
            score = score + acc.float()
    return score if fresh else acc.float()


@pytest.mark.parametrize("d", [32, 64, 768])
def test_f32_tile_six_products_within_f32_rounding(d):
    x, q = _rows_and_queries(d, 100 + d)
    exact = q.double() @ x.double().t()
    limit = 2.0 ** -22 * (q.double().abs() @ x.double().abs().t())
    err = (_tile_scores(x, q, SIX).double() - exact).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("d", [32, 64, 768])
def test_one_bf16_product_misses_the_limit(d):
    """The same arithmetic with x0 q0 alone (one bf16 product of an f32 row
    and query) is off by ~2^-9 of the score: the test above tells the two
    apart."""
    x, q = _rows_and_queries(d, 100 + d)
    exact = q.double() @ x.double().t()
    limit = 2.0 ** -22 * (q.double().abs() @ x.double().abs().t())
    ratio = (_tile_scores(x, q, ONE).double() - exact).abs() / limit
    assert float(ratio.max()) > 1.0 and float((ratio > 1.0).double().mean()) > 0.5


def test_one_accumulator_across_d_misses_the_limit():
    """The six products truncated into one accumulator over all of D 768
    (no fresh accumulator a step) miss the limit: the truncations pile up at
    the magnitude of the whole score."""
    x, q = _rows_and_queries(768, 868)
    exact = q.double() @ x.double().t()
    limit = 2.0 ** -22 * (q.double().abs() @ x.double().abs().t())
    assert bool(((_tile_scores(x, q, SIX).double() - exact).abs() <= limit).all())
    ratio = (_tile_scores(x, q, SIX, fresh=False).double() - exact).abs() / limit
    assert float(ratio.max()) > 4.0 and float((ratio > 1.0).double().mean()) > 0.25


def _patch_set(tq: int, tp: int, d: int, seed: int):
    """Normalised query tokens (tq, d) and patch rows (tp, d), f32, D
    zero-padded to a multiple of 16 as `maxsim_launch` pads it, a patch mask
    with about a third of the rows masked, and query weights in [0, 1]."""
    rng = np.random.RandomState(seed)
    q, p = rng.randn(tq, d).astype(np.float32), rng.randn(tp, d).astype(np.float32)
    p[: tp // 8] *= 1e-3
    p[: tp // 8, rng.randint(0, d, tp // 8)] = 1.0  # rows with one dominant entry
    pad = -d % 16
    q, p = (torch.nn.functional.pad(p_topk.l2_normalize(torch.from_numpy(x)), (0, pad)) for x in (q, p))
    mask = torch.from_numpy(rng.rand(tp) < 0.7)
    weight = torch.from_numpy(rng.rand(tq).astype(np.float32))
    return q, p, mask, weight


def _maxsim_model(q, p, mask, weight, products):
    """K15's arithmetic for one patch set: the f32 tile's scores of the
    patch rows against the query tokens (`_tile_scores`), masked rows at
    -1e30, each token's maximum, 0 where no row is valid, times its weight,
    summed in f32 in token order. Returns (maxima (tq,), score)."""
    s = torch.where(mask[None, :], _tile_scores(p, q, products), torch.tensor(-1e30))
    m = s.amax(dim=1)
    terms = torch.where(m > -1e29, m * weight, torch.zeros(()))
    total = torch.zeros((), dtype=torch.float32)
    for t in terms:
        total = total + t
    return m, total


def _maxsim_exact(q, p, mask, weight):
    """float64 MaxSim of one set, each token's limit (2^-22 of the largest
    sum |q_d p_d| over the valid rows) and the score's limit (the tokens'
    limits weighted, and the f32 rounding of the weighted sum)."""
    sims = q.double() @ p.double().t()
    bound = 2.0 ** -22 * (q.double().abs() @ p.double().abs().t())
    sims = torch.where(mask[None, :], sims, torch.tensor(float("-inf"), dtype=torch.float64))
    m = sims.amax(dim=1)
    lim = torch.where(mask[None, :], bound, torch.zeros_like(bound)).amax(dim=1)
    live = torch.isfinite(m)
    terms = torch.where(live, m, torch.zeros_like(m)) * weight.double()
    score_lim = float((lim * weight.double()).sum() + (len(terms) + 1) * 2.0 ** -24 * terms.abs().sum())
    return m, lim, terms.sum(), score_lim


@pytest.mark.parametrize("tq,tp,d", [(70, 77, 40), (128, 128, 768), (8, 200, 64)])
def test_maxsim_six_products_within_f32_rounding(tq, tp, d):
    """The MaxSim kernel's arithmetic (csrc/maxsim.cu on `F32Tile`): every
    token's maximum within its limit of the float64 one, the score within
    the weighted limits, and a set with no valid row scoring exactly 0."""
    q, p, mask, weight = _patch_set(tq, tp, d, 7 + tq + d)
    m, score = _maxsim_model(q, p, mask, weight, SIX)
    want_m, lim, want, score_lim = _maxsim_exact(q, p, mask, weight)
    assert bool(((m.double() - want_m).abs() <= lim).all()), float(((m.double() - want_m).abs() / lim).max())
    assert abs(float(score) - float(want)) <= score_lim
    none = torch.zeros(tp, dtype=torch.bool)
    assert float(_maxsim_model(q, p, none, weight, SIX)[1]) == 0.0


def test_maxsim_one_bf16_product_misses_the_limit():
    """One bf16 product of the f32 rows and tokens (x0 q0) misses the limit
    of most tokens by far: the test above tells the two apart."""
    q, p, mask, weight = _patch_set(128, 128, 768, 7 + 128 + 768)
    m, _ = _maxsim_model(q, p, mask, weight, ONE)
    want_m, lim, _, _ = _maxsim_exact(q, p, mask, weight)
    ratio = (m.double() - want_m).abs() / lim
    assert float(ratio.max()) > 16.0 and float((ratio > 1.0).double().mean()) > 0.5


def _prmt_sign(w: torch.Tensor) -> torch.Tensor:
    """`prmt.b32 w, 0, 0xBA98`: each byte replaced by its sign bit spread
    over the byte (int64 holding uint32 words)."""
    out = torch.zeros_like(w)
    for i in range(4):
        out |= ((w >> (8 * i + 7)) & 1) * (0xFF << (8 * i))
    return out


def _unpack_words(w: torch.Tensor):
    """K12's unpack (topk_common.cuh `unpack_lo`, `unpack_hi`) of uint32
    words: the low nibbles shifted to the top of each byte for their sign,
    kept below a bit select; the high nibbles from the word as it is."""
    lo = (w & 0x0F0F0F0F) | (_prmt_sign((w << 4) & 0xFFFFFFFF) & 0xF0F0F0F0)
    hi = ((w >> 4) & 0x0F0F0F0F) | (_prmt_sign(w) & 0xF0F0F0F0)
    return lo, hi


def _word_bytes(w: torch.Tensor) -> torch.Tensor:
    """(n,) uint32 words -> (n, 4) int8, little-endian, as the kernel's bytes."""
    b = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=1)
    return b.to(torch.uint8).view(torch.int8)


def test_int4_word_unpack_equals_unpack_int4():
    """Every byte value in every byte position of a word: word k holds bytes
    k, k+1, k+2, k+3 (mod 256)."""
    k = torch.arange(256, dtype=torch.int64)
    packed = torch.stack([(k + i) % 256 for i in range(4)], dim=1)  # (256, 4) byte values
    words = sum(packed[:, i] << (8 * i) for i in range(4))
    lo, hi = _unpack_words(words)
    packed8 = packed.to(torch.uint8).view(torch.int8)
    want_lo, want_hi = p_quant.unpack_int4(packed8)
    assert torch.equal(_word_bytes(lo), want_lo) and torch.equal(_word_bytes(hi), want_hi)
    jlo, jhi = j_quant.unpack_int4(packed8.numpy())
    assert np.array_equal(np.asarray(jlo), want_lo.numpy()) and np.array_equal(np.asarray(jhi), want_hi.numpy())


# blocks an SM holds of each form of a tile's kernels, as their occupancy
# queries report them on an H100 (0: no form for that query tile)
RESIDENT = {"bf16": {8: 3, 16: 3, 32: 3, 64: 2, 128: 0},
            "f32": {8: 2, 16: 2, 32: 2, 64: 1, 128: 1},
            "int8": {8: 3, 16: 3, 32: 2, 64: 2, 128: 2},
            "int4": {8: 2, 16: 2, 32: 2, 64: 2, 128: 2}}
SMS = 132


@pytest.mark.parametrize("tile", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 8, 9, 16, 20, 64, 65, 130, 256])
def test_tile_plan_is_one_wave(tile, B):
    """The query tile is a form the kernel has, holds B up to its widest
    form, and the row blocks of all query blocks fit the card's resident
    blocks at once."""
    resident = RESIDENT[tile]
    forms = [t for t, n in resident.items() if n > 0]
    tq, n_rb = p_topk._tile_plan(4096, B, resident, SMS)
    assert tq in forms and (tq >= B or tq == max(forms))
    assert tq == min(t for t in forms if t >= min(B, max(forms)))
    assert 1 <= n_rb and n_rb * -(-B // tq) <= SMS * resident[tq]
    assert p_topk._tile_plan(3, B, resident, SMS)[1] <= 3  # never more runs than tiles


def test_tile_plan_skips_forms_that_fit_no_block():
    """A form no block of which fits on an SM (its shared memory at a large
    k, say) is passed over; with none that fits the wrapper raises."""
    assert p_topk._tile_plan(4096, 4, {8: 0, 16: 2, 32: 2, 64: 1, 128: 0}, SMS) == (16, SMS * 2)
    assert p_topk._tile_plan(4096, 256, {8: 2, 16: 2, 32: 2, 64: 1, 128: 0}, SMS) == (64, SMS // 4)
    with pytest.raises(ValueError):
        p_topk._tile_plan(4096, 4, dict.fromkeys(p_topk._QUERY_TILES, 0), SMS)


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success; an occupancy query answers `blocks`."""

    def __init__(self, blocks: int = 0):
        self.calls, self.blocks = [], blocks

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name.endswith("_resident"):
                args[-1]._obj.value = self.blocks
            return 0
        return entry


def _stand_in(monkeypatch, tile: str):
    """The library replaced by a `_Recorder`, and the occupancy queries by
    `RESIDENT[tile]`; returns the recorder and the list of queries asked."""
    rec, asked = _Recorder(), []

    def resident(entry, device, tq, *args):
        asked.append((entry, (tq, *args)))
        return RESIDENT[tile][tq]

    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "resident", resident)
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    return rec, asked


def test_resident_asks_once_per_device_and_arguments(monkeypatch):
    """`kernels.resident` passes the query's arguments and a pointer to the
    answer, as the C signatures say, and asks each question once."""
    rec = _Recorder(blocks=3)
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_resident", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    dev = torch.device("cuda", 0)
    code = kernels.DTYPE_CODES[torch.float32]
    for _ in range(2):
        assert kernels.resident("topk_fused_resident", dev, 128, code, 10) == 3
        assert kernels.resident("topk_segmax_resident", dev, 64, code) == 3
        assert kernels.resident("topk_segmax_int4_resident", dev, 8, 16) == 3
    assert [(n, a[:-1]) for n, a in rec.calls] == [
        ("topk_fused_resident", (128, code, 10)), ("topk_segmax_resident", (64, code)),
        ("topk_segmax_int4_resident", (8, 16))]
    assert all(len(a) == len(kernels._QUERY_SIGNATURES[n]) for n, a in rec.calls)


def test_occupancy_queries_are_entry_points_that_launch_nothing():
    """Each occupancy query is a C entry point of the top-k sources and has
    no launch counter."""
    text = {p.name: p.read_text() for p in kernels._sources()}
    for entry in kernels._QUERY_SIGNATURES:
        assert any(f'extern "C" int {entry}(' in t for t in text.values()), entry
    assert not set(kernels._QUERY_SIGNATURES) & (set(kernels._SIGNATURES) | set(kernels.LAUNCHES))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_launch_arguments(monkeypatch, dtype):
    """K4 and K5 ask their own kernel's occupancy at every query tile and
    pass the three query terms, the tile plan and the dtype code in the
    places of csrc/topk_fused.cu's and topk_segmax.cu's signatures."""
    tile = "bf16" if dtype == torch.bfloat16 else "f32"
    rec, asked = _stand_in(monkeypatch, tile)
    N, D, B = 1024, 64, 130
    index = torch.zeros((N, D), dtype=dtype)
    q = torch.zeros((B, D), dtype=torch.float32)
    p_topk.fused_topk(index, q, N - 5, 10)
    p_topk.segment_max(index, q, N - 5, 8, 16)
    code = kernels.DTYPE_CODES[dtype]
    assert asked == ([("topk_fused_resident", (tq, code, 10)) for tq in p_topk._QUERY_TILES]
                     + [("topk_segmax_resident", (tq, code)) for tq in p_topk._QUERY_TILES])
    assert all(len(a) + 1 == len(kernels._QUERY_SIGNATURES[n]) for n, a in asked)
    tq, n_rb = p_topk._tile_plan(N // 128, B, RESIDENT[tile], SMS)
    (f_name, f_args), (s_name, s_args) = rec.calls
    assert f_name == "topk_fused" and len(f_args) == len(kernels._SIGNATURES[f_name])
    assert f_args[6:14] == (N, D, B, N - 5, 10, n_rb, code, tq)
    assert s_name == "topk_segmax" and len(s_args) == len(kernels._SIGNATURES[s_name])
    assert s_args[4:13] == (N, D, B, N - 5, 8, 16, n_rb, code, tq)
    assert kernels.LAUNCHES["topk_fused"] == 1 and kernels.LAUNCHES["topk_segmax"] == 1


@pytest.mark.parametrize("B", [8, 256])
def test_int4_launch_arguments(monkeypatch, B):
    """K12 asks its occupancy at the group and passes its row blocks and
    query tile after the group."""
    rec, asked = _stand_in(monkeypatch, "int4")
    N, D = 2048, 64
    packed = torch.zeros((N, D // 2), dtype=torch.int8)
    scale = torch.ones((N, 1))
    q8 = torch.zeros((B, D), dtype=torch.int8)
    p_quant.segment_max_int4(packed, scale, q8, N, 32)
    assert asked == [("topk_segmax_int4_resident", (tq, 32)) for tq in p_topk._QUERY_TILES]
    tq, n_rb = p_topk._tile_plan(N // 128, B, RESIDENT["int4"], SMS)
    ((i4, a4),) = rec.calls
    assert i4 == "topk_segmax_int4" and len(a4) == len(kernels._SIGNATURES[i4])
    assert a4[4:11] == (N, D, B, N, 32, n_rb, tq)
    assert kernels.LAUNCHES["topk_segmax_int4"] == 1


@pytest.mark.parametrize("B", [8, 256])
def test_int8_launch_arguments(monkeypatch, B):
    """K11 asks its own kernel's occupancy at the group and passes its row
    blocks and query tile after the group, as K12 does; it takes D % 16 == 0
    (48 here, which K12's D % 32 would refuse) and refuses D 40."""
    rec, asked = _stand_in(monkeypatch, "int8")
    N, D = 2048, 48
    scale = torch.ones((N, 1))
    q8 = torch.zeros((B, D), dtype=torch.int8)
    p_quant.segment_max_int8(torch.zeros((N, D), dtype=torch.int8), scale, q8, N - 7, 16)
    assert asked == [("topk_segmax_int8_resident", (tq, 16)) for tq in p_topk._QUERY_TILES]
    assert all(len(a) + 1 == len(kernels._QUERY_SIGNATURES[n]) for n, a in asked)
    tq, n_rb = p_topk._tile_plan(N // 128, B, RESIDENT["int8"], SMS)
    ((name, args),) = rec.calls
    assert name == "topk_segmax_int8" and len(args) == len(kernels._SIGNATURES[name])
    assert args[4:11] == (N, D, B, N - 7, 16, n_rb, tq)
    assert kernels.LAUNCHES["topk_segmax_int8"] == 1
    with pytest.raises(ValueError):
        p_quant.segment_max_int8(torch.zeros((N, 40), dtype=torch.int8), scale, torch.zeros((B, 40), dtype=torch.int8),
                                 N, 16)
    assert len(rec.calls) == 1
