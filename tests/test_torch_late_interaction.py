"""Port parity, MaxSim late interaction (K15) on the CPU: the plain version
`late_interaction` runs on CPU tensors against the JAX package's Pallas
kernel in interpret mode (one query, a patch mask) and against its batched
jnp function with both masks (what the JAX engine calls), and
`sharded_maxsim_topk` against the JAX one on the virtual CPU devices. The
kernel wrapper `maxsim` against a stand-in for the kernel library: what it
hands csrc/maxsim.cu (the query tokens' three bf16 terms, D zero-padded to
a multiple of 16, the masks, the query tile) and that CPU tensors never
reach it.

Tolerance 1e-5 on scores (sums of at most 128 cosines; the two frameworks
sum in another order); top-k indices exact, the seeded data having no ties
closer than that apart from the duplicated rows, whose order is the tie
rule under test."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rag_docvqa_tpu.ops import late_interaction as j_li
from rag_docvqa_tpu.parallel.index import sharded_maxsim_topk as j_sharded_maxsim_topk
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops import late_interaction as li
from rag_docvqa_tpu_torch.ops.topk import split_bf16x3
from rag_docvqa_tpu_torch.parallel import sharded_maxsim_topk

torch.set_num_threads(2)

T = torch.from_numpy


@pytest.mark.parametrize("Tq,N,Tp,D", [(8, 5, 16, 128), (7, 3, 5, 24), (128, 4, 128, 96)])
def test_late_interaction_matches_jax_kernel(Tq, N, Tp, D):
    rng = np.random.RandomState(Tq + N)
    q, p = rng.randn(Tq, D).astype(np.float32), rng.randn(N, Tp, D).astype(np.float32)
    pm = rng.rand(N, Tp) < 0.7
    pm[-1] = False  # a patch set with no valid token scores 0
    want = j_li.late_interaction_pallas(jnp.asarray(q), jnp.asarray(p), jnp.asarray(pm), interpret=True)
    got = li.late_interaction(T(q), T(p), patch_mask=T(pm))
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert got[-1].item() == 0.0
    # no mask at all
    want = j_li.late_interaction_pallas(jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_allclose(li.late_interaction(T(q), T(p)).numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask_dtype", [np.bool_, np.float32])
def test_batched_late_interaction_matches_jax(mask_dtype):
    """The engine's form: (B, Tq, D) x (B, mc, Tp, D) with a query mask and a
    patch-token mask, both as the engine passes them (f32 0/1) and as bool."""
    rng = np.random.RandomState(3)
    B, Tq, mc, Tp, D = 3, 6, 4, 9, 16
    q, p = rng.randn(B, Tq, D).astype(np.float32), rng.randn(B, mc, Tp, D).astype(np.float32)
    qm = (np.arange(Tq)[None, :] < np.asarray([6, 4, 1])[:, None]).astype(mask_dtype)
    pm = (rng.rand(B, mc, Tp) < 0.6).astype(mask_dtype)
    pm[1, 2] = 0
    want = j_li.late_interaction(jnp.asarray(q), jnp.asarray(p), query_mask=jnp.asarray(qm),
                                 patch_mask=jnp.asarray(pm).astype(bool))
    got = li.late_interaction(T(q), T(p), query_mask=T(qm), patch_mask=T(pm))
    assert got.shape == (B, mc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert got[1, 2].item() == 0.0
    assert torch.equal(got, li.late_interaction_reference(T(q), T(p), T(qm), T(pm)))


def test_late_interaction_reference_math():
    q = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    p = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[-1.0, 0.0], [0.0, -1.0]]])
    np.testing.assert_allclose(li.late_interaction(q, p).numpy(), [2.0, 0.0], atol=1e-6)
    # bf16 inputs are scored in f32
    assert li.late_interaction(q.bfloat16(), p.bfloat16()).dtype == torch.float32
    # the normalisation is x / (|x| + 1e-12), which keeps a zero row at zero
    z = li.late_interaction(torch.zeros(2, 2), p)
    assert torch.equal(z, torch.zeros(2))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_maxsim_matches_jax(n_shards):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    rng = np.random.RandomState(3)
    N, Tp, D, k, n_valid = 64, 5, 32, 6, 58
    patches, pmask = rng.randn(N, Tp, D).astype(np.float32), rng.rand(N, Tp) < 0.75
    q = rng.randn(4, D).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("data",))
    p_sh = jax.device_put(jnp.asarray(patches), NamedSharding(mesh, PS("data")))
    pm_sh = jax.device_put(jnp.asarray(pmask), NamedSharding(mesh, PS("data")))
    wv, wi, wok = j_sharded_maxsim_topk(p_sh, pm_sh, jnp.asarray(q), mesh=mesh, n_valid=n_valid, k=k)
    gv, gi, gok = sharded_maxsim_topk(T(patches), T(pmask), T(q), n_shards=n_shards, n_valid=n_valid, k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    assert (gi < n_valid).all()


def test_sharded_maxsim_tie_order_and_validity_tail():
    rng = np.random.RandomState(4)
    N, Tp, D = 32, 3, 16
    base = rng.randn(N, Tp, D).astype(np.float32)
    base[17] = base[2]  # a duplicate in another shard: the lower global row wins
    q = rng.randn(2, D).astype(np.float32)
    _, idx, _ = sharded_maxsim_topk(T(base), torch.ones(N, Tp, dtype=torch.bool), T(q), n_shards=8, n_valid=N, k=N)
    got = idx.tolist()
    assert got.index(2) < got.index(17) and sorted(got) == list(range(N))
    # fewer valid rows than k: the tail is invalid
    vals, idx, ok = sharded_maxsim_topk(T(base), torch.ones(N, Tp, dtype=torch.bool), T(q), n_shards=4, n_valid=3, k=5)
    assert ok.tolist() == [True, True, True, False, False] and set(idx[:3].tolist()) == {0, 1, 2}
    with pytest.raises(ValueError):
        sharded_maxsim_topk(T(base), torch.ones(N, Tp, dtype=torch.bool), T(q), n_shards=5, n_valid=N, k=2)


class _Capture:
    """Stands in for the kernel library: copies what `maxsim` is handed, the
    buffers read while the call lasts, and reports success."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _read(ptr, n, dtype):
        if ptr is None:
            return None
        return np.frombuffer(ctypes.string_at(ptr, n * np.dtype(dtype).itemsize), dtype=dtype).copy()

    def maxsim(self, qt, p, qw, pm, out, part, B, N, Tq, Tp, D, query_tile, stream):
        self.calls.append({"qt": self._read(qt, 3 * B * Tq * D, np.uint16), "p": self._read(p, B * N * Tp * D, np.float32),
                           "qw": self._read(qw, B * Tq, np.float32), "pm": self._read(pm, B * N * Tp, np.uint8),
                           "part": part, "dims": (B, N, Tq, Tp, D, query_tile)})
        return 0


def _library_stand_in(monkeypatch, on_card: bool) -> _Capture:
    cap = _Capture()
    monkeypatch.setattr(kernels, "library", lambda: cap)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    if on_card:
        monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
        monkeypatch.setattr(kernels, "stream_ptr", lambda t: 0)
    return cap


@pytest.mark.parametrize("B,Tq,Tp,D,tile", [(2, 70, 77, 40, 128), (3, 6, 9, 16, 8), (2, 130, 5, 24, 128), (1, 128, 128, 768, 128)])
def test_maxsim_launch_arguments(monkeypatch, B, Tq, Tp, D, tile):
    """`late_interaction` on the card normalises, then hands the kernel the
    query tokens as their three exact bf16 terms (3, B * Tq, D), the patch
    rows, both zero-padded to D % 16 == 0, the query weights in f32, the
    patch mask as bytes and the narrowest query tile that holds Tq (the
    widest, 128, with a scratch of strips above it); one launch counted."""
    cap = _library_stand_in(monkeypatch, on_card=True)
    rng, N = np.random.RandomState(B + Tq + D), 3
    q, p = rng.randn(B, Tq, D).astype(np.float32), rng.randn(B, N, Tp, D).astype(np.float32)
    qm = (rng.rand(B, Tq) < 0.8).astype(np.float32)
    pm = rng.rand(B, N, Tp) < 0.6
    li.late_interaction(T(q), T(p), T(qm), T(pm))
    (call,) = cap.calls
    dp = D + (-D % 16)
    assert call["dims"] == (B, N, Tq, Tp, dp, tile) and (call["part"] is None) == (Tq <= tile)
    qn = F.pad(li._normalize(T(q)), (0, dp - D))
    terms = split_bf16x3(qn.reshape(B * Tq, dp))
    assert np.array_equal(call["qt"], terms.view(torch.int16).numpy().view(np.uint16).ravel())
    assert float((terms.float().sum(0) - qn.reshape(B * Tq, dp)).abs().max()) == 0.0  # the terms are exact
    assert np.array_equal(call["p"], F.pad(li._normalize(T(p)), (0, dp - D)).numpy().ravel())
    assert np.array_equal(call["qw"], qm.ravel()) and np.array_equal(call["pm"], pm.astype(np.uint8).ravel())
    assert kernels.LAUNCHES["maxsim"] == 1
    with pytest.raises(ValueError):  # rows not f32, or shapes that do not fit, are refused before any launch
        li.maxsim(T(q).double(), T(p).double())
    with pytest.raises(ValueError):
        li.maxsim(T(q), T(p)[:, :, :, :-1])
    if D % 16 == 0:  # a contiguous view whose rows start 4 bytes into the storage
        flat = torch.zeros(B * N * Tp * D + 1)
        with pytest.raises(ValueError):
            li.maxsim(T(q), flat[1:].view(B, N, Tp, D))
    assert len(cap.calls) == 1


def test_maxsim_on_cpu_tensors_never_reaches_the_kernel(monkeypatch):
    """On CPU tensors both forms run the plain version: nothing is handed to
    the library and nothing is counted."""
    cap = _library_stand_in(monkeypatch, on_card=False)
    rng = np.random.RandomState(5)
    q, p = rng.randn(2, 7, 24).astype(np.float32), rng.randn(2, 4, 9, 24).astype(np.float32)
    qm, pm = (rng.rand(2, 7) < 0.8).astype(np.float32), rng.rand(2, 4, 9) < 0.6
    got = li.late_interaction(T(q), T(p), T(qm), T(pm))
    assert torch.equal(got, li.late_interaction_reference(T(q), T(p), T(qm), T(pm)))
    qn, pn = li._normalize(T(q)), li._normalize(T(p))
    assert torch.equal(li.maxsim(qn, pn, T(qm), T(pm)), li.maxsim_reference(qn, pn, T(qm), T(pm)))
    assert torch.equal(li.late_interaction(T(q[0]), T(p[0])), li.late_interaction_reference(T(q[0]), T(p[0])))
    assert cap.calls == [] and kernels.LAUNCHES["maxsim"] == 0
