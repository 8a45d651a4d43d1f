"""Port parity, MaxSim late interaction (K15) on the CPU: the plain version
`late_interaction` runs on CPU tensors against the JAX package's Pallas
kernel in interpret mode (one query, a patch mask) and against its batched
jnp function with both masks (what the JAX engine calls), and
`sharded_maxsim_topk` against the JAX one on the virtual CPU devices.

Tolerance 1e-5 on scores (sums of at most 128 cosines; the two frameworks
sum in another order); top-k indices exact, the seeded data having no ties
closer than that apart from the duplicated rows, whose order is the tie
rule under test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.ops import late_interaction as j_li
from rag_docvqa_tpu.parallel.index import sharded_maxsim_topk as j_sharded_maxsim_topk
from rag_docvqa_tpu_torch.ops import late_interaction as li
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
