"""Port parity, K2's dh-256 form: the plain version of the flash forward at
head dim 256 (and 200, which the card pads to the 256-wide instantiation),
causal with MQA and GQA heads and right-padded ragged keys, against the JAX
`flash_attention` run in Pallas interpret mode (as
tests/test_flash_attention.py runs it on the CPU) and its log-sum-exp,
within 1e-5 in f32; and the wrapper's head-dim limits: 256 for K2, 128 for
K6, checked before any launch. The CUDA kernel itself is held against this
plain version on the card by chip_smoke.py phase 13a."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.ops import flash_attention as j_fa
from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.ops import flash_attention as p_fa

torch.set_num_threads(2)

# (B, T, H, Hkv, dh): the Gemma reranker's heads (8 on 1) at tile edges of 63-129 keys
CASES = {
    "gemma_mqa_T63": (2, 63, 8, 1, 256),
    "gemma_mqa_T65": (2, 65, 8, 1, 256),
    "gqa2_T129": (2, 129, 4, 2, 256),
    "mqa_dh200_T96": (2, 96, 4, 1, 200),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_plain_dh256_causal_matches_jax_interpret(name):
    B, T, H, Hkv, dh = CASES[name]
    rng = np.random.RandomState(0)
    q = rng.randn(B, T, H, dh).astype(np.float32)
    k = rng.randn(B, T, Hkv, dh).astype(np.float32)
    v = rng.randn(B, T, Hkv, dh).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, T - 29])[:, None]
    scale = dh**-0.5
    out, lse = p_fa.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                              torch.from_numpy(mask), None, scale, True)
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), None, scale=scale,
                                causal=True, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    rep = H // Hkv
    qT = jnp.transpose(jnp.asarray(q), (0, 2, 1, 3)).reshape(B, Hkv, rep, T, dh)
    kT, vT = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)) for x in (k, v))
    pad = (-T) % 32  # the JAX wrapper pads to whole blocks; this calls its kernel with padded keys masked
    qT, kT, vT = (jnp.pad(x, ((0, 0),) * (x.ndim - 2) + ((0, pad), (0, 0))) for x in (qT, kT, vT))
    m = jnp.pad(jnp.asarray(mask), ((0, 0), (0, pad)))
    _, jlse = j_fa._fwd_call_impl(qT, kT, vT, m[:, None, :], None, scale=scale, causal=True, bq=32, bk=32, rep=rep,
                                  interpret=True)
    jlse = np.asarray(jlse).reshape(B, H, T + pad)[:, :, :T]
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    # the wrapper takes it on the CPU, K6's plain version too (the card's K6 stops at 128)
    got = p_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask),
                               scale=scale, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_head_dim_limits_of_the_two_kernels():
    """K2 checks dh <= 256 and K6 dh <= 128, before anything launches."""
    assert (p_fa.MAX_HEAD_DIM, p_fa.MAX_BWD_HEAD_DIM) == (256, 128)
    x = lambda dh: torch.zeros(1, 4, 2, dh)
    p_fa._check_inputs(x(256), x(256), x(256), None, None)
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        p_fa._check_inputs(x(264), x(264), x(264), None, None)
    with pytest.raises(ValueError, match="head dim 256 > 128"):
        p_fa._check_inputs(x(256), x(256), x(256), None, None, p_fa.MAX_BWD_HEAD_DIM)
    text = (kernels.CSRC / "flash_fwd.cu").read_text()
    assert "if (dh <= 256) return launch<float, BT, 256>" in text
    assert "if (dh <= 256) return vec ? launch_wgmma<BT, 256, true>" in text
    assert kernels.FORM_LAUNCHES == {"flash_fwd_dh256": 0, "lm_glu_rows": 0}
