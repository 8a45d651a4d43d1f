"""The Qwen2.5-VL tower's feed-forward on its padded intermediate, on the
card, at the published widths: one tower layer (D 1280, I 3420, 16 heads of
80, a windowed layer) and the merger over 8 crops of 448 px, bf16. The
padded path (`qwen25_vision._ffn_weights`: I held at 3424 with zeros) gives
the plain path's merged tokens within bf16 rounding, and a `torch.profiler`
trace of it names no CUTLASS `align2` GEMM kernel, which the plain path's
trace does name (the control: the trace sees the kernels). Every test skips
without a CUDA device. On the card: `python3 -m pytest --noconftest
tests/test_torch_qwen25_vision_card.py` (the tests' conftest.py imports JAX,
which a CUDA host running only the port need not have)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.models import qwen25_vision as Q

pytestmark = pytest.mark.card

CROPS, SIZE = 8, 448


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GEMM kernels cuBLAS picks exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tower(dev):
    """One layer of the published tower in bf16, norms and biases moved off
    their init values, and 8 crops of pixels."""
    cfg = Q.Qwen25VisionConfig(depth=1, image_size=SIZE, out_hidden_size=3584)
    g = torch.Generator(device=dev).manual_seed(0)
    params = Q.init_qwen25_vision_params(g, cfg)
    with torch.no_grad():
        for t in params.parameters():
            if t.dim() == 1:
                t.add_(0.1 * torch.randn(t.shape, generator=g, device=dev))
    params.to(torch.bfloat16)
    pix = torch.randn(CROPS, SIZE, SIZE, 3, generator=g, device=dev)
    return cfg, params, pix


def plain(params, cfg, pix):
    """The tower on the layer's own (I 3420) tensors: a gradient asked of
    the feed-forward weights sends `_ffn_weights` down the plain path."""
    ffn = [getattr(layer, n) for layer in params.layers for n in Q.FFN_FIELDS]
    for t in ffn:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            return Q.encode_image(params, cfg, pix).detach()
    finally:
        for t in ffn:
            t.requires_grad_(False)


def padded(params, cfg, pix):
    with torch.no_grad():
        return Q.encode_image(params, cfg, pix)


def kernel_names(fn, *args) -> set:
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


def test_padded_layer_gives_the_plain_tokens(tower):
    cfg, params, pix = tower
    profiling.reset()
    profiling.enable()
    try:
        got = padded(params, cfg, pix)
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    assert (profiling.total(counts, "vision.mlp_padded"), profiling.total(counts, "vision.mlp_plain")) == (1, 0)
    copy = Q._padded_ffn[params.layers[0]][2]
    assert [tuple(t.shape) for t in copy] == [(3424, 1280), (3424,), (3424, 1280), (3424,), (1280, 3424)]
    assert all(t.dtype == torch.bfloat16 and t.is_cuda and t.is_contiguous() for t in copy)
    want = plain(params, cfg, pix)
    assert got.shape == want.shape == (CROPS, (SIZE // 28) ** 2, 3584)
    # bf16's unit roundoff is 2^-8: the two GEMM kernels sum in other orders, so single roundings may differ
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= 4 * 2.0**-8, err


def test_padded_layer_runs_no_align2_gemm(tower):
    cfg, params, pix = tower
    got = kernel_names(padded, params, cfg, pix)
    control = kernel_names(plain, params, cfg, pix)
    assert any("align2" in n for n in control), sorted(control)
    assert got and not any("align2" in n for n in got), sorted(got)
