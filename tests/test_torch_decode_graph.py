"""The greedy decode's CUDA-graph path (`rag_docvqa_tpu_torch/ops/decode.py`)
on the card, at t5-base widths in bf16: a replayed decode gives the eager
decode's tokens and confidences bit for bit at the two served shapes (RAG-VT5:
B 32, Te 512, 100 steps; Hi-VT5: B 64, Te 200, 32 steps), a second call reads
its own inputs, a smaller last batch captures a second graph, a capture goes
through while another thread copies batches to the card, the tracer counts one
capture and T replays a call, parameters made for the call (a training step's
cast) take the eager path, and K3's launch count a call is the eager one.
The eager reference is the same function with autograd on. Every test skips
without a CUDA device; the CPU side (the device step, the graph key and the
cache) is in tests/test_torch_t5.py. On the card:
`python -m pytest --noconftest tests/test_torch_decode_graph.py` (the
tests' conftest.py imports JAX, which that machine lacks)."""

import dataclasses
import threading
from collections import OrderedDict

import pytest
import torch

from rag_docvqa_tpu_torch import kernels, profiling
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.ops import decode
from rag_docvqa_tpu_torch.ops.decode import greedy_decode

CFG = t5m.T5Config()  # t5-base widths


@pytest.fixture(scope="module")
def params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path captures on the card")
    return t5m.init_t5_params(torch.Generator(device="cuda").manual_seed(0), CFG).to(torch.bfloat16)


@pytest.fixture(autouse=True)
def fresh_graphs(monkeypatch):
    monkeypatch.setattr(decode, "_graphs", OrderedDict())


def inputs(B, Te, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    enc = torch.randn((B, Te, CFG.d_model), generator=g, device="cuda").bfloat16()
    lengths = torch.randint(1, Te + 1, (B, 1), generator=g, device="cuda")
    return enc, torch.arange(Te, device="cuda")[None, :] < lengths


def eager(params, cfg, enc, mask, T):
    with torch.enable_grad():  # autograd on: the eager path
        return greedy_decode(params, cfg, enc, mask, T)


def replayed(params, cfg, enc, mask, T):
    with torch.inference_mode():  # as the engines call it
        return greedy_decode(params, cfg, enc, mask, T)


def assert_same(got, want):
    assert torch.equal(got[0], want[0]), "tokens differ"
    assert torch.equal(got[1], want[1]), "confidences differ"


@pytest.mark.parametrize("B,Te,T", [(32, 512, 100), (64, 200, 32)], ids=["vt5", "hivt5"])
def test_replay_matches_eager_bit_for_bit(params, B, Te, T):
    enc, mask = inputs(B, Te, 1)
    assert_same(replayed(params, CFG, enc, mask, T), eager(params, CFG, enc, mask, T))
    assert len(decode._graphs) == 1


def test_second_call_reads_its_own_inputs(params):
    """Two calls of one key with different encoder states and masks: a stale
    static buffer (cross K/V, self K/V, mask, token, flags, step) would make
    the second call differ from its eager decode; the first call's outputs
    are copies that the second leaves alone."""
    a, b = inputs(32, 512, 2), inputs(32, 512, 3)
    first = replayed(params, CFG, *a, 100)
    kept = [x.clone() for x in first]
    second = replayed(params, CFG, *b, 100)
    assert_same(first, eager(params, CFG, *a, 100))
    assert_same(second, eager(params, CFG, *b, 100))
    assert all(torch.equal(x, y) for x, y in zip(first, kept))
    assert len(decode._graphs) == 1


def test_smaller_last_batch_captures_a_second_graph(params):
    full, last = inputs(32, 512, 4), inputs(7, 512, 5)
    profiling.reset()
    profiling.enable()
    try:
        got = [replayed(params, CFG, *x, 100) for x in (full, last, full)]
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    for out, x in zip(got, (full, last, full)):
        assert_same(out, eager(params, CFG, *x, 100))
    assert profiling.total(counts, "decode.graph_captures") == 2 and len(decode._graphs) == 2


def test_capture_while_another_thread_copies_to_the_card(params):
    """The ingest's prefetch thread keeps copying batches to the card (pinned
    staging, a copy on a stream of its own, a synchronize) while the decode
    captures: the thread-local capture lets it."""
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.data.transfer import device_put_batch_async
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    ing = DocVQAIngestor(HashTokenizer(vocab_size=32128), ChunkSpec(chunk_size=60, overlap=10))
    docs = make_corpus(32, n_pages=8, words_per_page=120, seed=6)
    ing.caps = ing.plan_caps(docs)
    batch = ing.ingest(docs)[0]
    stop, started, copies, errors = threading.Event(), threading.Event(), [0], []

    def copy_batches():
        try:
            while not stop.is_set():
                device_put_batch_async(batch, 32128, "cuda").wait()
                torch.cuda.current_stream().synchronize()
                copies[0] += 1
                started.set()
        except BaseException as e:  # noqa: BLE001 — reported by the test
            errors.append(e)
            started.set()

    enc, mask = inputs(32, 512, 7)
    thread = threading.Thread(target=copy_batches, daemon=True)
    thread.start()
    try:
        assert started.wait(60)
        before = copies[0]
        got = replayed(params, CFG, enc, mask, 100)
        during = copies[0] - before
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive() and not errors, errors
    assert during > 0
    assert_same(got, eager(params, CFG, enc, mask, 100))


def test_counters_and_spans(params):
    """A call counts T replays, its first one capture, and no eager step;
    with the tracer on each replay is one `decode.step` span, and the
    per-layer spans fire only while the step is warmed up and captured."""
    enc, mask = inputs(64, 200, 8)
    T = 32
    profiling.reset()
    profiling.enable()
    try:
        replayed(params, CFG, enc, mask, T)
        replayed(params, CFG, enc, mask, T)
        trace = profiling.read()
    finally:
        profiling.disable()
        profiling.reset()
    assert profiling.total(trace.counts, "decode.graph_captures") == 1
    assert profiling.total(trace.counts, "decode.graph_replays") == 2 * T
    assert profiling.total(trace.counts, "decode.eager_steps") == 0
    steps = [s for s in trace.spans if s.name == "decode.step"]
    assert len(steps) == 2 * T
    layers = [s for s in trace.spans if s.name == "decode.self_attn"]
    assert len(layers) == CFG.num_decoder_layers * (decode._WARMUP_STEPS + 1)
    assert max(s.end_ns for s in layers) < min(s.start_ns for s in steps)


def test_parameters_made_for_the_call_run_eagerly(params):
    """A training step's NAC decode reads `cast_params`' bf16 cast of its f32
    masters, made under autograd (tensors with a `grad_fn`, at new addresses
    every step): it runs eagerly, captures nothing, and decodes as the same
    cast made without autograd does through a graph."""
    from rag_docvqa_tpu_torch.training.train_step import cast_params

    masters = t5m.init_t5_params(torch.Generator(device="cuda").manual_seed(1), CFG).requires_grad_(True)
    cast = cast_params(masters, torch.bfloat16)
    with torch.no_grad():
        frozen = cast_params(masters, torch.bfloat16)
    enc, mask = inputs(8, 64, 10)
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            got = greedy_decode(cast, CFG, enc, mask, 8)
        counts = profiling.read().counts
    finally:
        profiling.disable()
        profiling.reset()
    assert profiling.total(counts, "decode.eager_steps") == 8
    assert profiling.total(counts, "decode.graph_captures") == 0 and not decode._graphs
    assert_same(got, replayed(frozen, CFG, enc, mask, 8))
    assert len(decode._graphs) == 1


def test_k3_launch_count_a_call_unchanged(params):
    """Under `fused_decode_attn` (K3) with an int8 cache, `kernels.LAUNCHES`
    counts a replayed call's K3 launches as the eager call's, the capturing
    call and a later one alike, and the decode's bits are the eager ones."""
    cfg = dataclasses.replace(CFG, decode_kv_int8=True, fused_decode_attn=True)
    enc, mask = inputs(32, 512, 9)
    launched = []
    outs = []
    for run in (eager, replayed, replayed):
        before = dict(kernels.LAUNCHES)
        outs.append(run(params, cfg, enc, mask, 16))
        launched.append({k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]})
    assert launched[0] == {"decode_cross_attention": 16 * cfg.num_decoder_layers}
    assert launched[1] == launched[2] == launched[0]
    assert_same(outs[1], outs[0])
    assert_same(outs[2], outs[0])
