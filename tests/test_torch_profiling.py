"""The port's tracer (`rag_docvqa_tpu_torch/profiling.py`): off, it is one
shared no-op that keeps nothing; on, its spans nest by thread, keep their
batch, and sit in a `torch.profiler` trace as ranges of their names, and its
counts add up. On tiny CPU engines and through `evaluate`, tracing changes
no token, confidence or synchronize, and every span of the serving path
appears where it belongs."""

import threading

import pytest
import torch

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.data.contract import Caps, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import hivt5_engine, rag_vt5, stages
from rag_docvqa_tpu_torch.engine.evaluate import evaluate
from rag_docvqa_tpu_torch.models import hivt5, t5, vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

torch.set_num_threads(2)

VOCAB = 1024
STEPS = 4
LAYERS = 2
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=LAYERS,
             num_decoder_layers=LAYERS, dropout_rate=0.0)
ENGINE_SPANS = {
    "vt5": {"engine.retrieve", "engine.assemble", "engine.encode", "engine.decode", "engine.answers"},
    "hivt5": {"engine.encode", "hivt5.pages", "hivt5.page_head", "engine.decode", "engine.answers"},
}
DECODE_SPANS = {"decode.step", "decode.self_attn", "decode.cross_attn", "decode.ffn", "decode.head"}


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_is_the_shared_noop():
    a, b = profiling.span("x"), profiling.span("y", 3)
    assert a is b
    with a, b:
        profiling.count("n", 4)
        profiling.device_count("m", torch.ones(3, dtype=torch.bool))
    assert profiling.read() == profiling.Trace([], [])


def test_spans_nest_by_thread_and_keep_their_batch(tracer):
    seen = {}

    def work(tag):
        with tracer.span(f"{tag}.outer", 7 if tag == "a" else -1):
            with tracer.span(f"{tag}.inner"):
                seen[tag] = threading.get_ident()
                barrier.wait(5)  # both threads have both spans open at once

    barrier = threading.Barrier(2)
    threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    with tracer.span("main", 2):
        with tracer.span("main.child") as child:
            assert child.batch == 2
    spans = {s.name: s for s in tracer.read().spans}
    assert len(spans) == 6 and all(s.end_ns >= s.start_ns for s in spans.values())
    for tag in "ab":
        outer, inner = spans[f"{tag}.outer"], spans[f"{tag}.inner"]
        assert outer.parent == -1 and inner.parent == outer.id
        assert outer.thread == inner.thread == seen[tag]
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert seen["a"] != seen["b"]
    assert spans["a.inner"].batch == 7 and spans["b.inner"].batch == -1
    assert spans["main.child"].parent == spans["main"].id and spans["main.child"].batch == 2


def test_self_time_is_duration_less_children():
    S = profiling.Span
    spans = [S(0, "p", 1, -1, 0, 0, 100), S(1, "c", 1, 0, 0, 10, 40), S(2, "c", 1, 0, 0, 50, 70),
             S(3, "g", 1, 1, 0, 15, 20), S(4, "other", 2, -1, 0, 0, 30), S(5, "open", 1, -1, 0, 80, -1)]
    assert profiling.self_ns(spans) == {0: 50, 1: 25, 2: 20, 3: 5, 4: 30, 5: 0}


def test_counts_add_up(tracer):
    for n in (3, 4):
        tracer.count("host", n)
    masks = [torch.tensor([[True, False, True], [False, False, True]]), torch.ones(5, dtype=torch.bool),
             torch.arange(4)]
    for m in masks:
        tracer.device_count("dev", m)
    mid = tracer.read().counts[-1].t_ns
    tracer.count("host", 10)
    counts = tracer.read().counts
    assert [c.name for c in counts] == ["host"] * 2 + ["dev"] * 3 + ["host"]
    assert all(isinstance(c.n, int) for c in counts)
    assert profiling.total(counts, "host") == 17 and profiling.total(counts, "dev") == 3 + 5 + 6
    assert profiling.total(counts, "host", hi_ns=mid) == 7 and profiling.total(counts, "host", lo_ns=mid + 1) == 10


def test_span_is_a_profiler_range_while_one_runs(tracer):
    from torch.profiler import ProfilerActivity, profile

    with tracer.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("traced.outer"):
            with tracer.span("traced.inner"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"traced.outer", "traced.inner"} <= names and "before" not in names
    assert {s.name for s in tracer.read().spans} == {"before", "traced.outer", "traced.inner"}


def _corpus(n, pages):
    return make_corpus(n, n_pages=pages, words_per_page=24, seed=5)


def _vt5():
    cfg = vt5.VT5Config(t5=t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0))
    params = vt5.init_vt5_params(torch.Generator().manual_seed(0), cfg)
    engine = rag_vt5.RAGVT5Engine(rag_vt5.RAGConfig(chunk_num=3, max_source_length=96, max_new_tokens=STEPS), cfg,
                                  params, HashTokenizer(VOCAB))
    caps = Caps(max_pages=4, max_chunks=16, max_slots=160, embed_tokens=16)
    return engine, DocVQAIngestor(HashTokenizer(VOCAB), ChunkSpec(chunk_size=10, overlap=2), caps)


def _hivt5():
    cfg = hivt5.HiVT5Config(t5=t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0),
                            page_tokens=4, max_doc_pages=4, page_seq_len=40)
    params = hivt5.init_hivt5_params(torch.Generator().manual_seed(0), cfg)
    engine = hivt5_engine.HiVT5Engine(cfg, params, HashTokenizer(VOCAB), max_new_tokens=STEPS)
    caps = Caps(max_pages=4, max_chunks=16, max_slots=160)
    return engine, DocVQAIngestor(HashTokenizer(VOCAB), ChunkSpec(chunk_size=10, overlap=2), caps)


def _serve(make, monkeypatch):
    """One tiny engine's answers to a batch with the tracer off, then on:
    (off, on, synchronizes off, synchronizes on, the trace, the valid
    positions the encoder was handed)."""
    engine, ingestor = make()
    syncs = [0]
    original = stages.synchronize

    def counted(device):
        syncs[0] += 1
        original(device)

    monkeypatch.setattr(stages, "synchronize", counted)
    masks, encode = [], t5.encode

    def recorded(params, cfg, x, mask, **kwargs):
        masks.append(mask)
        return encode(params, cfg, x, mask, **kwargs)

    monkeypatch.setattr(t5, "encode", recorded)
    batch, aux = ingestor.ingest(_corpus(3, 3))
    batch = to_device(batch, "cpu")
    off = engine.inference(batch, aux)
    n_off = syncs[0]
    profiling.reset()
    profiling.enable()
    try:
        on = engine.inference(batch, aux)
        trace = profiling.read()
    finally:
        profiling.disable()
        profiling.reset()
    return off, on, n_off, syncs[0] - n_off, trace, int(masks[-1].sum())


@pytest.mark.parametrize("family", ["vt5", "hivt5"])
def test_tracing_changes_no_answer_and_no_synchronize(family, monkeypatch):
    off, on, syncs_off, syncs_on, trace, valid = _serve({"vt5": _vt5, "hivt5": _hivt5}[family], monkeypatch)
    assert on["pred_answers"] == off["pred_answers"] and on["pred_answer_pages"] == off["pred_answer_pages"]
    assert on["confidences"] == off["confidences"]
    assert syncs_on == syncs_off == 3  # vt5: retrieve, assemble, encode; hivt5: visual_host, visual, encode
    names = {s.name for s in trace.spans}
    assert ENGINE_SPANS[family] | DECODE_SPANS <= names
    steps = by_name(trace.spans, "decode.step")
    assert len(steps) == STEPS
    kids = {name: [s for s in trace.spans if s.name == name] for name in DECODE_SPANS - {"decode.step"}}
    assert all(len(kids[n]) == STEPS * LAYERS for n in ("decode.self_attn", "decode.cross_attn", "decode.ffn"))
    assert len(kids["decode.head"]) == 2 * STEPS
    step_ids = {s.id for s in steps}
    assert all(s.parent in step_ids or trace.spans[s.parent].parent in step_ids for k in kids.values() for s in k)
    encode = {s.id for s in by_name(trace.spans, "engine.encode")}
    if family == "hivt5":
        assert all(s.parent in encode for n in ("hivt5.pages", "hivt5.page_head") for s in by_name(trace.spans, n))
    decode = {s.id for s in by_name(trace.spans, "engine.decode")}
    assert all(s.parent in decode for s in steps)
    assert profiling.total(trace.counts, "encode.tokens_valid") == valid > 0
    assert profiling.total(trace.counts, "encode.positions") > valid


@pytest.mark.parametrize("family", ["vt5", "hivt5"])
def test_evaluate_spans_each_batch_on_its_thread(family, tracer):
    engine, ingestor = {"vt5": _vt5, "hivt5": _hivt5}[family]()
    docs = _corpus(5, 2)
    evaluate(engine, docs, ingestor, batch_size=2)
    spans = tracer.read().spans
    main = by_name(spans, "evaluate.inference")[0].thread
    for name in ("evaluate.wait", "evaluate.inference", "evaluate.score"):
        loop = by_name(spans, name)
        assert all(s.thread == main and s.parent == -1 for s in loop)
        assert [s.batch for s in loop][:3] == [0, 1, 2]
    assert len(by_name(spans, "evaluate.wait")) == 4  # the last one finds the stream ended
    ingest = by_name(spans, "ingest.batch")
    assert sorted(s.batch for s in ingest) == [0, 1, 2] and all(s.thread != main for s in ingest)
    transfers = by_name(spans, "ingest.transfer")
    assert sorted(spans[s.parent].id for s in transfers) == sorted(s.id for s in ingest)
    inference = {s.id: s for s in by_name(spans, "evaluate.inference")}
    for s in spans:
        if s.name in ENGINE_SPANS[family] - {"hivt5.pages", "hivt5.page_head"}:
            assert s.parent in inference and s.batch == inference[s.parent].batch
    assert len(by_name(spans, "decode.step")) == 3 * STEPS
