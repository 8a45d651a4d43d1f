"""The readers of the program's spans and counters (`perfbench/spans.py` and
its six metrics): device time by span on a hand-made trace, the idle gaps
and stages of `trace.py` with program ranges in the trace, and tiny CPU runs
of each cell with the tracer on (the host-side metrics read a number, the
valid-token counter equals the rows the family's work counts) and off
(every reader gives None)."""

import json

import pytest
import torch

from perfbench import harness, spans, work
from perfbench.tests.test_perfbench_trace import X
from perfbench.tests.tiny import tiny
from perfbench.trace import analyse
from rag_docvqa_tpu_torch import profiling

CELLS = ("vt5-concat-mpdocvqa", "hivt5-mpdocvqa")
HOST = ("batch_wait_ms", "score_ms", "ingest_overlap_share", "decode_host_ms_per_step", "encode_valid_share")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decode_trace(tmp_path):
    """One call: a synchronize ends stage one; then two decode steps, each a
    `decode.ffn` child with a kernel and a kernel of the step's own, and a
    gap in Python inside the second step's `decode.ffn`; the tokens' copy
    back ends stage two."""
    ev = [X("user_annotation", "perfbench.inference", 0, 200), X("user_annotation", "evaluate.inference", 0, 200)]
    ev.append(X("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1))
    ev.append(X("kernel", "encode", 6, 10, tid=7, corr=1))
    ev.append(X("cuda_runtime", "cudaDeviceSynchronize", 17, 3))
    corr = 2
    for start in (30, 100):
        ev.append(X("user_annotation", "decode.step", start, 60))
        ev.append(X("user_annotation", "decode.ffn", start + 10, 40))
        for ts, name in ((start + 15, "ffn"), (start + 55, "head")):
            ev.append(X("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr))
            ev.append(X("kernel", name, ts + 1, 4, tid=7, corr=corr))
            corr += 1
    ev.append(X("cuda_runtime", "cudaMemcpyAsync", 170, 1, corr=50))
    ev.append(X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 171, 2, tid=7, corr=50))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_device_time_goes_to_the_innermost_span(tmp_path):
    by = spans.device_by_span(_decode_trace(tmp_path), {"decode.step", "decode.ffn", "evaluate.inference"})
    step, ffn, loop = by["decode.step"], by["decode.ffn"], by["evaluate.inference"]
    assert (step.count, ffn.count, loop.count) == (2, 2, 1)
    assert (ffn.launches, step.launches, loop.launches) == (2, 2, 2)  # the encode kernel and the copy
    assert ffn.device_s == pytest.approx(8e-6) and step.device_s == pytest.approx(8e-6)
    assert (step.launches_in, step.device_in_s) == (4, pytest.approx(16e-6))
    assert loop.launches_in == 6 and loop.device_in_s == pytest.approx(28e-6)
    assert step.host_s == pytest.approx(120e-6) and step.self_s == pytest.approx(40e-6)
    assert loop.self_s == pytest.approx(80e-6)


def test_trace_names_a_gap_by_its_span_and_keeps_the_stages(tmp_path):
    s = analyse(_decode_trace(tmp_path), ["encode", "decode"])
    (c,) = s.calls
    assert c.ops == {"encode": 1, "decode": 5} and c.device_s["encode"] == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["in a call: decode.ffn"] == pytest.approx(2 * 36e-6)  # each ffn kernel's end to the head kernel
    assert "in a call: host" not in gaps


def _traced_run(cell, on, monkeypatch):
    """A tiny CPU run of `cell`, the tracer on or off: (its window's data,
    the six readers' values, the valid positions the family's work counted
    over the window's calls, the program's `encode.tokens_valid` there)."""
    seen, rows = {}, []
    reader, encoder_work = harness.reader, work.encoder_work

    def keeping(name):
        read = reader(name)

        def kept(run):
            seen.setdefault("run", run)
            return read(run)

        return kept

    def counted(c, lengths):
        rows.append(list(lengths))
        return encoder_work(c, lengths)

    monkeypatch.setattr(harness, "reader", keeping)
    monkeypatch.setattr(work, "encoder_work", counted)
    profiling.reset()
    if on:
        profiling.enable()
    try:
        harness.run(tiny(cell), 2**31 + 17, 1.0, False, device="cpu", log=lambda *a: None)
        run = seen["run"]
        values = {m["name"]: harness.reader(m["name"])(run) for m in spans.METRICS}
        from perfbench.families import hivt5, rag_vt5

        fam = {"vt5-concat-mpdocvqa": rag_vt5, "hivt5-mpdocvqa": hivt5}[cell]
        rows.clear()
        c = run.spec.cfg["engine"]
        for call in run.calls:
            fam.call_work(c, 512, call.record)
        lo, hi = (int(x * 1e9) for x in spans.window(run))
        return run, values, sum(sum(r) for r in rows), profiling.total(profiling.read().counts,
                                                                       "encode.tokens_valid", lo, hi)
    finally:
        profiling.disable()
        profiling.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_host_metric(cell, monkeypatch):
    run, values, valid, counted = _traced_run(cell, True, monkeypatch)
    assert run.calls
    assert all(values[name] is not None for name in HOST), values
    assert values["decode_device_ms_per_step"] is None  # no device trace on the CPU
    assert 0 < values["encode_valid_share"] < 100 and 0 <= values["ingest_overlap_share"] <= 100
    assert values["batch_wait_ms"] >= 0 and values["score_ms"] >= 0 and values["decode_host_ms_per_step"] > 0
    assert counted == valid > 0  # the counter against the rows the family's work counts


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_tracer_every_reader_gives_none(cell, monkeypatch):
    _, values, _, counted = _traced_run(cell, False, monkeypatch)
    assert counted == 0
    assert values == {m["name"]: None for m in spans.METRICS}
