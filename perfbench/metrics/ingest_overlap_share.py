"""Share of the window's `evaluate.inference` time during which the
prefetch thread was inside an `ingest.batch` span, in percent: how much of
the engine's host work shares the interpreter with an ingest (the program's
spans; None without the program's tracer on)."""

from perfbench import spans


def read(run):
    trace, w = spans.program_trace(), spans.window(run)
    inference = spans.intervals(trace, "evaluate.inference", *w) if trace and w else []
    if not inference:
        return None
    return 100.0 * spans.overlap(inference, spans.intervals(trace, "ingest.batch", *w)) / spans.measure(inference)
