"""Milliseconds a batch that `evaluate` waits in its `evaluate.wait` span:
for the prefetch thread's next ingested batch and its copy to the device
(the program's span, over the window's batches; None without the program's
tracer on)."""

from perfbench import spans


def read(run):
    trace, w = spans.program_trace(), spans.window(run)
    if trace is None or w is None:
        return None
    return 1e3 * spans.measure(spans.intervals(trace, "evaluate.wait", *w)) / len(run.calls)
