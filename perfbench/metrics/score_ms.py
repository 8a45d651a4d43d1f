"""Milliseconds a batch that `evaluate` spends in its `evaluate.score` span:
the evaluator and the per-sample bookkeeping after `inference`, on the main
thread while the card idles (the program's span, over the window's batches;
None without the program's tracer on)."""

from perfbench import spans


def read(run):
    trace, w = spans.program_trace(), spans.window(run)
    if trace is None or w is None:
        return None
    return 1e3 * spans.measure(spans.intervals(trace, "evaluate.score", *w)) / len(run.calls)
