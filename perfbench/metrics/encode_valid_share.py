"""Share of the encoder's positions that are real tokens over the window,
in percent: the program's counters `encode.tokens_valid` (summed on the
device) over `encode.positions`, counted where each engine hands its rows to
the encoder (Hi-VT5: every page slot's row, page tokens included). None
without the program's tracer on."""

from perfbench import spans
from rag_docvqa_tpu_torch import profiling


def read(run):
    trace, w = spans.program_trace(), spans.window(run)
    if trace is None or w is None:
        return None
    lo, hi = (int(x * 1e9) for x in w)
    positions = profiling.total(trace.counts, "encode.positions", lo, hi)
    return 100.0 * profiling.total(trace.counts, "encode.tokens_valid", lo, hi) / positions if positions else None
