"""Milliseconds of a `decode.step` span, the mean over the window's steps:
the host's time to launch one step (the step holds no synchronize, so no
wait for the device is in it; the program's span, None without the
program's tracer on)."""

from perfbench import spans


def read(run):
    trace, w = spans.program_trace(), spans.window(run)
    steps = spans.inside(trace, "decode.step", *w) if trace and w else []
    return 1e-6 * sum(s.dur_ns for s in steps) / len(steps) if steps else None
