"""Share of the traced window (from the first traced call's start to the
last one's end) in which no kernel, copy or set runs on the device, in
percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
