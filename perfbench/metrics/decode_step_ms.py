"""Milliseconds a decode step: the engine's decode stage
(`timings.decode_s`) over `max_new_tokens`, the steps it always runs."""


def read(run):
    t = [c.timings["decode_s"] for c in run.calls if "decode_s" in c.timings]
    return 1e3 * sum(t) / len(t) / run.max_new_tokens if t else None
