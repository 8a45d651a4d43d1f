"""Milliseconds a batch of the causal LM's prefill (`timings.prefill_s`,
ended by a device synchronize; the `engine.prefill` span)."""


def read(run):
    t = [c.timings["prefill_s"] for c in run.calls if "prefill_s" in c.timings]
    return 1e3 * sum(t) / len(t) if t else None
