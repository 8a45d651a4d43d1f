"""Milliseconds a batch of the engine's encode stage (`timings.encode_s`,
ended by a device synchronize)."""


def read(run):
    t = [c.timings["encode_s"] for c in run.calls if "encode_s" in c.timings]
    return 1e3 * sum(t) / len(t) if t else None
