"""Milliseconds a batch of the engine's retrieve-and-assemble stage
(`timings.retrieve_assemble_s`, ended by a device synchronize)."""


def read(run):
    t = [c.timings["retrieve_assemble_s"] for c in run.calls if "retrieve_assemble_s" in c.timings]
    return 1e3 * sum(t) / len(t) if t else None
