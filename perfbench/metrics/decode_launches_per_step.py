"""CUDA kernels, copies and sets launched in the decode stage of the traced
calls, over their steps (`max_new_tokens` a call)."""


def read(run):
    calls = [c for c in (run.trace.calls if run.trace else []) if c is not None]
    return sum(c.ops["decode"] for c in calls) / (len(calls) * run.max_new_tokens) if calls else None
