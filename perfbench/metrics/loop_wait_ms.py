"""Milliseconds a batch that the loop spends outside the engine's
`inference`: waiting for the prefetched batch and its copy, and scoring;
the window's time less the time inside `inference`, over its batches."""


def read(run):
    if not run.calls:
        return None
    inside = sum(c.end - c.start for c in run.calls)
    return 1e3 * (run.used_s - inside) / len(run.calls)
