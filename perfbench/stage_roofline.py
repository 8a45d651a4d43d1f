"""A stage's share of its roofline over the traced calls, for the metric
readers: the summed least time of the stage's work over the summed device
time of its operations, in percent; None where the trace holds no call whose
stages it could place."""


def roofline(run, stage: str):
    if run.trace is None:
        return None
    pairs = [(w[stage].least_s, c.device_s[stage]) for w, c in zip(run.traced_work, run.trace.calls)
             if c is not None and c.device_s[stage] > 0]
    if not pairs:
        return None
    return 100.0 * sum(a for a, _ in pairs) / sum(b for _, b in pairs)
