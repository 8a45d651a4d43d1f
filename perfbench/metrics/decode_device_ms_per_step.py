"""Milliseconds of device time a decode step: the summed device time of the
operations launched inside the traced calls' `decode.step` ranges, their
children's included, over those ranges (`spans.device_by_span`; None where
the trace holds no such range)."""


def read(run):
    by = getattr(run.trace, "spans", None) if run.trace is not None else None
    step = by.get("decode.step") if by else None
    return 1e3 * step.device_in_s / step.count if step and step.count else None
