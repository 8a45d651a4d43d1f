"""The prefill stage's least time (the family's `call_work`: each row's
valid prompt tokens, causal attention per row) over the summed device time
of the operations the stage launched, in the traced calls, in percent."""

from perfbench.stage_roofline import roofline


def read(run):
    return roofline(run, "prefill")
