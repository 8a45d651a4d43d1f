"""The encode stage's least time (work.py, from the valid tokens) over the
summed device time of the operations the stage launched, in the traced
calls, in percent."""

from perfbench.stage_roofline import roofline


def read(run):
    return roofline(run, "encode")
