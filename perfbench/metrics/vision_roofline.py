"""The crops stage's least time (the family's `call_work`: the vision
tower over the valid crops, windowed and full attention apart) over the
summed device time of the operations the stage launched, in the traced
calls, in percent."""

from perfbench.stage_roofline import roofline


def read(run):
    return roofline(run, "crops")
