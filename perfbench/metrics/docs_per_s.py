"""Documents answered inside the window over the time from the window's
start to the last answer inside it: a closed-loop rate of all the work over
all the time."""


def read(run):
    return run.docs / run.used_s if run.docs else None
