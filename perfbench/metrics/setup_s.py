"""Set-up time: from the process's start to the window's, the warm-up call
(and, on a checkout's first run, the kernel build) included."""


def read(run):
    return run.setup_s
