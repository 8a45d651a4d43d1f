"""Milliseconds a batch of the engine's crops stage (`timings.crops_s`: the
host cuts, the upload, the device resize and the vision tower, ended by a
device synchronize; the `engine.crops` span)."""


def read(run):
    t = [c.timings["crops_s"] for c in run.calls if "crops_s" in c.timings]
    return 1e3 * sum(t) / len(t) if t else None
