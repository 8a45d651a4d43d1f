"""Model FLOPs of the documents answered inside the window (work.py:
embeddings, encoder, decode and page head over the valid tokens, pages and
steps) over the window's time times the card's bfloat16 peak, in percent.
Taken with the profiler off."""

from perfbench.work import PEAK_BF16_FLOPS


def read(run):
    if not run.work or not run.used_s:
        return None
    return 100.0 * sum(w["model"].flops for w in run.work) / (run.used_s * PEAK_BF16_FLOPS)
