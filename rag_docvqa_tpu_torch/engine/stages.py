"""The stage clock: where an engine call's stages end.

An engine makes one `StageClock` a call: `end(stage)` synchronizes the device
and notes the time under the stage's name, `note(name)` notes a time without
one. The engine derives its "timings" ("retrieval_time", "generation_time",
"rerank_time" too) from the noted times; the benchmark's host metrics read them.

The synchronizes are a contract with the benchmark's trace reader
(`perfbench/trace.py`), which puts each device operation of a call in a stage
by counting the call's synchronizes: stage k takes the launches after the
(k-1)-th up to the k-th, the last stage those up to the first copy back to the
host. The configuration names the stages in order (`stages` in
`perfbench/configs/*.json`), and a call with another count drops out of every
roofline metric. So the ended stages carry those names, the last stage ends at
a copy and not here, and this module holds the serving path's only
`torch.cuda.synchronize`.
"""

from __future__ import annotations

import time

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device`; nothing to wait for off CUDA."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageClock:
    """One engine call's noted times, by name; "start" is the clock's making."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times = {}
        self.note("start")

    def end(self, stage: str) -> None:
        """End `stage`: wait for the device, then note the time."""
        synchronize(self.device)
        self.note(stage)

    def note(self, name: str) -> None:
        self.times[name] = time.perf_counter()
