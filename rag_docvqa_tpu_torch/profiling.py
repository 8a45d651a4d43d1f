"""Profiling: named wall-clock stages, traces and annotations.

Counterpart of `rag_docvqa_tpu/profiling.py`:

  * `StageTimer`: named wall-clock stages; a stage given a tensor on a CUDA
    device as `sync` synchronizes that device (`torch.cuda.synchronize`,
    where JAX fetches a scalar of it) before its clock stops, so that it
    times the device's work and not only its enqueue. An exception inside a
    stage propagates (nothing is swallowed) and the stage is not counted.
  * `trace(logdir)`: a `torch.profiler` trace of the CPU and, where there is
    one, the CUDA device, written for TensorBoard; a no-op without a logdir.
  * `annotate(name)`: a `record_function` range that names a region in a
    trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Optional[torch.Tensor] = None):
        """Time a stage; with `sync` a CUDA tensor, its device's work is waited for."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        total = sum(self.totals.values()) or 1.0
        return {
            name: {
                "total_s": round(t, 4),
                "mean_s": round(t / max(self.counts[name], 1), 4),
                "pct": round(100 * t / total, 1),
            }
            for name, t in self.totals.items()
        }
