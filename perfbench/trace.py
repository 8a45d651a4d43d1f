"""Reading a `torch.profiler` trace of a few served batches.

Each call of the engine is marked in the trace by the `EngineTap`'s
"perfbench.inference" range. Inside a call, the engine ends each of its
`timings` stages with a device synchronize; the configuration names the
stages in order (`stages`). A device operation (kernel, copy or set)
belongs to the stage in which the host launched it, found through the
launch's correlation id: stage k takes the launches after the (k-1)-th
synchronize of the call up to the k-th, and the last stage the launches
after the last synchronize up to the first copy back to the host, which
waits for its result. So the attribution follows the engine's own stage
boundaries, not the names of the kernels.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime"}
SYNC = "cudaDeviceSynchronize"


@dataclass
class CallStages:
    device_s: Dict[str, float] = field(default_factory=dict)  # summed device time of each stage's operations
    ops: Dict[str, int] = field(default_factory=dict)  # device operations of each stage


@dataclass
class TraceSummary:
    calls: List[Optional[CallStages]]  # None where the call's synchronizes do not match the stages
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def analyse(path: str, stages: List[str], top: int = 10) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls, device, runtime, cpu = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat == "user_annotation" and e.get("name") == "perfbench.inference":
            calls.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid")))
        elif cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e.get("dur", 0)), e["name"], (e.get("args") or {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            runtime.append((float(e["ts"]), e["name"], e.get("tid"), (e.get("args") or {}).get("correlation")))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            cpu.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"], e.get("tid")))
    calls.sort()
    runtime.sort(key=lambda r: r[0])
    by_corr: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for ts, dur, name, corr in device:
        if corr is not None:
            by_corr[corr].append((ts, dur, name))

    summaries: List[Optional[CallStages]] = []
    for start, end, tid in calls:
        rts = [r for r in runtime if start <= r[0] <= end and r[2] == tid]
        syncs = [i for i, r in enumerate(rts) if r[1] == SYNC]
        if len(syncs) != len(stages) - 1:
            summaries.append(None)
            continue
        cs = CallStages({s: 0.0 for s in stages}, {s: 0 for s in stages})
        bounds = [-1] + syncs
        for k, stage in enumerate(stages):
            lo = bounds[k] + 1
            hi = bounds[k + 1] if k + 1 < len(bounds) else len(rts) - 1
            for r in rts[lo:hi + 1]:
                ops = by_corr.get(r[3], [])
                cs.device_s[stage] += sum(dur for _, dur, _ in ops) * 1e-6
                cs.ops[stage] += len(ops)
                if k == len(stages) - 1 and any("DtoH" in name for _, _, name in ops):
                    break
        summaries.append(cs)

    if not calls:
        return TraceSummary(summaries, 0.0, 0.0, [], [])
    w0, w1 = calls[0][0], calls[-1][1]
    clipped = [(max(ts, w0), min(ts + dur, w1)) for ts, dur, _, _ in device if ts < w1 and ts + dur > w0]
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    by_name: Dict[str, float] = defaultdict(float)
    for ts, dur, name, _ in device:
        if w0 <= ts < w1:
            by_name[name] += dur * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # each idle gap is named by the innermost host range open on the engine's
    # thread at its middle, found in one sweep (one thread's ranges nest)
    main = calls[0][2]
    host = sorted((c for c in cpu if c[3] == main), key=lambda c: c[0])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    stack: List[Tuple[float, float, str, object]] = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        where = "in a call" if any(c0 <= mid <= c1 for c0, c1, _ in calls) else "between calls"
        gaps[f"{where}: {stack[-1][2] if stack else 'host'}"] += (b - a) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(summaries, busy_s, (w1 - w0) * 1e-6, device_ops, idle)
