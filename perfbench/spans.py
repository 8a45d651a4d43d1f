"""The program's spans and counters (`rag_docvqa_tpu_torch/profiling.py`) as
the benchmark reads them, and a traced run of a cell with them on.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]

runs the cell as `run.py --trace 1` does (the same `harness.run`), with the
program's tracer on from the process's start (`--spans 1`, the default) or
off (`--spans 0`, the same run without it, to price it). Its result line
holds, beside the cell's per-layer metrics and `docs_per_s`, the six that
read the spans (`METRICS`); standard error gets two tables: the window's
spans (profiler off) a batch, and the traced calls' spans, each with the
device operations launched inside it. `run.py` does not turn the tracer on,
so the benchmark's own runs read none of these: the six entries wait for
the harness to call `profiling.enable()` in its traced runs.

Readers take the spans of the window (from its start to the last answer in
it) from the tracer itself, by time; the device time of a span comes from
`device_by_span`, a pass over the traced calls' exported trace that puts
each device operation down to the innermost program span in which its
thread launched it (by the launch's correlation id), kept on the run's
`TraceSummary` as `spans`. Where the program keeps no spans (tracing off,
or a program without the tracer) every reader here gives None.
"""

import time

T0 = time.perf_counter()  # set-up time counts from here, as in run.py

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.trace import DEVICE_CATS, RUNTIME_CATS, _union  # noqa: E402

CELLS = ["vt5-concat-mpdocvqa", "hivt5-mpdocvqa"]
METRICS = [
    {"name": "batch_wait_ms", "unit": "ms", "better": "lower", "source": "program_span", "layer": "host ingest",
     "moves": "docs_per_s", "workloads": CELLS},
    {"name": "score_ms", "unit": "ms", "better": "lower", "source": "program_span", "layer": "host ingest",
     "moves": "docs_per_s", "workloads": CELLS},
    {"name": "ingest_overlap_share", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "host ingest", "moves": "docs_per_s", "workloads": CELLS},
    {"name": "decode_host_ms_per_step", "unit": "ms", "better": "lower", "source": "program_span", "layer": "decode",
     "moves": "docs_per_s", "workloads": CELLS},
    {"name": "decode_device_ms_per_step", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "decode", "moves": "docs_per_s", "workloads": CELLS},
    {"name": "encode_valid_share", "unit": "%", "better": "higher", "source": "program_counter", "layer": "encode",
     "moves": "docs_per_s", "workloads": CELLS},
]


def program_trace():
    """The tracer's spans and counts, or None where it kept none."""
    from rag_docvqa_tpu_torch import profiling

    read = getattr(profiling, "read", None)
    if read is None:
        return None
    trace = read()
    return trace if trace.spans else None


def window(run) -> Optional[Tuple[float, float]]:
    """The window's bounds on the host clock (seconds of `time.perf_counter`)."""
    return (run.window_start, run.calls[-1].end) if run.calls else None


def intervals(trace, name: str, lo: float, hi: float, thread=None) -> List[Tuple[float, float]]:
    """The spans named `name` (on `thread`, where given), each cut to [lo, hi]."""
    out = []
    for s in trace.spans:
        if s.name != name or s.end_ns < 0 or (thread is not None and s.thread != thread):
            continue
        a, b = max(s.start_ns * 1e-9, lo), min(s.end_ns * 1e-9, hi)
        if b > a:
            out.append((a, b))
    return out


def inside(trace, name: str, lo: float, hi: float) -> List:
    """The spans named `name` that began and ended inside [lo, hi]."""
    return [s for s in trace.spans if s.name == name and s.end_ns >= 0 and s.start_ns * 1e-9 >= lo
            and s.end_ns * 1e-9 <= hi]


def measure(spans: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in _union(spans))


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The time that the union of `a` and the union of `b` share."""
    ua, ub = _union(a), _union(b)
    i = j = 0
    out = 0.0
    while i < len(ua) and j < len(ub):
        lo, hi = max(ua[i][0], ub[j][0]), min(ua[i][1], ub[j][1])
        out += max(0.0, hi - lo)
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return out


# -- the traced calls' device time by span -----------------------------------------------------------------


@dataclass
class SpanDevice:
    count: int = 0  # ranges of the name
    host_s: float = 0.0  # their summed duration
    self_s: float = 0.0  # less the part their program-span children cover
    launches: int = 0  # device operations launched with the range innermost
    device_s: float = 0.0  # their summed device time
    launches_in: int = 0  # device operations launched inside the range, its children's included
    device_in_s: float = 0.0
    mallocs: int = 0  # `cudaMalloc` calls made with the range innermost
    malloc_s: float = 0.0


def device_by_span(path: str, names) -> Dict[str, SpanDevice]:
    """Per program span name (the host ranges named in `names`), what the
    ranges of an exported `torch.profiler` trace hold: their host time and
    the device operations their threads launched inside them, and the
    `cudaMalloc` calls made inside them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = set(names)
    ranges: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[object, List[Tuple[float, float, object, str]]] = defaultdict(list)
    ops: Dict[object, List[float]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation" and e.get("name") in names:
            ranges[e.get("tid")].append((ts, ts + dur, e["name"]))
        elif cat in RUNTIME_CATS:
            launches[e.get("tid")].append((ts, dur, (e.get("args") or {}).get("correlation"), e.get("name")))
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                ops[corr].append(dur)
    out: Dict[str, SpanDevice] = defaultdict(SpanDevice)
    for tid, rs in ranges.items():
        rs.sort(key=lambda r: (r[0], -r[1]))
        children = [0.0] * len(rs)
        stack: List[int] = []
        for k, (a, b, name) in enumerate(rs):
            while stack and rs[stack[-1]][1] <= a:
                stack.pop()
            if stack:
                children[stack[-1]] += b - a
            stack.append(k)
        for k, (a, b, name) in enumerate(rs):
            d = out[name]
            d.count += 1
            d.host_s += (b - a) * 1e-6
            d.self_s += (b - a - children[k]) * 1e-6
        # one sweep: the stack holds the ranges open at the launch, innermost last
        stack = []
        j = 0
        for ts, dur, corr, call in sorted(launches.get(tid, []), key=lambda x: x[0]):
            while j < len(rs) and rs[j][0] <= ts:
                while stack and rs[stack[-1]][1] < rs[j][0]:
                    stack.pop()
                stack.append(j)
                j += 1
            while stack and rs[stack[-1]][1] < ts:
                stack.pop()
            if not stack:
                continue
            if call == "cudaMalloc":
                out[rs[stack[-1]][2]].mallocs += 1
                out[rs[stack[-1]][2]].malloc_s += dur * 1e-6
            durs = ops.get(corr, [])
            if not durs:
                continue
            d = out[rs[stack[-1]][2]]
            d.launches += len(durs)
            d.device_s += sum(durs) * 1e-6
            for name in {rs[k][2] for k in stack}:
                out[name].launches_in += len(durs)
                out[name].device_in_s += sum(durs) * 1e-6
    return dict(out)


@contextmanager
def device_pass(names_of):
    """For the length of the block, the harness's trace summary also holds
    `device_by_span` of the exported trace, as `spans`, and every idle gap
    (the result line keeps the ten longest), as `gaps`; `names_of()` gives
    the program span names to look for."""
    import tempfile

    from perfbench import harness
    from perfbench.trace import analyse

    def summary(prof, stages):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            out = analyse(path, stages, top=1 << 30)
            out.gaps, out.idle_gaps = out.idle_gaps, out.idle_gaps[:10]
            out.spans = device_by_span(path, names_of())
            return out
        finally:
            os.unlink(path)

    original = harness._summary
    harness._summary = summary
    try:
        yield
    finally:
        harness._summary = original


# -- the tables ---------------------------------------------------------------------------------------------


def window_table(run) -> List[str]:
    from rag_docvqa_tpu_torch import profiling

    trace, w = program_trace(), window(run)
    if trace is None or w is None:
        return []
    lo, hi = (int(x * 1e9) for x in w)
    kept = [s for s in trace.spans if s.end_ns >= 0 and s.start_ns >= lo and s.end_ns <= hi]
    own = profiling.self_ns(kept)
    rows: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    for s in kept:
        r = rows[s.name]
        r[0] += 1
        r[1] += s.dur_ns * 1e-6
        r[2] += own[s.id] * 1e-6
    n = len(run.calls)
    lines = [f"window spans ({n} batches, profiler off), a batch: name, count, host ms, host self ms"]
    for name, (c, host, slf) in sorted(rows.items(), key=lambda kv: -kv[1][2]):
        lines.append(f"  {name:24s} {c / n:10.2f} {host / n:12.3f} {slf / n:12.3f}")
    return lines


def traced_table(run) -> List[str]:
    by = getattr(run.trace, "spans", None) if run.trace is not None else None
    if not by:
        return []
    lines = ["traced calls' spans, summed: name, count, host self ms, launches, device ms "
             "(the operations launched with the span innermost; with its children in brackets)"]
    for name, d in sorted(by.items(), key=lambda kv: -kv[1].self_s):
        lines.append(f"  {name:24s} {d.count:8d} {1e3 * d.self_s:12.3f} {d.launches:9d} {1e3 * d.device_s:10.3f}"
                     f"  [{d.launches_in} {1e3 * d.device_in_s:.3f}]")
    gaps = dict(getattr(run.trace, "gaps", []))
    lines.append(f"  idle in a call in no host range ('in a call: host'): {gaps.get('in a call: host', 0.0):.4f} s; "
                 f"cudaMalloc: {sum(d.mallocs for d in by.values())} calls, "
                 f"{1e3 * sum(d.malloc_s for d in by.values()):.3f} ms inside program spans")
    step = by.get("decode.step")
    if step and step.count:
        lines.append(f"  a decode step: host {1e3 * step.host_s / step.count:.3f} ms, launches "
                     f"{step.launches_in / step.count:.2f}, device {1e3 * step.device_in_s / step.count:.3f} ms")
    return lines


def main(argv: List[str]) -> int:
    import argparse

    from perfbench import harness

    ap = argparse.ArgumentParser(description="A traced run of one cell with the program's spans on or off")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sp = harness.spec(args.workload)
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    have = {m["name"] for m in sp.metrics["per_layer"]}
    sp.metrics["per_layer"] += [m for m in METRICS + manifest["end_to_end"]
                                if m["name"] not in have and m["name"] != "setup_s"]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(harness.ROOT / "build" / "bench_cache" / sub)
    from rag_docvqa_tpu_torch import profiling

    if not hasattr(profiling, "enable"):
        print("the program has no tracer (rag_docvqa_tpu_torch/profiling.py::enable)", file=sys.stderr)
        return 2
    if args.spans:
        profiling.enable()
    captured = {}
    reader = harness.reader

    def keeping(name):  # the run's data, for the tables, as the first reader sees it
        read = reader(name)

        def wrapped(run):
            captured.setdefault("run", run)
            return read(run)

        return wrapped

    harness.reader = keeping
    try:
        names = lambda: {s.name for s in (program_trace() or profiling.Trace([], [])).spans}
        with device_pass(names):
            result = harness.finite(harness.run(sp, args.seed, args.seconds, True, t0=T0))
    finally:
        harness.reader = reader
    profiling.disable()
    run = captured.get("run")
    if run is not None:
        print("\n".join(window_table(run) + traced_table(run)), file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r}) "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
