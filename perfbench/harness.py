"""One run of one cell: set-up, the measured window, the traced batches, the
check, and the result line.

Everything that belongs to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration in `configs/<config>.json` (the engine's
config dict, its family, its tokenizer, its stages and the limits of its
check), its traffic in `traffic/<traffic>.json`, the family's code in
`families/<family>.py` and each metric's reader in `metrics/<name>.py`.

A family module gives `leaf_init(name, shape, c)` (its weights' rule, for
`weights.make_weights`), `structure(c, vocab, device)` (the program's
parameter tree, which may be on the `meta` device), `install(engine,
recorder)` (what it records from the timed path), `call_work(c, vocab,
record)` (a call's work by stage, and "model") and `check(ctx, control)`
(the numbers compared with the configuration's limits).

The window drives the eval CLI's own loop, `engine/evaluate.py::evaluate`,
with the engine `config.build_engine` builds from the configuration's dict
and a `DocVQAIngestor` whose caps `plan_caps` sized in set-up: one call over
the seed's endless document stream (`stream.Pool`), as `eval.py` makes one
call over a dataset, so the prefetch thread ingests ahead through the whole
window; one caller in a closed loop. The call that is running when
`--seconds` have passed is finished and its answers are checked, but only
the documents answered inside the window count; with `--trace 1` the next
`trace_batches` calls of the same `evaluate` run under the profiler. Then the
tap's hook raises `record.Stop` through `evaluate`. `setup_s` runs from the
process's start to the window's: imports, the documents, the weights, the
engine and one warm-up call of the same shapes (which builds the kernels on
a checkout's first run).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from perfbench.record import Call, EngineTap, IngestTap, Recorder, Stop, clock

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_docvqa_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    workload: str
    cfg: Dict
    traffic: Dict
    chips: int
    metrics: Dict[str, List[Dict]]  # "end_to_end" and "per_layer" entries that this cell reports


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def spec(workload: str, manifest: Optional[Dict] = None) -> Spec:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return Spec(workload, load_json(BENCH / "configs" / f"{cell['config']}.json"),
                load_json(BENCH / "traffic" / f"{cell['traffic']}.json"), cell["chips"],
                {kind: [m for m in manifest[kind] if applies(m, workload)] for kind in ("end_to_end", "per_layer")})


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.read


@dataclass
class RunData:
    """What the metric readers read."""

    spec: Spec
    setup_s: float
    window_start: float
    calls: List[Call]  # the calls answered inside the window
    ingest_spans: List[tuple]  # (start, end) of the ingests begun inside the window
    work: List[Dict[str, Any]]  # each window call's work (work.Work by stage and "model")
    trace: Any = None  # trace.TraceSummary of the traced calls
    traced_work: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def docs(self) -> int:
        return sum(c.rows for c in self.calls)

    @property
    def used_s(self) -> float:
        return (self.calls[-1].end - self.window_start) if self.calls else 0.0

    @property
    def max_new_tokens(self) -> int:
        return self.spec.cfg["engine"].get("max_new_tokens", 32)


@dataclass
class CheckInput:
    cfg: Dict
    vocab: int
    weights: Dict
    device: Any
    sample: list
    block: int = 8
    stream: Any = None  # the window's stream.DocStream, which makes its page images again


class Window:
    """The tap's hooks that end the run's one `evaluate` call: once a call
    ends past the deadline, `trace` more calls run under the profiler (the
    prefetch thread keeps ingesting ahead, as through the window), and the
    tap then raises `Stop` through `evaluate`."""

    def __init__(self, tap: EngineTap, end: float, traced: int):
        self.tap, self.end, self.traced = tap, end, traced
        self.first: Optional[int] = None  # index of the first traced call
        self.prof = None

    def before(self, i: int) -> None:
        if i == self.first:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.tap.annotate = True

    def after(self, i: int) -> None:
        if self.first is None:
            if clock() < self.end:
                return
            if not self.traced:
                raise Stop
            self.first = i + 1
        elif i == self.first + self.traced - 1:
            import torch

            torch.cuda.synchronize()
            self.tap.annotate = False
            self.prof.stop()
            raise Stop


def _ingest_ended(timeout: float = 300.0) -> None:
    """Waits for the prefetch thread of the stopped `evaluate` (closed with
    its generator) to finish the ingest it was in."""
    import threading

    gc.collect()
    for t in threading.enumerate():
        if t.name == "ingest-prefetch":
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("the stopped evaluate's prefetch thread did not end")


def _summary(prof, stages: List[str]):
    from perfbench.trace import analyse

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return analyse(path, stages)
    finally:
        os.unlink(path)


def run(sp: Spec, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: Optional[float] = None,
        log=lambda *a: print(*a, file=sys.stderr, flush=True), control: bool = False) -> Dict:
    """One run of the cell `sp`; returns the result object. With `control`
    (control.py's runs, never the benchmark's), it also holds under
    "control" the numbers of the float8 control put in the program's place
    on the same sample."""
    t0 = clock() if t0 is None else t0
    import torch

    from rag_docvqa_tpu_torch.config import build_caps, build_chunk_spec, build_engine, load_tokenizer
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.metrics import Evaluator

    from perfbench import check as chk
    from perfbench.stream import WARMUP, DocStream, Pool
    from perfbench.weights import load_into, make_weights

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, traffic = sp.cfg, sp.traffic
    c = cfg["engine"]
    fam = importlib.import_module(f"perfbench.families.{cfg['family']}")
    B = traffic["batch_size"]

    tok = load_tokenizer(cfg["tokenizer"])
    pool = Pool(traffic, seed)
    warm = DocStream(traffic, seed, WARMUP)
    ingestor = DocVQAIngestor(tok, build_chunk_spec(c), build_caps(c))
    # every block of the stream has the same sizes, so one block's caps are the stream's
    ingestor.caps = ingestor.plan_caps(pool.docs[:traffic["block_docs"]])
    params = fam.structure(c, tok.vocab_size, dev)
    weights = make_weights([(n, p.shape) for n, p in params.named_parameters()], seed, dev,
                           lambda name, shape: fam.leaf_init(name, shape, c), getattr(torch, cfg["dtype"]))
    load_into(params, weights)
    engine = build_engine(c, params, tok)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    recorder = Recorder()
    tap, itap, evaluator = EngineTap(engine, recorder), IngestTap(ingestor), Evaluator()

    images = "page_images" in traffic
    with fam.install(engine, recorder):
        itap.paint = warm.with_images if images else None
        evaluate(tap, warm.take(traffic["warmup_batches"] * B), itap, evaluator, batch_size=B)
        if cuda:
            torch.cuda.synchronize(dev)
        # the pool, the weights' host tree and the imports stay for the run:
        # the collector's full passes need not walk them in the window
        gc.collect()
        gc.freeze()
        setup_s = clock() - t0
        tap.calls.clear()
        itap.spans.clear()
        start = clock()
        end = start + seconds
        window = Window(tap, end, traffic["trace_batches"] if trace else 0)
        tap.before, tap.after = window.before, window.after
        itap.paint = pool.stream.with_images if images else None
        try:
            evaluate(tap, pool, itap, evaluator, batch_size=B)
        except Stop:
            pass
        finally:
            tap.before = tap.after = None
        _ingest_ended()
        gc.unfreeze()
        calls = list(tap.calls)
        loop_calls = calls if window.first is None else calls[:window.first]
        traced = [] if window.first is None else calls[window.first:]
        spans = [s for s in itap.spans if s[0] < end]
        summary = _summary(window.prof, cfg["stages"]) if window.prof is not None else None
    in_window = [cl for cl in loop_calls if cl.end <= end]
    vocab = tok.vocab_size
    data = RunData(sp, setup_s, start, in_window, spans,
                   [fam.call_work(c, vocab, cl.record) for cl in in_window] if trace else [], summary,
                   [fam.call_work(c, vocab, cl.record) for cl in traced])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window {seconds} s: {data.docs} documents in {len(in_window)} calls, the last done at "
        f"{data.used_s:.3f} s; {len(loop_calls) - len(in_window)} call(s) finished after it; "
        f"{pool.extended} documents made past the pool of {traffic['pool_docs']}; caps {ingestor.caps}")
    if in_window:
        log("inference s a call, in order: " + " ".join(f"{cl.end - cl.start:.3f}" for cl in in_window))

    del engine, tap.engine, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx = CheckInput(cfg, vocab, weights, dev, chk.sample(calls, pool.by_id, cfg["check_docs"], seed),
                     stream=pool.stream)
    numbers = fam.check(ctx)
    correct, checks = chk.verdict(numbers, cfg["limits"])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in sp.metrics[kind]:
        value = reader(m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": data.docs, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in summary.device_ops],
                               "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    result["checks"] = checks
    if control:
        result["control"] = fam.check(ctx, control=True)
    return result


def finite(x):
    """The result's numbers as strict JSON has them: a number that is not
    finite becomes 1e30, above every limit."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e30
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: List[str], t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one benchmark cell on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sp = spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < sp.chips:
        print(f"needs {sp.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    result = finite(run(sp, args.seed, args.seconds, bool(args.trace), t0=t0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded by the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r}) "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
