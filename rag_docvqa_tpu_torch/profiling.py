"""The port's tracer: named host spans and counters, off by default.

  * `span(name, batch=-1)`: a context manager around a region of host code.
    When on, it keeps the span's name, thread, parent (the span open on the
    same thread when it began), batch index (given, else the parent's) and
    its start and end on `time.perf_counter_ns()`, the clock of
    `time.perf_counter`. While a `torch.profiler` session runs, it also opens
    a `record_function` range of the same name, so the span sits in the
    device trace's timeline and a launch can be put down to the span that
    made it.
  * `count(name, n)` keeps a host count; `device_count(name, t)` keeps the
    sum of a mask or integer tensor, taken on the tensor's device. Each
    count is kept with its time, so a reader takes the counts of any window.
  * `enable()`, `disable()`, `reset()` and `read()` switch the tracer and
    read it: `read()` gives every span and count kept since the last
    `reset()`, the device sums brought to the host in one copy a device, so
    it is called once the traced work is done.

The rules that keep it out of the timed path: when off (the default),
`span` returns one shared no-op context and reads no clock, and the
counters return at once; when on, no span or counter synchronizes a device
(the engines end their stages on `engine/stages.py`'s clock, inside the
stage's spans), reads a device value on the host or copies one back: a
device count is one reduction launched beside the work it counts. The
module imports no torch, so the data layer's worker processes import it freely.

The spans and counters of the serving path, by layer: `evaluate.wait`,
`evaluate.inference`, `evaluate.score` (`engine/evaluate.py`), `ingest.batch`
and its child `ingest.transfer` on the prefetch thread (`evaluate`,
`data/transfer.py`); `engine.retrieve`, `engine.assemble`, `engine.encode`,
`engine.decode` and `engine.answers` (`engine/rag_vt5.py`,
`engine/hivt5_engine.py`, `models/hivt5.py::generate`, where `engine.encode`
has the children `hivt5.pages` and `hivt5.page_head`); a stage's time in a
call is the sum of its spans there. `decode.step`, one a step, with
`decode.self_attn`, `decode.cross_attn` and `decode.ffn` one each a layer,
and `decode.head` (the final norm and LM head in `models/t5.py::decode_step`,
then the argmax, confidence and done flags in
`ops/decode.py::greedy_decode`), twice a step; where the step is a
replayed CUDA graph, `decode.step` is one replay and its children fire only
while the step is warmed up and captured. The counters
`encode.tokens_valid` (device) and `encode.positions` (host): the valid and
all positions of the rows each engine hands to the encoder; the decode's
`decode.graph_captures`, `decode.graph_replays` and `decode.eager_steps`
(host): the graphs captured, the steps replayed and the steps run eagerly;
the causal LM's `lm.glue_fused` and `lm.glue_plain` (host,
`models/causal_lm.py`): one a layer of each pass over the layers (the stack,
a decode step), by whether that layer's elementwise glue took its kernels;
the Qwen2.5-VL tower's `vision.mlp_padded` and `vision.mlp_plain` (host,
`models/qwen25_vision.py`): one a layer a tower call, by whether that
layer's feed-forward read the copy padded to an 8-aligned intermediate;
the expert layer's (`models/moe.py`) span `moe.layer` with its children
`moe.route`, `moe.experts` and `moe.shared`, the host counter `moe.layers`
(one a layer a pass) and the device counters `moe.tokens`,
`moe.routed_pairs`, `moe.null_picks` and `moe.one_pick`. The benchmark's
`perfbench/spans.py` and its readers in `perfbench/metrics/` read them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional


class Span(NamedTuple):
    id: int  # its place in `read().spans`
    name: str
    thread: int  # `threading.get_ident()` of the thread that opened it
    parent: int  # the id of the span open on the same thread when it began, -1 for none
    batch: int  # the batch index given to it or to its nearest ancestor that had one, -1 for none
    start_ns: int
    end_ns: int  # -1 while it is open

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns if self.end_ns >= 0 else 0


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


class Trace(NamedTuple):
    spans: List[Span]
    counts: List[Count]


_on = False
_torch = None  # the torch module, bound by `enable()`
_local = threading.local()
_spans: List["_Open"] = []
_counts: List[tuple] = []  # (name, t_ns, int or 0-d tensor); list.append is atomic
_NOOP = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "thread", "parent", "batch", "start", "end", "rf")

    def __init__(self, name: str, batch: int):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.batch < 0 and parent is not None:
            self.batch = parent.batch
        self.thread = threading.get_ident()
        self.end = -1
        self.rf = None
        if _torch._C._autograd._profiler_enabled():
            self.rf = _torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _local.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def span(name: str, batch: int = -1):
    """A span named `name` (module docstring); the shared no-op when off."""
    if not _on:
        return _NOOP
    return _Open(name, batch)


def count(name: str, n: int) -> None:
    if _on:
        _counts.append((name, time.perf_counter_ns(), int(n)))


def device_count(name: str, t) -> None:
    """Keeps `t.sum()` (a mask or integer tensor), left on `t`'s device."""
    if _on:
        _counts.append((name, time.perf_counter_ns(), t.sum()))


def enabled() -> bool:
    """Whether the tracer is on: a caller that must launch work to count
    (a mask made only for a device count) asks first."""
    return _on


def enable() -> None:
    global _on, _torch
    import torch

    _torch, _on = torch, True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drops what was kept; spans open now are kept by no later `read()`."""
    _spans.clear()
    _counts.clear()


def read() -> Trace:
    opened = list(_spans)
    ids = {id(s): i for i, s in enumerate(opened)}
    spans = [Span(i, s.name, s.thread, ids.get(id(s.parent), -1) if s.parent is not None else -1, s.batch,
                  s.start, s.end) for i, s in enumerate(opened)]
    kept = list(_counts)
    values: Dict[int, int] = {}
    on_device: Dict[object, List[int]] = {}
    for i, (_, _, n) in enumerate(kept):
        if isinstance(n, int):
            values[i] = n
        else:
            on_device.setdefault(n.device, []).append(i)
    for idx in on_device.values():
        for i, v in zip(idx, _torch.stack([kept[i][2] for i in idx]).tolist()):
            values[i] = int(v)
    return Trace(spans, [Count(name, t, values[i]) for i, (name, t, _) in enumerate(kept)])


def self_ns(spans: Iterable[Span]) -> Dict[int, int]:
    """Each span's duration less the part its children cover (children nest
    inside their parent on one thread, so that part is the children's summed
    duration), by span id."""
    spans = list(spans)
    out = {s.id: s.dur_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.dur_ns
    return out


def total(counts: Iterable[Count], name: str, lo_ns: Optional[int] = None, hi_ns: Optional[int] = None) -> int:
    """The sum of the counts named `name` kept in [lo_ns, hi_ns]."""
    return sum(c.n for c in counts if c.name == name and (lo_ns is None or c.t_ns >= lo_ns)
               and (hi_ns is None or c.t_ns <= hi_ns))
