"""What the benchmark reads from the timed path, without changing it.

`EngineTap` and `IngestTap` are delegating wrappers that `evaluate` is
given in place of the engine and the ingestor: they time each call on the
host and keep the engine's own stage `timings`. `Recorder` keeps, call by
call, what the timed path itself produced (the chosen chunks, the generator
rows, the served tokens), through wrappers that a family installs around the
engine's functions for the length of a run and takes away after it. They
hold references only: nothing is copied and nothing waits for the device.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

clock = time.perf_counter


@dataclass
class Call:
    start: float
    end: float
    rows: int
    question_ids: List[int]
    timings: Dict[str, float]
    record: Dict[str, Any] = field(default_factory=dict)


class Recorder:
    def __init__(self):
        self.current: Dict[str, Any] = {}

    def begin(self) -> Dict[str, Any]:
        self.current = {}
        return self.current

    def put(self, **values) -> None:
        self.current.update(values)


class Stop(Exception):
    """Raised by a hook of `EngineTap` to end the `evaluate` call it is in."""


class EngineTap:
    """Stands in for the engine in `evaluate`. `before` and `after`, when
    set, are called with the call's index before and after it: they start
    and stop the profiler, and end the run's `evaluate` by raising `Stop`
    (the call is recorded first)."""

    def __init__(self, engine, recorder: Recorder):
        self.engine, self.recorder = engine, recorder
        self.device = engine.device
        self.calls: List[Call] = []
        self.before: Optional[Callable[[int], None]] = None
        self.after: Optional[Callable[[int], None]] = None
        self.annotate = False

    def inference(self, batch, aux=None):
        i = len(self.calls)
        if self.before is not None:
            self.before(i)
        record = self.recorder.begin()
        t0 = clock()
        if self.annotate:
            import torch

            with torch.profiler.record_function("perfbench.inference"):
                out = self.engine.inference(batch, aux)
        else:
            out = self.engine.inference(batch, aux)
        t1 = clock()
        self.calls.append(Call(t0, t1, batch.batch_size, list(aux["question_ids"]), dict(out.get("timings", {})),
                               record))
        if self.after is not None:
            self.after(i)
        return out


class IngestTap:
    """Stands in for the ingestor in `evaluate` (on its prefetch thread).
    `paint`, when set, is called with each batch's documents and gives them
    their page images before the ingestor sees them (`DocStream.with_images`):
    where a deployment decodes its image files, inside the ingest's span."""

    def __init__(self, ingestor):
        self.ingestor = ingestor
        self.tokenizer = ingestor.tokenizer
        self.spans: List[tuple] = []
        self.paint: Optional[Callable[[list], list]] = None

    def ingest(self, docs):
        t0 = clock()
        if self.paint is not None:
            docs = self.paint(docs)
        out = self.ingestor.ingest(docs)
        self.spans.append((t0, clock()))
        return out


@contextmanager
def wrapped(owner, name: str, after: Callable):
    """owner.name replaced, for the block, by a function that calls the
    original and then `after(result, *args, **kwargs)`, returning the result."""
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        after(out, *args, **kwargs)
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        if isinstance(owner, type) or not hasattr(type(owner), name):
            setattr(owner, name, original)
        else:
            delattr(owner, name)  # an instance attribute over the class's method
