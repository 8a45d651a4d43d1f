"""Asynchronous input pipeline: overlap host ingest with device compute.

A copy of `rag_docvqa_tpu/data/prefetch.py` (which imports no jax, but
its package `rag_docvqa_tpu/data/__init__.py` does). `prefetch` runs the
producer on a background thread with a bounded queue, so batch N+1 is
ingested (and copied to the device) while the device computes batch N.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(items: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from `items`, producing up to `depth` elements ahead on a
    background thread. Exceptions in the producer re-raise at the consumer.
    depth <= 0 disables prefetching (plain iteration)."""
    if depth <= 0:
        yield from items
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(entry) -> bool:
        # bounded put that aborts when the consumer has gone away — a plain
        # q.put could block forever if the consumer exits mid-ingest (one
        # drain pass can hit Empty while the producer is still ingesting)
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for item in items:
                if not _put((False, item)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            _put((True, e))
        finally:
            _put((False, _SENTINEL))

    t = threading.Thread(target=_worker, daemon=True, name="ingest-prefetch")
    t.start()
    try:
        while True:
            is_err, item = q.get()
            if is_err:
                raise item
            if item is _SENTINEL:
                break
            yield item
    finally:
        # consumer stopped (normally or early): tell the producer, then drain
        # until it exits so no ingested batch stays pinned on device
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)


def map_prefetch(fn: Callable[[T], object], items: Iterable[T], depth: int = 2) -> Iterator[object]:
    """prefetch(map(fn, items)) — fn runs on the background thread."""
    return prefetch((fn(x) for x in items), depth=depth)
