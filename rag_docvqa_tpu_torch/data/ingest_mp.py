"""Multi-process sharded host ingest.

The port's own copy of `rag_docvqa_tpu/data/ingest_mp.py`: `MPIngestor`
shards documents over a persistent pool of worker processes, each holding
its own `DocVQAIngestor` built from the picklable (tokenizer, ChunkSpec,
Caps), whose word-matrix cache stays warm across batches. Two shapes:

  * `MPIngestor.ingest(docs)` shards one batch over the workers (at least 2
    documents a shard) and concatenates the fixed-shape arrays along the
    batch axis: bit for bit the single-process ingest;
  * `MPIngestor.imap(doc_batches)` pipelines whole batches through the pool
    in order, at most `depth` in flight (the evaluation loop's shape).

Workers are started with spawn, never fork, so they inherit no CUDA state
of the parent, and each hides the card (`CUDA_VISIBLE_DEVICES=""`) in its
initializer, before it takes any work: no worker creates a CUDA context.
The host data layer they run (`data/contract.py`, `ingest.py`,
`tokenizer.py`, `ops/chunking.py`) imports numpy only, so a worker imports
torch only where the parent's main module does.
Page images and layouts are not sent back: the parent restores them from
its own documents.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rag_docvqa_tpu_torch.data.contract import Caps, ChunkedBatch, RawDocument
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.tokenizer import BaseTokenizer
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

_WORKER_ING: Optional[DocVQAIngestor] = None


def _worker_init(tokenizer: BaseTokenizer, spec: ChunkSpec, caps: Caps) -> None:
    # Hide the card before the worker takes any work: it never creates a CUDA
    # context beside the parent's.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _WORKER_ING
    _WORKER_ING = DocVQAIngestor(tokenizer, spec, caps)


def _worker_ingest(
    docs: List[RawDocument], caps: Caps
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    assert _WORKER_ING is not None
    # caps ride along with every task (a tiny int dataclass): pool tasks have
    # no worker affinity, so a broadcast-style caps update could miss a worker
    _WORKER_ING.caps = caps
    batch, aux = _WORKER_ING.ingest(docs)
    arrays = {f.name: np.asarray(getattr(batch, f.name)) for f in dataclasses.fields(batch)}
    # images/layouts may hold numpy pages; they pickle fine but can be big —
    # the parent already has the docs, so strip and restore there
    aux = {k: v for k, v in aux.items() if k not in ("images", "layouts")}
    return arrays, aux


class MPIngestor:
    """Duck-types DocVQAIngestor.ingest/plan_caps/answer_labels over a
    persistent spawn-context process pool. Construct with the same
    (tokenizer, spec, caps) — they must be picklable (all in-tree tokenizers
    are). Use as a context manager or call close()."""

    def __init__(
        self,
        tokenizer: BaseTokenizer,
        spec: Optional[ChunkSpec] = None,
        caps: Optional[Caps] = None,
        num_workers: Optional[int] = None,
    ) -> None:
        from concurrent.futures import ProcessPoolExecutor
        import multiprocessing as mp

        self.tokenizer = tokenizer
        self.spec = spec or ChunkSpec()
        self._caps = caps or Caps()
        self.num_workers = num_workers or max(1, (os.cpu_count() or 1) - 1)
        # local ingestor: plan_caps/answer_labels run in-parent (cheap), and
        # tiny batches skip the pool entirely
        self._local = DocVQAIngestor(tokenizer, self.spec, self._caps)
        self._pool = ProcessPoolExecutor(
            max_workers=self.num_workers,
            mp_context=mp.get_context("spawn"),
            initializer=_worker_init,
            initargs=(tokenizer, self.spec, self._caps),
        )

    # caps is a property so `ing.caps = ing.plan_caps(docs)` (the standard
    # sizing idiom) stays one assignment; workers receive caps per task
    @property
    def caps(self) -> Caps:
        return self._caps

    @caps.setter
    def caps(self, caps: Caps) -> None:
        self._caps = caps
        self._local.caps = caps

    def plan_caps(self, docs: Sequence[RawDocument]) -> Caps:
        return self._local.plan_caps(list(docs))

    def answer_labels(self, answers, max_len: int = 32, seed: int = 0) -> np.ndarray:
        return self._local.answer_labels(answers, max_len=max_len, seed=seed)

    # ------------------------------------------------------------------ #
    def ingest(self, docs: Sequence[RawDocument]) -> Tuple[ChunkedBatch, Dict[str, Any]]:
        """Shard one batch of docs over the pool; bit-identical to the
        single-process ingest (each worker packs its row range with the
        shared caps; arrays concatenate along the batch axis)."""
        docs = list(docs)
        B = len(docs)
        # effective worker count: at least 2 docs per shard so the per-task
        # pickling overhead amortizes; shrink W rather than no-op the pool
        # (with W pinned to num_workers, typical eval batches of 8 docs would
        # silently run in-parent forever)
        W = min(self.num_workers, B // 2)
        if W <= 1:
            return self._local.ingest(docs)
        bounds = np.linspace(0, B, W + 1).astype(int)
        futs = [
            self._pool.submit(_worker_ingest, docs[bounds[w] : bounds[w + 1]], self._caps)
            for w in range(W)
        ]
        parts = [f.result() for f in futs]
        arrays = {
            k: np.concatenate([p[0][k] for p in parts], axis=0)
            for k in parts[0][0]
        }
        aux = _merge_aux([p[1] for p in parts], docs)
        return ChunkedBatch(**arrays), aux

    def imap(
        self, doc_batches: Iterable[Sequence[RawDocument]], depth: Optional[int] = None
    ) -> Iterator[Tuple[ChunkedBatch, Dict[str, Any]]]:
        """Pipeline whole batches through the pool, preserving order, with at
        most `depth` (default: num_workers + 1) in flight."""
        from collections import deque

        depth = depth or self.num_workers + 1
        pending: deque = deque()
        it: Optional[Iterator] = iter(doc_batches)

        def _refill():
            nonlocal it
            while it is not None and len(pending) < depth:
                try:
                    docs = list(next(it))
                except StopIteration:
                    it = None
                    return
                pending.append((self._pool.submit(_worker_ingest, docs, self._caps), docs))

        try:
            _refill()
            while pending:
                fut, docs = pending.popleft()
                arrays, aux = fut.result()
                _refill()  # keep the pool fed while the consumer computes
                yield ChunkedBatch(**arrays), _merge_aux([aux], docs)
        finally:
            for fut, _ in pending:
                fut.cancel()

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "MPIngestor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _merge_aux(parts: List[Dict[str, Any]], docs: List[RawDocument]) -> Dict[str, Any]:
    aux: Dict[str, Any] = {}
    for k in parts[0]:
        v = parts[0][k]
        aux[k] = [x for p in parts for x in p[k]] if isinstance(v, list) else v
    # restore the stripped host-side fields from the parent's docs
    aux["images"] = [d.images for d in docs]
    aux["layouts"] = [d.layout for d in docs]
    return aux
