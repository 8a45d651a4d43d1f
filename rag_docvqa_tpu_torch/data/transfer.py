"""Host -> device batch transfer with narrow token ids.

Counterpart of `rag_docvqa_tpu/data/transfer.py`. Its `sharding=` form, the
data-parallel eval's, has no argument here: under a mesh `engine/evaluate.py`
picks each rank's rows before the copy, and each rank copies its own rows to
its own device with these functions. The token-id arrays of a
`ChunkedBatch` (`TOKEN_FIELDS`) are most of its bytes, and their ids fit
int16 whenever the tokenizer's vocabulary is below 2**15 (T5's 32128 does,
Qwen's 151936 does not). `device_put_batch` narrows them to int16 when the
vocabulary allows and every id is in [0, 2**15) (JAX's min/max scan, here
one bitwise-or pass an array; an id out of range leaves every field as it
is), writing them straight into one pinned staging buffer beside every
other field, grouped by dtype at 16-byte offsets, and copies the buffer with
one non-blocking copy on a stream of its own. On the device each integer
group is widened to int64 by one cast, and every field is a view of its
group, so the result equals `contract.to_device(batch, device)` field by
field, dtype included.

`device_put_batch_async` returns a `PendingBatch` at once: the copy and the
widening are queued on the side stream behind an event. `wait()` makes the
calling thread's current stream wait on that event and marks the batch's
device memory as used by that stream (`record_stream`), so the caching
allocator reuses none of it early. This is the form for a producer thread
(`engine/evaluate.py` ingests on `data/prefetch.py`'s thread): the producer
queues the copy, the consumer calls `wait()` before the engine reads the
batch. The staging buffer comes from PyTorch's pinned host allocator, which
records the copy's completion on it, so it is not handed out again before the
copy has read it. On a CPU device the same packing and widening run
synchronously, without pinning.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch

TOKEN_FIELDS = ("chunk_emb_tokens", "q_tokens", "slot_tokens", "raw_tokens", "prompt_tokens")
_ALIGN = 16


def narrow_tokens(batch: ChunkedBatch, vocab_size: int) -> bool:
    """Whether the token fields travel as int16: a vocabulary below 2**15 and
    every id in [0, 2**15) (no bit at 15 or above set: a negative id has its
    sign bit). A tokenizer whose ids exceed its stated vocabulary (added
    specials) leaves the batch as it is rather than wrap negative."""
    if vocab_size >= (1 << 15):
        return False
    return all(int(np.bitwise_or.reduce(a, axis=None)) >> 15 == 0
               for a in (np.asarray(getattr(batch, f)) for f in TOKEN_FIELDS) if a.size)


class PendingBatch:
    """A batch whose copy to the device is queued: `wait()` gives the
    `ChunkedBatch` of device tensors, safe to read on the calling thread's
    current stream. `nbytes` is the size of the one host -> device copy."""

    def __init__(self, batch: ChunkedBatch, event, staging, device_buffers, nbytes: int):
        self._batch, self._event, self._staging, self._buffers = batch, event, staging, device_buffers
        self.nbytes = nbytes

    def wait(self) -> ChunkedBatch:
        if self._event is not None:
            import torch

            stream = torch.cuda.current_stream(self._buffers[0].device)
            stream.wait_event(self._event)
            for t in self._buffers:
                t.record_stream(stream)
            self._event = None
        self._staging = None
        return self._batch


def _plan(batch: ChunkedBatch, narrow: bool):
    """Fields grouped by the dtype they travel in (int16 ids first when
    narrowed), each group 16-byte aligned: [(dtype, [(name, array, offset in
    the group)], group offset, group bytes)] and the total size."""
    groups: Dict[np.dtype, List[Tuple[str, np.ndarray]]] = {}
    for f in dataclasses.fields(batch):
        a = np.asarray(getattr(batch, f.name))
        dt = np.dtype(np.int16) if narrow and f.name in TOKEN_FIELDS else a.dtype
        groups.setdefault(dt, []).append((f.name, a))
    plan, end = [], 0
    for dt, fields in groups.items():
        start, members = end, []
        for name, a in fields:
            members.append((name, a, end - start))
            end += -(-a.size * dt.itemsize // _ALIGN) * _ALIGN
        plan.append((dt, members, start, end - start))
    return plan, max(end, _ALIGN)


def device_put_batch_async(batch: ChunkedBatch, vocab_size: int, device) -> PendingBatch:
    """Queue the copy of a numpy `ChunkedBatch` to `device` (see the module
    docstring); token ids travel as int16 when `narrow_tokens` allows."""
    import torch

    device = torch.device(device)
    plan, total = _plan(batch, narrow_tokens(batch, vocab_size))
    cuda = device.type == "cuda"
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    host = staging.numpy()
    for dt, members, start, _ in plan:
        for _, a, off in members:
            o = start + off
            np.copyto(host[o:o + a.size * dt.itemsize].view(dt).reshape(a.shape), a, casting="unsafe")

    def unpack(buffer) -> Tuple[Dict[str, "torch.Tensor"], list]:
        out, buffers = {}, [buffer]
        for dt, members, start, size in plan:
            group = buffer[start:start + size].view(torch.from_numpy(np.empty(0, dt)).dtype)
            if dt.kind in "iu":
                group = group.to(torch.int64)
                buffers.append(group)
            for name, a, off in members:
                out[name] = group[off // dt.itemsize:off // dt.itemsize + a.size].view(a.shape)
        return out, buffers

    if not cuda:
        fields, buffers = unpack(staging)
        return PendingBatch(ChunkedBatch(**fields), None, None, buffers, total)
    stream = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        fields, buffers = unpack(staging.to(device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return PendingBatch(ChunkedBatch(**fields), event, staging, buffers, total)


def device_put_batch(batch: ChunkedBatch, vocab_size: int, device) -> ChunkedBatch:
    """`device_put_batch_async(...).wait()`: the batch on `device`, ready for
    the calling thread's current stream; equal to `to_device(batch, device)`."""
    return device_put_batch_async(batch, vocab_size, device).wait()
