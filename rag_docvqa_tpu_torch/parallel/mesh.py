"""Process groups over `torch.distributed`, laid out as a device mesh.

Counterpart of `rag_docvqa_tpu/parallel/mesh.py`. Axis conventions, as
there:
  * "data"  -- the batch and the index-shard axis: each rank holds its rows,
               and the collectives are all-gathers of small top-k tuples and
               the all-reduce of the gradients;
  * "model" -- the axis over which `training/train_step.py::vt5_param_spec`
               splits the generator's weights: a rank stores its slice, and
               the whole weight is all-gathered before a layer uses it.

Ranks lie on the mesh in row-major order (rank = coords[0] * shape[1] +
coords[1]), and each axis has one process group per line of the mesh along
it, its members in ascending rank, so a group's rank order is the order of
the axis. `all_gather` returns the members' tensors in that order.

The backend is NCCL on the card and gloo on the CPU. NCCL refuses two ranks
on one GPU, so ranks that share a card run gloo on CUDA tensors; gloo has no
all-gather for CUDA tensors, and the helpers below copy such a tensor to the
host and back, a choice made from the group's backend and the tensor's
device, never by catching an error.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT_S = 300  # every collective fails after this instead of waiting


@dataclass
class Mesh:
    """A `shape` of ranks with named axes, this rank's coordinates, one
    process group per axis (the line of the mesh through this rank) and the
    device this rank computes on."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    device: torch.device

    def size(self, axis: str) -> int:
        """The length of `axis`; 1 for an axis the mesh does not have."""
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`; 0 for an axis the mesh does not have."""
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    @property
    def first(self) -> bool:
        """Whether this is the mesh's first rank (the one that prints and writes)."""
        return not any(self.coords)

    def _staged(self, axis: str, t: torch.Tensor) -> bool:
        """Whether a collective over `axis` must take `t` through the host:
        gloo on a CUDA tensor."""
        return t.is_cuda and dist.get_backend(self.groups[axis]) == "gloo"

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every member's `t` (equal shapes and dtypes), in the axis's order."""
        if axis not in self.axis_names:
            return [t]
        src = t.detach().contiguous()
        if self._staged(axis, src):
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(out, src, group=self.groups[axis])
        return [o.to(t.device) for o in out]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every member's `t`, written into `t` and returned."""
        if axis not in self.axis_names:
            return t
        if self._staged(axis, t):
            host = t.detach().cpu()
            dist.all_reduce(host, group=self.groups[axis])
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.groups[axis])
        return t

    def all_gather_object(self, obj: Any, axis: str) -> List[Any]:
        """Every member's picklable `obj`, in the axis's order."""
        if axis not in self.axis_names:
            return [obj]
        out = [None] * self.size(axis)
        dist.all_gather_object(out, obj, group=self.groups[axis])
        return out


def _device_for(device, backend: str) -> torch.device:
    """`device` as a torch.device: "cpu", "cuda" (the card LOCAL_RANK names)
    or a torch.device / "cuda:N" as it is."""
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return device


def create_mesh(shape: Tuple[int, ...], axis_names: Sequence[str] = ("data", "model"),
                device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of every rank of the initialized default process group.
    The product of `shape` must be the world size. Every rank calls this with the same arguments (it
    creates the groups of every line of the mesh). `device`: "cpu", "cuda"
    (cuda:LOCAL_RANK) or a device; by default cuda:LOCAL_RANK under NCCL and
    the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialized (init_from_env or init_with_store)")
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_names = tuple(axis_names)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, have {world}")
    ranks = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for i, axis in enumerate(axis_names):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line], timeout=timeout)
            if rank in line:
                groups[axis] = group
    dev = _device_for(device, dist.get_backend())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # the device NCCL's object collectives use
    return Mesh(shape=shape, axis_names=axis_names, coords=coords, groups=groups, device=dev)


def default_mesh(data_parallel: Optional[int] = None, device=None) -> Mesh:
    """Every rank on the data axis (the retrieval-index layout), or
    `data_parallel` ranks on it and the rest on the model axis."""
    world = dist.get_world_size()
    dp = data_parallel or world
    if world % dp:
        raise ValueError(f"{world} ranks do not divide into {dp} on the data axis")
    return create_mesh((dp, world // dp), ("data", "model"), device=device)


def init_from_env(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group `torchrun` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns this rank's device.
    The backend is NCCL for a CUDA device and gloo for the CPU."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s))
    return device


def under_torchrun() -> bool:
    """Whether this process was started by `torchrun` (or another launcher
    that sets RANK and WORLD_SIZE)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def mesh_from_env(device) -> Optional[Mesh]:
    """Under `torchrun`, the mesh of every rank on the data axis (the CLIs'
    data-parallel form); else None."""
    return default_mesh(device=init_from_env(device)) if under_torchrun() else None


def init_with_store(store_path: str, rank: int, world_size: int, backend: str,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a process group whose rendezvous is a `FileStore` at
    `store_path` (no network)."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


# --------------------------------------------------------------------------- #
# several ranks from one call
# --------------------------------------------------------------------------- #
def _rank_entry(rank: int, fn: Callable, world_size: int, backend: str, workdir: str, timeout_s: float,
                args: tuple) -> None:
    init_with_store(os.path.join(workdir, "store"), rank, world_size, backend, timeout_s)
    try:
        result = fn(rank, *args)
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        if dist.is_initialized():  # `fn` may have ended the group itself (the CLIs do)
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), backend: str = "gloo", workdir: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: float = 4 * DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run fn(rank, *args) in `world_size` spawned processes joined in one
    process group (a FileStore under `workdir`, a temporary directory by
    default) and return each rank's picklable result, in rank order. If a
    rank raises, the others are stopped and the error is raised here. A
    collective that waits longer than `timeout_s` fails, and ranks still
    running `deadline_s` after the start (the whole run: imports, every
    case) are stopped and a TimeoutError raised."""
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        context = mp.start_processes(_rank_entry, args=(fn, world_size, backend, tmp, timeout_s, args),
                                     nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + deadline_s
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in context.processes:
                    p.kill()
                raise TimeoutError(f"{world_size} ranks still running after {deadline_s} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


# --------------------------------------------------------------------------- #
# rows over the data axis, weight slices over the model axis
# --------------------------------------------------------------------------- #
def local_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous share of `n` rows split evenly over `axis`."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide over the {size} ranks of the {axis} axis")
    per = n // size
    return slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)


def split_leaf(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of `t` along `dim`, split evenly over the model axis."""
    rows = local_rows(t.shape[dim], mesh, "model")
    return t.narrow(dim, rows.start, rows.stop - rows.start).clone()


class _GatherSlices(torch.autograd.Function):
    """Forward: for each slice, the model axis members' slices along its
    dimension, concatenated in the axis's order, all through one all-gather
    of a flat buffer (the slices share a dtype). Backward: each gradient's
    part of this rank, not summed over the axis: every member of the axis
    computed the whole gradient from the same rows, so a sum would count it
    `size` times."""

    @staticmethod
    def forward(ctx, dims, mesh: Mesh, *slices):
        ctx.dims, ctx.index, ctx.lens = dims, mesh.index("model"), [t.shape[d] for t, d in zip(slices, dims)]
        members = mesh.all_gather(torch.cat([t.reshape(-1) for t in slices]), "model")
        pieces = [m.split([t.numel() for t in slices]) for m in members]
        return tuple(torch.cat([p[i].view(t.shape) for p in pieces], dim=d) for i, (t, d) in enumerate(zip(slices, dims)))

    @staticmethod
    def backward(ctx, *grads):
        out = [None if g is None or not need else g.narrow(d, ctx.index * n, n).contiguous()
               for g, d, n, need in zip(grads, ctx.dims, ctx.lens, ctx.needs_input_grad[2:])]
        return (None, None, *out)


def shard_params(module: nn.Module, split: Dict[str, Optional[int]], mesh: Mesh) -> nn.Module:
    """In place: each parameter that `split` gives a dimension becomes this
    rank's slice of it along that dimension over the model axis
    (`requires_grad` kept); the others stay whole. Returns `module`."""
    for name, p in list(module.named_parameters()):
        dim = split.get(name)
        if dim is None:
            continue
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        leaf = name.rpartition(".")[2]
        owner._parameters[leaf] = nn.Parameter(split_leaf(p.data, dim, mesh), requires_grad=p.requires_grad)
    return module


def gathered_params(module: nn.Module, split: Dict[str, Optional[int]], mesh: Mesh,
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A copy of the module tree whose split parameters are whole again
    (one all-gather over the model axis a dtype, differentiable back to the slices, see
    `_GatherSlices`) and, with `dtype`, every floating parameter cast to it
    first (a differentiable cast, so the gather moves the narrower type).
    The copy shares no gradient storage with the slices: their gradients
    come back through autograd."""
    import copy

    leaves = {n: p.to(dtype) if dtype is not None and p.is_floating_point() else p
              for n, p in module.named_parameters(remove_duplicate=False)}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n, t in leaves.items():
        if split.get(n) is not None:
            by_dtype.setdefault(t.dtype, []).append(n)
    for names in by_dtype.values():
        whole = _GatherSlices.apply(tuple(split[n] for n in names), mesh, *(leaves[n] for n in names))
        leaves.update(zip(names, whole))

    def rebuild(m: nn.Module, prefix: str) -> nn.Module:
        out = copy.copy(m)
        out._parameters = {n: None if p is None else leaves[prefix + n] for n, p in m._parameters.items()}
        out._modules = {n: None if c is None else rebuild(c, f"{prefix}{n}.") for n, c in m._modules.items()}
        return out

    return rebuild(module, "")
