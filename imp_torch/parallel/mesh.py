"""The process mesh — the torch counterpart of ``imp_tpu/parallel/mesh.py``.

JAX lays one process's devices out as a ``Mesh`` and lets XLA insert the
collectives.  Here each rank is one process driving one device, started by
``torchrun`` (or :func:`imp_torch.parallel.launch.spawn`), and
:func:`make_mesh` lays the world of ranks out as a ``(data, seq)`` grid,
row-major over ``TPU.MESH_AXES``, with one process group per row and column
(:class:`~imp_torch.parallel.collectives.Axis`).  A world of one is the
single-card path: both axes have size 1 and every collective is the
identity.

Every rank's loader builds the same full global batch (the loaders are
seeded and deterministic), and :func:`shard_batch` keeps this rank's part:
dim 0 split over ``data`` (after a wrap-pad to a multiple of its size),
the token dim of the keys in ``seq_keys`` split over ``seq``, the keys in
``replicated_keys`` whole.  :func:`fetch_global` gathers data-split
outputs back onto every rank, as JAX's ``fetch_global`` does on a pod, so
every rank computes the same metrics.  :func:`replicate_module` broadcasts
rank 0's parameters (JAX's ``replicate_tree``).

The card of a rank is ``cuda:LOCAL_RANK``; where fewer cards than local
ranks exist, ranks share them (``LOCAL_RANK`` modulo the count) and talk
over gloo.  The CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import deferred
from .collectives import Axis, broadcast_tensors

MESH_AXES = ("data", "seq")
#: how long a collective of torchrun's ranks waits for the others before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and dumps."""
    return world()[0] == 0


def backend_for(device: str, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo (CPU
    ranks, or ranks sharing a card through host-staged collectives)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:LOCAL_RANK`` (modulo the cards there are) for a CUDA device,
    else ``device`` as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


def maybe_initialize_distributed(device: str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a no-op for a single process.  Returns this rank's
    device."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device, local_rank)
    if world_size > 1 and not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(device, local_world), init_method="env://",
                                timeout=TIMEOUT)
    return dev


@dataclass
class Mesh:
    """The ``(data, seq)`` layout of the world, seen from this rank."""

    shape: Dict[str, int]
    data: Axis
    seq: Axis
    world: Axis  # every rank: the gradient reduction and the broadcasts
    device: torch.device

    @property
    def size(self) -> int:
        return self.world.size


def _resolve_shape(shape: Sequence[int], n: int) -> list:
    shape = [int(s) for s in shape]
    known = int(np.prod([s for s in shape if s != -1])) if shape else 1
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one -1")
    if -1 in shape:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, the "
                         f"world has {n}: start as many (torchrun --nproc-per-node)")
    return shape


def make_mesh(axes: Sequence[str] = ("data",), shape: Sequence[int] = (-1,),
              device="cpu") -> Mesh:
    """The mesh of ``axes`` × ``shape`` over the world (``-1`` absorbs the
    remaining ranks).  Axes other than ``data`` and ``seq`` raise; a missing
    one has size 1.  Every rank must call it, in the same order as the
    others (it creates the process groups)."""
    axes = tuple(axes)
    for a in axes:
        if a not in MESH_AXES:
            raise deferred(f"mesh axis {a!r} (tensor/pipeline parallelism)", 8)
    if len(axes) != len(shape):
        raise ValueError(f"TPU.MESH_AXES {axes} and TPU.MESH_SHAPE {tuple(shape)} differ in length")
    rank, n = world()
    dims = dict(zip(axes, _resolve_shape(shape, n)))
    full = [dims.get(a, 1) for a in MESH_AXES]  # (data, seq), row-major
    grid = np.arange(n).reshape(full)
    coord = [int(c) for c in np.unravel_index(rank, full)]

    def axis(k: int) -> Axis:
        name = MESH_AXES[k]
        if full[k] == 1:
            return Axis(name, ranks=[rank])
        mine = None
        lines = np.moveaxis(grid, k, -1).reshape(-1, full[k])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = Axis(name, full[k], coord[k], group, [int(r) for r in line])
        return mine

    data, seq = axis(0), axis(1)
    everyone = (Axis("world", n, rank, dist.group.WORLD, list(range(n))) if n > 1
                else Axis("world", ranks=[0]))
    return Mesh({"data": full[0], "seq": full[1]}, data, seq, everyone, torch.device(device))


def host_local_slice(global_batch_size: int, axis: Axis) -> Tuple[int, int]:
    """(start, size) of this rank's part of a batch split over ``axis``."""
    if global_batch_size % axis.size:
        raise ValueError(f"batch {global_batch_size} not divisible by {axis.name}-axis "
                         f"size {axis.size}")
    per = global_batch_size // axis.size
    return axis.index * per, per


def shard_batch(arrays: Dict[str, np.ndarray], mesh: Mesh, seq_keys: Iterable[str] = (),
                replicated_keys: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch whose dim 0 is already a multiple of
    the data-axis size, as tensors on the mesh's device."""
    seq_keys, replicated_keys = set(seq_keys), set(replicated_keys)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k not in replicated_keys and v.ndim > 0:
            start, per = host_local_slice(v.shape[0], mesh.data)
            v = v[start:start + per]
            if k in seq_keys and mesh.seq.size > 1:
                if v.shape[1] % mesh.seq.size:
                    raise ValueError(
                        f"{k} token dim {v.shape[1]} not divisible by seq-axis size "
                        f"{mesh.seq.size}: pick DATASET.BAG_PAD as a multiple of it")
                start, per = host_local_slice(v.shape[1], mesh.seq)
                v = v[:, start:start + per]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
    return out


def fetch_global(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A data-split output with every rank's rows, in rank order, on every
    rank (no gradient)."""
    from .collectives import _gather

    return t.detach() if mesh.data.size == 1 else _gather(mesh.data, t, 0)


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers on every rank."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()), mesh.world)


def barrier() -> None:
    """Wait for every rank (a no-op for a single process)."""
    if world()[1] > 1:
        dist.barrier()
