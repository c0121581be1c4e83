"""Parallelism over a mesh of processes, one rank per card — the torch
counterpart of ``imp_tpu/parallel/``: the ``(data, seq, model, pipe)``
mesh (:mod:`.mesh`), the collectives (:mod:`.collectives`), sequence
parallelism of the bag (:mod:`.sequence`), and tensor and pipeline
parallelism of the CLIP towers (:mod:`.tensor`, :mod:`.pipeline`)."""

from .collectives import (
    LOCAL,
    Axis,
    all_gather,
    all_reduce_grads,
    pmax,
    psum,
    replicate_from,
    shift,
)
from .mesh import (
    Mesh,
    barrier,
    fetch_global,
    host_local_slice,
    is_primary,
    make_mesh,
    maybe_initialize_distributed,
    replicate_module,
    shard_batch,
)

__all__ = [
    "LOCAL",
    "Axis",
    "Mesh",
    "all_gather",
    "all_reduce_grads",
    "barrier",
    "fetch_global",
    "host_local_slice",
    "is_primary",
    "make_mesh",
    "maybe_initialize_distributed",
    "pmax",
    "psum",
    "replicate_from",
    "replicate_module",
    "shard_batch",
    "shift",
]
