"""Pipeline (stage) parallelism for the CLIP/PLIP vision tower — the torch
counterpart of ``imp_tpu/parallel/pipeline.py``.

The ViT's residual blocks are split into ``pp`` contiguous stages over the
``pipe`` axis of a process mesh, and microbatches flow through the stages
GPipe-style: T = MB + pp − 1 ticks; at tick t, stage s runs microbatch
t − s through its blocks and hands the activation to stage s + 1 (one
point-to-point hop, :func:`~imp_torch.parallel.collectives._shift` without
wrap-around: ``batch_isend_irecv`` under NCCL, staged through the host
under gloo).  A stage that holds no valid microbatch at a tick does not
compute (JAX computes on a clamped microbatch and never collects it; the
outputs are the same).  The last stage collects microbatch t − (pp − 1),
and at the end its outputs reach every stage by a broadcast (JAX's psum of
the outputs masked to the last stage: the same bits).

The stage boundaries (patchify, embeddings, ``ln_pre``; ``ln_post`` and
``proj``) run replicated on every stage, as in JAX; each rank holds only
its own ``layers/pp`` blocks (:func:`put_pp_params`), run by the port's own
``ResidualAttentionBlock`` code.  Nothing takes a gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from ..models.clip import ResidualAttentionBlock
from .collectives import _shift, broadcast_tensors
from .mesh import Mesh
from .tensor import data_parallel, split_blocks, vit_embed, vit_pool


def split_vision_params_pp(state: Dict[str, torch.Tensor], pp: int) -> Dict:
    """The ``pp``-stage split of a ViT tower's ``state_dict``: ``{"rep":
    the entries outside the blocks, "stages": {name within a block: [pp,
    layers/pp, ...]}}`` (stage s holds blocks ``[s·L/pp, (s+1)·L/pp)``).
    JAX's error where the layers do not divide."""
    rep, blocks = split_blocks(state)
    n_layers = len(blocks)
    if n_layers % pp:
        raise ValueError(f"{n_layers} blocks not divisible into {pp} pipeline stages")
    lps = n_layers // pp
    stages = {name: torch.stack([torch.stack([blocks[s * lps + i][name] for i in range(lps)])
                                 for s in range(pp)]).contiguous()
              for name in blocks[0]}
    return {"rep": rep, "stages": stages}


def put_pp_params(pp_params: Dict, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> Dict:
    """A split on this rank's device: the replicated entries whole, of the
    stages only this rank's along ``pipe`` (``[layers/pp, ...]`` a leaf);
    floating tensors cast to ``dtype`` if given."""
    axis = mesh.pipe

    def put(t):
        t = t.to(mesh.device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    if any(v.shape[0] != axis.size for v in pp_params["stages"].values()):
        raise ValueError(f"the split's stage count differs from the pipe axis ({axis.size})")
    return {"rep": {k: put(v) for k, v in pp_params["rep"].items()},
            "stages": {k: put(v[axis.index]) for k, v in pp_params["stages"].items()}}


def _vit_forward_pp(vit, params: Dict, x: torch.Tensor, num_microbatches: int,
                    mesh: Mesh) -> torch.Tensor:
    """The GPipe schedule of this rank's stage over ``mesh.pipe``."""
    axis = mesh.pipe
    pp, stage, mb = axis.size, axis.index, num_microbatches
    b = x.shape[0]
    if b % mb:
        raise ValueError(f"batch {b} not divisible into {mb} microbatches")
    tokens = vit_embed(vit, params["rep"], x)  # replicated stage boundary
    tokens_mb = tokens.reshape(mb, b // mb, *tokens.shape[1:])
    stages = params["stages"]
    lps = next(iter(stages.values())).shape[0]
    with torch.device("meta"):  # the block's code, with this stage's weights
        template = ResidualAttentionBlock(vit.width, vit.heads)
    blocks = [{k: v[i] for k, v in stages.items()} for i in range(lps)]

    outs = torch.zeros_like(tokens_mb)
    buf = torch.zeros_like(tokens_mb[0])
    for t in range(mb + pp - 1):
        m = t - stage  # this stage's microbatch at tick t
        if 0 <= m < mb:
            h = tokens_mb[m] if stage == 0 else buf
            for blk in blocks:
                h = functional_call(template, blk, (h,))
            if stage == pp - 1:
                outs[m] = h
            buf = h
        if pp > 1:  # every stage takes part in every hop
            buf = _shift(axis, buf, 1, cyclic=False)
    broadcast_tensors([outs], axis, src_index=pp - 1)
    return vit_pool(params["rep"], outs.reshape(tokens.shape))


def make_pp_encode(vit, mesh: Mesh, num_microbatches: int, pre: Optional[Callable] = None):
    """``fn(pp_params, images) -> features`` with the batch split over
    ``data`` and the blocks staged over ``pipe`` (see
    :func:`imp_torch.parallel.tensor.make_tp_encode` for ``vit`` and
    ``pre``); ``pp_params`` comes from :func:`put_pp_params`.  Runs without
    gradient."""

    @torch.no_grad()
    def fn(pp_params: Dict, images: torch.Tensor) -> torch.Tensor:
        def body(x):
            return _vit_forward_pp(vit, pp_params, pre(x) if pre is not None else x,
                                   num_microbatches, mesh)

        return data_parallel(mesh, body)(images)

    return fn
