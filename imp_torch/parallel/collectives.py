"""Collectives over one axis of a process mesh, with gradients — the torch
forms of the ``jax.lax`` collectives that ``imp_tpu/parallel/sequence.py``
and ``imp_tpu/ops/attention.py`` call inside ``shard_map``.

An :class:`Axis` is one mesh axis as this rank sees it: its process group,
its size and this rank's index along it.  On an axis of size 1 every
collective is the identity, so the single-card path runs the same code.

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is JAX's transpose of it:

* :func:`all_gather` (tiled along a dim) ↔ reduce-scatter (sum);
* :func:`psum` ↔ psum;
* :func:`shift` (``ppermute`` by a fixed offset, cyclic or with zeros at
  the edges) ↔ the shift by the opposite offset;
* :func:`pmax` carries no gradient (the max shift of a softmax is
  gradient-neutral; JAX stop-gradients before its ``pmax``).

With these transposes the gradient of the multi-rank program is exact when
every rank seeds its copy of a replicated loss with 1/world and the
parameter gradients are then summed over the world
(:func:`all_reduce_grads`): replicated work is counted once in total, and
banded work (a rank's own token band) once per band.

The backend comes from the process group: NCCL on cards, one per rank;
gloo for CPU tensors, and for ranks that share one card, where a CUDA
tensor is staged through a host buffer explicitly (:func:`staged`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class Axis:
    """One mesh axis seen from this rank: ``size`` ranks in ``group`` (None
    when ``size`` is 1), this rank at ``index``, and the global ranks of the
    group in axis order (``ranks[i]`` holds index ``i``)."""

    name: str
    size: int = 1
    index: int = 0
    group: Optional[object] = None
    ranks: List[int] = field(default_factory=lambda: [0])

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group) if self.size > 1 else "none"


LOCAL = Axis("local")  # an axis of size 1: every collective is the identity


def _host_staged(axis: Axis, t: torch.Tensor) -> bool:
    return axis.backend == "gloo" and t.is_cuda


def staged(axis: Axis, t: torch.Tensor, op) -> torch.Tensor:
    """Run the in-place collective ``op`` on a contiguous copy of ``t``;
    under gloo a CUDA tensor goes through a host buffer and back."""
    if _host_staged(axis, t):
        buf = t.detach().to("cpu", copy=True).contiguous()
        op(buf)
        return buf.to(t.device)
    buf = t.detach().clone(memory_format=torch.contiguous_format)
    op(buf)
    return buf


def _all_reduce(axis: Axis, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if axis.size == 1:
        return t.detach().clone()
    return staged(axis, t, lambda b: dist.all_reduce(b, op=op, group=axis.group))


def _gather(axis: Axis, t: torch.Tensor, dim: int) -> torch.Tensor:
    if axis.size == 1:
        return t.detach().clone()
    src = t.detach().contiguous()
    if _host_staged(axis, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def _reduce_scatter(axis: Axis, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the axis, then this rank's 1/size slice along ``dim``."""
    if axis.size == 1:
        return t.detach().clone()
    n = t.shape[dim] // axis.size
    if axis.backend == "nccl":
        src = t.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=axis.group)
        return out.movedim(0, dim)
    # gloo has no reduce-scatter: a sum, then the own slice
    return _all_reduce(axis, t).narrow(dim, axis.index * n, n).contiguous()


def _shift(axis: Axis, t: torch.Tensor, offset: int, cyclic: bool) -> torch.Tensor:
    """Rank i sends ``t`` to rank i + offset and receives from i - offset;
    without ``cyclic`` the edge ranks send nothing past the ends and
    receive zeros."""
    n, i = axis.size, axis.index
    if n == 1:
        return t.detach().clone() if cyclic else torch.zeros_like(t)
    src = t.detach().contiguous()
    if _host_staged(axis, src):
        src = src.cpu()
    out = torch.zeros_like(src)
    to, frm = i + offset, i - offset
    if cyclic:
        to, frm = to % n, frm % n
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, src, axis.ranks[to], group=axis.group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[frm], group=axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.axis, g, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(axis, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.axis, g), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset, cyclic):
        ctx.axis, ctx.offset, ctx.cyclic = axis, offset, cyclic
        return _shift(axis, x, offset, cyclic)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.axis, g, -ctx.offset, ctx.cyclic), None, None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order (JAX
    ``all_gather(..., tiled=True)``); backward: reduce-scatter."""
    return x if axis.size == 1 else _AllGather.apply(x, axis, dim)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank; backward: psum."""
    return x if axis.size == 1 else _Psum.apply(x, axis)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise max over the axis, without gradient."""
    x = x.detach()
    return x if axis.size == 1 else _all_reduce(axis, x, dist.ReduceOp.MAX)


def shift(x: torch.Tensor, axis: Axis, offset: int = 1, cyclic: bool = True) -> torch.Tensor:
    """``ppermute`` by ``offset``: rank i's ``x`` lands on rank i + offset
    (mod size if ``cyclic``, else zeros where no rank sends); backward: the
    shift by ``-offset``."""
    if axis.size == 1 and cyclic:
        return x
    return _Shift.apply(x, axis, offset, cyclic)


class _ReplicateFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src_index):
        ctx.axis, ctx.mine = axis, axis.index == src_index
        return _all_reduce(axis, x if ctx.mine else torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(ctx.axis, g)
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def replicate_from(x: torch.Tensor, axis: Axis, src_index: int = 0) -> torch.Tensor:
    """``psum(where(index == src, x, 0))``: rank ``src``'s value on every
    rank, bit-identical (JAX's broadcast of a replicated result).  Every
    rank passes its own ``x`` (so every rank takes part in the backward);
    only rank ``src``'s receives a cotangent."""
    if axis.size == 1:
        return x
    return _ReplicateFrom.apply(x, axis, src_index)


class _PmaxSelect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = _all_reduce(axis, x.max(), dist.ReduceOp.MAX)
        hit = x == out
        ctx.axis = axis
        ctx.save_for_backward(hit, _all_reduce(axis, hit.sum().to(x.dtype)))
        return out

    @staticmethod
    def backward(ctx, g):
        hit, holders = ctx.saved_tensors
        share = _all_reduce(ctx.axis, g) / holders
        return torch.where(hit, share, torch.zeros_like(share)), None


def pmax_select(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The max of every element of ``x`` over every rank of the axis, a
    scalar, differentiable as a selection: the cotangent, summed over the
    axis, is split evenly over the elements that hold the max on any rank
    (what a max over the whole gathered array does on one device, also
    where a wrap-padded batch holds a sample twice)."""
    return x.max() if axis is None or axis.size == 1 else _PmaxSelect.apply(x, axis)


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]], axis: Axis) -> List[torch.Tensor]:
    """Sum each gradient over the axis, in one flat buffer per dtype (None
    stays None)."""
    grads = list(grads)
    if axis.size == 1:
        return grads
    by_dtype = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _all_reduce(axis, torch.cat([grads[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i])
            off += n
    return grads


def broadcast_tensors(tensors: Sequence[torch.Tensor], axis: Axis, src_index: int = 0) -> None:
    """Overwrite each tensor in place with rank ``src``'s value (JAX's
    ``replicate_tree`` of rank 0's parameters and optimizer state)."""
    if axis.size == 1:
        return
    for t in tensors:
        src = axis.ranks[src_index]
        if _host_staged(axis, t):
            buf = t.detach().cpu()
            dist.broadcast(buf, src, group=axis.group)
            t.data.copy_(buf)
        else:
            buf = t.detach().contiguous()
            dist.broadcast(buf, src, group=axis.group)
            if buf.data_ptr() != t.data_ptr():
                t.data.copy_(buf)
