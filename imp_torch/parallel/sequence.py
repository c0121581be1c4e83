"""Sequence parallelism over the bag's token axis — the torch counterpart of
``imp_tpu/parallel/sequence.py``.

Each rank of the ``seq`` axis holds N/sp tokens of every slide.  Two
layouts, as in JAX (``TPU.SP_ATTENTION``):

* ``gather``: the modularity passes gather the normalised, masked bag once
  and sweep only this rank's row band of the [N, N] adjacency
  (:func:`compute_modularity_pair_sp`); self-attention gathers K and V and
  runs this rank's query band through K1 (:func:`self_attention_tokens_sp`).
* ``ring``: nothing of size N lives on one rank.  Column chunks (the bag,
  its degrees and assignments; K, V and the key mask) rotate around the
  ring by :func:`~imp_torch.parallel.collectives.shift`, one hop per rank
  (:func:`compute_modularity_pair_ring`, :func:`ring_self_attention`).

The modularity sweeps are plain torch row blocks of 512 rows, the JAX
package's XLA sweeps under ``shard_map``, through the plain versions of
:mod:`imp_torch.ops.modularity` (:func:`~imp_torch.ops.modularity.block_degrees`,
:func:`~imp_torch.ops.modularity.combined_sweep`) at this rank's row
offset; the single-card path keeps the kernels K4/K5.  Ring attention runs K1 on each hop in its forward
(:func:`ring_hop_forward`) and K2/K3 on each hop in its backward with the
global row statistics (:func:`ring_hop_backward`), through
:func:`imp_torch.ops.flash_attention.flash_attention_partial` and
``flash_attention_partial_bwd``.

Gradients follow :mod:`imp_torch.parallel.collectives`: every rank seeds
1/world of a replicated loss, each collective's backward is its transpose,
and the trainer sums parameter gradients over the world.  A function whose
forward sums over the axis inside a ``torch.autograd.Function`` (the
modularity traces) therefore sums the cotangent over the axis in its
backward.  The bag itself takes no gradient from the modularity loss, as on
one card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.attention import distributed_softmax_attention
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_partial,
    flash_attention_partial_bwd,
)
from ..ops.modularity import _prepare, _traces, block_degrees, combined_sweep
from .collectives import Axis, _all_reduce, _gather, _shift, all_gather


def _sharded_traces(s1, q, e, axis: Axis):
    """The traces from this rank's partial s1 and q of every set."""
    return _traces(torch.stack([_all_reduce(axis, s) for s in s1]),
                   torch.stack([_all_reduce(axis, qq) for qq in q]), e)


def _sp_passes(norm_x_local, Cs_local, temp: float, axis: Axis):
    """This rank's row band swept against the gathered bag: (replicated
    traces, dC of the local rows per set)."""
    start = axis.index * norm_x_local.shape[1]
    norm_x = _gather(axis, norm_x_local, 1)
    Cs = [_gather(axis, C, 2) for C in Cs_local]
    deg_local = block_degrees(norm_x_local, norm_x, start)
    deg = _gather(axis, deg_local, 1)
    e = _all_reduce(axis, deg_local.sum(dim=1)).clamp_min(1e-12)
    s1, q, dcs = combined_sweep(norm_x_local, norm_x, deg_local, deg, 1.0 / e, Cs_local, Cs,
                                temp, start)
    return _sharded_traces(s1, q, e, axis), tuple(dcs)


def _ring_passes(norm_x_local, Cs_local, temp: float, axis: Axis):
    """:func:`_sp_passes` with the column chunks (bag, degrees, assignments)
    rotating around the ring: two sweeps of sp hops, O(N/sp) per rank."""
    nl = norm_x_local.shape[1]
    sp, me = axis.size, axis.index
    start = me * nl

    def col0(t):  # after t hops a rank holds the chunk that started at me - t
        return ((me - t) % sp) * nl

    deg_local = torch.zeros_like(norm_x_local[..., 0])
    x_chunk = norm_x_local
    for t in range(sp):
        deg_local = deg_local + block_degrees(norm_x_local, x_chunk, start, col0(t))
        if t < sp - 1:
            x_chunk = _shift(axis, x_chunk, 1, True)
    e = _all_reduce(axis, deg_local.sum(dim=1)).clamp_min(1e-12)
    s1 = q = dcs = [0.0] * len(Cs_local)
    x_chunk, deg_chunk, c_chunks = norm_x_local, deg_local, list(Cs_local)
    for t in range(sp):
        s, qq, dc = combined_sweep(norm_x_local, x_chunk, deg_local, deg_chunk, 1.0 / e,
                                   Cs_local, c_chunks, temp, start, col0(t))
        s1 = [a + b for a, b in zip(s1, s)]
        q = [a + b for a, b in zip(q, qq)]
        dcs = [a + b for a, b in zip(dcs, dc)]
        if t < sp - 1:
            x_chunk = _shift(axis, x_chunk, 1, True)
            deg_chunk = _shift(axis, deg_chunk, 1, True)
            c_chunks = [_shift(axis, c, 1, True) for c in c_chunks]
    return _sharded_traces(s1, q, e, axis), tuple(dcs)


_PASSES = {"gather": _sp_passes, "ring": _ring_passes}


class _ShardedTraces(torch.autograd.Function):
    """The traces of the sharded bag, replicated on every rank; backward:
    the cotangent summed over the axis (the transpose of the forward's sum)
    times the local rows' dC."""

    @staticmethod
    def forward(ctx, temp, axis, mode, norm_x_local, *Cs_local):
        traces, dcs = _PASSES[mode](norm_x_local, [C.contiguous() for C in Cs_local],
                                    temp, axis)
        ctx.axis = axis
        ctx.save_for_backward(*dcs)
        return traces

    @staticmethod
    def backward(ctx, *gts):
        gts = [_all_reduce(ctx.axis, g) for g in gts]
        return (None, None, None, None) + tuple(
            g[:, None, None] * dc for g, dc in zip(gts, ctx.saved_tensors))


def _modularity_pair_sharded(mode, c_list, x_local, valid_local, temp, axis):
    norm_x_local, Cs_local = _prepare(tuple(c_list), x_local, valid_local)
    traces = _ShardedTraces.apply(float(temp), axis, mode, norm_x_local, *Cs_local)
    return sum(-t.mean() * 100.0 for t in traces)


def compute_modularity_pair_sp(
    c_list: Sequence[torch.Tensor],  # K x [B, P_k, D], replicated over seq
    x_local: torch.Tensor,  # [B, N/sp, D] this rank's tokens
    valid_local: Optional[torch.Tensor] = None,  # [B, N/sp]
    temp: float = 0.1,
    axis: Axis = None,
) -> torch.Tensor:
    """The sequence-sharded :func:`imp_torch.ops.modularity.compute_modularity_pair`
    (gather layout): the same replicated scalar; gradients reach ``c_list``."""
    return _modularity_pair_sharded("gather", c_list, x_local, valid_local, temp, axis)


def compute_modularity_pair_ring(
    c_list: Sequence[torch.Tensor],
    x_local: torch.Tensor,
    valid_local: Optional[torch.Tensor] = None,
    temp: float = 0.1,
    axis: Axis = None,
) -> torch.Tensor:
    """:func:`compute_modularity_pair_sp` with column chunks streamed around
    the ring (O(N/sp) memory a rank)."""
    return _modularity_pair_sharded("ring", c_list, x_local, valid_local, temp, axis)


def _float_mask(valid: torch.Tensor) -> torch.Tensor:
    return valid.to(torch.float32)


def gather_kv(k_local, v_local, valid_local, axis: Axis):
    """Every rank's K and V ([B, H, N/sp, D] each) along the token dim, the
    all-gather-KV layout (backward: a reduce-scatter), and the key mask
    gathered likewise (None without one)."""
    mask = None
    if valid_local is not None:
        mask = _gather(axis, _float_mask(valid_local), 1) > 0.5
    return all_gather(k_local, axis, 2), all_gather(v_local, axis, 2), mask


def self_attention_tokens_sp(
    q_local: torch.Tensor,  # [B, H, N/sp, D]
    k_local: torch.Tensor,
    v_local: torch.Tensor,
    valid_local: Optional[torch.Tensor] = None,  # [B, N/sp]
    axis: Axis = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact self-attention over a sharded bag, all-gather-KV: K, V and the
    mask gather once (:func:`gather_kv`), and this rank's queries run
    through flash attention (K1, and K2/K3 in the backward) against every
    key."""
    k, v, mask = gather_kv(k_local, v_local, valid_local, axis)
    return flash_attention(q_local, k, v, mask=mask, scale=scale)


def ring_hop_forward(q, k, v, mask, o, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the ring's forward: K1 over the resident key chunk
    (``flash_attention_partial``) and the exact logsumexp merge into the
    running (O, lse); both float32.  ``lse`` starts at -inf and O at 0."""
    o_t, lse_t = flash_attention_partial(q, k, v, mask)
    # a chunk's lse is finite (the kernel's additive -1e30 bias), so only
    # the -inf start weighs exp(-inf) = 0, never NaN
    lse_new = torch.logaddexp(lse, lse_t)
    o = o * torch.exp(lse - lse_new)[..., None] + o_t * torch.exp(lse_t - lse_new)[..., None]
    return o, lse_new


def ring_hop_backward(q, k, v, mask, do, lse, delta):
    """One hop of the ring's backward: K2/K3 over the resident key chunk with
    the global lse and delta (``flash_attention_partial_bwd``): this
    chunk's dq part and its dk, dv for these queries."""
    return flash_attention_partial_bwd(q, k, v, mask, do, lse, delta)


class _RingAttention(torch.autograd.Function):
    """O = attention of the local (pre-scaled) queries over every rank's
    keys, the key chunks rotating around the ring; the backward reruns the
    ring, the dk/dv accumulators travelling with their chunks and arriving
    home after sp hops."""

    @staticmethod
    def forward(ctx, q, k0, v0, m0, axis):
        sp = axis.size
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32, device=q.device)
        k, v, m = k0, v0, m0
        for t in range(sp):
            o, lse = ring_hop_forward(q, k, v, m > 0.5, o, lse)
            if t < sp - 1:
                k, v, m = (_shift(axis, x, 1, True) for x in (k, v, m))
        ctx.axis = axis
        ctx.save_for_backward(q, k0, v0, m0, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k0, v0, m0, o, lse = ctx.saved_tensors
        axis, sp = ctx.axis, ctx.axis.size
        do = do.to(torch.float32).contiguous()
        delta = (do * o).sum(dim=-1)  # global statistics of the local rows
        k, v, m = k0, v0, m0
        dk = torch.zeros(k0.shape, dtype=torch.float32, device=k0.device)
        dv = torch.zeros_like(dk)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for t in range(sp):
            dq_t, dk_t, dv_t = ring_hop_backward(q, k, v, m > 0.5, do, lse, delta)
            dq = dq + dq_t
            dk = _shift(axis, dk + dk_t, 1, True)
            dv = _shift(axis, dv + dv_t, 1, True)
            if t < sp - 1:
                k, v, m = (_shift(axis, x, 1, True) for x in (k, v, m))
        return dq.to(q.dtype), dk.to(k0.dtype), dv.to(v0.dtype), None, None


def ring_self_attention(
    q_local: torch.Tensor,  # [B, H, N/sp, D]
    k_local: torch.Tensor,
    v_local: torch.Tensor,
    valid_local: Optional[torch.Tensor] = None,  # [B, N/sp]
    scale: Optional[float] = None,
    axis: Axis = None,
    mxu_precision: str = "fp32",
) -> torch.Tensor:
    """Exact self-attention over a sharded bag with O(N/sp) memory a rank:
    the ring twin of :func:`self_attention_tokens_sp`.  Returns the local
    queries' output in their dtype.  JAX's ``block_q``/``block_k`` have no
    counterpart (the kernels pick their tiles); ``mxu_precision`` must be
    ``"fp32"``."""
    if mxu_precision != "fp32":
        raise ValueError(f"mxu_precision {mxu_precision!r}: only 'fp32' is ported")
    if scale is None:
        scale = q_local.shape[-1] ** -0.5
    if valid_local is None:
        valid_local = torch.ones(q_local.shape[:1] + q_local.shape[2:3], dtype=torch.bool,
                                 device=q_local.device)
    mask_f = _float_mask(valid_local)  # rotates as float32
    q = (q_local * scale).contiguous()
    out = _RingAttention.apply(q, k_local.contiguous(), v_local.contiguous(), mask_f, axis)
    return out.to(q_local.dtype)


def cross_attention_tokens_sp(
    q: torch.Tensor,  # [B, P, D] replicated queries (prototype tokens)
    k_local: torch.Tensor,  # [B, N/sp, D]
    v_local: torch.Tensor,  # [B, N/sp, D]
    valid_local: Optional[torch.Tensor] = None,  # [B, N/sp]
    scale: Optional[float] = None,
    axis: Axis = None,
) -> torch.Tensor:
    """Distributed-softmax cross-attention of a few replicated queries over a
    sharded bag (:func:`imp_torch.ops.attention.distributed_softmax_attention`
    with one head): a pmax (no gradient) and two psums, no score matrix
    across ranks."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _ = distributed_softmax_attention(q[:, None], k_local[:, None], v_local[:, None],
                                           valid_local, scale, axis)
    return out[:, 0]
