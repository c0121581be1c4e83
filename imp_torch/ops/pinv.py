"""The fused Newton-Schulz pseudo-inverse — the PyTorch counterpart of
``imp_tpu/ops/pinv_kernel.py``.

* :func:`pinv_fwd` — the wrapper of K6, ``imp_torch/csrc/pinv.cu``
  (``pinv_fwd_kernel``; it replaces the Pallas TPU kernel
  ``imp_tpu/ops/pinv_kernel.py::_fwd_kernel``): for each of g matrices
  x ``[g, m, m]``, z0 = xᵀ / c and ``iters`` steps of
  z ← ¼·z(13I − y(15I − y(7I − y))), y = xz, in true fp32.
* :func:`pinv_bwd` — the wrapper of K7 (``pinv_bwd_kernel``; it replaces
  ``_bwd_kernel``): replays K6, keeping each iterate, and runs the reverse
  of each Horner chain by hand; returns dx and one normaliser-gradient
  partial per matrix, dcp = −Σ(xᵀ ⊙ dz) / c².
* :func:`pinv_fwd_reference` and :func:`pinv_bwd_reference` — the plain
  versions, transcriptions of the two TPU kernel bodies.  The CPU tests
  hold them against JAX and ``chip_smoke.py`` holds the kernels against
  them on the card.
* :class:`PinvNewtonSchulz` — a ``torch.autograd.Function`` over (x, c):
  K6 forward, K7 backward returning (dx, Σ dcp).  The normaliser
  c = max(colsums) · max(rowsums) is global over all g matrices, so no one
  program can form it: :func:`pinv_newton_schulz` computes it with torch
  ops outside the Function, and autograd carries dc back through its max,
  splitting the gradient evenly over ties as JAX's ``jax.vjp`` of
  ``_norm_scalar`` does.  Under ``torch.no_grad()`` K6 is the only launch.

On a CUDA tensor each wrapper launches its kernel or raises; only a tensor
on the CPU takes the plain version.  The callers gate the kernels as JAX
does (square, m % 128 == 0, m ≤ 512): :func:`imp_torch.ops.attention.moore_penrose_pinv`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

#: the matrix sizes the kernels are built for (8 row bands of m / 8 rows)
PINV_SIZES = (128, 256, 384, 512)


def norm_scalar(x: torch.Tensor) -> torch.Tensor:
    """The reference's global normaliser: max over every matrix of the
    absolute column sums times the same of the row sums."""
    abs_x = x.abs()
    return abs_x.sum(dim=-1).max() * abs_x.sum(dim=-2).max()


def _iterate(x, z, eye):
    """One Newton-Schulz step, the exact Horner chain of the TPU kernel:
    (z_next, (y, t1, t3, m))."""
    y = x @ z
    t1 = 7.0 * eye - y
    t2 = y @ t1
    t3 = 15.0 * eye - t2
    t4 = y @ t3
    m = 13.0 * eye - t4
    return 0.25 * (z @ m), (y, t1, t3, m)


def _eye(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def pinv_fwd_reference(x: torch.Tensor, c: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Plain PyTorch version of K6: z [g, m, m]."""
    eye = _eye(x)
    z = x.transpose(-1, -2) / c
    for _ in range(iters):
        z, _ = _iterate(x, z, eye)
    return z


def pinv_bwd_reference(
    x: torch.Tensor, c: torch.Tensor, g_out: torch.Tensor, iters: int = 6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7: (dx [g, m, m], dcp [g])."""
    eye = _eye(x)
    xt = x.transpose(-1, -2)
    zs = [xt / c]
    for _ in range(iters - 1):
        zs.append(_iterate(x, zs[-1], eye)[0])
    dz = g_out
    dx = torch.zeros_like(x)
    for zi in reversed(zs):
        _, (y, t1, t3, m) = _iterate(x, zi, eye)
        yt = y.transpose(-1, -2)
        dzi = 0.25 * (dz @ m.transpose(-1, -2))  # z' = 0.25 z m
        dm = 0.25 * (zi.transpose(-1, -2) @ dz)
        dt4 = -dm  # m = 13I - t4
        dy = dt4 @ t3.transpose(-1, -2)  # t4 = y t3
        dt3 = yt @ dt4
        dt2 = -dt3  # t3 = 15I - t2
        dy = dy + dt2 @ t1.transpose(-1, -2)  # t2 = y t1
        dt1 = yt @ dt2
        dy = dy - dt1  # t1 = 7I - y
        dx = dx + dy @ zi.transpose(-1, -2)  # y = x z_i
        dz = dzi + xt @ dy
    dx = dx + dz.transpose(-1, -2) / c  # z_0 = x^T / c
    return dx, -(xt * dz).sum(dim=(-1, -2)) / (c * c)


def _check(x: torch.Tensor, c: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: x must be [g, m, m], got {tuple(x.shape)}")
    if c.numel() != 1 or c.device != x.device:
        raise ValueError(f"{name}: c must be one value on the device of x")


def _check_cuda(named, m: int, iters: int, name: str) -> None:
    """What the CUDA kernels take: fp32, contiguous, 16-byte aligned, on
    the card, m in PINV_SIZES, at least one step."""
    if named[0][1].device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {named[0][1].device}")
    if m not in PINV_SIZES:
        raise ValueError(f"{name}: m = {m} not in {PINV_SIZES}")
    if iters < 1:
        raise ValueError(f"{name}: iters must be at least 1, got {iters}")
    for n, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if t.dim() == 3 and t.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned (float4 loads)")


def pinv_fwd(x: torch.Tensor, c: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """z by K6 on CUDA, by the plain version on CPU."""
    _check(x, c, "pinv_fwd")
    if x.device.type == "cpu":
        return pinv_fwd_reference(x, c, iters)
    g, m, _ = x.shape
    c = c.reshape(1)
    _check_cuda((("x", x), ("c", c)), m, iters, "pinv_fwd")

    from ..kernels import count_launch, load

    z = torch.empty_like(x)
    if g:
        ws = torch.empty((g, 4, m, m), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load("pinv_fwd").imp_pinv_fwd_f32(
            x.data_ptr(), c.data_ptr(), z.data_ptr(), ws.data_ptr(), g, m, iters,
            ctypes.c_void_p(stream),
        )
        if err:
            raise RuntimeError(f"pinv_fwd launch failed: cudaError {err}")
        count_launch("pinv_fwd")
    return z


def pinv_bwd(
    x: torch.Tensor, c: torch.Tensor, g_out: torch.Tensor, iters: int = 6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dcp) by K7 on CUDA, by the plain version on CPU."""
    _check(x, c, "pinv_bwd")
    if g_out.shape != x.shape or g_out.device != x.device:
        raise ValueError(f"g_out must be {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(g_out.shape)} on {g_out.device}")
    if x.device.type == "cpu":
        return pinv_bwd_reference(x, c, g_out, iters)
    g, m, _ = x.shape
    c = c.reshape(1)
    _check_cuda((("x", x), ("c", c), ("g_out", g_out)), m, iters, "pinv_bwd")

    from ..kernels import count_launch, load

    dx = torch.empty_like(x)
    dcp = torch.empty((g,), dtype=torch.float32, device=x.device)
    if g:
        part = torch.empty((g, 8), dtype=torch.float32, device=x.device)
        ws = torch.empty((g, iters + 8, m, m), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load("pinv_bwd").imp_pinv_bwd_f32(
            x.data_ptr(), c.data_ptr(), g_out.data_ptr(), dx.data_ptr(), dcp.data_ptr(),
            part.data_ptr(), ws.data_ptr(), g, m, iters, ctypes.c_void_p(stream),
        )
        if err:
            raise RuntimeError(f"pinv_bwd launch failed: cudaError {err}")
        count_launch("pinv_bwd")
    return dx, dcp


class PinvNewtonSchulz(torch.autograd.Function):
    """z = pinv(x) given the normaliser c, by K6; (dx, dc) by K7, with
    dc = Σ dcp summed by torch in a fixed order."""

    @staticmethod
    def forward(ctx, x, c, iters):
        ctx.iters = iters
        ctx.save_for_backward(x, c)
        return pinv_fwd(x, c, iters)

    @staticmethod
    def backward(ctx, g_out):
        x, c = ctx.saved_tensors
        dx, dcp = pinv_bwd(x, c, g_out.contiguous(), ctx.iters)
        return dx, dcp.sum().reshape(c.shape), None


def pinv_newton_schulz(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """pinv(x) for x ``[..., m, m]`` float32 through :class:`PinvNewtonSchulz`
    (the counterpart of JAX's ``pinv_newton_schulz``); differentiable in x."""
    lead, m = x.shape[:-2], x.shape[-1]
    flat = x.reshape(-1, m, m).contiguous()
    out = PinvNewtonSchulz.apply(flat, norm_scalar(flat), iters)
    return out.reshape(*lead, m, m)
