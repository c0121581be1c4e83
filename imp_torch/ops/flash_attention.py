"""Masked flash-attention forward — the PyTorch counterpart of
``imp_tpu/ops/flash_attention.py``.

Three functions:

* :func:`flash_attention_fwd` — the wrapper of the Hopper kernel
  ``imp_torch/csrc/flash_fwd.cu`` (it replaces the Pallas TPU kernel
  ``imp_tpu/ops/flash_attention.py::_make_fwd_kernel``).  It takes
  pre-scaled q, k, v ``[B, H, N, d]`` and an additive key-bias row
  ``[B, Nk]`` (0 valid / -1e30 masked) and returns O and the row
  logsumexp.  On a CUDA tensor it launches the kernel or raises; only a
  tensor on the CPU takes the plain version.
* :func:`flash_attention_reference` — the plain version: exact scores
  ``q @ kᵀ + bias``, their logsumexp and ``softmax @ v``.  The CPU tests use it
  and ``chip_smoke.py`` holds the kernel against it on the card.
* :func:`flash_attention` — the JAX signature ``(q, k, v, mask, scale)``:
  it scales q before the kernel, as JAX does, and returns O.

Forward only: the backward kernels (``_make_dq_kernel``,
``_make_dkv_kernel``) are the ROADMAP item "training under
``TPU.ATTENTION=flash`` (K2/K3)", so on CUDA a call that would need a
gradient raises instead of returning a result without one.
Unlike the TPU path, keys are not padded to a block multiple: the kernel
masks its ragged edge itself.  A query row whose keys are all masked returns
the mean of V over all keys and an lse near -1e30 — finite, like the TPU
kernel, for callers to mask downstream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # the additive bias of a masked key
HEAD_DIMS = (32, 64)  # the head widths the kernel is built for


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (O [B,H,Nq,d], lse [B,H,Nq])."""
    s = q.float() @ k.float().transpose(-1, -2) + bias.float()[:, None, None, :]
    # softmax, not exp(s - lse): on a fully masked row lse = -1e30 + log(Nk)
    # rounds to -1e30, and the weights must still sum to one (the kernel's
    # acc / l), giving the mean of V
    o = torch.softmax(s, dim=-1) @ v.float()
    return o, torch.logsumexp(s, dim=-1)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, N, d]")
    b, h, _, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if bias.shape != (b, nk):
        raise ValueError(f"bias must be [B, Nk] = {(b, nk)}, got {tuple(bias.shape)}")
    devices = {t.device for t in (q, k, v, bias)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, bias lie on different devices: {devices}")


def flash_attention_fwd(
    q: torch.Tensor,  # [B, H, Nq, d] PRE-SCALED queries
    k: torch.Tensor,  # [B, H, Nk, d]
    v: torch.Tensor,  # [B, H, Nk, d]
    bias: torch.Tensor,  # [B, Nk] additive key bias, 0 valid / -1e30 masked
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) by the Hopper kernel on CUDA, by the plain version on CPU."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet: ROADMAP.md "
            "item 'training under TPU.ATTENTION=flash (K2/K3)'; call under "
            "torch.no_grad()"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if nk == 0:
        raise ValueError("flash_attention_fwd needs at least one key")

    from ..kernels import count_launch, load

    lib = load("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if o.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.imp_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, nq, nk, d, ctypes.c_void_p(stream),
        )
        if err:
            raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
        count_launch("flash_fwd")
    return o, lse


def flash_attention(
    q: torch.Tensor,  # [B, H, Nq, D]
    k: torch.Tensor,  # [B, H, Nk, D]
    v: torch.Tensor,  # [B, H, Nk, D]
    mask: Optional[torch.Tensor] = None,  # [B, Nk] bool, True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention with the JAX signature; returns O [B, H, Nq, D]."""
    b, _, _, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    q = (q * scale).contiguous()
    if mask is None:
        bias = torch.zeros((b, nk), dtype=torch.float32, device=q.device)
    else:
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    o, _ = flash_attention_fwd(q, k.contiguous(), v.contiguous(), bias.contiguous())
    return o
