"""Masked flash attention, forward and backward — the PyTorch counterpart of
``imp_tpu/ops/flash_attention.py``.

* :func:`flash_attention_fwd` — the wrapper of the Hopper kernel
  ``imp_torch/csrc/flash_fwd.cu`` (K1; it replaces the Pallas TPU kernel
  ``imp_tpu/ops/flash_attention.py::_make_fwd_kernel``).  It takes
  pre-scaled q, k, v ``[B, H, N, d]`` and an additive key-bias row
  ``[B, Nk]`` (0 valid / -1e30 masked) and returns O and the row
  logsumexp.  :func:`flash_fwd_layout` reads its tile and shared memory
  from the built library.
* :func:`flash_attention_bwd` — the wrapper of the two Hopper kernels of
  ``imp_torch/csrc/flash_bwd.cu`` (K2 for dq, then K3 for dk and dv; they
  replace ``_make_dq_kernel`` and ``_make_dkv_kernel``).  Like the TPU's
  ``_bwd_impl`` it takes the row logsumexp and delta = rowsum(dO ⊙ O) from
  the caller, so a ring attention can pass statistics that are global over
  the ring.  :func:`flash_bwd_layout` reads their tile and shared memory
  from the built library.
* :func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
  — the plain versions (the backward also split by kernel,
  :func:`flash_attention_bwd_dq_reference` for K2 and
  :func:`flash_attention_bwd_dkv_reference` for K3).  The CPU tests use them
  and ``chip_smoke.py`` holds the kernels against them on the card.
* :func:`flash_attention_partial` and :func:`flash_attention_partial_bwd`
  — JAX's chunk forms for ring attention (``imp_tpu/ops/flash_attention.py
  :412,460``): K1 over one key chunk, returning O normalised within the
  chunk and the chunk's lse; K2/K3 over one chunk with the **global** lse
  and delta, so the chunks' dq parts and each chunk's dk, dv add up to the
  exact gradient.  A chunk with no valid key for a row gives that row an
  lse near -1e30 forward (its merge weight underflows to 0) and, under a
  finite global lse, P = exp(s - 1e30 - lse) = 0 backward, so dk = dv = 0
  exactly.
* :func:`flash_attention` — the JAX signature ``(q, k, v, mask, scale)``:
  it scales q before the kernels, as JAX does, and returns O through
  :class:`FlashAttention`, a ``torch.autograd.Function`` whose forward is K1
  through the registered operator ``imp_torch::flash_fwd``
  (:func:`flash_fwd_op`, which an exported program calls; saving q, k, v,
  bias, O and lse) and whose backward forms delta as a
  torch op and runs K2 and K3.  Under ``torch.no_grad()`` K1 is the only
  launch.

Operands (``TRAINER.PREC``).  q, k and v are float32, or bfloat16 under the
bf16 precision policy; bias, lse, delta and dO are float32, and O, lse, dq,
dk and dv come out float32 in both cases: the TPU kernels' contract under
``mxu_precision="fp32"``.  A bf16 q, k, v goes to the kernels' bf16 entries
(``imp_flash_*_bf16``, counted apart as ``flash_fwd_bf16``,
``flash_bwd_dq_bf16`` and ``flash_bwd_dkv_bf16``).  K1's widens the
operands exactly as it stages them and so gives the fp32 entry's bits on
widened copies.  K2's and K3's keep q, k and v in bf16 and run each
product in the passes its operands need (Q·Kᵀ in one bf16 pass, a product
with one bf16 operand in two TF32 passes), so they sum in another order
than the fp32 entries: they are held within 1e-4 of the plain versions,
which widen the operands, and to a float64 replay.
:func:`flash_attention` and :class:`FlashAttention` return O and the
gradients in the operands' dtype, as the JAX ``flash_attention`` and its
custom VJP do, and form delta from the float32 O.

On a CUDA tensor each wrapper launches its kernels or raises; only a tensor
on the CPU takes the plain version.  Unlike the TPU path, keys are not
padded to a block multiple: the kernels mask their ragged edge themselves.

Fully masked query rows.  A row whose keys are all masked returns, forward,
the mean of V over all keys and an lse near -1e30: finite, like the TPU
kernel, for callers to mask downstream.  Backward, P = exp(s - lse) is
computed as on the TPU (not a softmax): lse = -1e30 + log(Nk) rounds to
-1e30, so P = 1 on every key and such a row's gradients are not those of
its forward.  No caller in the port passes such a row: TransMIL's cls key
is always valid and UMEML_GAN passes no mask to its TransLayers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # the additive bias of a masked key
HEAD_DIMS = (32, 64)  # the head widths the kernels are built for
#: q, k, v dtype -> the suffix of the kernels' C entry and launch counter
OPERAND_ENTRIES = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16")}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 if it is (a float64 replay of a step
    through the plain versions stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: (O [B,H,Nq,d], lse [B,H,Nq])."""
    s = _wide(q) @ _wide(k).transpose(-1, -2) + _wide(bias)[:, None, None, :]
    # softmax, not exp(s - lse): on a fully masked row lse = -1e30 + log(Nk)
    # rounds to -1e30, and the weights must still sum to one (the kernel's
    # acc / l), giving the mean of V
    o = torch.softmax(s, dim=-1) @ _wide(v)
    return o, torch.logsumexp(s, dim=-1)


def _bwd_p_ds(q, k, v, bias, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """P = exp(s - lse) and dS = P (dP - delta), the math of the off-TPU
    branch of ``imp_tpu``'s ``flash_attention_partial_bwd``.  Not
    differentiable: it works in place on its two [B, H, Nq, Nk] buffers."""
    p = _wide(q) @ _wide(k).transpose(-1, -2)
    p += _wide(bias)[:, None, None, :]
    p -= _wide(lse)[..., None]
    p.exp_()
    ds = _wide(do) @ _wide(v).transpose(-1, -2)  # dP
    ds -= _wide(delta)[..., None]
    ds *= p
    return p, ds


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 and K3 together: (dq, dk, dv)."""
    p, ds = _bwd_p_ds(q, k, v, bias, do, lse, delta)
    return ds @ _wide(k), ds.transpose(-1, -2) @ _wide(q), p.transpose(-1, -2) @ _wide(do)


def flash_attention_bwd_dq_reference(q, k, v, bias, do, lse, delta) -> torch.Tensor:
    """Plain PyTorch version of K2 alone: dq."""
    _, ds = _bwd_p_ds(q, k, v, bias, do, lse, delta)
    return ds @ _wide(k)


def flash_attention_bwd_dkv_reference(
    q, k, v, bias, do, lse, delta
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 alone: (dk, dv)."""
    p, ds = _bwd_p_ds(q, k, v, bias, do, lse, delta)
    return ds.transpose(-1, -2) @ _wide(q), p.transpose(-1, -2) @ _wide(do)


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


def _check_kernel_operands(qkv, rest) -> tuple:
    """What the CUDA kernels take: q, k, v all float32 or all bfloat16, the
    other operands float32; contiguous, 16-byte aligned.  Returns the
    (C entry suffix, counter suffix) of q's dtype."""
    if qkv[0][1].dtype not in OPERAND_ENTRIES:
        raise TypeError(f"q must be float32 or bfloat16, got {qkv[0][1].dtype}")
    for name, t in qkv[1:]:
        if t.dtype != qkv[0][1].dtype:
            raise TypeError(f"{name} must have q's dtype {qkv[0][1].dtype}, got {t.dtype}")
    for name, t in rest:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (*qkv, *rest):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector loads)")
    return OPERAND_ENTRIES[qkv[0][1].dtype]


def _check_cuda(q, k, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if k.shape[2] == 0:
        raise ValueError(f"{name} needs at least one key")


def flash_attention_fwd(
    q: torch.Tensor,  # [B, H, Nq, d] PRE-SCALED queries
    k: torch.Tensor,  # [B, H, Nk, d]
    v: torch.Tensor,  # [B, H, Nk, d]
    bias: torch.Tensor,  # [B, Nk] additive key bias, 0 valid / -1e30 masked
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse), both float32, by K1 on CUDA (its fp32 or bf16 entry, by
    q's dtype), by the plain version on CPU."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    _check_cuda(q, k, "flash_attention_fwd")
    entry, counter = _check_kernel_operands((("q", q), ("k", k), ("v", v)), (("bias", bias),))
    b, h, nq, d = q.shape
    nk = k.shape[2]

    from ..kernels import count_launch, load

    name = "flash_fwd" + counter
    lib = load(name)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if o.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"imp_flash_fwd_{entry}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, nq, nk, d, ctypes.c_void_p(stream),
        )
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        count_launch(name)
    return o, lse


@torch.library.custom_op("imp_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as the registered operator
    ``imp_torch::flash_fwd``: K1 on a CUDA tensor (counted where it
    launches), the plain version on a CPU tensor.  ``torch.export`` records
    the operator in its program, which a ``ctypes`` call would stop."""
    return flash_attention_fwd(q, k, v, bias)


@flash_fwd_op.register_fake
def _(q, k, v, bias):
    _check(q, k, v, bias)
    b, h, nq, _ = q.shape
    dtype = torch.promote_types(q.dtype, torch.float32)  # bf16 operands: fp32 out
    return q.new_empty(q.shape, dtype=dtype), q.new_empty((b, h, nq), dtype=dtype)


def flash_attention_bwd(
    q: torch.Tensor,  # [B, H, Nq, d] PRE-SCALED queries
    k: torch.Tensor,  # [B, H, Nk, d]
    v: torch.Tensor,  # [B, H, Nk, d]
    bias: torch.Tensor,  # [B, Nk]
    do: torch.Tensor,  # [B, H, Nq, d] output cotangent
    lse: torch.Tensor,  # [B, H, Nq] row logsumexp
    delta: torch.Tensor,  # [B, H, Nq] rowsum(dO ⊙ O)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), float32, by K2 then K3 on CUDA (their fp32 or bf16
    entries, by q's dtype), by the plain version on CPU."""
    _check(q, k, v, bias)
    b, h, nq, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, nq):
            raise ValueError(f"{name} must be [B, H, Nq] = {(b, h, nq)}, got {tuple(t.shape)}")
    if {do.device, lse.device, delta.device} != {q.device}:
        raise ValueError("do, lse and delta must lie on the device of q")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, do, lse, delta)
    _check_cuda(q, k, "flash_attention_bwd")
    entry, counter = _check_kernel_operands(
        (("q", q), ("k", k), ("v", v)),
        (("bias", bias), ("do", do), ("lse", lse), ("delta", delta)))
    nk = k.shape[2]

    from ..kernels import count_launch, load

    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=t.device) for t in (q, k, v))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    inputs = [t.data_ptr() for t in (q, k, v, bias, do, lse, delta)]
    if dq.numel():
        name = "flash_bwd_dq" + counter
        err = getattr(load(name), f"imp_flash_bwd_dq_{entry}")(
            *inputs, dq.data_ptr(), b, h, nq, nk, d, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        count_launch(name)
    if dk.numel():
        name = "flash_bwd_dkv" + counter
        err = getattr(load(name), f"imp_flash_bwd_dkv_{entry}")(
            *inputs, dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, d, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        count_launch(name)
    return dq, dk, dv


def flash_fwd_layout(d: int) -> dict:
    """K1's launch layout at head width ``d``, as ``flash_fwd.cu`` sets it:
    ``tile``, the query rows a CTA owns and the keys it sweeps per step
    (masked key tiles are skipped a tile at a time), and its dynamic shared
    memory in bytes.  Builds the kernel's library at first use."""
    from ..kernels import load

    tile, smem = ctypes.c_int(), ctypes.c_int()
    err = load("flash_fwd").imp_flash_fwd_layout(d, ctypes.byref(tile), ctypes.byref(smem))
    if err:
        raise ValueError(f"flash_fwd has no layout for d = {d}: cudaError {err}")
    return {"tile": tile.value, "flash_fwd": smem.value}


def flash_bwd_layout(d: int) -> dict:
    """K2/K3's launch layout at head width ``d``, as ``flash_bwd.cu`` sets
    it: ``tile``, the rows a CTA owns and sweeps per step (masked keys are
    skipped, or zero-filled, a tile at a time), and each kernel's dynamic
    shared memory in bytes; under ``bf16`` the same of the bf16 entries'
    kernels.  Builds the kernels' library at first use."""
    from ..kernels import load

    layout = {}
    for name, entry in (("flash_bwd_dq", "imp_flash_bwd_layout"),
                        ("flash_bwd_dq_bf16", "imp_flash_bwd_layout_bf16")):
        tile, dq_smem, dkv_smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = getattr(load(name), entry)(d, ctypes.byref(tile), ctypes.byref(dq_smem),
                                         ctypes.byref(dkv_smem))
        if err:
            raise ValueError(f"flash_bwd has no {entry} for d = {d}: cudaError {err}")
        layout[name] = {"tile": tile.value, "flash_bwd_dq": dq_smem.value,
                        "flash_bwd_dkv": dkv_smem.value}
    return {**layout["flash_bwd_dq"], "bf16": layout["flash_bwd_dq_bf16"]}


def _mask_bias(mask: Optional[torch.Tensor], b: int, nk: int, device) -> torch.Tensor:
    """The kernels' additive key bias of a bool mask (None: every key)."""
    if mask is None:
        return torch.zeros((b, nk), dtype=torch.float32, device=device)
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32).contiguous()


def _fp32_only(mxu_precision: str) -> None:
    # JAX's bf16 products of fp32 P have no caller outside the ring passes
    if mxu_precision != "fp32":
        raise ValueError(f"mxu_precision {mxu_precision!r}: only 'fp32' is ported")


def flash_attention_partial(
    q: torch.Tensor,  # [B, H, Nq, D] PRE-SCALED queries
    k: torch.Tensor,  # [B, H, Nk, D] one key chunk
    v: torch.Tensor,  # [B, H, Nk, D]
    mask: Optional[torch.Tensor] = None,  # [B, Nk] bool, True = attend
    mxu_precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` against one key chunk, normalised within the chunk:
    (O float32, lse float32 [B, H, Nq]) by K1 (:func:`flash_attention_fwd`),
    to merge exactly by logsumexp across chunks.  Not differentiable (the
    ring wraps forward and backward in one Function).  A row with no valid
    key in the chunk gets lse ~ -1e30 and the mean of the chunk's V (JAX's
    CPU branch gives the sum; the merge weighs either by exactly 0).
    JAX's ``block_q``/``block_k`` have no counterpart: the kernel picks its
    tiles."""
    _fp32_only(mxu_precision)
    b, nk = q.shape[0], k.shape[2]
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               _mask_bias(mask, b, nk, q.device))


def flash_attention_partial_bwd(
    q: torch.Tensor,  # [B, H, Nq, D] PRE-SCALED queries
    k: torch.Tensor,  # [B, H, Nk, D] one key chunk
    v: torch.Tensor,  # [B, H, Nk, D]
    mask: Optional[torch.Tensor],  # [B, Nk] bool
    do: torch.Tensor,  # [B, H, Nq, D] output cotangent
    lse: torch.Tensor,  # [B, H, Nq] GLOBAL row logsumexp (after the merge)
    delta: torch.Tensor,  # [B, H, Nq] GLOBAL rowsum(dO ⊙ O)
    mxu_precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This chunk's share of the backward, float32 (dq part, dk, dv), by K2
    and K3 (:func:`flash_attention_bwd`): with the global statistics,
    P = exp(s - lse) is the true attention restricted to these keys."""
    _fp32_only(mxu_precision)
    b, nk = q.shape[0], k.shape[2]
    return flash_attention_bwd(
        q.contiguous(), k.contiguous(), v.contiguous(), _mask_bias(mask, b, nk, q.device),
        do.to(torch.float32).contiguous(), lse.contiguous(), delta.contiguous())


class FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v, bias) by K1; its gradient by K2 and K3.  The
    bias row carries no gradient (the JAX package returns zeros for it).
    O and the gradients come back in q's dtype (K1-K3 write float32; under
    bf16 they are rounded here, as JAX's ``flash_attention`` and custom VJP
    round them).  The float32 O is saved for delta: JAX forms delta from
    the kernel's float32 output, not from the rounded one."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = flash_fwd_op(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()  # dO in float32, as JAX casts it
        delta = (do * o).sum(dim=-1)  # as JAX forms it, outside the kernels
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, do, lse, delta.contiguous())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(
    q: torch.Tensor,  # [B, H, Nq, D]
    k: torch.Tensor,  # [B, H, Nk, D]
    v: torch.Tensor,  # [B, H, Nk, D]
    mask: Optional[torch.Tensor] = None,  # [B, Nk] bool, True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention with the JAX signature; returns O [B, H, Nq, D] in
    q's dtype and is differentiable in q, k and v.  q is scaled in its own
    dtype (in bf16 under the bf16 policy), as JAX's ``q = q * scale``."""
    b, _, _, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    q = (q * scale).contiguous()
    return FlashAttention.apply(q, k.contiguous(), v.contiguous(),
                                _mask_bias(mask, b, nk, q.device))
