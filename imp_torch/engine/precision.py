"""The mixed-precision policy of ``TRAINER.PREC`` — the counterpart of
``compute_dtype_of``/``cast_floats`` and MBTRAIN's ``_amp_apply`` in
``imp_tpu/engine/{trainer,mbtrain}.py``.

``bf16``, ``fp16`` and ``amp`` all compute in bfloat16 (the reference's
amp/fp16 map to bf16, with no loss scaling), ``fp32`` in float32.  Under
bf16, :func:`amp_call` runs a model method on bfloat16 copies of the
model's float32 parameters and of the float32 tensors among its
arguments, and casts its floating outputs back to float32:

* the parameters themselves stay float32 (the optimizers update them); the
  copies are made with ``Tensor.to`` inside the call, so gradients flow
  through the casts into the float32 parameters, as JAX's
  ``value_and_grad`` through ``cast_floats(p)`` does;
* buffers are not cast: HFB's BatchNorm statistics stay float32, as JAX
  leaves ``model_state`` uncast;
* no ``torch.autocast``, no ``GradScaler``: their per-op lists are another
  policy.

JAX promotes mixed operands (a bfloat16 activation meeting a float32
constant, such as UMEML_GAN's zero-padded gene-group mask, runs that
branch in float32 from there on); PyTorch's products and normalisations
refuse them.  Inside :func:`amp_call` (and UMEML_GAN's ``encode`` under
its bag-only ``bag_dtype``), :class:`JaxPromotion` casts the floating
operands of those ops to their promoted dtype first, which is what JAX
computes, and runs layer norms in float32 as flax does.

On the card a bfloat16 product accumulates in float32 end to end only with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
off (JAX's ``preferred_element_type=jnp.float32``); :func:`bf16_matmul_scope`
turns it off for the extent of a step or an evaluation and restores the
caller's setting after it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

PRECISIONS = ("fp32", "bf16", "fp16", "amp")


def compute_dtype_of(cfg) -> Optional[torch.dtype]:
    """bfloat16 for ``TRAINER.PREC`` in (bf16, fp16, amp), None for fp32."""
    prec = cfg.TRAINER.PREC
    if prec not in PRECISIONS:
        raise ValueError(f"TRAINER.PREC={prec!r} not in {PRECISIONS}")
    return torch.bfloat16 if prec != "fp32" else None


def _map(fn, tree: Any) -> Any:
    """``tree`` (tensors in dicts, lists and tuples) with ``fn`` applied to
    every tensor; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def cast_floats(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """``tree`` with every float32 tensor cast to ``dtype`` (JAX's
    ``cast_floats``); ``dtype=None`` is the identity."""
    if dtype is None:
        return tree
    return _map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, tree)


def floats_to_fp32(tree: Any) -> Any:
    """``tree`` with every floating tensor of less than 32 bits in float32."""
    return _map(lambda t: t.float() if t.is_floating_point() and t.element_size() < 4 else t,
                tree)


#: the ops that refuse floating operands of different dtypes
_PROMOTING = frozenset({
    F.linear, F.conv1d, F.conv2d, torch.matmul, torch.bmm, torch.einsum,
    torch.addmm, torch.baddbmm, torch.Tensor.matmul, torch.Tensor.__matmul__,
    torch.Tensor.__rmatmul__, torch.Tensor.bmm,
})


def _float_dtypes(tree) -> set:
    dtypes = set()
    _map(lambda t: dtypes.add(t.dtype) if t.is_floating_point() else None, tree)
    return dtypes


def _floats_to(tree, dtype):
    return _map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


class JaxPromotion(TorchFunctionMode):
    """Products and convolutions whose floating operands differ in dtype
    compute in the promoted dtype (bfloat16 with float32 gives float32), as
    ``jnp.dot``/``jnp.einsum`` do; a layer norm computes in float32 and
    returns the promoted dtype of its operands, as flax's ``LayerNorm``
    (float32 statistics, one rounding of its output) does; every other op
    runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.layer_norm:
            dtype = functools.reduce(torch.promote_types, _float_dtypes((args, kwargs)))
            wide = torch.promote_types(dtype, torch.float32)
            return func(*_floats_to(args, wide), **_floats_to(kwargs, wide)).to(dtype)
        if func in _PROMOTING:
            dtypes = _float_dtypes((args, kwargs))
            if len(dtypes) > 1:
                dtype = functools.reduce(torch.promote_types, dtypes)
                args, kwargs = _floats_to(args, dtype), _floats_to(kwargs, dtype)
        return func(*args, **kwargs)


class _Method(nn.Module):
    """Calls a method of ``model`` (``torch.func.functional_call`` calls
    only ``forward``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args, **kwargs):
        fn = self.model if method == "forward" else getattr(self.model, method)
        return fn(*args, **kwargs)  # forward through __call__: hooks fire


def amp_call(model: nn.Module, method: str, dtype: Optional[torch.dtype], *args, **kwargs):
    """``getattr(model, method)(*args, **kwargs)`` under the precision
    policy: with ``dtype`` None, the plain call; else on ``dtype`` copies of
    the float32 parameters and float32 argument tensors, under
    :class:`JaxPromotion`, with the floating outputs back in float32."""
    if dtype is None:
        return (model if method == "forward" else getattr(model, method))(*args, **kwargs)
    params = {f"model.{name}": p.to(dtype) for name, p in model.named_parameters()
              if p.dtype == torch.float32}
    with JaxPromotion():
        out = torch.func.functional_call(
            _Method(model), params, (method, *cast_floats(args, dtype)),
            cast_floats(kwargs, dtype), strict=False)
    return floats_to_fp32(out)


@contextlib.contextmanager
def bf16_matmul_scope(dtype: Optional[torch.dtype]):
    """Under bf16, bfloat16 products accumulate in float32 without reduced
    precision reductions for the extent of the block (the caller's setting
    comes back after it); under fp32, nothing changes."""
    if dtype is None:
        yield
        return
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
