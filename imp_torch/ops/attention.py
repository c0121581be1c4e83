"""Attention ops — the PyTorch counterpart of ``imp_tpu/ops/attention.py``.

The non-sequence-parallel subset that UMEML_GAN and TransMIL run:

* :class:`MultiheadAttention` — batch-first MHA returning the raw
  (pre-softmax) scores for co-attention interpretability.  The packed
  ``in_proj_weight`` is stored ``[e, 3e]`` and applied as ``x @ W``, as in
  the JAX package, so converted weights carry over unchanged.
* :class:`NystromAttention` — landmark attention with the iterative
  Moore-Penrose pseudo-inverse and the depthwise-conv value residual.  The
  pseudo-inverse runs as the unrolled chain of products (``pinv_mode=
  "chain"``, the default, JAX's ``PINV_MODE="xla"``) or fused
  (``"fused"``, JAX's ``"pallas"``: the Hopper kernels K6 forward and K7
  backward of :mod:`imp_torch.ops.pinv` on a CUDA tensor).
* :class:`ExactSelfAttention` — the same parameters, exact masked attention
  through :func:`imp_torch.ops.flash_attention.flash_attention` (the Hopper
  kernels K1 forward and K2/K3 backward on a CUDA tensor).
* :class:`TransLayer` — ``x + Attention(LN(x))`` with the implementation
  (``"nystrom"`` or ``"flash"``) and the pseudo-inverse mode as constructor
  arguments, not process globals.
* :class:`PreNorm`, :class:`FeedForward`, :class:`Nystromformer` — the
  depth-stacked Nyström encoder.

Masks are ``valid=True`` booleans.  Training draws dropout from an explicit
``torch.Generator`` passed down the forward calls (:func:`dropout`); without
one a module runs its eval forward.  Every module is initialised at
construction from torch's global RNG; :func:`init_parameters_` redraws all
of a model's parameters from a generator, from the JAX package's
distributions.  The attention output of a TransLayer
drops at rate 0.1, as the JAX package's ``TransLayer.dropout`` does.

Numerics: everything is float32.  The Newton-Schulz pseudo-inverse needs
true fp32 products, and the residual conv must not run in TF32; the model
builders turn TF32 off (:mod:`imp_torch.models`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .flash_attention import flash_attention
from .pinv import norm_scalar, pinv_newton_schulz

ATTENTION_IMPLS = ("nystrom", "flash")
PINV_MODES = ("chain", "fused")


# ---------------------------------------------------------------------------
# initialisation with an explicit generator (the JAX package's distributions)
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """torch's default Linear init, U(±1/sqrt(fan_in)) for weight and bias —
    what the JAX ``TorchLinear`` draws — from ``generator``."""
    bound = 1.0 / math.sqrt(lin.in_features) if lin.in_features > 0 else 0.0
    lin.weight.uniform_(-bound, bound, generator=generator)
    if lin.bias is not None:
        lin.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from the JAX package's init
    distributions with ``generator`` (the same seed gives the same weights
    on any device; the values differ from a JAX init of the same seed)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        if hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(generator)


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------


def train_generator(
    train: bool, generator: Optional[torch.Generator]
) -> Optional[torch.Generator]:
    """The generator that drives a training forward's randomness, None in
    eval; training without one raises."""
    if not train:
        return None
    if generator is None:
        raise ValueError("train=True draws dropout from an explicit "
                         "torch.Generator: pass generator=")
    return generator


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    1 - rate and scale the kept values by 1 / (1 - rate).  The identity
    without a generator (eval) or at rate 0.  The bits differ from JAX's.
    The uniforms are float32 whatever the dtype of ``x``, so a float64
    replay of a float32 step draws the same masks."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def masked_fill_neg(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid positions with -finfo.max (the reference's value)."""
    return scores.masked_fill(~valid, -torch.finfo(scores.dtype).max)


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6, mode: str = "chain") -> torch.Tensor:
    """Iterative Moore-Penrose pseudo-inverse in float32.

    The normaliser is the *global* max over all batch and head dims (the
    reference's ``torch.max`` with no dim), reproduced faithfully.  The
    products need full fp32: the model builders turn TF32 off.

    ``mode="chain"`` (JAX's ``PINV_MODE="xla"``) runs the unrolled products;
    ``mode="fused"`` (JAX's ``"pallas"``) runs
    :func:`imp_torch.ops.pinv.pinv_newton_schulz` — K6/K7 on a CUDA tensor,
    their plain versions on a CPU one — where JAX takes its kernel: square,
    m % 128 == 0, m <= 512; any other input takes the chain."""
    if mode not in PINV_MODES:
        raise ValueError(f"pinv mode {mode!r} not in {PINV_MODES}")
    in_dtype = x.dtype
    x = x.float()
    m = x.shape[-1]
    if mode == "fused" and x.dim() >= 2 and x.shape[-2] == m and m % 128 == 0 and m <= 512:
        return pinv_newton_schulz(x, iters).to(in_dtype)
    z = x.transpose(-1, -2) / norm_scalar(x)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z.to(in_dtype)


def _token_conv(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(v, w, padding=(w.shape[2] // 2, 0), groups=w.shape[0])


@contextlib.contextmanager
def _onednn_off():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


class _CPUTokenConv(torch.autograd.Function):
    """:func:`_token_conv` on the CPU with oneDNN off, forward and backward:
    oneDNN's float32 weight gradient of this long (k × 1) depthwise filter
    is off by ~6e-2 relative (measured against float64 at [3, 8, 256, 64],
    torch 2.13 CPU), ATen's own kernels by ~5e-7."""

    @staticmethod
    def forward(ctx, v, w):
        ctx.save_for_backward(v, w)
        with _onednn_off():
            return _token_conv(v, w)

    @staticmethod
    def backward(ctx, g):
        v, w = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad(), _onednn_off():
            return torch.autograd.grad(_token_conv(v, w), (v, w), g)


def residual_depthwise_conv(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head depthwise conv over the token axis with SAME padding (the
    Nyström value residual, reference ``Conv2d(heads, heads, (k,1),
    groups=heads)``).  v: [B, H, N, dh]; w: [H, 1, k, 1]."""
    if v.device.type == "cpu":
        return _CPUTokenConv.apply(v, w)
    return _token_conv(v, w)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain masked dense attention.

    q: [B,H,L,dh], k/v: [B,H,S,dh], key_valid: [B,S] bool (True = attend).
    Returns (out [B,H,L,dh], weights [B,H,L,S], raw scores [B,H,L,S])."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhld,bhsd->bhls", q * scale, k)
    if key_valid is not None:
        scores = masked_fill_neg(scores, key_valid[:, None, None, :])
    raw = scores
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhls,bhsd->bhld", weights, v)
    return out, weights, raw


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, e = t.shape
    return t.reshape(b, n, h, e // h).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MultiheadAttention(nn.Module):
    """Batch-first MHA with optional raw-score output (reference
    ``ops/blocks.py:346-527`` + ``multi_head_attention_forward``)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}"
            )
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(embed_dim, 3 * embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        e = self.embed_dim
        bound = math.sqrt(6.0 / (e + 3 * e))  # xavier-uniform on [e, 3e]
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, L, E]
        key: torch.Tensor,  # [B, S, E]
        value: torch.Tensor,  # [B, S, E]
        key_valid: Optional[torch.Tensor] = None,  # [B, S] bool, True = attend
        need_raw: bool = True,
    ):
        e, h = self.embed_dim, self.num_heads
        w, bias = self.in_proj_weight, self.in_proj_bias
        q = query @ w[:, :e] + bias[:e]
        k = key @ w[:, e : 2 * e] + bias[e : 2 * e]
        v = value @ w[:, 2 * e :] + bias[2 * e :]
        q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
        out, weights, raw = dense_attention(q, k, v, key_valid, scale=(e // h) ** -0.5)
        out = self.out_proj(_merge_heads(out))
        if need_raw:
            return out, raw  # [B, H, L, S]
        return out, weights.mean(dim=1)  # averaged over heads


class _QKVAttention(nn.Module):
    """Parameters shared by the Nyström and exact paths (``to_qkv``,
    ``res_conv``, ``to_out``), so checkpoints interchange between them."""

    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        residual: bool = True,
        residual_conv_kernel: int = 33,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        self.dropout = dropout  # on the output, in training
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.res_conv = (
            nn.Parameter(torch.empty(heads, 1, residual_conv_kernel, 1))
            if residual
            else None
        )
        self.to_out = nn.Linear(inner, dim)
        self.reset_own_parameters(None)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.res_conv is not None:
            bound = 1.0 / math.sqrt(self.res_conv.shape[2])  # fan_in = k
            self.res_conv.uniform_(-bound, bound, generator=generator)

    def _qkv(self, x: torch.Tensor):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        h = self.heads
        return _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)


class NystromAttention(_QKVAttention):
    """Nyström linear attention over (optionally masked) token sequences
    (reference ``ops/attention.py:46-161``): front padding to a multiple of
    the landmark count, masked landmark means, three similarity softmaxes,
    the 6-iteration pseudo-inverse (by ``pinv_mode``, see
    :func:`moore_penrose_pinv`) and the depthwise-conv value residual."""

    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        num_landmarks: int = 256,
        pinv_iterations: int = 6,
        residual: bool = True,
        residual_conv_kernel: int = 33,
        eps: float = 1e-8,
        dropout: float = 0.0,
        pinv_mode: str = "chain",
    ):
        super().__init__(dim, dim_head, heads, residual, residual_conv_kernel, dropout)
        if pinv_mode not in PINV_MODES:
            raise ValueError(f"pinv_mode {pinv_mode!r} not in {PINV_MODES}")
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        self.eps = eps
        self.pinv_mode = pinv_mode

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        b, n, _ = x.shape
        h, m, eps = self.heads, self.num_landmarks, self.eps

        padding = (m - n % m) % m  # pad FRONT to a multiple of m
        if padding > 0:
            x = F.pad(x, (0, 0, padding, 0))
            if mask is not None:
                mask = F.pad(mask, (padding, 0), value=False)
        n_pad = n + padding

        q, k, v = self._qkv(x)
        if mask is not None:
            mvalid = mask[:, None, :, None]
            q, k, v = q * mvalid, k * mvalid, v * mvalid
        q = q * (self.dim_head**-0.5)

        l = n_pad // m
        if l == 1 and mask is None:
            # every landmark group is one token: q_l == q, k_l == k, so the
            # three similarity matrices are one and the same
            attn1 = attn2 = attn3 = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        else:
            q_l = q.reshape(b, h, m, l, self.dim_head).sum(dim=3)
            k_l = k.reshape(b, h, m, l, self.dim_head).sum(dim=3)
            if mask is not None:
                mask_l_sum = mask.reshape(b, 1, m, l).sum(dim=3)  # [B,1,m]
                divisor = mask_l_sum[..., None] + eps
                mask_l = mask_l_sum > 0
            else:
                divisor = float(l)
                mask_l = None
            q_l = q_l / divisor
            k_l = k_l / divisor

            sim1 = q @ k_l.transpose(-1, -2)
            sim2 = q_l @ k_l.transpose(-1, -2)
            sim3 = q_l @ k.transpose(-1, -2)
            if mask is not None:
                sim1 = masked_fill_neg(sim1, mask[:, None, :, None] & mask_l[..., None, :])
                sim2 = masked_fill_neg(sim2, mask_l[..., None] & mask_l[..., None, :])
                sim3 = masked_fill_neg(sim3, mask_l[..., None] & mask[:, None, None, :])
            attn1 = torch.softmax(sim1, dim=-1)
            attn2 = torch.softmax(sim2, dim=-1)
            attn3 = torch.softmax(sim3, dim=-1)
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations, self.pinv_mode)

        out = (attn1 @ attn2_inv) @ (attn3 @ v)
        if self.res_conv is not None:
            out = out + residual_depthwise_conv(v, self.res_conv)
        out = self.to_out(_merge_heads(out))[:, -n:]  # the padding is in front
        return dropout(out, self.dropout, generator)


class ExactSelfAttention(_QKVAttention):
    """Exact masked self-attention with the parameters of
    :class:`NystromAttention`, computed by flash attention (the Hopper
    kernels on a CUDA tensor, their plain versions on the CPU), forward and
    backward."""

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        q, k, v = self._qkv(x)
        if mask is not None:
            v = v * mask[:, None, :, None]
        out = flash_attention(q, k, v, mask=mask, scale=self.dim_head**-0.5)
        if self.res_conv is not None:
            out = out + residual_depthwise_conv(v, self.res_conv)
        return dropout(self.to_out(_merge_heads(out)), self.dropout, generator)


class TransLayer(nn.Module):
    """``x + Attention(LN(x))`` with heads=8, dim_head=dim/8 (reference
    ``ops/blocks.py:252-268``).  ``impl="nystrom"`` uses landmarks = dim/2
    (reference parity) and its pseudo-inverse by ``pinv_mode``;
    ``impl="flash"`` the exact kernel, which has no pseudo-inverse."""

    def __init__(self, dim: int = 512, impl: str = "nystrom", dropout: float = 0.1,
                 pinv_mode: str = "chain"):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"TransLayer impl {impl!r} not in {ATTENTION_IMPLS}")
        self.impl = impl
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        if impl == "flash":
            self.attn = ExactSelfAttention(dim=dim, dim_head=dim // 8, heads=8, dropout=dropout)
        else:
            self.attn = NystromAttention(
                dim=dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2,
                pinv_iterations=6, dropout=dropout, pinv_mode=pinv_mode,
            )

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        return x + self.attn(self.norm(x), mask=mask, generator=generator)


class PreNorm(nn.Module):
    """``fn(LN(x))``."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class FeedForward(nn.Module):
    """Linear(dim, mult·dim) → exact GELU → dropout → Linear(mult·dim, dim)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(dim, dim * mult)
        self.fc2 = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.fc2(dropout(F.gelu(self.fc1(x)), self.dropout, generator))


class Nystromformer(nn.Module):
    """Depth-stacked ``PreNorm(NystromAttention) + PreNorm(FeedForward)``
    with residuals (reference ``attention.py:187-231``)."""

    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        num_landmarks: int = 256,
        pinv_iterations: int = 6,
        attn_values_residual: bool = True,
        attn_values_residual_conv_kernel: int = 33,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        pinv_mode: str = "chain",
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, NystromAttention(
                    dim=dim, dim_head=dim_head, heads=heads, num_landmarks=num_landmarks,
                    pinv_iterations=pinv_iterations, residual=attn_values_residual,
                    residual_conv_kernel=attn_values_residual_conv_kernel, dropout=attn_dropout,
                    pinv_mode=pinv_mode,
                )),
                PreNorm(dim, FeedForward(dim, dropout=ff_dropout)),
            ])
            for _ in range(depth)
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        for attn, ff in self.layers:
            x = attn(x, mask=mask, generator=generator) + x
            x = ff(x, generator=generator) + x
        return x
