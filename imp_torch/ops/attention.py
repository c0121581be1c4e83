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

Sequence parallelism (JAX's ``seq_axis``; :mod:`imp_torch.parallel`): a
``seq`` :class:`~imp_torch.parallel.collectives.Axis` given to
:class:`MultiheadAttention` makes its keys and values this rank's token
band, normalised over every rank's keys (:func:`distributed_softmax_attention`);
given to :class:`TransLayer`, the layer always runs exact attention (the
Nyström landmarks do not split over bands) in one of two layouts,
``sp_mode="gather"`` (tokens replicated in and out, the query band through
K1 against gathered keys, :meth:`ExactSelfAttention._sp_forward`) or
``"ring"`` (tokens banded in and out, keys rotating,
:meth:`ExactSelfAttention._ring_forward`, the residual conv over
:func:`halo_depthwise_conv`).  Parameter names do not change, so
checkpoints load in every layout.

Masks are ``valid=True`` booleans.  Training draws dropout from an explicit
``torch.Generator`` passed down the forward calls (:func:`dropout`); without
one a module runs its eval forward.  Every module is initialised at
construction from torch's global RNG; :func:`init_parameters_` redraws all
of a model's parameters from a generator, from the JAX package's
distributions.  The attention output of a TransLayer
drops at rate 0.1, as the JAX package's ``TransLayer.dropout`` does.

Numerics: float32, or bfloat16 activations under ``TRAINER.PREC`` bf16
(:mod:`imp_torch.engine.precision`), with the JAX package's float32
islands: the pseudo-inverse and the residual depthwise conv compute in
float32 and return the input's dtype, and the cross-attention's K and V
keep the key and value dtype (UMEML_GAN's bag-only bf16).  The
Newton-Schulz pseudo-inverse needs true fp32 products, and the residual
conv must not run in TF32; the model builders turn TF32 off
(:mod:`imp_torch.models`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..parallel.collectives import Axis, all_gather, pmax, psum, replicate_from, shift
from .flash_attention import _wide, flash_attention
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


def rank_generator(
    generator: Optional[torch.Generator], axis: Optional[Axis]
) -> Optional[torch.Generator]:
    """The generator of this rank's token band: ``generator`` itself off a
    sequence axis; on one, a generator seeded from one draw of
    ``generator`` (the same draw on every rank) plus the rank's index, where
    JAX folds ``axis_index`` into its key."""
    if generator is None or axis is None or axis.size == 1:
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed + axis.index)


def masked_fill_neg(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid positions with -finfo.max (the reference's value)."""
    return scores.masked_fill(~valid, -torch.finfo(scores.dtype).max)


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6, mode: str = "chain",
                       batch_axis: Optional[Axis] = None) -> torch.Tensor:
    """Iterative Moore-Penrose pseudo-inverse in float32 (float64 for a
    float64 input).

    The normaliser is the *global* max over all batch and head dims (the
    reference's ``torch.max`` with no dim), reproduced faithfully; with a
    ``batch_axis`` (a mesh's ``data`` axis) over every rank's part of the
    batch.  The products need full fp32: the model builders turn TF32 off.

    ``mode="chain"`` (JAX's ``PINV_MODE="xla"``) runs the unrolled products;
    ``mode="fused"`` (JAX's ``"pallas"``) runs
    :func:`imp_torch.ops.pinv.pinv_newton_schulz` — K6/K7 on a CUDA tensor,
    their plain versions on a CPU one — where JAX takes its kernel: square,
    m % 128 == 0, m <= 512; any other input takes the chain."""
    if mode not in PINV_MODES:
        raise ValueError(f"pinv mode {mode!r} not in {PINV_MODES}")
    in_dtype = x.dtype
    x = x.to(torch.promote_types(in_dtype, torch.float32))  # a float64 replay stays float64
    m = x.shape[-1]
    if mode == "fused" and x.dim() >= 2 and x.shape[-2] == m and m % 128 == 0 and m <= 512:
        return pinv_newton_schulz(x, iters, batch_axis).to(in_dtype)
    z = x.transpose(-1, -2) / norm_scalar(x, batch_axis)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z.to(in_dtype)


def _token_conv(v: torch.Tensor, w: torch.Tensor, same: bool = True) -> torch.Tensor:
    return F.conv2d(v, w, padding=(w.shape[2] // 2 if same else 0, 0), groups=w.shape[0])


@contextlib.contextmanager
def _onednn_off():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


@torch.library.custom_op("imp_torch::token_conv_cpu", mutates_args=())
def token_conv_cpu(v: torch.Tensor, w: torch.Tensor, same: bool) -> torch.Tensor:
    """:func:`_token_conv` with oneDNN off, as a registered operator: an
    exported program (``torch.export``) calls it as it is, where a traced
    ``conv2d`` would run with the process's oneDNN setting."""
    with _onednn_off():
        return _token_conv(v, w, same)


@token_conv_cpu.register_fake
def _(v, w, same):
    b, h, n, dh = v.shape
    n_out = n if same else n - w.shape[2] + 1
    return v.new_empty((b, h, n_out, dh), dtype=torch.promote_types(v.dtype, w.dtype))


class _CPUTokenConv(torch.autograd.Function):
    """:func:`_token_conv` on the CPU with oneDNN off, forward
    (:func:`token_conv_cpu`) and backward: oneDNN's float32 weight gradient
    of this long (k × 1) depthwise filter is off by ~6e-2 relative
    (measured against float64 at [3, 8, 256, 64], torch 2.13 CPU), ATen's
    own kernels by ~5e-7."""

    @staticmethod
    def forward(ctx, v, w, same):
        ctx.same = same
        ctx.save_for_backward(v, w)
        return token_conv_cpu(v, w, same)

    @staticmethod
    def backward(ctx, g):
        v, w = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad(), _onednn_off():
            return torch.autograd.grad(_token_conv(v, w, ctx.same), (v, w), g) + (None,)


def residual_depthwise_conv(v: torch.Tensor, w: torch.Tensor,
                            token_padding: str = "same") -> torch.Tensor:
    """Per-head depthwise conv over the token axis with SAME padding (the
    Nyström value residual, reference ``Conv2d(heads, heads, (k,1),
    groups=heads)``), or none (``token_padding="valid"``: k - 1 fewer
    tokens out, for a band that carries its halos).  v: [B, H, N, dh]; w:
    [H, 1, k, 1].  Computed in float32 (float64 for a float64 input) and
    returned in v's dtype, as JAX computes it."""
    same = {"same": True, "valid": False}[token_padding]
    wide = torch.promote_types(torch.promote_types(v.dtype, w.dtype), torch.float32)
    vw, ww = v.to(wide), w.to(wide)
    out = (_CPUTokenConv.apply(vw, ww, same) if v.device.type == "cpu"
           else _token_conv(vw, ww, same))
    return out.to(v.dtype)


def halo_depthwise_conv(
    v_band: torch.Tensor,  # [B, H, nb, dh] this rank's token band
    w: torch.Tensor,  # [H, 1, k, 1]
    axis: Axis,
    left_extra: Optional[torch.Tensor] = None,  # [B, H, 1, dh] replicated cls
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`residual_depthwise_conv` over a token-banded array without
    gathering it: k//2-token halos come from the neighbouring ranks
    (zeros past the ends: the SAME padding) and the conv runs VALID on the
    haloed band, equal to the SAME conv over ``[left_extra?; band_0; ...]``.
    ``left_extra`` is a replicated token just before band 0 (TransMIL's
    cls); its own output, computable where band 0 lives, is broadcast from
    rank 0 and returned second."""
    b, h, nb, dh = v_band.shape
    r = w.shape[2] // 2
    if nb < r:
        raise ValueError(
            f"halo conv needs a band of >= k//2 tokens ({nb} < {r}); lower the "
            f"seq-axis size or use the gather layout (TPU.SP_ATTENTION=gather)")
    left = shift(v_band[:, :, -r:], axis, 1, cyclic=False)  # rank i-1's last r
    if left_extra is not None:
        # a select, not a branch: every rank keeps the shift in its graph, so
        # every rank takes part in its backward
        dev0_left = torch.cat([torch.zeros_like(left[:, :, : r - 1]),
                               left_extra.to(left.dtype)], dim=2)
        left = torch.where(torch.tensor(axis.index == 0, device=left.device), dev0_left, left)
    right = shift(v_band[:, :, :r], axis, -1, cyclic=False)  # rank i+1's first r
    band_out = residual_depthwise_conv(torch.cat([left, v_band, right], dim=2), w, "valid")
    cls_out = None
    if left_extra is not None:
        cseq = torch.cat([torch.zeros_like(v_band[:, :, :r]), left_extra.to(v_band.dtype),
                          v_band[:, :, :r]], dim=2)
        cls_out = replicate_from(residual_depthwise_conv(cseq, w, "valid"), axis, 0)
    return band_out, cls_out


def band_bounds(ntok: int, axis: Axis) -> Tuple[int, int]:
    """(band size, padded length) of an equal split of ``ntok`` tokens over
    the axis (JAX ``_band_bounds``)."""
    band = -(-ntok // axis.size)
    return band, band * axis.size


def gather_tokens_replicated(band: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """Every rank's token band, concatenated along ``dim`` on every rank
    (JAX's psum of scattered bands); backward: a reduce-scatter.  A bool
    band gathers as float32."""
    if band.dtype == torch.bool:
        return all_gather(band.to(torch.float32), axis, dim) > 0.5
    return all_gather(band, axis, dim)


def distributed_softmax_attention(q, k, v, key_valid, scale, axis: Axis):
    """Softmax attention of replicated queries q [B, H, L, dh] with the keys
    and values [B, H, S, dh] split over ``axis`` (key_valid [B, S]): local
    scores, a global max (no gradient) and psums of the numerator and
    denominator.  Returns (out, raw local scores).  The scores, the weights
    and both sums are float32 for bf16 operands (JAX's
    ``preferred_element_type=jnp.float32``; a bf16 product is exact in
    float32) and float64 for float64 ones; the output in q's dtype."""
    s = torch.einsum("bhld,bhsd->bhls", _wide(q * scale), _wide(k))
    raw = s
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :], s, -torch.finfo(s.dtype).max)
    m = pmax(s.amax(dim=-1), axis)  # [B, H, L]
    p = torch.exp(s - m[..., None])
    if key_valid is not None:
        p = p * key_valid[:, None, None, :]
    num = psum(torch.einsum("bhls,bhsd->bhld", p, _wide(v)), axis)
    den = psum(p.sum(dim=-1), axis)
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype), raw


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
    ``ops/blocks.py:346-527`` + ``multi_head_attention_forward``).  In a
    training forward (a ``generator``), ``dropout`` drops the softmax
    weights before they weigh the values, as the JAX module does.  With a
    ``seq`` axis, key and value are this rank's token band and the softmax
    spans every rank's keys; ``raw`` is then the band's scores and there is
    no weight dropout (the weights never exist whole)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 seq: Optional[Axis] = None):
        super().__init__()
        self.seq = seq
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}"
            )
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
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
        generator: Optional[torch.Generator] = None,
    ):
        e, h = self.embed_dim, self.num_heads
        w, bias = self.in_proj_weight, self.in_proj_bias
        q = query @ w[:, :e] + bias[:e]
        # K and V keep the key and value dtype (a no-op in fp32): under the
        # bag-only bf16 the bag-sized K/V stay half-width (JAX :335-346);
        # mixed operands promote under engine.precision.JaxPromotion
        k = (key @ w[:, e : 2 * e] + bias[e : 2 * e]).to(key.dtype)
        v = (value @ w[:, 2 * e :] + bias[2 * e :]).to(value.dtype)
        q, k, v = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
        if self.seq is not None:
            if self.dropout > 0.0 and generator is not None:
                raise ValueError("attention-weight dropout is not supported under "
                                 "sequence parallelism")
            out, raw = distributed_softmax_attention(q, k, v, key_valid, (e // h) ** -0.5,
                                                     self.seq)
            return self.out_proj(_merge_heads(out)), raw
        out, weights, raw = dense_attention(q, k, v, key_valid, scale=(e // h) ** -0.5)
        if self.dropout > 0.0 and generator is not None:
            weights = dropout(weights, self.dropout, generator)
            out = torch.einsum("bhls,bhsd->bhld", weights, v)
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
            bound = 1.0 / math.sqrt(self.res_conv.shape[-2])  # fan_in = k
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
        #: the mesh axis the batch is split over (the pseudo-inverse's
        #: normaliser spans it), set by :func:`set_batch_axis`
        self.batch_axis: Optional[Axis] = None

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
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations, self.pinv_mode,
                                       self.batch_axis)

        out = (attn1 @ attn2_inv) @ (attn3 @ v)
        if self.res_conv is not None:
            out = out + residual_depthwise_conv(v, self.res_conv)
        out = self.to_out(_merge_heads(out))[:, -n:]  # the padding is in front
        return dropout(out, self.dropout, generator)


def set_batch_axis(model: nn.Module, axis: Optional[Axis]) -> None:
    """Take every statistic over the batch that a module of ``model`` forms
    (the pseudo-inverse normaliser of a :class:`NystromAttention`, the
    batch moments of HFB's ``BatchNorm``: the modules with a ``batch_axis``)
    over the ranks of ``axis`` (a mesh's ``data`` axis), so each rank's part
    of a batch is normalised as the whole batch is."""
    for m in model.modules():
        if hasattr(m, "batch_axis"):
            m.batch_axis = axis


class ExactSelfAttention(_QKVAttention):
    """Exact masked self-attention with the parameters of
    :class:`NystromAttention`, computed by flash attention (the Hopper
    kernels on a CUDA tensor, their plain versions on the CPU), forward and
    backward.

    With a ``seq`` axis: ``sp_mode="gather"`` takes and returns the whole
    (replicated) token array and projects and attends only this rank's
    query band; ``"ring"`` takes and returns this rank's band ``[cls?;
    band]`` and runs :func:`imp_torch.parallel.sequence.ring_self_attention`,
    the cls key and value entering the ring once (rank 0's slot) and every
    rank computing the cls query row."""

    SP_MODES = ("gather", "ring")

    def __init__(self, *args, seq: Optional[Axis] = None, sp_mode: str = "gather", **kwargs):
        super().__init__(*args, **kwargs)
        if sp_mode not in self.SP_MODES:
            raise ValueError(f"sp_mode {sp_mode!r} not in {self.SP_MODES}")
        self.seq, self.sp_mode = seq, sp_mode

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        has_cls: bool = False,
    ):
        if self.seq is not None:
            if self.sp_mode == "ring":
                return self._ring_forward(x, mask, generator, has_cls)
            return self._sp_forward(x, mask, generator)
        q, k, v = self._qkv(x)
        if mask is not None:
            v = v * mask[:, None, :, None]
        out = flash_attention(q, k, v, mask=mask, scale=self.dim_head**-0.5)
        if self.res_conv is not None:
            out = out + residual_depthwise_conv(v, self.res_conv)
        return dropout(self.to_out(_merge_heads(out)), self.dropout, generator)

    def _sp_forward(self, x, mask, generator):
        """Gather layout: this rank's query band against the gathered keys;
        the residual conv over the gathered values (zero past the bag, so
        the band edges see the SAME padding), the output bands gathered."""
        from ..parallel.sequence import gather_kv

        ax = self.seq
        b, n, _ = x.shape
        band, npad = band_bounds(n, ax)
        lo = ax.index * band
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        m_band = F.pad(mask, (0, npad - n))[:, lo:lo + band]
        q, k, v = self._qkv(F.pad(x, (0, 0, 0, npad - n))[:, lo:lo + band])
        v = v * m_band[:, None, :, None]
        k_full, v_full, m_full = gather_kv(k, v, m_band, ax)
        out = flash_attention(q, k_full, v_full, mask=m_full, scale=self.dim_head**-0.5)
        if self.res_conv is not None:
            out = out + residual_depthwise_conv(v_full, self.res_conv)[:, :, lo:lo + band]
        out = dropout(self.to_out(_merge_heads(out)), self.dropout, rank_generator(generator, ax))
        return all_gather(out, ax, 1)[:, :n]

    def _ring_forward(self, x, mask, generator, has_cls):
        """Ring layout: ``x`` is ``[cls?; band]`` ([B, nb (+1), D]); keys
        rotate, the residual conv takes halos, the output stays a band."""
        from ..parallel.sequence import ring_self_attention

        ax = self.seq
        b, nc, _ = x.shape
        nb = nc - 1 if has_cls else nc
        if mask is None:
            mask = torch.ones((b, nb), dtype=torch.bool, device=x.device)
        q, k, v = self._qkv(x)
        m_chunk = mask
        if has_cls:  # the cls key is valid in rank 0's slot only
            m_chunk = torch.cat([torch.full((b, 1), ax.index == 0, device=x.device), mask], 1)
        v_raw = v
        v = v * m_chunk[:, None, :, None]
        out = ring_self_attention(q, k, v, m_chunk, scale=self.dim_head**-0.5, axis=ax)
        if self.res_conv is not None:
            if has_cls:
                band_res, cls_res = halo_depthwise_conv(v[:, :, 1:], self.res_conv, ax,
                                                        left_extra=v_raw[:, :, :1])
                out = out + torch.cat([cls_res, band_res], dim=2).to(out.dtype)
            else:
                out = out + halo_depthwise_conv(v, self.res_conv, ax)[0].to(out.dtype)
        out = self.to_out(_merge_heads(out))
        band_gen = rank_generator(generator, ax)
        if not has_cls:
            return dropout(out, self.dropout, band_gen)
        # the cls row draws the same mask on every rank, so it stays replicated
        return torch.cat([dropout(out[:, :1], self.dropout, generator),
                          dropout(out[:, 1:], self.dropout, band_gen)], dim=1)


class TransLayer(nn.Module):
    """``x + Attention(LN(x))`` with heads=8, dim_head=dim/8 (reference
    ``ops/blocks.py:252-268``).  ``impl="nystrom"`` uses landmarks = dim/2
    (reference parity) and its pseudo-inverse by ``pinv_mode``;
    ``impl="flash"`` the exact kernel, which has no pseudo-inverse.  A
    ``seq`` axis always runs the exact kernel, in the ``sp_mode`` layout;
    under ``"ring"``, ``x`` and the result are this rank's token band and a
    replicated ``cls`` token threads beside them (the call then returns
    ``(band, cls)``)."""

    def __init__(self, dim: int = 512, impl: str = "nystrom", dropout: float = 0.1,
                 pinv_mode: str = "chain", seq: Optional[Axis] = None,
                 sp_mode: str = "gather"):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"TransLayer impl {impl!r} not in {ATTENTION_IMPLS}")
        self.impl = impl
        self.ring = seq is not None and sp_mode == "ring"
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        if impl == "flash" or seq is not None:
            self.attn = ExactSelfAttention(dim=dim, dim_head=dim // 8, heads=8, dropout=dropout,
                                           seq=seq, sp_mode=sp_mode)
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
        cls: Optional[torch.Tensor] = None,
    ):
        if cls is not None and not self.ring:
            raise ValueError("a separate cls token is the ring layout's contract; "
                             "prepend it to x otherwise")
        if self.ring:
            xin = x if cls is None else torch.cat([cls, x], dim=1)
            out = xin + self.attn(self.norm(xin), mask=mask, generator=generator,
                                  has_cls=cls is not None)
            return out if cls is None else (out[:, 1:], out[:, :1])
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
