"""Shared NN blocks of the MIL and fusion baselines and the UMEML heads —
the PyTorch counterpart of the non-sequence-parallel parts of
``imp_tpu/ops/blocks.py`` (reference ``medmm/modeling/ops/blocks.py``), over
fixed-shape masked inputs.  Parameter names follow the JAX package's tree
(``imp_torch.convert``).  Dropout is drawn from the ``generator`` passed to
``forward``; without one (eval) every block is deterministic."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .attention import TransLayer, dropout, masked_fill_neg

#: the SELU negative saturation -scale·alpha (torch ``nn.AlphaDropout``, JAX
#: ``AlphaDropout``)
ALPHA_P = -1.7580993408473766


def alpha_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Self-normalising dropout as the JAX ``AlphaDropout``: a dropped value
    becomes ``ALPHA_P``, then ``a·x + b`` with a = (q + ALPHA_P²·p·q)^-½,
    b = -a·ALPHA_P·p (p = rate, q = 1 - p), which keeps the mean and
    variance of SELU-normalised input.  The identity without a generator or
    at rate 0; the uniforms are float32 (see :func:`dropout`)."""
    if generator is None or rate == 0.0:
        return x
    p, q = rate, 1.0 - rate
    a = (q + ALPHA_P**2 * p * q) ** -0.5
    b = -a * ALPHA_P * p
    keep = torch.rand(x.shape, generator=generator, device=x.device) < q
    return a * torch.where(keep, x, torch.full((), ALPHA_P, dtype=x.dtype, device=x.device)) + b


class SNN_Block(nn.Module):
    """Linear + ELU + AlphaDropout (reference ``blocks.py:15-27``)."""

    def __init__(self, dim1: int, dim2: int, dropout: float = 0.25):
        super().__init__()
        self.rate = dropout
        self.fc = nn.Linear(dim1, dim2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return alpha_dropout(F.elu(self.fc(x)), self.rate, generator)


class Reg_Block(nn.Module):
    """Linear + ReLU + Dropout (reference ``blocks.py:29-42``)."""

    def __init__(self, dim1: int, dim2: int, dropout: float = 0.25):
        super().__init__()
        self.rate = dropout
        self.fc = nn.Linear(dim1, dim2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return dropout(F.relu(self.fc(x)), self.rate, generator)


MLP_Block = Reg_Block  # reference ``blocks.py:44-48`` is identical


class Attn_Net(nn.Module):
    """ABMIL attention scorer ``score(tanh(fc(x)))``, dropout 0.25 after
    the tanh when ``dropout`` (reference ``blocks.py:50-65``).  Returns
    (scores [B, N, n_classes], x)."""

    def __init__(self, L: int, D: int = 256, dropout: bool = False, n_classes: int = 1):
        super().__init__()
        self.rate = 0.25 if dropout else 0.0
        self.fc = nn.Linear(L, D)
        self.score = nn.Linear(D, n_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.score(dropout(torch.tanh(self.fc(x)), self.rate, generator)), x


class Attn_Net_Gated(nn.Module):
    """Gated ABMIL attention scorer: ``c(tanh(a(x)) ⊙ sigmoid(b(x)))``, with
    dropout 0.25 on both gates when ``dropout`` (reference
    ``blocks.py:67-97``).  Returns (scores [B, N, n_classes], x)."""

    def __init__(self, L: int, D: int = 256, dropout: bool = False, n_classes: int = 1):
        super().__init__()
        self.rate = 0.25 if dropout else 0.0
        self.attention_a = nn.Linear(L, D)
        self.attention_b = nn.Linear(L, D)
        self.attention_c = nn.Linear(D, n_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        a = dropout(torch.tanh(self.attention_a(x)), self.rate, generator)
        b = dropout(torch.sigmoid(self.attention_b(x)), self.rate, generator)
        return self.attention_c(a * b), x


class BilinearFusion(nn.Module):
    """Kronecker (outer-product) gated fusion of two vectors with appended
    ones (reference ``blocks.py:102-184``): each side is gated by a sigmoid
    of both inputs, projected to ``dim // scale_dim`` features, extended by
    a constant 1, and the flattened outer product of the two goes through
    ``encoder1`` (256 wide) and ``encoder2`` (``mmhid`` wide).  Dropout at
    ``dropout_rate`` follows the JAX module's six places, drawn from the
    ``generator`` passed in (None: eval)."""

    def __init__(self, skip: int = 0, gate1: int = 1, gate2: int = 1, dim1: int = 128,
                 dim2: int = 128, scale_dim1: int = 1, scale_dim2: int = 1, mmhid: int = 256,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.skip, self.gate1, self.gate2 = skip, gate1, gate2
        self.dropout_rate = dropout_rate
        og1, og2 = dim1 // scale_dim1, dim2 // scale_dim2
        self.linear_h1 = nn.Linear(dim1, og1)
        if gate1:
            self.linear_z1 = nn.Linear(dim1 + dim2, og1)
        self.linear_o1 = nn.Linear(og1, og1)
        self.linear_h2 = nn.Linear(dim2, og2)
        if gate2:
            self.linear_z2 = nn.Linear(dim1 + dim2, og2)
        self.linear_o2 = nn.Linear(og2, og2)
        self.encoder1 = nn.Linear((og1 + 1) * (og2 + 1), 256)
        self.encoder2 = nn.Linear(256 + (dim1 + dim2 if skip else 0), mmhid)

    def forward(self, vec1: torch.Tensor, vec2: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(x):
            return dropout(x, self.dropout_rate, generator)

        both = torch.cat([vec1, vec2], dim=1)
        o1 = F.relu(self.linear_h1(vec1))
        if self.gate1:
            o1 = torch.sigmoid(self.linear_z1(both)) * o1
        o1 = drop(F.relu(self.linear_o1(o1)))
        o2 = F.relu(self.linear_h2(vec2))
        if self.gate2:
            o2 = torch.sigmoid(self.linear_z2(both)) * o2
        o2 = drop(F.relu(self.linear_o2(o2)))

        ones = o1.new_ones(o1.shape[0], 1)
        o12 = torch.einsum("bi,bj->bij", torch.cat([o1, ones], dim=1),
                           torch.cat([o2, ones], dim=1)).reshape(o1.shape[0], -1)
        out = drop(F.relu(self.encoder1(drop(o12))))
        if self.skip:
            out = torch.cat([out, vec1, vec2], dim=1)
        return drop(F.relu(self.encoder2(out)))


class LRBilinearFusion(nn.Module):
    """Low-rank bilinear fusion (reference ``blocks.py:187-249``): the gated
    sides of :class:`BilinearFusion`, each extended by a leading 1 and
    projected by ``rank`` factors (``h1_factor`` [rank, d1 + 1, out],
    ``h2_factor``), their products summed by ``fusion_weights`` [1, rank]
    plus ``fusion_bias`` [1, out].  Init: Xavier-normal factors and
    weights, a zero bias (the JAX module's)."""

    def __init__(self, skip: int = 0, gate1: int = 1, gate2: int = 1, dim1: int = 128,
                 dim2: int = 128, scale_dim1: int = 1, scale_dim2: int = 1,
                 dropout_rate: float = 0.25, rank: int = 16, output_dim: int = 4):
        super().__init__()
        self.gate1, self.gate2 = gate1, gate2
        self.dropout_rate = dropout_rate
        self.out_features = output_dim
        og1, og2 = dim1 // scale_dim1, dim2 // scale_dim2
        self.linear_h1 = nn.Linear(dim1, og1)
        if gate1:
            self.linear_z1 = nn.Linear(dim1 + dim2, og1)
        self.linear_o1 = nn.Linear(og1, og1)
        self.linear_h2 = nn.Linear(dim2, og2)
        if gate2:
            self.linear_z2 = nn.Linear(dim1 + dim2, og2)
        self.linear_o2 = nn.Linear(og2, og2)
        self.h1_factor = nn.Parameter(torch.empty(rank, og1 + 1, output_dim))
        self.h2_factor = nn.Parameter(torch.empty(rank, og2 + 1, output_dim))
        self.fusion_weights = nn.Parameter(torch.empty(1, rank))
        self.fusion_bias = nn.Parameter(torch.empty(1, output_dim))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        for t in (self.h1_factor, self.h2_factor, self.fusion_weights):
            # flax's xavier_normal: fan_in = shape[-2], fan_out = shape[-1],
            # the leading axes a receptive field
            field = math.prod(t.shape[:-2])
            std = math.sqrt(2.0 / (field * (t.shape[-2] + t.shape[-1])))
            t.normal_(0.0, std, generator=generator)
        self.fusion_bias.zero_()

    def forward(self, vec1: torch.Tensor, vec2: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(x):
            return dropout(x, self.dropout_rate, generator)

        both = torch.cat([vec1, vec2], dim=1)
        o1 = F.relu(self.linear_h1(vec1))
        if self.gate1:
            o1 = torch.sigmoid(self.linear_z1(both)) * o1
        o1 = drop(F.relu(self.linear_o1(o1)))
        o2 = F.relu(self.linear_h2(vec2))
        if self.gate2:
            o2 = torch.sigmoid(self.linear_z2(both)) * o2
        o2 = drop(F.relu(self.linear_o2(o2)))

        ones = o1.new_ones(o1.shape[0], 1)
        f1 = torch.einsum("bd,rdo->rbo", torch.cat([ones, o1], dim=1), self.h1_factor)
        f2 = torch.einsum("bd,rdo->rbo", torch.cat([ones, o2], dim=1), self.h2_factor)
        return torch.einsum("xr,rbo->bo", self.fusion_weights, f1 * f2) + self.fusion_bias


def masked_attention_pool(
    scores: torch.Tensor,  # [B, N, C] pre-softmax scores
    feats: torch.Tensor,  # [B, N, D]
    valid: Optional[torch.Tensor] = None,  # [B, N] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(scores) over N (masked), then the weighted sum of feats.
    Returns (pooled [B, C, D], weights [B, C, N])."""
    s = scores.transpose(-1, -2)
    if valid is not None:
        s = masked_fill_neg(s, valid[:, None, :])
    w = torch.softmax(s, dim=-1)
    return w @ feats, w


class PPEG(nn.Module):
    """Pyramid positional encoding: 7/5/3 depthwise convs over the token
    grid plus the grid itself, cls token excluded (reference
    ``blocks.py:271-285``).  Each conv's kernel is ``{name}_kernel``
    ``[C, 1, k, k]`` and its bias ``{name}_bias`` ``[C]``, as in the JAX
    tree; both draw U(±1/k).

    With a ``seq`` axis (the ring layout), ``x`` is this rank's band of
    grid tokens (no cls; H/sp whole grid rows, ``[B, H·W/sp, C]``); 3-row
    halos come from the neighbouring ranks and the convs run without row
    padding on the haloed slab, equal to the SAME convs over the grid."""

    KERNELS = (("proj", 7), ("proj1", 5), ("proj2", 3))
    HALO = 3  # rows: the 7 × 7 conv's reach

    def __init__(self, dim: int = 512, seq=None):
        super().__init__()
        self.seq = seq
        for name, k in self.KERNELS:
            self.register_parameter(f"{name}_kernel", nn.Parameter(torch.empty(dim, 1, k, k)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.empty(dim)))
        self.reset_own_parameters(None)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        for name, k in self.KERNELS:
            bound = 1.0 / math.sqrt(k * k)
            getattr(self, f"{name}_kernel").uniform_(-bound, bound, generator=generator)
            getattr(self, f"{name}_bias").uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:  # [B, 1 + H·W, C]
        b, _, c = x.shape
        if self.seq is None:
            cls_token, feat = x[:, :1], x[:, 1:]
            grid = feat.transpose(1, 2).reshape(b, c, H, W)
            src, rows = grid, H
        else:
            from ..parallel.collectives import shift

            sp, r = self.seq.size, self.HALO
            if H % sp or H // sp < r:
                raise ValueError(f"PPEG ring layout needs grid rows divisible by the seq "
                                 f"axis with >= {r} rows a rank (H={H}, sp={sp})")
            rows = H // sp
            grid = x.transpose(1, 2).reshape(b, c, rows, W)
            # rank i-1's bottom rows above the band, rank i+1's top rows below
            # (zeros at the ends: the SAME padding)
            src = torch.cat([shift(grid[:, :, -r:], self.seq, 1, cyclic=False), grid,
                             shift(grid[:, :, :r], self.seq, -1, cyclic=False)], dim=2)
        # each conv in float32 (float64 for a float64 input), returned in
        # x's dtype, as JAX computes them under bf16
        wide = torch.promote_types(x.dtype, torch.float32)
        out = grid
        for name, k in self.KERNELS:
            if self.seq is None:
                inp, pad = src, (k // 2, k // 2)
            else:  # the slab rows this conv reaches, no row padding
                inp, pad = src[:, :, self.HALO - k // 2:self.HALO + rows + k // 2], (0, k // 2)
            out = out + F.conv2d(inp.to(wide), getattr(self, f"{name}_kernel").to(wide),
                                 getattr(self, f"{name}_bias").to(wide), padding=pad,
                                 groups=c).to(x.dtype)
        out = out.reshape(b, c, rows * W).transpose(1, 2)
        return out if self.seq is not None else torch.cat([cls_token, out], dim=1)


def square_pad(features: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Pad a bag to a square token grid by repeating its leading tokens
    (reference Transformer_P pad, ``blocks.py:300-305``).
    Returns (features, valid, side)."""
    n = features.shape[1]
    side = int(math.ceil(math.sqrt(n)))
    add = side * side - n
    if add > 0:
        features = torch.cat([features, features[:, :add]], dim=1)
        if valid is not None:
            valid = torch.cat([valid, valid[:, :add]], dim=1)
    return features, valid, side



class _ClsEncoder(nn.Module):
    """cls token, two TransLayers and a LayerNorm: what the two encoders
    share.  ``impl`` (``"nystrom"``/``"flash"``) and ``pinv_mode`` reach
    both TransLayers."""

    def __init__(self, feature_dim: int = 512, impl: str = "nystrom",
                 pinv_mode: str = "chain"):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, feature_dim))
        self.layer1 = TransLayer(feature_dim, impl, pinv_mode=pinv_mode)
        self.layer2 = TransLayer(feature_dim, impl, pinv_mode=pinv_mode)
        self.norm = nn.LayerNorm(feature_dim, eps=1e-5)
        self.reset_own_parameters(None)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.cls_token.normal_(0.0, 1e-6, generator=generator)

    def with_cls(self, h: torch.Tensor, valid: Optional[torch.Tensor]):
        """cls prepended to ``h``, and to the mask a valid bit for it."""
        b = h.shape[0]
        h = torch.cat([self.cls_token.expand(b, -1, -1), h], dim=1)
        return h, None if valid is None else torch.cat([valid.new_ones(b, 1), valid], dim=1)


class Transformer_P(_ClsEncoder):
    """TransMIL-style pathology encoder: square-pad, cls, TransLayer, PPEG,
    TransLayer, LayerNorm (reference ``blocks.py:288-318``), the layers
    masked by ``valid`` (the padded grid cells repeat the leading tokens and
    their mask bits).  Returns (cls [B, D], tokens [B, side², D])."""

    def __init__(self, feature_dim: int = 512, impl: str = "nystrom",
                 pinv_mode: str = "chain"):
        super().__init__(feature_dim, impl, pinv_mode)
        self.pos_layer = PPEG(feature_dim)

    def forward(self, features: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h, valid_sq, side = square_pad(features, valid)
        h, vmask = self.with_cls(h, valid_sq)
        h = self.layer1(h, mask=vmask, generator=generator)
        h = self.pos_layer(h, side, side)
        h = self.norm(self.layer2(h, mask=vmask, generator=generator))
        return h[:, 0], h[:, 1:]


class Transformer_G(_ClsEncoder):
    """Genomics encoder: cls, TransLayer, TransLayer, LayerNorm (reference
    ``blocks.py:321-342``).  Returns (cls [B, D], tokens [B, N, D])."""

    def forward(self, features: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h, vmask = self.with_cls(features, valid)
        h = self.layer1(h, mask=vmask, generator=generator)
        h = self.norm(self.layer2(h, mask=vmask, generator=generator))
        return h[:, 0], h[:, 1:]
