"""Shared NN blocks of the MIL baselines and the UMEML heads — the PyTorch
counterpart of the non-sequence-parallel parts of ``imp_tpu/ops/blocks.py``
(reference ``medmm/modeling/ops/blocks.py``), over fixed-shape masked
inputs.  Parameter names follow the JAX package's tree
(``imp_torch.convert``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .attention import dropout, masked_fill_neg


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
    tree; both draw U(±1/k)."""

    KERNELS = (("proj", 7), ("proj1", 5), ("proj2", 3))

    def __init__(self, dim: int = 512):
        super().__init__()
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
        cls_token, feat = x[:, :1], x[:, 1:]
        grid = feat.transpose(1, 2).reshape(b, c, H, W)
        out = grid
        for name, k in self.KERNELS:
            out = out + F.conv2d(grid, getattr(self, f"{name}_kernel"),
                                 getattr(self, f"{name}_bias"), padding=k // 2, groups=c)
        return torch.cat([cls_token, out.reshape(b, c, H * W).transpose(1, 2)], dim=1)


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
