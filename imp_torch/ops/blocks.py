"""Shared NN blocks of the MIL baselines — the PyTorch counterpart of the
non-sequence-parallel parts of ``imp_tpu/ops/blocks.py`` (reference
``medmm/modeling/ops/blocks.py``), over fixed-shape masked inputs.
Parameter names follow the JAX package's tree (``imp_torch.convert``)."""

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
