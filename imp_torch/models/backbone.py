"""Genomic backbones SNN and SNN_M — the PyTorch counterpart of
``imp_tpu/models/backbone.py`` (reference ``medmm/modeling/backbone/``).
Their Linears draw the reference's ``init_max_weights``, N(0, 1/√fan_in)
with a zero bias."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import dropout
from ..ops.blocks import Attn_Net_Gated, alpha_dropout, masked_attention_pool


class MaxLinear(nn.Linear):
    """A Linear initialised as ``init_max_weights`` (reference
    ``ops/utils.py:86-100``): weight N(0, 1/√fan_in), bias 0."""

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features), generator=generator)
        self.bias.zero_()


class SNNMaxBlock(nn.Module):
    """``SNN_Block`` over a :class:`MaxLinear` (the reference applies
    ``init_max_weights`` after construction, ``backbone/snn.py:31``)."""

    def __init__(self, dim1: int, dim2: int, dropout: float = 0.25):
        super().__init__()
        self.rate = dropout
        self.fc = MaxLinear(dim1, dim2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return alpha_dropout(F.elu(self.fc(x)), self.rate, generator)


#: hidden widths by ``model_size_omic``
SNN_HIDDEN = {"small": [256, 256, 256, 256], "big": [1024, 1024, 1024, 256]}
#: SNN_M's: the "big" list's leading 1 is the JAX module's (kept as it is)
SNNM_HIDDEN = {"small": [256, 256, 256, 256], "big": [1, 1024, 1024, 256]}


def _blocks(module: nn.Module, dim: int, hidden, dropout: float) -> None:
    """``fc_omic_i``: the chain of SNN blocks, the first at dropout 0.25."""
    for i, width in enumerate(hidden):
        setattr(module, f"fc_omic_{i}", SNNMaxBlock(dim, width, 0.25 if i == 0 else dropout))
        dim = width


class SNN(nn.Module):
    """4-layer self-normalising MLP over the omics vector (reference
    ``backbone/snn.py:9-38``)."""

    out_features = 256

    def __init__(self, num_mol: int = 1000, dropout: float = 0.1,
                 model_size_omic: str = "small"):
        super().__init__()
        self.depth = len(SNN_HIDDEN[model_size_omic])
        _blocks(self, num_mol, SNN_HIDDEN[model_size_omic], dropout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"fc_omic_{i}")(x, generator)
        return x


class SNN_M(nn.Module):
    """SNN over the omics cut into ``G // num_mol`` chunks of ``num_mol``
    genes (the tail dropped), then gated-attention pooling over the chunks
    (reference ``backbone/snnm.py:11-58``)."""

    out_features = 256

    def __init__(self, num_mol: int = 50, dropout: float = 0.1,
                 model_size_omic: str = "small"):
        super().__init__()
        hidden = SNNM_HIDDEN[model_size_omic]
        self.num_mol, self.rate, self.depth = num_mol, dropout, len(hidden)
        _blocks(self, num_mol, hidden, dropout)
        self.fc = MaxLinear(hidden[3], hidden[2])
        self.attention_net = Attn_Net_Gated(hidden[2], D=hidden[3], dropout=dropout > 0)
        self.rho = MaxLinear(hidden[2], hidden[3])

    def forward(self, x_omic: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, g = x_omic.shape
        n_chunks = g // self.num_mol
        h = x_omic[:, : n_chunks * self.num_mol].reshape(b, n_chunks, self.num_mol)
        for i in range(self.depth):
            h = getattr(self, f"fc_omic_{i}")(h, generator)
        h = dropout(F.relu(self.fc(h)), self.rate, generator)
        scores, h = self.attention_net(h, generator)
        pooled, _ = masked_attention_pool(scores, h)
        return dropout(F.relu(self.rho(pooled[:, 0])), self.rate, generator)
