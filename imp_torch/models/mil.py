"""MIL baselines ABMIL and TransMIL — the PyTorch counterpart of
``imp_tpu/models/mil.py`` (reference ``medmm/modeling/mil/``), batched over
slides with masks.  TransMIL runs its non-sequence-parallel path; its
TransLayer implementation (``"nystrom"`` or ``"flash"``) and the Nyström
pseudo-inverse mode (``"chain"`` or ``"fused"``) are constructor
arguments."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import TransLayer, dropout
from ..ops.blocks import PPEG, Attn_Net_Gated, masked_attention_pool, square_pad


class ABMIL_MODULE(nn.Module):
    """Gated-attention MIL pooling (reference ``mil/abmil.py:11-55``);
    ``out_features`` = 256 (small) or 384 (big)."""

    SIZES = {"small": (512, 256), "big": (512, 384)}

    def __init__(self, path_input_dim: int = 512, model_size_wsi: str = "small",
                 dropout: float = 0.25):
        super().__init__()
        hidden, self.out_features = self.SIZES[model_size_wsi]
        self.dropout = dropout
        self.fc = nn.Linear(path_input_dim, hidden)
        self.attention_net = Attn_Net_Gated(hidden, D=self.out_features, dropout=dropout > 0)
        self.rho = nn.Linear(hidden, self.out_features)

    def forward(self, x_path: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.fc(x_path)), self.dropout, generator)
        scores, h = self.attention_net(h, generator)
        pooled, _ = masked_attention_pool(scores, h, valid)  # [B, 1, hidden]
        return dropout(F.relu(self.rho(pooled[:, 0])), self.dropout, generator)


class TransMIL_MODULE(nn.Module):
    """fc → square-pad → cls → TransLayer → PPEG → TransLayer → LN → cls
    (reference ``mil/transmil.py:12-68``)."""

    out_features = 512

    def __init__(self, path_input_dim: int = 512, attention: str = "nystrom",
                 pinv_mode: str = "chain"):
        super().__init__()
        self._fc1 = nn.Linear(path_input_dim, 512)
        self.cls_token = nn.Parameter(torch.randn(1, 1, 512))
        self.layer1 = TransLayer(512, attention, pinv_mode=pinv_mode)
        self.pos_layer = PPEG(512)
        self.layer2 = TransLayer(512, attention, pinv_mode=pinv_mode)
        self.norm = nn.LayerNorm(512, eps=1e-5)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(generator=generator)

    def forward(self, x_path: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self._fc1(x_path))
        if valid is not None:
            h = h * valid[..., None]
        h, valid_sq, side = square_pad(h, valid)
        b = h.shape[0]
        h = torch.cat([self.cls_token.expand(b, -1, -1), h], dim=1)
        vmask = None
        if valid_sq is not None:
            vmask = torch.cat([valid_sq.new_ones(b, 1), valid_sq], dim=1)
        h = self.layer1(h, mask=vmask, generator=generator)
        h = self.pos_layer(h, side, side)
        h = self.layer2(h, mask=vmask, generator=generator)
        return self.norm(h)[:, 0]
