"""MIL baselines ABMIL and TransMIL — the PyTorch counterpart of
``imp_tpu/models/mil.py`` (reference ``medmm/modeling/mil/``), batched over
slides with masks.  TransMIL's TransLayer implementation (``"nystrom"``
or ``"flash"``), the Nyström pseudo-inverse mode (``"chain"`` or
``"fused"``) and its sequence parallelism (a ``seq`` axis and
``sp_mode``) are constructor arguments."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import TransLayer, dropout, gather_tokens_replicated
from ..parallel.collectives import replicate_from
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
    (reference ``mil/transmil.py:12-68``).

    With a ``seq`` axis the bag arrives as this rank's token band
    [B, N/sp, D], in one of two layouts (``sp_mode``):

    * ``"gather"``: the fc runs on the band, the tokens gather once,
      square-pad, cls and PPEG run replicated, and the TransLayers split
      the attention's query band across the ranks;
    * ``"ring"``: the tokens stay banded end to end (the TransLayers' ring
      attention, PPEG's row halos) and only the replicated cls row leaves
      the band, broadcast from rank 0.  The global bag must be a square
      whose side divides by sp with >= 3 grid rows a rank
      (``DATASET.BAG_PAD`` 10000 = 100², sp in {2, 4, 5, 10})."""

    out_features = 512

    def __init__(self, path_input_dim: int = 512, attention: str = "nystrom",
                 pinv_mode: str = "chain", seq=None, sp_mode: str = "gather"):
        super().__init__()
        self.seq, self.sp_mode = seq, sp_mode
        ring = seq is not None and sp_mode == "ring"
        self._fc1 = nn.Linear(path_input_dim, 512)
        self.cls_token = nn.Parameter(torch.randn(1, 1, 512))
        self.layer1 = TransLayer(512, attention, pinv_mode=pinv_mode, seq=seq, sp_mode=sp_mode)
        self.pos_layer = PPEG(512, seq=seq if ring else None)
        self.layer2 = TransLayer(512, attention, pinv_mode=pinv_mode, seq=seq, sp_mode=sp_mode)
        self.norm = nn.LayerNorm(512, eps=1e-5)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(generator=generator)

    def forward(self, x_path: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.seq is not None and self.sp_mode == "ring":
            return self._ring_forward(x_path, valid, generator)
        h = F.relu(self._fc1(x_path))
        if valid is not None:
            h = h * valid[..., None]
        if self.seq is not None:
            h = gather_tokens_replicated(h, self.seq, 1)
            if valid is not None:
                valid = gather_tokens_replicated(valid, self.seq, 1)
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

    def _ring_forward(self, x_band, valid, generator):
        ax = self.seq
        b, nb, _ = x_band.shape
        n = nb * ax.size
        side = math.isqrt(n)
        if side * side != n:
            raise ValueError(f"TPU.SP_ATTENTION=ring needs a square global bag (got {n}); "
                             f"set DATASET.BAG_PAD to a square (10000, 4096, 102400, ...)")
        if side % ax.size or side // ax.size < 3:
            raise ValueError(f"the ring layout needs the grid side ({side}) divisible by the "
                             f"seq-axis size ({ax.size}) with >= 3 grid rows a rank")
        h = F.relu(self._fc1(x_band))
        if valid is not None:
            h = h * valid[..., None]
        cls = self.cls_token.expand(b, -1, -1)
        h, cls = self.layer1(h, mask=valid, generator=generator, cls=cls)
        h = self.pos_layer(h, side, side)
        h, cls = self.layer2(h, mask=valid, generator=generator, cls=cls)
        # the final LayerNorm is per token: the cls row alone is the
        # replicated path's [:, 0]; rank 0's row on every rank
        return replicate_from(self.norm(cls)[:, 0], ax, 0)
