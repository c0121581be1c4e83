"""Task networks wrapping the MIL modules and the genomic backbones with a
classifier — the PyTorch counterpart of ``imp_tpu/models/nets.py`` (the
reference's per-engine ``*_NET`` classes).  Each maps a batch dict to
logits; a survival head has 4 bins.  ``train=True`` draws dropout from the
``generator`` passed in."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.attention import train_generator
from .backbone import SNN, SNN_M
from .mil import ABMIL_MODULE, TransMIL_MODULE


class ABMIL_NET(nn.Module):
    def __init__(self, num_classes: int, path_input_dim: int = 512,
                 model_size_wsi: str = "small", dropout: float = 0.25):
        super().__init__()
        self.mil = ABMIL_MODULE(path_input_dim, model_size_wsi, dropout)
        self.classifier = nn.Linear(self.mil.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = train_generator(train, generator)
        return self.classifier(self.mil(batch["img"], batch.get("img_mask"), g))


class TransMIL_NET(nn.Module):
    def __init__(self, num_classes: int, path_input_dim: int = 512,
                 attention: str = "nystrom", pinv_mode: str = "chain"):
        super().__init__()
        self.mil = TransMIL_MODULE(path_input_dim, attention, pinv_mode)
        self.classifier = nn.Linear(self.mil.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = train_generator(train, generator)
        return self.classifier(self.mil(batch["img"], batch.get("img_mask"), g))


class SNN_NET(nn.Module):
    """SNN over the first ``num_mol`` genes."""

    def __init__(self, num_classes: int, num_mol: int = 1000, dropout: float = 0.1,
                 model_size_omic: str = "small"):
        super().__init__()
        self.num_mol = num_mol
        self.backbone = SNN(num_mol, dropout, model_size_omic)
        self.classifier = nn.Linear(self.backbone.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = train_generator(train, generator)
        return self.classifier(self.backbone(batch["mol"][:, : self.num_mol], g))


class SNNM_NET(nn.Module):
    """SNN_M over every gene, in chunks of ``num_mol``."""

    def __init__(self, num_classes: int, num_mol: int = 50, dropout: float = 0.1,
                 model_size_omic: str = "small"):
        super().__init__()
        self.backbone = SNN_M(num_mol, dropout, model_size_omic)
        self.classifier = nn.Linear(self.backbone.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = train_generator(train, generator)
        return self.classifier(self.backbone(batch["mol"], g))
