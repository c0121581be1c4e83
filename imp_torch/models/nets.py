"""Task networks wrapping the MIL modules with a classifier — the PyTorch
counterpart of ``imp_tpu/models/nets.py`` (the reference's per-engine
``*_NET`` classes).  Each maps a batch dict to logits; a survival head has
4 bins.  ``train=True`` draws dropout from the ``generator`` passed in."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.attention import train_generator
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
