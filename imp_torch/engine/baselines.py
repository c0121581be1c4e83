"""The MIL baseline trainers ABMIL and TransMIL — the PyTorch counterpart of
``imp_tpu/engine/baselines.py`` (reference ``medmm/engine/{abmil,transmil}.py``),
registered under the same names.  SNN, SNNM and CLIPOMIC are ROADMAP.md
§A item 6."""

from __future__ import annotations

import torch

from . import TRAINER_REGISTRY
from .trainer import StandardTrainer
from ..models import build_model, survival_num_classes


class _MILTrainer(StandardTrainer):
    MODEL_NAME = ""

    def build_network(self):
        cfg = self.cfg
        return build_model(
            self.MODEL_NAME, cfg=cfg,
            num_classes=survival_num_classes(cfg.TASK.NAME, self.num_classes),
            device=self.device, generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
        )


@TRAINER_REGISTRY.register()
class ABMIL(_MILTrainer):
    MODEL_NAME = "abmil"


@TRAINER_REGISTRY.register()
class TransMIL(_MILTrainer):
    """TransMIL; its two TransLayers follow ``TPU.ATTENTION`` (under
    ``flash``, K1 forward and K2/K3 backward on the card)."""

    MODEL_NAME = "transmil"
