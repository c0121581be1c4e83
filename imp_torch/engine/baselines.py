"""The unimodal baseline trainers ABMIL and TransMIL (pathology), SNN and
SNNM (genomics) — the PyTorch counterpart of ``imp_tpu/engine/baselines.py``
(reference ``medmm/engine/{abmil,transmil,snn,snnm}.py``), registered under
the same names.  CLIPOMIC needs the CLIP text tower, ROADMAP.md §A item 7."""

from __future__ import annotations

from . import TRAINER_REGISTRY
from .trainer import OmicTrainer, StandardTrainer, deferred


@TRAINER_REGISTRY.register()
class ABMIL(StandardTrainer):
    MODEL_NAME = "abmil"


@TRAINER_REGISTRY.register()
class TransMIL(StandardTrainer):
    """TransMIL; its two TransLayers follow ``TPU.ATTENTION`` (under
    ``flash``, K1 forward and K2/K3 backward on the card)."""

    MODEL_NAME = "transmil"


@TRAINER_REGISTRY.register()
class SNN(OmicTrainer):
    """SNN over the first min(1000, G) genes."""

    MODEL_NAME = "snn"


@TRAINER_REGISTRY.register()
class SNNM(OmicTrainer):
    """SNN_M over chunks of 50 genes."""

    MODEL_NAME = "snnm"


@TRAINER_REGISTRY.register()
class CLIPOMIC(StandardTrainer):
    """The CLIP-text-tower omics baseline: not ported yet."""

    def check_cfg(self, cfg):
        raise deferred("CLIPOMIC (the CLIP text tower and its prompt learner)", 7)
