"""The multimodal fusion baseline trainers MCAT, CMTA, Porpoise, ConCAT, ADD
and HFB — the PyTorch counterpart of ``imp_tpu/engine/fusion_trainers.py``
(reference ``medmm/engine/{mcat,cmta,porpoise,concat,add,hfb}.py``),
registered under the same names.

Each builds a :class:`FusionNet` (the fusion module of ``models/fusion.py``
plus a task classifier) through the model registry (``mcat``, ``cmta``,
``porpoise``, ``hfb``), so the builders can be rebound as the TransMIL
one can.  MCAT accumulates gradients over 32 steps unless the config sets
``OPTIM.GRAD_ACCUM`` (reference ``mcat.py:175-193``); CMTA adds its
alignment loss; CMTA's eight TransLayers follow ``TPU.ATTENTION`` (under
``flash``, K1 forward and K2/K3 backward on the card) and take the
``pinv_mode`` of their builder.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from . import TRAINER_REGISTRY
from .trainer import OmicTrainer
from ..models import MODEL_REGISTRY, build_module, resolve_attention
from ..models.fusion import CMTA as CMTA_MODULE
from ..models.fusion import HFB as HFB_MODULE
from ..models.fusion import MCAT as MCAT_MODULE
from ..models.fusion import OMIC_SIZES
from ..models.fusion import Porpoise as PORPOISE_MODULE
from ..ops.attention import train_generator


class FusionNet(nn.Module):
    """A fusion module and a task classifier (the reference's ``*_NET``
    wrappers, e.g. ``engine/mcat.py:18-74``): ``model(batch, train,
    generator)`` returns ``{"logits": ..., **extras}``."""

    def __init__(self, fusion_module: nn.Module, num_classes: int):
        super().__init__()
        self.fusion_module = fusion_module
        self.classifier = nn.Linear(fusion_module.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g = train_generator(train, generator)
        out = self.fusion_module(batch["img"], batch["mol"], batch.get("img_mask"), g)
        out, extras = out if isinstance(out, tuple) else (out, {})
        return {"logits": self.classifier(out), **extras}


def _fusion_net(make, num_classes, device, generator) -> FusionNet:
    return build_module(lambda: FusionNet(make(), num_classes), device, generator)


@MODEL_REGISTRY.register_as("mcat")
def build_mcat(cfg, num_classes: int, omic_dim: int = 1000, device="cuda",
               generator: Optional[torch.Generator] = None) -> FusionNet:
    """MCAT at ``MODEL.SIZE`` with ``MODEL.FUSION`` (default concat) over five
    200-gene signatures."""
    return _fusion_net(lambda: MCAT_MODULE(
        fusion=cfg.MODEL.FUSION or "concat", path_input_dim=cfg.DATASET.PATH.DIM,
        omic_sizes=OMIC_SIZES, model_size_wsi=cfg.MODEL.SIZE, model_size_omic=cfg.MODEL.SIZE,
    ), num_classes, device, generator)


@MODEL_REGISTRY.register_as("cmta")
def build_cmta(cfg, num_classes: int, omic_dim: int = 1000, device="cuda",
               generator: Optional[torch.Generator] = None,
               pinv_mode: str = "chain") -> FusionNet:
    """CMTA with ``MODEL.FUSION`` (default concat), its TransLayers by
    ``TPU.ATTENTION`` and ``pinv_mode``."""
    return _fusion_net(lambda: CMTA_MODULE(
        fusion=cfg.MODEL.FUSION or "concat", path_input_dim=cfg.DATASET.PATH.DIM,
        omic_sizes=OMIC_SIZES, attention=resolve_attention(cfg.TPU.ATTENTION),
        pinv_mode=pinv_mode,
    ), num_classes, device, generator)


@MODEL_REGISTRY.register_as("porpoise")
def build_porpoise(cfg, num_classes: int, omic_dim: int = 1000, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   fusion: Optional[str] = None) -> FusionNet:
    """Porpoise over the first min(1000, ``omic_dim``) genes, with
    ``fusion`` (ConCAT: concat, ADD: add) or ``MODEL.FUSION`` (default
    bilinear)."""
    return _fusion_net(lambda: PORPOISE_MODULE(
        fusion=fusion or cfg.MODEL.FUSION or "bilinear", omic_input_dim=min(1000, omic_dim),
        path_input_dim=cfg.DATASET.PATH.DIM, model_size_wsi=cfg.MODEL.SIZE,
        model_size_omic=cfg.MODEL.SIZE,
    ), num_classes, device, generator)


@MODEL_REGISTRY.register_as("hfb")
def build_hfb(cfg, num_classes: int, omic_dim: int = 1000, device="cuda",
              generator: Optional[torch.Generator] = None) -> FusionNet:
    """HFB over the first 1 000 genes."""
    return _fusion_net(lambda: HFB_MODULE(path_input_dim=cfg.DATASET.PATH.DIM),
                       num_classes, device, generator)


class _FusionTrainer(OmicTrainer):
    #: ``OPTIM.GRAD_ACCUM`` when the config leaves it at 1
    default_grad_accum = 1

    def check_cfg(self, cfg):
        if self.default_grad_accum > 1 and cfg.OPTIM.GRAD_ACCUM == 1:
            frozen = cfg.is_frozen()
            cfg.defrost()
            cfg.OPTIM.GRAD_ACCUM = self.default_grad_accum
            if frozen:
                cfg.freeze()
        super().check_cfg(cfg)


@TRAINER_REGISTRY.register()
class MCAT(_FusionTrainer):
    MODEL_NAME = "mcat"
    default_grad_accum = 32


@TRAINER_REGISTRY.register()
class CMTA(_FusionTrainer):
    MODEL_NAME = "cmta"

    def extra_loss(self, out, batch):
        """α·(mean|sg(pe) − pd| + mean|sg(ge) − gd|), α = ``LOSS.CMTA_ALPHA``:
        the decoders' cls tokens pulled to the encoders' (detached) ones, a
        functional L1 in place of the reference's ``nn.L1Loss(a, b)``
        (``engine/cmta.py``)."""
        pe = out["cls_token_pathomics_encoder"].detach()
        ge = out["cls_token_genomics_encoder"].detach()
        sim_p = (pe - out["cls_token_pathomics_decoder"]).abs().mean()
        sim_g = (ge - out["cls_token_genomics_decoder"]).abs().mean()
        return float(self.cfg.LOSS.CMTA_ALPHA) * (sim_p + sim_g)


@TRAINER_REGISTRY.register()
class Porpoise(_FusionTrainer):
    MODEL_NAME = "porpoise"


@TRAINER_REGISTRY.register()
class ConCAT(Porpoise):
    """Porpoise with concat fusion (reference ``engine/concat.py``)."""

    def build_kwargs(self):
        return {**super().build_kwargs(), "fusion": "concat"}


@TRAINER_REGISTRY.register()
class ADD(Porpoise):
    """Porpoise with additive fusion (reference ``engine/add.py``)."""

    def build_kwargs(self):
        return {**super().build_kwargs(), "fusion": "add"}


@TRAINER_REGISTRY.register()
class HFB(_FusionTrainer):
    MODEL_NAME = "hfb"
