"""The unimodal baseline trainers ABMIL and TransMIL (pathology), SNN and
SNNM (genomics) — the PyTorch counterpart of ``imp_tpu/engine/baselines.py``
(reference ``medmm/engine/{abmil,transmil,snn,snnm}.py``), registered under
the same names, and CLIPOMIC, the CLIP-text-tower omics baseline
(``imp_tpu/engine/baselines.py:69-160``, reference
``medmm/engine/clipomic.py``)."""

from __future__ import annotations

from typing import Dict

from torch import nn

from . import TRAINER_REGISTRY
from .trainer import OmicTrainer, StandardTrainer, validated_sp_mode


@TRAINER_REGISTRY.register()
class ABMIL(StandardTrainer):
    MODEL_NAME = "abmil"


@TRAINER_REGISTRY.register()
class TransMIL(StandardTrainer):
    """TransMIL; its two TransLayers follow ``TPU.ATTENTION`` (under
    ``flash``, K1 forward and K2/K3 backward on the card).  On a mesh whose
    ``seq`` axis has more than one rank the bag splits over it, in the
    ``TPU.SP_ATTENTION`` layout, and the TransLayers run exact attention
    (K1–K3 on each rank's band)."""

    MODEL_NAME = "transmil"

    def network_seq_axis(self):
        return self.mesh.seq if self.mesh.seq.size > 1 else None

    def build_kwargs(self) -> Dict:
        if self.sp_axis is None:
            return {}
        return {"seq": self.sp_axis, "sp_mode": validated_sp_mode(self.cfg)}


@TRAINER_REGISTRY.register()
class SNN(OmicTrainer):
    """SNN over the first min(1000, G) genes."""

    MODEL_NAME = "snn"


@TRAINER_REGISTRY.register()
class SNNM(OmicTrainer):
    """SNN_M over chunks of 50 genes."""

    MODEL_NAME = "snnm"


#: the text tower's parameters inside the CLIPOMIC backbone — the reference
#: freezes everything named ``omic_encoder`` (the CLIP text transformer,
#: positional embedding, ln_final, text_projection; ref
#: ``engine/clipomic.py:124-126``) and keeps the token-embedding rows as
#: frozen buffers (ref ``backbone/clipomic.py:70-72``)
CLIP_TEXT_FROZEN = (
    "resblocks",
    "ln_final",
    "positional_embedding",
    "text_projection",
    "token_embedding",
)


@TRAINER_REGISTRY.register()
class CLIPOMIC(OmicTrainer):
    """CLIPOMIC over 5 chunks of the genes.  With
    ``MODEL.BACKBONE.CLIP_CHECKPOINT`` (an OpenAI CLIP ``state_dict`` or
    TorchScript archive) the text tower loads those weights; it is frozen
    either way: only ``omic_fc``, ``fc``, the attention pool, ``rho`` and
    the classifier train, the reference's ``requires_grad`` partition."""

    MODEL_NAME = "clipomic"

    def build_network(self) -> nn.Module:
        return self.init_network_params(super().build_network())

    def init_network_params(self, net: nn.Module) -> nn.Module:
        """Load the text tower of ``MODEL.BACKBONE.CLIP_CHECKPOINT`` into
        ``net``'s backbone, each tensor's name and shape checked."""
        path = self.cfg.MODEL.BACKBONE.CLIP_CHECKPOINT
        if not path:
            print("CLIPOMIC: no MODEL.BACKBONE.CLIP_CHECKPOINT — text tower "
                  "stays randomly initialized (frozen regardless)")
            return net
        from ..convert import convert_torch_clip_state, load_torch_checkpoint

        _, txt = convert_torch_clip_state(load_torch_checkpoint(path),
                                          self.cfg.MODEL.BACKBONE.CLIP)
        backbone = net.genomic_backbone
        state = backbone.state_dict()
        for key, value in txt.items():
            if key not in state:
                raise KeyError(f"unexpected CLIP text param {key}")
            if value.shape != state[key].shape:
                raise ValueError(f"CLIP text param {key}: {tuple(value.shape)} != "
                                 f"{tuple(state[key].shape)}")
        backbone.load_state_dict({**state, **txt}, strict=True)
        print(f"CLIPOMIC: loaded pretrained CLIP text tower from {path}")
        return net

    def param_labels(self) -> Dict[str, str]:
        def label(name: str) -> str:
            parts = name.split(".")
            frozen = parts[0] == "genomic_backbone" and parts[1].startswith(CLIP_TEXT_FROZEN)
            return "frozen" if frozen else "train"

        return {n: label(n) for n, _ in self.model.named_parameters()}
