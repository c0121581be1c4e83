"""Model registry — the PyTorch counterpart of ``imp_tpu/models/__init__.py``.
Same config names; this slice registers ``umeml_gan``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.registry import Registry
from .umeml_gan import UMEML_GAN

MODEL_REGISTRY = Registry("MODEL")

#: cfg.TPU.ATTENTION -> TransLayer implementation ("auto" is the reference's
#: Nyström, as in the JAX trainer)
_ATTENTION = {"auto": "nystrom", "nystrom": "nystrom", "flash": "flash"}


def survival_num_classes(task: str, num_classes: int) -> int:
    return 4 if task == "Survival" else num_classes


def resolve_attention(value: str) -> str:
    if value not in _ATTENTION:
        raise ValueError(
            f"TPU.ATTENTION={value!r}: the port's TransLayer runs "
            f"{sorted(_ATTENTION)}"
        )
    return _ATTENTION[value]


@MODEL_REGISTRY.register_as("umeml_gan")
def build_umeml_gan(
    cfg,
    num_classes: int,
    gene_group_indexes: Sequence[Sequence[int]],
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> UMEML_GAN:
    """UMEML_GAN from ``cfg`` and the gene groups, initialised from
    ``generator`` (default: seed 0) and moved to ``device``, in eval mode."""
    if cfg.MODEL.UMEML.PROTO_INIT != "uniform":
        raise NotImplementedError(
            f"MODEL.UMEML.PROTO_INIT={cfg.MODEL.UMEML.PROTO_INIT!r} needs the "
            "PLIP text tower: not ported yet (ROADMAP.md §A, CLIP/PLIP towers)"
        )
    # fp32 means fp32: cuDNN's TF32 default would run the k=33 depthwise
    # residual conv in TF32, and the Newton-Schulz pseudo-inverse of the
    # Nyström path diverges from the reference without full-fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    # nn.Linear draws a default init from the global RNG at construction;
    # fork it so building a model leaves the caller's RNG state untouched
    with torch.random.fork_rng(devices=[]):
        model = UMEML_GAN(
            num_classes=num_classes,
            gene_group_indexes=gene_group_indexes,
            feat_dim=cfg.DATASET.PATH.DIM,
            hidden=cfg.MODEL.HIDDEN_DIM,
            n_proto=cfg.MODEL.UMEML.PROTOTYPES,
            n_reg=cfg.MODEL.UMEML.REGISTERS,
            dropout_rate=float(cfg.MODEL.DROPOUT),
            fusion=cfg.MODEL.FUSION,
            lambda_cyc=float(cfg.MODEL.UMEML.LAMBDA_CYC),
            topk=cfg.MODEL.UMEML.TOPK,
            kd_t=float(cfg.MODEL.UMEML.KD_T),
            attention=resolve_attention(cfg.TPU.ATTENTION),
        )
    model.reset_parameters(generator)
    return model.to(device).eval()


def build_model(name: str, **kwargs):
    return MODEL_REGISTRY.get(name)(**kwargs)
