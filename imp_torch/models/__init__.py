"""Model registry — the PyTorch counterpart of ``imp_tpu/models/__init__.py``.
Same config names; the port registers ``umeml``, ``umeml_gan`` (and its
alias ``umeml_gan_plot``), ``transmil``, ``abmil``, ``snn``, ``snnm`` and ``clipomic`` here, and the
fusion nets ``mcat``, ``cmta``, ``porpoise`` and ``hfb`` with their trainers
(``engine/fusion_trainers.py``).  Every builder turns TF32 off, initialises the
model from a ``torch.Generator`` (default: seed 0) without touching the
caller's RNG, and returns it on ``device`` in eval mode.  The builders of
the models with Nyström TransLayers take ``pinv_mode`` (``"chain"``, the
default, or ``"fused"``: see :func:`imp_torch.ops.attention.moore_penrose_pinv`),
which, like the JAX module global it replaces, has no cfg key."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.attention import init_parameters_
from ..utils.registry import Registry
from .clipomic import CLIPOMIC_NET
from .nets import ABMIL_NET, SNN_NET, SNNM_NET, TransMIL_NET
from .prototypes import plip_prototype_init
from .umeml import UMEML
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


def build_module(make: Callable[[], nn.Module], device, generator: Optional[torch.Generator]):
    """``make()`` initialised from ``generator`` on ``device``, in eval mode."""
    # fp32 means fp32: cuDNN's TF32 default would run the depthwise convs
    # (the k=33 residual, PPEG's 7/5/3) in TF32, and the Newton-Schulz
    # pseudo-inverse of the Nyström path diverges from the reference
    # without full-fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    # construction draws a default init from the global RNG; fork it so
    # building a model leaves the caller's RNG state untouched
    with torch.random.fork_rng(devices=[]):
        model = make()
    init_parameters_(model, generator)
    return model.to(device).eval()


@MODEL_REGISTRY.register_as("umeml")
def build_umeml(
    cfg,
    num_classes: int,
    omic_dim: int,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    pinv_mode: str = "chain",
) -> UMEML:
    """UMEML from ``cfg`` over ``omic_dim`` genes (it has no gene groups).
    Its prototypes are always drawn uniform: as in the JAX package, only
    UMEML_GAN reads ``MODEL.UMEML.PROTO_INIT``."""
    return build_module(
        lambda: UMEML(
            num_classes=num_classes,
            feat_dim=cfg.DATASET.PATH.DIM,
            omic_dim=omic_dim,
            hidden=cfg.MODEL.HIDDEN_DIM,
            n_proto=cfg.MODEL.UMEML.PROTOTYPES,
            n_reg=cfg.MODEL.UMEML.REGISTERS,
            dropout_rate=float(cfg.MODEL.DROPOUT),
            fusion=cfg.MODEL.FUSION,
            attention=resolve_attention(cfg.TPU.ATTENTION),
            pinv_mode=pinv_mode,
        ),
        device, generator,
    )


@MODEL_REGISTRY.register_as("umeml_gan")
def build_umeml_gan(
    cfg,
    num_classes: int,
    gene_group_indexes: Sequence[Sequence[int]],
    device="cuda",
    generator: Optional[torch.Generator] = None,
    pinv_mode: str = "chain",
    head_fused: bool = True,
    stacked_pairs: bool = False,
    bag_dtype: Optional[torch.dtype] = None,
    seq=None,
    sp_mode: str = "gather",
) -> UMEML_GAN:
    """UMEML_GAN from ``cfg`` and the gene groups; with
    ``MODEL.UMEML.PROTO_INIT=plip`` its prototypes come from the cached PLIP
    prototypes (:func:`imp_torch.models.prototypes.plip_prototype_init`).
    ``head_fused``, ``stacked_pairs`` and ``bag_dtype``, the JAX module
    globals ``HEAD_FUSED``, ``STACKED_PAIRS`` and ``BAG_DTYPE``, have no cfg
    key either (see :class:`UMEML_GAN`).  ``seq`` (a
    :class:`~imp_torch.parallel.collectives.Axis`) and ``sp_mode`` select
    its sequence-parallel layout."""
    proto_init = None
    if cfg.MODEL.UMEML.PROTO_INIT == "plip":
        proto_init = plip_prototype_init(cfg, cfg.MODEL.UMEML.PROTOTYPES, cfg.MODEL.HIDDEN_DIM)
    return build_module(
        lambda: UMEML_GAN(
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
            pinv_mode=pinv_mode,
            head_fused=head_fused,
            stacked_pairs=stacked_pairs,
            bag_dtype=bag_dtype,
            proto_init=proto_init,
            seq=seq,
            sp_mode=sp_mode,
        ),
        device, generator,
    )


@MODEL_REGISTRY.register_as("umeml_gan_plot")
def build_umeml_gan_plot(cfg, num_classes: int, gene_group_indexes: Sequence[Sequence[int]],
                         **kwargs) -> UMEML_GAN:
    """The reference's ``umeml_gan_plot.py``: UMEML_GAN as it is; MBTRAIN
    (which tells it by the ``_plot`` suffix) draws its similarity grids
    after each evaluation."""
    return build_umeml_gan(cfg, num_classes, gene_group_indexes, **kwargs)


@MODEL_REGISTRY.register_as("transmil")
def build_transmil(cfg, num_classes: int, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   pinv_mode: str = "chain", seq=None, sp_mode: str = "gather") -> TransMIL_NET:
    """TransMIL over ``DATASET.PATH.DIM`` features, its TransLayers by
    ``TPU.ATTENTION`` (exact in every layout of a ``seq`` axis)."""
    return build_module(
        lambda: TransMIL_NET(num_classes, cfg.DATASET.PATH.DIM,
                             attention=resolve_attention(cfg.TPU.ATTENTION),
                             pinv_mode=pinv_mode, seq=seq, sp_mode=sp_mode),
        device, generator,
    )


@MODEL_REGISTRY.register_as("abmil")
def build_abmil(cfg, num_classes: int, device="cuda",
                generator: Optional[torch.Generator] = None) -> ABMIL_NET:
    """ABMIL over ``DATASET.PATH.DIM`` features at ``MODEL.SIZE`` (dropout
    0.25, as the JAX trainer builds it)."""
    return build_module(
        lambda: ABMIL_NET(num_classes, cfg.DATASET.PATH.DIM, cfg.MODEL.SIZE),
        device, generator,
    )


@MODEL_REGISTRY.register_as("snn")
def build_snn(cfg, num_classes: int, omic_dim: int, device="cuda",
              generator: Optional[torch.Generator] = None) -> SNN_NET:
    """SNN over the first min(1000, ``omic_dim``) genes at ``MODEL.SIZE``
    and ``MODEL.DROPOUT``."""
    return build_module(
        lambda: SNN_NET(num_classes, min(1000, omic_dim), float(cfg.MODEL.DROPOUT),
                        cfg.MODEL.SIZE),
        device, generator,
    )


@MODEL_REGISTRY.register_as("snnm")
def build_snnm(cfg, num_classes: int, omic_dim: int, device="cuda",
               generator: Optional[torch.Generator] = None) -> SNNM_NET:
    """SNN_M over chunks of 50 genes at ``MODEL.SIZE`` and ``MODEL.DROPOUT``."""
    return build_module(
        lambda: SNNM_NET(num_classes, 50, float(cfg.MODEL.DROPOUT), cfg.MODEL.SIZE),
        device, generator,
    )


@MODEL_REGISTRY.register_as("clipomic")
def build_clipomic(cfg, num_classes: int, omic_dim: int, device="cuda",
                   generator: Optional[torch.Generator] = None) -> CLIPOMIC_NET:
    """CLIPOMIC over 5 chunks of ``omic_dim // 5`` genes (the reference's
    fixed 200 only agrees at 1 000 genes), its text tower at
    ``MODEL.BACKBONE.TEXT_*``."""
    bb = cfg.MODEL.BACKBONE
    return build_module(
        lambda: CLIPOMIC_NET(
            num_classes, num_mol=5, len_mol=max(1, omic_dim // 5),
            model_size_omic=cfg.MODEL.SIZE, dropout=float(cfg.MODEL.DROPOUT),
            width=bb.TEXT_WIDTH, heads=bb.TEXT_HEADS, layers=bb.TEXT_LAYERS,
            vocab_size=bb.TEXT_VOCAB, context_length=bb.TEXT_CONTEXT,
        ),
        device, generator,
    )


def build_model(name: str, **kwargs):
    return MODEL_REGISTRY.get(name)(**kwargs)
