"""UMEML_GAN — the flagship prototype model with CycleGAN omics imputation;
the PyTorch counterpart of ``imp_tpu/models/umeml_gan.py`` (reference
``medmm/modeling/models/umeml_gan.py:232-706``).

Serving runs :meth:`UMEML_GAN.encode`, :meth:`finish` and :meth:`head` at
``train=False``; MBTRAIN runs them at ``train=True`` with a
``torch.Generator`` that draws the dropout masks and the progressive
replacement, plus the GAN losses :meth:`gen_loss`, :meth:`dis_p_loss` and
:meth:`dis_o_loss`, which the trainer differentiates with respect to the
generator and discriminator parameters.  ``finish(train=True)`` adds the
modularity loss through :func:`imp_torch.ops.modularity.compute_modularity_pair`
(kernels K4 and K5 on the card).

``fusion`` is ``"concat"`` (two Linear layers over the concatenated
tokens, the Survival configs) or ``"bilinear"`` (:class:`BilinearFusion`
with dim 256 / 8 per side, the other tasks' configs), as in JAX.

The JAX package's module globals are constructor arguments here:
``head_fused`` (JAX ``HEAD_FUSED``; default True: the head's plain and
importance-scaled bottleneck passes as one call over 2B rows; False: two
sequential passes, as the reference runs them), ``stacked_pairs``
(``STACKED_PAIRS``; default False: twin modules ``path_decoder``/
``omic_decoder``, ``layer_norm_p``/``layer_norm_o``, ``explainer_path``/
``explainer_omic``; True: ``pair_decoder``, ``pair_norm`` and
``pair_explainer``, each one :class:`~imp_torch.models.layers.Stacked`
module over the ``[2, B, T, D]`` stack of the two token sequences) and
``bag_dtype`` (``BAG_DTYPE``; default None: float32; ``torch.bfloat16``:
the bag activations after ``path_net`` are cast to it, and the prototype
cross-attention's K and V keep it, while parameters, losses, the
pseudo-inverse and the modularity stay float32; :meth:`encode` then runs
under :class:`~imp_torch.engine.precision.JaxPromotion`, so mixed operands
promote as in JAX).  ``attention`` replaces the process-global ``TPU.ATTENTION`` default, and
``pinv_mode`` the JAX module global ``PINV_MODE`` (``"chain"``, the default,
or ``"fused"``: the Nyström pseudo-inverse through the kernels K6/K7, see
:func:`imp_torch.ops.attention.moore_penrose_pinv`).  ``proto_init``, JAX's
``proto_initializer``, fills the prototypes in place of the uniform draw
(the cached PLIP prototypes, :mod:`imp_torch.models.prototypes`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..engine.precision import JaxPromotion
from ..losses.survival import kd_loss
from ..ops.attention import (
    ATTENTION_IMPLS,
    TransLayer,
    dropout,
    init_parameters_,
    train_generator,
)
from ..ops.blocks import BilinearFusion
from ..ops.modularity import compute_modularity_pair
from .layers import (
    Block,
    BottleneckAttentionBlock,
    Discriminator,
    Generator,
    GroupedLinear,
    PathProtoGenerator,
    Stacked,
    proto_init_,
    transform_importance,
    transform_importance_to_half_one_point_five,
)

def _bce_with_logits_vs_ones(z: torch.Tensor) -> torch.Tensor:
    """BCEWithLogits(z, 1) = softplus(-z).  The reference applies it to the
    discriminator's *sigmoid output* (``adversarial_loss``, ref ``:371-372``)
    — reproduced faithfully."""
    return F.softplus(-z).mean()


def _bce(p: torch.Tensor, y: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    p = p.clamp(eps, 1.0 - eps)
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)).mean()


class UMEML_GAN(nn.Module):
    def __init__(
        self,
        num_classes: int,
        gene_group_indexes: Sequence[Sequence[int]],
        feat_dim: int,
        hidden: int = 256,
        n_proto: int = 6,
        n_reg: int = 3,
        dropout_rate: float = 0.25,
        fusion: str = "concat",
        lambda_cyc: float = 10.0,
        topk: int = 3,
        kd_t: float = 5.0,
        attention: str = "nystrom",
        pinv_mode: str = "chain",
        head_fused: bool = True,
        stacked_pairs: bool = False,
        bag_dtype: Optional[torch.dtype] = None,
        proto_init: Optional[Callable[[torch.Tensor, torch.Generator], None]] = None,
    ):
        super().__init__()
        if len(gene_group_indexes) != n_proto:
            raise ValueError(
                f"MODEL.UMEML.PROTOTYPES ({n_proto}) must equal the number of "
                f"gene groups ({len(gene_group_indexes)}) — one omics encoder "
                "per prototype (ref umeml_gan.py:274-283)"
            )
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention {attention!r} not in {ATTENTION_IMPLS}")
        if fusion not in ("concat", "bilinear"):
            raise ValueError(f"Unknown fusion: {fusion}")
        self.head_fused, self.stacked_pairs, self.bag_dtype = head_fused, stacked_pairs, bag_dtype
        self.num_classes, self.hidden = num_classes, hidden
        self.n_proto, self.kd_t, self.attention = n_proto, kd_t, attention
        self.dropout_rate, self.lambda_cyc = dropout_rate, lambda_cyc
        self.proto_init = proto_init
        self.gene_group_indexes = tuple(tuple(int(i) for i in g) for g in gene_group_indexes)
        tokens = n_proto + 1

        self.gan_generator_p2o = Generator(tokens=tokens, dim=hidden)
        self.gan_generator_o2p = Generator(tokens=tokens, dim=hidden)
        self.gan_discriminator_o = Discriminator(tokens * hidden)
        self.gan_discriminator_p = Discriminator(tokens * hidden)

        self.path_net = nn.Linear(feat_dim, hidden)
        self.omic_net = GroupedLinear([len(g) for g in self.gene_group_indexes], hidden)
        self.proto_g_blocks = nn.ModuleList([PathProtoGenerator(hidden) for _ in range(2)])
        self.omic_encoder = nn.ModuleList([Block(hidden, attention, pinv_mode) for _ in range(2)])
        if stacked_pairs:
            self.pair_decoder = Stacked(lambda: TransLayer(hidden, attention, pinv_mode=pinv_mode))
            self.pair_norm = Stacked(lambda: nn.LayerNorm(hidden, eps=1e-5))
        else:
            self.layer_norm_p = nn.LayerNorm(hidden, eps=1e-5)
            self.layer_norm_o = nn.LayerNorm(hidden, eps=1e-5)
            self.path_decoder = TransLayer(hidden, attention, pinv_mode=pinv_mode)
            self.omic_decoder = TransLayer(hidden, attention, pinv_mode=pinv_mode)
        self.bottleattn = BottleneckAttentionBlock(
            dim=hidden, n_reg=n_reg, use_pairing=True, topk=topk, impl=attention,
            pinv_mode=pinv_mode,
        )
        self.p_proto = nn.Parameter(torch.empty(1, n_proto, hidden))
        self.p_encoder_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.o_encoder_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.fusion = fusion
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=hidden, dim2=hidden, scale_dim1=8, scale_dim2=8,
                                     mmhid=hidden)
        else:
            self.mm_fc1 = nn.Linear(2 * hidden, hidden)
            self.mm_fc2 = nn.Linear(hidden, hidden)
        self.classifier = nn.Linear(hidden, num_classes)
        if stacked_pairs:
            self.pair_explainer = Stacked(lambda: nn.Linear(hidden, num_classes, bias=False))
        else:
            self.explainer_path = nn.Linear(hidden, num_classes, bias=False)
            self.explainer_omic = nn.Linear(hidden, num_classes, bias=False)

        # all gene groups gathered into one zero-padded [K, Gmax] index grid
        gmax = max(len(g) for g in self.gene_group_indexes)
        pad_idx = torch.zeros(n_proto, gmax, dtype=torch.long)
        pad_valid = torch.zeros(n_proto, gmax)
        for k, idx in enumerate(self.gene_group_indexes):
            pad_idx[k, : len(idx)] = torch.tensor(idx, dtype=torch.long)
            pad_valid[k, : len(idx)] = 1.0
        self.register_buffer("pad_idx", pad_idx, persistent=False)
        self.register_buffer("pad_valid", pad_valid, persistent=False)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        if self.proto_init is None:  # the reference's reset(): uniform
            proto_init_(self.p_proto, self.n_proto, generator)
        else:
            self.proto_init(self.p_proto, generator)
        self.p_encoder_token.uniform_(0.0, 1.0, generator=generator)
        self.o_encoder_token.uniform_(0.0, 1.0, generator=generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)

    # ------------------------------------------------------------------ #
    # encoder: bag + omics -> normalized token sequences                  #
    # ------------------------------------------------------------------ #
    def encode(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        if self.bag_dtype is None:
            return self._encode(batch, train, generator)
        # the bag's dtype meets float32 parameters and prototypes: mixed
        # operands promote as they do in JAX
        with JaxPromotion():
            return self._encode(batch, train, generator)

    def _encode(self, batch, train, generator) -> Dict:
        g = train_generator(train, generator)
        x_path = batch["img"]
        mask = batch.get("img_mask")
        x_omic = batch["mol"]  # [B, G]
        b = x_path.shape[0]

        # in-sample omics deletion -> train-mean imputation (ref :391-392)
        insample = batch.get("insample_without_omic")
        if insample is not None and "omic_means" in batch:
            x_omic = torch.where(insample.bool(), batch["omic_means"][None, :], x_omic)

        h = self.path_net(x_path)
        if self.bag_dtype is not None:  # every bag-sized tensor downstream in it
            h = h.to(self.bag_dtype)
        h_path_bag = dropout(F.relu(h), self.dropout_rate, g)
        if mask is not None:
            h_path_bag = h_path_bag * mask[..., None]

        xg = x_omic[:, self.pad_idx] * self.pad_valid[None]  # [B, K, Gmax]
        h_omic_bag = dropout(F.relu(self.omic_net(xg)), self.dropout_rate, g)  # [B, n_proto, D]

        p_proto = self.p_proto.expand(b, -1, -1)
        for blk in self.proto_g_blocks:
            p_proto = blk(h_path_bag, p_proto, key_valid=mask)

        h_omic = torch.cat([self.o_encoder_token.expand(b, -1, -1), h_omic_bag], dim=1)
        for blk in self.omic_encoder:
            h_omic = blk(h_omic, generator=g)
        h_path = torch.cat([self.p_encoder_token.expand(b, -1, -1), p_proto], dim=1)
        if self.stacked_pairs:  # both [B, n_proto + 1, D]: one module over the stack
            h_path, h_omic = self.pair_norm(
                self.pair_decoder(torch.stack([h_path, h_omic]), generator=g))
        else:
            h_path = self.layer_norm_p(self.path_decoder(h_path, generator=g))
            h_omic = self.layer_norm_o(self.omic_decoder(h_omic, generator=g))
        return {
            "h_path": h_path,
            "h_omic": h_omic,
            "p_proto": p_proto,
            "p_proto_before": p_proto,
            "h_omic_bag_before": h_omic_bag,
            "h_path_bag": h_path_bag,
        }

    def gen_p2o(self, h_path: torch.Tensor) -> torch.Tensor:
        return self.gan_generator_p2o(h_path)

    def gen_o2p(self, h_omic: torch.Tensor) -> torch.Tensor:
        return self.gan_generator_o2p(h_omic)

    # ------------------------------------------------------------------ #
    # GAN losses (the trainer differentiates them over their partitions)  #
    # ------------------------------------------------------------------ #
    def gen_loss(self, h_path: torch.Tensor, h_omic: torch.Tensor) -> torch.Tensor:
        """Adversarial + cycle loss (ref ``:461-471``); inputs detached."""
        h_path, h_omic = h_path.detach(), h_omic.detach()
        fake_omic = self.gan_generator_p2o(h_path)
        fake_path = self.gan_generator_o2p(h_omic)
        cycle_path = self.gan_generator_o2p(fake_omic)
        cycle_omic = self.gan_generator_p2o(fake_path)
        gan_p2o = _bce_with_logits_vs_ones(self.gan_discriminator_o(fake_omic))
        gan_o2p = _bce_with_logits_vs_ones(self.gan_discriminator_p(fake_path))
        cyc_o = torch.mean(torch.abs(cycle_omic - h_omic))
        cyc_p = torch.mean(torch.abs(cycle_path - h_path))
        return (gan_p2o + gan_o2p) + self.lambda_cyc * (cyc_o + cyc_p)

    def _dis_loss(self, disc, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        pred = torch.cat([disc(real), disc(fake)], dim=0)
        b = real.shape[0]
        labels = torch.cat([real.new_ones(b, 1), real.new_zeros(b, 1)], dim=0)
        return _bce(pred, labels)

    def dis_p_loss(self, h_path: torch.Tensor, h_omic: torch.Tensor) -> torch.Tensor:
        """Pathology discriminator BCE (ref ``:476-482``); generator frozen."""
        fake_path = self.gan_generator_o2p(h_omic.detach()).detach()
        return self._dis_loss(self.gan_discriminator_p, h_path.detach(), fake_path)

    def dis_o_loss(self, h_path: torch.Tensor, h_omic: torch.Tensor) -> torch.Tensor:
        """Omics discriminator BCE (ref ``:484-490``)."""
        fake_omic = self.gan_generator_p2o(h_path.detach()).detach()
        return self._dis_loss(self.gan_discriminator_o, h_omic.detach(), fake_omic)

    # ------------------------------------------------------------------ #
    # bottleneck + fusion + explainer head                                 #
    # ------------------------------------------------------------------ #
    def _fuse(self, t_path: torch.Tensor, t_omic: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.fusion == "bilinear":
            return self.mm(t_path[:, 0], t_omic[:, 0], generator=generator)
        z = torch.cat([t_path[:, 0], t_omic[:, 0]], dim=1)
        return F.relu(self.mm_fc2(F.relu(self.mm_fc1(z))))

    def head(self, h_path, h_omic, train: bool = False, T: float = 5.0,
             generator: Optional[torch.Generator] = None) -> Dict:
        g = train_generator(train, generator)
        b, n_tokens, _ = h_path.shape

        # per-prototype explainer + self-distillation (ref :554-598), first,
        # so both bottleneck passes can run as ONE call over 2B rows
        if self.stacked_pairs:
            logits_path_proto, logits_omic_proto = self.pair_explainer(
                torch.stack([h_path, h_omic]))  # [B, P, C] each
        else:
            logits_path_proto = self.explainer_path(h_path)  # [B, P, C]
            logits_omic_proto = self.explainer_omic(h_omic)
        logits_explained = (logits_path_proto.mean(dim=1) + logits_omic_proto.mean(dim=1)) / 2.0
        pred = logits_explained.argmax(dim=1)[:, None, None]  # [B, 1, 1]
        imp_path = logits_path_proto.gather(2, pred.expand(b, n_tokens, 1))[..., 0]
        imp_omic = logits_omic_proto.gather(2, pred.expand(b, h_omic.shape[1], 1))[..., 0]

        w_path = transform_importance_to_half_one_point_five(imp_path.detach())[..., None]
        w_omic = transform_importance_to_half_one_point_five(imp_omic.detach())[..., None]
        if self.head_fused:
            # the plain pass (ref :514) and the importance-scaled pass (ref
            # :649-678) share no state: one batched call over 2B rows
            hp2 = torch.cat([h_path, h_path * w_path], dim=0)
            ho2 = torch.cat([h_omic, h_omic * w_omic], dim=0)
            t_path, _, t_omic, _ = self.bottleattn(hp2, ho2, generator=g)
            logits_both = self.classifier(self._fuse(t_path, t_omic, g))
            logits1, logits = logits_both[:b], logits_both[b:]
        else:  # two sequential passes, as the reference runs them
            t_path, _, t_omic, _ = self.bottleattn(h_path, h_omic, generator=g)
            logits1 = self.classifier(self._fuse(t_path, t_omic, g))
            t_path, _, t_omic, _ = self.bottleattn(h_path * w_path, h_omic * w_omic, generator=g)
            logits = self.classifier(self._fuse(t_path, t_omic, g))
        return {
            "logits": logits,
            "logits_first_pass": logits1,
            "loss_kd": kd_loss(logits_explained, logits1, T=T),
            "importance_path": transform_importance(imp_path)[:, : n_tokens - 1],
            "importance_omic": transform_importance(imp_omic)[:, : n_tokens - 1],
        }

    # ------------------------------------------------------------------ #
    # eval forward                                                          #
    # ------------------------------------------------------------------ #
    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        replace_ratio: float = 0.0,
        cca: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        enc = self.encode(batch, train=train, generator=generator)
        return self.finish(enc, batch, train=train, replace_ratio=replace_ratio, cca=cca,
                           generator=generator)

    def finish(
        self,
        enc: Dict,
        batch: Dict,
        train: bool = False,
        replace_ratio: float = 0.0,
        cca: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        """Everything after :meth:`encode`: the progressive replacement
        (train), missing-omics generation, the in-sample generation blend,
        the head and the modularity loss (train).  Split out so the trainer
        runs ONE encode shared by the GAN phase and the main loss."""
        h_path, h_omic = enc["h_path"], enc["h_omic"]
        if cca:
            return {
                "h_path": h_path,
                "h_omic": h_omic,
                "p_proto_before": enc["p_proto_before"],
                "h_omic_bag_before": enc["h_omic_bag_before"],
            }
        g = train_generator(train, generator)
        # one generator pass serves the replacement and the missing-omics
        # generation (the reference calls it twice on the same h_path)
        h_omic_gen = self.gan_generator_p2o(h_path)

        if train:
            # progressive replacement by generated omics (ref :492-497; the
            # reference replaces when uniform > ratio)
            u = torch.rand(h_omic.shape[0], generator=g, device=h_omic.device)
            ratio = float(replace_ratio)
            do_replace = (u > ratio) & (ratio > 0)
            h_omic = torch.where(do_replace[:, None, None], h_omic_gen, h_omic)

        # generation for missing omics (ref :499-511)
        without = batch.get("without_omic")
        if without is not None:
            h_omic = torch.where(without.bool()[:, None, None], h_omic_gen, h_omic)
        insample = batch.get("insample_without_omic")
        if insample is not None:
            gen_ratio = insample.to(h_omic.dtype).mean()
            h_omic = (1.0 - gen_ratio) * h_omic + gen_ratio * h_omic_gen

        out = self.head(h_path, h_omic, train=train, T=self.kd_t, generator=g)
        if train:
            out["modular_loss"] = compute_modularity_pair(
                (enc["p_proto"], h_omic), enc["h_path_bag"], valid=batch.get("img_mask")
            )
        else:
            out["modular_loss"] = torch.zeros((), device=h_path.device)
        out["h_path"] = h_path
        out["h_omic"] = h_omic
        return out

    def init_all(self, batch: Dict, generator: torch.Generator) -> Dict:
        """Run every submodule once — the train forward at replace ratio 0.1
        and the three GAN losses — as the JAX ``init_all`` does to create the
        parameters (here they exist from construction).  Returns the losses."""
        out = self(batch, train=True, replace_ratio=0.1, generator=generator)
        return {
            "modular_loss": out["modular_loss"],
            "loss_kd": out["loss_kd"],
            "gen": self.gen_loss(out["h_path"], out["h_omic"]),
            "dis_p": self.dis_p_loss(out["h_path"], out["h_omic"]),
            "dis_o": self.dis_o_loss(out["h_path"], out["h_omic"]),
        }
