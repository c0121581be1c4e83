"""UMEML — the fully-paired prototype model; the PyTorch counterpart of
``imp_tpu/models/umeml.py`` (reference ``medmm/modeling/models/umeml.py:86-222``).

Batched, masked, fixed-shape: the bag enters as [B, N_pad, Dp] with a
boolean mask.  The reference feeds its -10000-sentinel-padded bag straight
into ``path_net`` without stripping (``umeml.py:168``); the JAX package
masks it, deliberately, and so does the port.

``train=True`` draws dropout from the ``generator`` passed in and adds the
modularity loss of the prototypes and the omics tokens over the bag through
:func:`imp_torch.ops.modularity.compute_modularity_pair` (kernels K4 and K5
on the card).  ``attention`` and ``pinv_mode`` choose every TransLayer's
implementation and its Nyström pseudo-inverse (K6/K7 under ``"fused"``),
as in :class:`imp_torch.models.umeml_gan.UMEML_GAN`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import ATTENTION_IMPLS, TransLayer, dropout, train_generator
from ..ops.modularity import compute_modularity_pair
from .layers import Block, BottleneckAttentionBlock, PathProtoGenerator, proto_init_


class UMEML(nn.Module):
    def __init__(
        self,
        num_classes: int,
        feat_dim: int,
        omic_dim: int,
        hidden: int = 256,
        n_proto: int = 6,
        n_reg: int = 3,
        dropout_rate: float = 0.25,
        fusion: str = "concat",
        attention: str = "nystrom",
        pinv_mode: str = "chain",
    ):
        super().__init__()
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention {attention!r} not in {ATTENTION_IMPLS}")
        if fusion == "bilinear":
            raise NotImplementedError(
                "bilinear fusion (ops/blocks.py::BilinearFusion) not ported yet: see "
                "ROADMAP.md §A (the rest of the UMEML_GAN options)")
        if fusion != "concat":
            raise ValueError(f"Unknown fusion: {fusion}")
        self.num_classes, self.hidden, self.n_proto = num_classes, hidden, n_proto
        self.dropout_rate, self.attention = dropout_rate, attention

        self.path_net = nn.Linear(feat_dim, hidden)
        self.omic_net = nn.Linear(omic_dim, hidden)
        self.g_omic_net = nn.Linear(omic_dim, hidden)
        self.proto_g_blocks = nn.ModuleList([PathProtoGenerator(hidden) for _ in range(2)])
        self.omic_encoder = nn.ModuleList([Block(hidden, attention, pinv_mode) for _ in range(2)])
        self.path_decoder = TransLayer(hidden, attention, pinv_mode=pinv_mode)
        self.omic_decoder = TransLayer(hidden, attention, pinv_mode=pinv_mode)
        self.layer_norm_p = nn.LayerNorm(hidden, eps=1e-5)
        self.layer_norm_o = nn.LayerNorm(hidden, eps=1e-5)
        self.bottleattn = BottleneckAttentionBlock(dim=hidden, n_reg=n_reg, impl=attention,
                                                   pinv_mode=pinv_mode)
        self.p_proto = nn.Parameter(torch.empty(1, n_proto, hidden))
        self.o_encoder_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.p_encoder_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.mm_fc1 = nn.Linear(2 * hidden, hidden)
        self.mm_fc2 = nn.Linear(hidden, hidden)
        self.classifier = nn.Linear(hidden, num_classes)

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        proto_init_(self.p_proto, self.n_proto, generator)
        self.o_encoder_token.uniform_(0.0, 1.0, generator=generator)
        self.p_encoder_token.uniform_(0.0, 1.0, generator=generator)

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        g = train_generator(train, generator)
        x_path = batch["img"]  # [B, N, Dp]
        mask = batch.get("img_mask")  # [B, N] or None
        x_omic = batch["mol"][:, None, :]  # [B, 1, G]; the reference's detached twin has the same values
        b = x_path.shape[0]
        rate = self.dropout_rate

        h_path_bag = dropout(F.relu(self.path_net(x_path)), rate, g)
        if mask is not None:
            h_path_bag = h_path_bag * mask[..., None]
        h_omic_bag = torch.cat([dropout(F.relu(self.omic_net(x_omic)), rate, g),
                                dropout(F.relu(self.g_omic_net(x_omic)), rate, g)], dim=1)

        p_proto = self.p_proto.expand(b, -1, -1)
        for blk in self.proto_g_blocks:
            p_proto = blk(h_path_bag, p_proto, key_valid=mask)

        h_omic = torch.cat([self.o_encoder_token.expand(b, -1, -1), h_omic_bag], dim=1)
        for blk in self.omic_encoder:
            h_omic = blk(h_omic, generator=g)
        h_path = torch.cat([self.p_encoder_token.expand(b, -1, -1), p_proto], dim=1)
        h_path = self.layer_norm_p(self.path_decoder(h_path, generator=g))
        h_omic = self.layer_norm_o(self.omic_decoder(h_omic, generator=g))

        t_path, _, t_omic, _ = self.bottleattn(h_path, h_omic, generator=g)
        if train:
            modular_loss = compute_modularity_pair((p_proto, h_omic), h_path_bag, valid=mask)
        else:
            modular_loss = torch.zeros((), device=x_path.device)

        z = torch.cat([t_path[:, 0], t_omic[:, 0]], dim=1)
        hfused = F.relu(self.mm_fc2(F.relu(self.mm_fc1(z))))
        return {"logits": self.classifier(hfused), "modular_loss": modular_loss}
