"""Multimodal fusion baselines MCAT, CMTA, Porpoise and HFB — the PyTorch
counterpart of ``imp_tpu/models/fusion.py`` (reference
``medmm/modeling/fusion/``), batched with masks.

Every module maps (``x_path`` [B, N, D], ``x_omic`` [B, G], ``path_valid``
[B, N] bool) to a fused vector of ``out_features`` (MCAT and CMTA also
return a dict of extras); dropout comes from the ``generator`` passed in
(None: eval).  The JAX modules' semantics are kept as they are, including
those the reference defines by accident: CMTA's decoder attends over the
padded bag positions unmasked, and HFB keeps ``cona_x_a = sc * gene_x`` and
one ``Linear_gene_a`` for all three inter projections (ROADMAP.md §C,
documented differences).  Parameter names follow the JAX tree
(``imp_torch.convert.zoo_state_dict``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import MultiheadAttention, dropout
from ..ops.blocks import (
    Attn_Net_Gated,
    BilinearFusion,
    LRBilinearFusion,
    MLP_Block,
    SNN_Block,
    Transformer_G,
    Transformer_P,
    masked_attention_pool,
)
from ..parallel.collectives import psum

OMIC_SIZES = (200, 200, 200, 200, 200)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with a ReLU feed-forward, the semantics of
    ``nn.TransformerEncoderLayer(d_model, nhead, dim_ff)`` (MCAT, reference
    ``fusion/mcat.py:47-54``); ``dropout`` on the attention weights, its
    output and both feed-forward outputs."""

    def __init__(self, d_model: int = 256, nhead: int = 8, dim_feedforward: int = 512,
                 dropout: float = 0.1):
        super().__init__()
        self.rate = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        attn, _ = self.self_attn(x, x, x, need_raw=False, generator=generator)
        x = self.norm1(x + dropout(attn, self.rate, generator))
        y = dropout(F.relu(self.linear1(x)), self.rate, generator)
        y = dropout(self.linear2(y), self.rate, generator)
        return self.norm2(x + y)


class SigNetworks(nn.Module):
    """One SNN chain per gene signature (reference ``fusion/mcat.py:32-40``):
    ``sig{i}_fc{j}``, the first block of each at dropout 0.25.  Returns
    [B, n_sigs, hidden[-1]]."""

    def __init__(self, omic_sizes: Sequence[int], hidden: Sequence[int], dropout: float = 0.25):
        super().__init__()
        self.omic_sizes, self.depth = tuple(omic_sizes), len(hidden)
        for i, size in enumerate(self.omic_sizes):
            dim = size
            for j, width in enumerate(hidden):
                setattr(self, f"sig{i}_fc{j}", SNN_Block(dim, width, 0.25 if j == 0 else dropout))
                dim = width

    def forward(self, x_omic: torch.Tensor, generator: Optional[torch.Generator] = None):
        outs, start = [], 0
        for i, size in enumerate(self.omic_sizes):
            h = x_omic[:, start : start + size]
            start += size
            for j in range(self.depth):
                h = getattr(self, f"sig{i}_fc{j}")(h, generator)
            outs.append(h)
        return torch.stack(outs, dim=1)


def _concat_head(module: nn.Module, dim: int) -> None:
    """``mm_fc1`` (two vectors of ``dim`` in) and ``mm_fc2``: the concat
    fusion of MCAT, CMTA and Porpoise."""
    module.mm_fc1 = nn.Linear(2 * dim, dim)
    module.mm_fc2 = nn.Linear(dim, dim)


def _concat(module: nn.Module, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.relu(module.mm_fc2(F.relu(module.mm_fc1(torch.cat([a, b], dim=1)))))


class MCAT(nn.Module):
    """Genomic-guided co-attention (reference ``fusion/mcat.py:11-103``): the
    signatures attend over the bag (one head, ``key_valid=path_valid``, raw
    scores kept), two encoder layers and a gated-attention pool per side,
    then concat or bilinear fusion.  Extras: the co-attention's raw scores
    and both pools' scores."""

    SIZES = {"small": (256, 256), "big": (512, 384)}
    HIDDEN = {"small": (256, 256), "big": (1024, 1024, 1024, 256)}

    def __init__(self, fusion: str = "concat", path_input_dim: int = 512,
                 omic_sizes: Sequence[int] = OMIC_SIZES, model_size_wsi: str = "small",
                 model_size_omic: str = "small", dropout: float = 0.10):
        super().__init__()
        hidden, top = self.SIZES[model_size_wsi]
        self.fusion, self.rate = fusion, dropout
        self.out_features = 256 if fusion == "bilinear" else top
        self.wsi_net = nn.Linear(path_input_dim, hidden)
        self.sig_networks = SigNetworks(omic_sizes, self.HIDDEN[model_size_omic], dropout)
        self.coattn = MultiheadAttention(256, 1)
        for side in ("path", "omic"):
            for i in range(2):
                setattr(self, f"{side}_transformer_{i}",
                        TorchTransformerEncoderLayer(dropout=dropout))
            setattr(self, f"{side}_attention_head", Attn_Net_Gated(256, D=top, dropout=dropout > 0))
            setattr(self, f"{side}_rho", nn.Linear(256, top))
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=256, dim2=256, scale_dim1=8, scale_dim2=8, mmhid=256)
        else:
            _concat_head(self, top)

    def _side(self, name: str, h: torch.Tensor, generator):
        for i in range(2):
            h = getattr(self, f"{name}_transformer_{i}")(h, generator)
        scores, h = getattr(self, f"{name}_attention_head")(h, generator)
        pooled, _ = masked_attention_pool(scores, h)
        pooled = F.relu(getattr(self, f"{name}_rho")(pooled[:, 0]))
        return dropout(pooled, self.rate, generator), scores

    def forward(self, x_path, x_omic, path_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h_path_bag = dropout(F.relu(self.wsi_net(x_path)), self.rate, generator)
        h_omic_bag = self.sig_networks(x_omic, generator)  # [B, n_sigs, 256]
        h_path_coattn, a_coattn = self.coattn(h_omic_bag, h_path_bag, h_path_bag,
                                              key_valid=path_valid, need_raw=True)
        h_path, a_path = self._side("path", h_path_coattn, generator)
        h_omic, a_omic = self._side("omic", h_omic_bag, generator)
        if self.fusion == "bilinear":
            out = self.mm(h_path, h_omic, generator)
        else:
            out = _concat(self, h_path, h_omic)
        return out, {"coattn": a_coattn, "path": a_path, "omic": a_omic}


class CMTA(nn.Module):
    """Cross-modal translation and alignment (reference
    ``fusion/cmta.py:12-142``): a pathology encoder (``Transformer_P``,
    masked) and a genomics encoder (``Transformer_G``), cross attention each
    way, a decoder per side, then concat or bilinear fusion of the
    encoder/decoder cls means.  The decoders and ``G_in_P_Att`` take no mask,
    as in the JAX module.  ``attention`` (``"nystrom"``/``"flash"``) and
    ``pinv_mode`` reach its eight TransLayers.  Extras: the four cls tokens
    (CMTA's trainer aligns them)."""

    P_HIDDEN = {"small": (256, 256), "large": (512, 256)}
    G_HIDDEN = {"small": (1024, 256), "large": (1024, 1024, 1024, 256)}
    out_features = 256

    def __init__(self, fusion: str = "concat", path_input_dim: int = 512,
                 omic_sizes: Sequence[int] = OMIC_SIZES, model_size: str = "small",
                 dropout: float = 0.25, attention: str = "nystrom", pinv_mode: str = "chain"):
        super().__init__()
        self.fusion, self.rate = fusion, dropout
        self.p_hidden = self.P_HIDDEN[model_size]
        dim = path_input_dim
        for i, width in enumerate(self.p_hidden):
            setattr(self, f"pathomics_fc_{i}", nn.Linear(dim, width))
            dim = width
        self.genomics_fc = SigNetworks(omic_sizes, self.G_HIDDEN[model_size], 0.25)
        for name in ("pathomics_encoder", "pathomics_decoder"):
            setattr(self, name, Transformer_P(256, attention, pinv_mode))
        for name in ("genomics_encoder", "genomics_decoder"):
            setattr(self, name, Transformer_G(256, attention, pinv_mode))
        self.P_in_G_Att = MultiheadAttention(256, 1)
        self.G_in_P_Att = MultiheadAttention(256, 1)
        if fusion == "bilinear":
            self.mm = BilinearFusion(dim1=256, dim2=256, scale_dim1=8, scale_dim2=8, mmhid=256)
        else:
            _concat_head(self, 256)

    def forward(self, x_path, x_omic, path_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x_path
        for i in range(len(self.p_hidden)):
            h = dropout(F.relu(getattr(self, f"pathomics_fc_{i}")(h)), self.rate, generator)
        genomics = self.genomics_fc(x_omic, generator)

        cls_pe, tok_pe = self.pathomics_encoder(h, path_valid, generator)
        cls_ge, tok_ge = self.genomics_encoder(genomics, None, generator)
        p_in_g, _ = self.P_in_G_Att(tok_pe, tok_ge, tok_ge, need_raw=True)
        g_in_p, _ = self.G_in_P_Att(tok_ge, tok_pe, tok_pe)
        cls_pd, _ = self.pathomics_decoder(p_in_g, None, generator)
        cls_gd, _ = self.genomics_decoder(g_in_p, None, generator)

        vp, vg = (cls_pe + cls_pd) / 2, (cls_ge + cls_gd) / 2
        out = self.mm(vp, vg, generator) if self.fusion == "bilinear" else _concat(self, vp, vg)
        return out, {
            "cls_token_pathomics_encoder": cls_pe,
            "cls_token_pathomics_decoder": cls_pd,
            "cls_token_genomics_encoder": cls_ge,
            "cls_token_genomics_decoder": cls_gd,
        }


class Porpoise(nn.Module):
    """ABMIL pathology (input dropout 0.10) and an SNN (or MLP) omics chain,
    fused by gated bilinear, low-rank bilinear (``"lrb"``), concat or add
    (reference ``fusion/porpoise.py:10-107``)."""

    SIZES = {"small": (512, 256), "big": (512, 384)}
    HIDDEN = {"small": (256, 256), "big": (1024, 1024, 1024, 256)}
    FUSIONS = ("bilinear", "lrb", "concat", "add")

    def __init__(self, fusion: str = "bilinear", omic_input_dim: int = 1000,
                 path_input_dim: int = 512, model_size_wsi: str = "small",
                 model_size_omic: str = "small", scale_dim1: int = 8, scale_dim2: int = 8,
                 gate_path: int = 1, gate_omic: int = 1, skip: bool = True,
                 dropinput: float = 0.10, use_mlp: bool = False, dropout: float = 0.1):
        super().__init__()
        if fusion not in self.FUSIONS:
            raise ValueError(f"Porpoise fusion {fusion!r} not in {self.FUSIONS}")
        hidden, top = self.SIZES[model_size_wsi]
        omic_hidden = self.HIDDEN[model_size_omic]
        self.fusion, self.rate, self.dropinput = fusion, dropout, dropinput
        self.omic_input_dim, self.omic_depth = omic_input_dim, len(omic_hidden)
        self.fc_h = nn.Linear(path_input_dim, hidden)
        self.attention_net_h = Attn_Net_Gated(hidden, D=top, dropout=dropout > 0)
        self.rho_h = nn.Linear(hidden, top)
        block, dim = MLP_Block if use_mlp else SNN_Block, omic_input_dim
        for j, width in enumerate(omic_hidden):
            setattr(self, f"fc_omic_{j}", block(dim, width, 0.25))
            dim = width
        gates = dict(dim1=256, dim2=256, scale_dim1=scale_dim1, gate1=gate_path,
                     scale_dim2=scale_dim2, gate2=gate_omic)
        if fusion == "bilinear":
            self.mm = BilinearFusion(skip=int(skip), mmhid=256, **gates)
            self.out_features = 256
        elif fusion == "lrb":
            self.mm = LRBilinearFusion(**gates)
            self.out_features = self.mm.out_features
        elif fusion == "concat":
            _concat_head(self, top)
            self.out_features = top
        else:
            self.out_features = top

    def forward(self, x_path, x_omic, path_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = dropout(x_path, self.dropinput, generator)
        h = dropout(F.relu(self.fc_h(h)), self.rate, generator)
        scores, h = self.attention_net_h(h, generator)
        h_path, _ = masked_attention_pool(scores, h, path_valid)
        h_path = dropout(F.relu(self.rho_h(h_path[:, 0])), self.rate, generator)

        ho = x_omic[:, : self.omic_input_dim]
        for j in range(self.omic_depth):
            ho = getattr(self, f"fc_omic_{j}")(ho, generator)

        if self.fusion in ("bilinear", "lrb"):
            return self.mm(h_path, ho, generator)
        if self.fusion == "concat":
            return _concat(self, h_path, ho)
        return h_path + ho


class SubNet(nn.Module):
    """tanh(enc2(tanh(enc1(x))))."""

    def __init__(self, in_size: int, hidden_size: int):
        super().__init__()
        self.enc1 = nn.Linear(in_size, hidden_size)
        self.enc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.enc2(torch.tanh(self.enc1(x))))


class BatchNorm(nn.Module):
    """Batch normalisation over the rows of [R, C] as flax's ``nn.BatchNorm``
    with its defaults, not ``torch.nn.BatchNorm1d``: a training forward
    normalises by the batch mean and the *biased* variance
    max(0, E[x²] − E[x]²) and updates ``running = 0.99·running + 0.01·batch``
    with that same biased variance (``BatchNorm1d`` takes the unbiased one
    into its running variance, which doubles the increment at two rows);
    an eval forward normalises by the running buffers.  ε = 1e-5.  The
    buffers ``running_mean``/``running_var`` are part of ``state_dict``.

    With a ``batch_axis`` of more than one rank (a mesh's ``data`` axis, set
    by :func:`imp_torch.ops.attention.set_batch_axis`) a training forward
    takes the moments of the global batch: Σx and Σx² summed over the axis
    by one differentiable all-reduce, over every rank's rows (the data
    shards are equal), as JAX's BatchNorm does under its trainer's
    data-sharded ``jit``; the running buffers then move alike on every
    rank."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.batch_axis = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # statistics in float32 (float64 for a float64 input) and the
        # output in the dtype of x and the affine parameters (bfloat16
        # under TRAINER.PREC bf16), as flax computes them; the running
        # buffers stay float32
        out_dtype = torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            moments = torch.stack([x.sum(dim=0), (x * x).sum(dim=0)])
            rows = x.shape[0]
            if self.batch_axis is not None:
                moments, rows = psum(moments, self.batch_axis), rows * self.batch_axis.size
            mean, mean_sq = moments / rows
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean.detach(), alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var.detach(), alpha=1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(out_dtype)


def _mfb(x1: torch.Tensor, x2: torch.Tensor, output_dim: int, rank: int, rate: float,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """Factorised bilinear pooling: the product summed over ``rank`` groups,
    signed square root, L2-normalised (``jnp.maximum(norm, 1e-12)``)."""
    f = dropout(x1 * x2, rate, generator)
    f = f.reshape(f.shape[0], output_dim, rank).sum(-1)
    f = torch.sqrt(F.relu(f)) - torch.sqrt(F.relu(-f))
    return f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-12)


class HFB(nn.Module):
    """Hierarchical factorised bilinear fusion (reference
    ``fusion/hfb.py:22-190``), per sample: the omics' first 1 000 genes as
    2 × 250 rows of genes and 2 × 250 of copy numbers, two attention pools
    of the bag as 2 path rows; intra- and inter-modal factorised bilinear
    pooling, :class:`BatchNorm` over the 2B fused rows (batch statistics in
    a training forward, the one with a ``generator``), and the pair of
    rows concatenated into ``Linear_encoder``.  The reference's two quirks
    stay (module docstring)."""

    def __init__(self, omic_input_dim: int = 250, path_input_dim: int = 512,
                 hidden_dims: Sequence[int] = (128, 128, 128, 256),
                 output_dims: Sequence[int] = (128, 128, 1), rank: int = 20,
                 fac_drop: float = 0.10):
        super().__init__()
        gh, ph, ch, _ = hidden_dims
        oi, oe, _ = output_dims
        self.ph, self.oi, self.oe, self.rank, self.fac_drop = ph, oi, oe, rank, fac_drop
        in_size = gh + oi + oe
        self.out_features = in_size
        self.encoder_gene = SubNet(omic_input_dim, gh)
        self.encoder_cona = SubNet(omic_input_dim, ch)
        self.encoder_path = SubNet(path_input_dim, ph)
        self.attention_net1 = Attn_Net_Gated(ph, D=ph, dropout=True)
        self.attention_net2 = Attn_Net_Gated(ph, D=ph, dropout=True)
        self.Linear_gene = nn.Linear(gh, rank * oi)
        self.Linear_path = nn.Linear(ph, rank * oi)
        self.Linear_cona = nn.Linear(ch, rank * oi)
        self.attention_fc = nn.Linear(gh + oi, 1)
        self.Linear_gene_a = nn.Linear(gh + oi, rank * oe)
        self.norm = BatchNorm(in_size)
        self.Linear_encoder = nn.Linear(2 * in_size, in_size)

    def forward(self, x_path, x_omic, path_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b = x_path.shape[0]

        def mfb(a, c, output_dim):
            return _mfb(a, c, output_dim, self.rank, self.fac_drop, generator)

        gene_feature = self.encoder_gene(x_omic[:, :500].reshape(2 * b, 250))
        cona_feature = self.encoder_cona(x_omic[:, 500:1000].reshape(2 * b, 250))
        path_feature = self.encoder_path(x_path)  # [B, N, ph]
        pools = []
        for net in (self.attention_net1, self.attention_net2):
            scores, h = net(path_feature, generator)
            pools.append(masked_attention_pool(scores, h, path_valid)[0])
        path_rows = torch.cat(pools, dim=1).reshape(2 * b, self.ph)

        gene_h = self.Linear_gene(gene_feature)
        path_h = self.Linear_path(path_rows)
        cona_h = self.Linear_cona(cona_feature)
        gene_x = torch.cat([gene_feature, mfb(gene_h, gene_h, self.oi)], dim=1)
        path_x = torch.cat([path_rows, mfb(path_h, path_h, self.oi)], dim=1)
        cona_x = torch.cat([cona_feature, mfb(cona_h, cona_h, self.oi)], dim=1)

        sg, sp, sc = (torch.sigmoid(self.attention_fc(t)) for t in (gene_x, path_x, cona_x))
        gene_x_a, path_x_a = sg * gene_x, sp * path_x
        cona_x_a = sc * gene_x  # the reference's quirk (ref hfb.py:150)
        unimodal = gene_x_a + path_x_a + cona_x_a

        g, p, c = (torch.softmax(t, dim=1) for t in (gene_x_a, path_x_a, cona_x_a))
        sgv, spv, scv = sg[:, 0], sp[:, 0], sc[:, 0]

        def dot(u, v):
            return (u * v).sum(dim=1)

        sgp = 1.0 / (dot(g, p) + 0.5) * (sgv + spv)
        sgc = 1.0 / (dot(g, c) + 0.5) * (sgv + scv)
        spc = 1.0 / (dot(p, c) + 0.5) * (spv + scv)
        normalize = torch.softmax(torch.stack([sgp, sgc, spc], dim=1), dim=1)

        # the reference's quirk: one projection for all three (ref hfb.py:174-176)
        gene_l, path_l, cona_l = (self.Linear_gene_a(t) for t in (gene_x_a, path_x_a, cona_x_a))
        bimodal = (normalize[:, 0:1] * mfb(gene_l, path_l, self.oe)
                   + normalize[:, 1:2] * mfb(gene_l, cona_l, self.oe)
                   + normalize[:, 2:3] * mfb(path_l, cona_l, self.oe))
        fusion = self.norm(torch.cat([unimodal, bimodal], dim=1), train=generator is not None)
        return self.Linear_encoder(fusion.reshape(b, -1))
