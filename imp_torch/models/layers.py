"""Shared UMEML building blocks — the PyTorch counterpart of
``imp_tpu/models/layers.py``, batched over slides with masks instead of
per-slide Python loops.  Parameter names follow the JAX package's tree
(``imp_torch.convert`` maps one onto the other)."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import MultiheadAttention, TransLayer
from ..ops.pairing import (
    cosine_similarity_matrix,
    gather_tokens,
    greedy_topk_pairs,
    remove_indices_keep_order,
)


@torch.no_grad()
def proto_init_(t: torch.Tensor, n_c: int, generator: torch.Generator) -> None:
    """reset(): U(-1/n_c, 1/n_c) (reference ``umeml.py:18``)."""
    t.uniform_(-1.0 / n_c, 1.0 / n_c, generator=generator)


class GroupedLinear(nn.Module):
    """K parallel Linear layers evaluated as ONE batched einsum over
    zero-padded gene groups (``bkg,kgd->bkd``).  ``kernel`` is
    ``[K, Gmax, D]``; rows past group k's true fan-in are zero, and the
    caller zeroes the matching inputs, so the values equal K separate
    Linears.  Init: U(±1/sqrt(fan_in_k)) with each group's TRUE fan-in."""

    def __init__(self, group_sizes: Sequence[int], features: int):
        super().__init__()
        self.group_sizes = tuple(int(g) for g in group_sizes)
        k, gmax = len(self.group_sizes), max(self.group_sizes)
        self.kernel = nn.Parameter(torch.empty(k, gmax, features))
        self.bias = nn.Parameter(torch.empty(k, features))

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        self.kernel.zero_()
        for i, g in enumerate(self.group_sizes):
            bound = 1.0 / math.sqrt(g) if g > 0 else 0.0
            self.kernel[i, :g].uniform_(-bound, bound, generator=generator)
            self.bias[i].uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, K, Gmax]
        return torch.einsum("bkg,kgd->bkd", x, self.kernel) + self.bias


class PathProtoGenerator(nn.Module):
    """Prototype refinement: c + LN(CrossAttn(c, bag, bag)), one head
    (reference ``umeml_gan.py:65-80``), with a key mask over the bag; with
    a ``seq`` axis the bag is this rank's token band."""

    def __init__(self, dim: int, seq=None):
        super().__init__()
        self.cross_attn = MultiheadAttention(dim, num_heads=1, seq=seq)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D] bag
        c: torch.Tensor,  # [B, P, D] prototypes
        key_valid: Optional[torch.Tensor] = None,  # [B, N]
    ) -> torch.Tensor:
        _c, _ = self.cross_attn(c, x, x, key_valid=key_valid, need_raw=True)
        return c + self.norm1(_c)


class Block(nn.Module):
    """TransLayer wrapper (reference ``umeml_gan.py:86-96``)."""

    def __init__(self, dim: int, impl: str = "nystrom", pinv_mode: str = "chain"):
        super().__init__()
        self.attn = TransLayer(dim=dim, impl=impl, pinv_mode=pinv_mode)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        return self.attn(x, mask=mask, generator=generator)


class BottleneckAttentionBlock(nn.Module):
    """Bottleneck-token multimodal encoder.

    Plain variant (reference ``umeml.py:58-83``): [x_path, bottle, x_omic]
    through two TransLayers, split back.  Paired variant
    (``use_pairing=True``, reference ``umeml_gan.py:100-229``): greedy top-K
    cosine pairing, fusion tokens ``linear_p(p) + linear_o(o)``, sequence
    [fused(K), remaining_p, bottle, remaining_o].  The split indices follow
    the reference (computed from the ORIGINAL path length)."""

    def __init__(
        self,
        dim: int = 256,
        n_reg: int = 2,
        use_pairing: bool = False,
        topk: int = 3,
        impl: str = "nystrom",
        pinv_mode: str = "chain",
    ):
        super().__init__()
        self.n_reg, self.use_pairing, self.topk = n_reg, use_pairing, topk
        self.bottle_tokens = nn.Parameter(torch.empty(1, n_reg, dim))
        if use_pairing:
            self.linear_p = nn.Linear(dim, dim)
            self.linear_o = nn.Linear(dim, dim)
        self.encoders = nn.ModuleList([Block(dim, impl, pinv_mode) for _ in range(2)])
        #: a list while :func:`sow_similarity` records: each paired call
        #: appends its pre-pairing similarity grid (JAX's sown ``similarity``)
        self.sown: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def reset_own_parameters(self, generator: torch.Generator) -> None:
        self.bottle_tokens.uniform_(0.0, 1.0, generator=generator)

    def forward(
        self,
        x_path: torch.Tensor,
        x_omic: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        b, path_len, d = x_path.shape
        bottle_b = self.bottle_tokens.expand(b, -1, -1)
        if not self.use_pairing:
            x = torch.cat([x_path, bottle_b, x_omic], dim=1)
        else:
            sim = cosine_similarity_matrix(x_path, x_omic)
            if self.sown is not None:  # the plot variant's grid
                self.sown.append(sim.detach())
            rows, cols = greedy_topk_pairs(sim, self.topk)  # selection order
            ks = self.linear_p(gather_tokens(x_path, rows)) + self.linear_o(
                gather_tokens(x_omic, cols)
            )
            remaining_p = remove_indices_keep_order(x_path, rows)
            remaining_o = remove_indices_keep_order(x_omic, cols)
            x = torch.cat([ks, remaining_p, bottle_b, remaining_o], dim=1)
        for enc in self.encoders:
            x = enc(x, generator=generator)
        t = path_len + self.n_reg
        return x[:, :1], x[:, 1:path_len], x[:, t : t + 1], x[:, t + 1 :]


class Stacked(nn.Module):
    """``n`` twins of one module as ONE module over a leading axis (JAX's
    ``nn.vmap`` with ``variable_axes={"params": 0}``): every parameter of
    ``self.layer`` is stacked to ``[n, *shape]`` (independent init draws
    per twin), and :meth:`forward` maps twin ``i`` of the ``[n, ...]``
    input through ``self.layer`` at parameter slice ``i``.  The twins run
    one after the other, so each keeps its own reductions (a Nyström
    twin's pseudo-inverse normalises by its own global max, as under
    ``vmap``) and draws its own dropout masks."""

    def __init__(self, make, n: int = 2):
        super().__init__()
        self.n = n
        self.layer = make()
        for mod in self.layer.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = nn.Parameter(
                        p.detach().unsqueeze(0).repeat(n, *([1] * p.dim())))

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        stacked = dict(self.layer.named_parameters())
        return torch.stack([
            torch.func.functional_call(self.layer, {k: p[i] for k, p in stacked.items()},
                                       (x[i], *args), kwargs)
            for i in range(self.n)
        ])


@contextlib.contextmanager
def sow_similarity(block: BottleneckAttentionBlock) -> Iterator[List[torch.Tensor]]:
    """Record the pre-pairing similarity grid ([rows, P, O]) of each paired
    call of ``block`` in the yielded list, in call order (the plot variant,
    reference ``umeml_gan_plot.py:124-168``)."""
    block.sown = []
    try:
        yield block.sown
    finally:
        block.sown = None


class Generator(nn.Module):
    """CycleGAN generator MLP: flatten -> 1024 -> ReLU -> out -> Softplus
    (reference ``umeml_gan.py:25-45``)."""

    def __init__(self, tokens: int, dim: int):
        super().__init__()
        self.tokens, self.dim = tokens, dim
        self.fc1 = nn.Linear(tokens * dim, 1024)
        self.fc2 = nn.Linear(1024, tokens * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = F.relu(self.fc1(x.reshape(b, -1)))
        return F.softplus(self.fc2(h)).reshape(b, self.tokens, self.dim)


class Discriminator(nn.Module):
    """flatten -> 256 -> ReLU -> 1 -> Sigmoid (reference ``umeml_gan.py:48-62``).
    Trained by the GAN phase of MBTRAIN; unused by the eval forward."""

    def __init__(self, in_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 256)
        self.fc2 = nn.Linear(256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return torch.sigmoid(self.fc2(h))


def transform_importance(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max to [0.5, 1.0] (reference ``umeml_gan.py:689-694``)."""
    mn = x.min(dim=1, keepdim=True).values
    mx = x.max(dim=1, keepdim=True).values
    return 0.5 + 0.5 * (x - mn) / (mx - mn + 1e-8)


def transform_importance_to_half_one_point_five(x: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max to [0.5, 1.5] (reference ``umeml_gan.py:696-702``)."""
    mn = x.min(dim=1, keepdim=True).values
    mx = x.max(dim=1, keepdim=True).values
    return 0.5 + (x - mn) / (mx - mn + 1e-8)
