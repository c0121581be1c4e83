"""CLIP / PLIP towers — the PyTorch counterpart of ``imp_tpu/models/clip.py``
(reference vendored ``clip/model.py``).

* :class:`VisionTransformer` — the ViT image tower (QuickGELU, pre-LN
  residual blocks, class token and positional embedding, ``ln_post`` on
  token 0, then ``proj``), batched; the patchify is a bias-free
  stride = kernel = patch product over the HWIO kernel.
* :class:`TextTransformer` — the causal text tower with EOT pooling at the
  highest token id, then ``text_projection``.
* :class:`ModifiedResNet` — the anti-aliased ResNet tower with inference
  BatchNorm (running statistics, ε = 1e-5) and :class:`AttentionPool2d`,
  which attends with the mean-token query alone, as the JAX module does.

Images are NHWC (``[B, H, W, 3]``), as in the JAX package; the ResNet
permutes to NCHW inside.  Parameter names follow the flax tree
(``resblocks.i`` for ``resblocks_i``, ``layer1.0`` for ``layer1_0``), and
the packed ``in_proj_weight`` is kept ``[d, 3d]`` and applied as ``x @ W``,
as the port's :class:`~imp_torch.ops.attention.MultiheadAttention` keeps it:
:func:`imp_torch.convert.clip_state_dict` carries a flax tree over and
:func:`imp_torch.convert.convert_torch_clip_state` an OpenAI ``state_dict``.
The products are ``torch.matmul`` and the softmax plain PyTorch: the JAX
towers run no Pallas kernel.  :func:`imp_torch.ops.attention.init_parameters_`
draws every parameter from the flax module's own init distributions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

CLIP_CONFIGS = {
    # embed_dim, image_resolution, vision_layers, vision_width, patch,
    # context_length, vocab_size, t_width, t_heads, t_layers
    "ViT-B/32": dict(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=32, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-B/16": dict(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=16, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-L/14": dict(
        embed_dim=768, image_resolution=224, vision_layers=24, vision_width=1024,
        vision_patch_size=14, context_length=77, vocab_size=49408,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    "ViT-L/14@336px": dict(
        embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
        vision_patch_size=14, context_length=77, vocab_size=49408,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    # ModifiedResNet variants (ref ``clip/model.py:93-164``); vision_layers
    # is the per-stage Bottleneck count, vision_width the stem width
    "RN50": dict(
        embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
        vision_width=64, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=512, transformer_heads=8,
        transformer_layers=12,
    ),
    "RN101": dict(
        embed_dim=512, image_resolution=224, vision_layers=(3, 4, 23, 3),
        vision_width=64, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=512, transformer_heads=8,
        transformer_layers=12,
    ),
    "RN50x4": dict(
        embed_dim=640, image_resolution=288, vision_layers=(4, 6, 10, 6),
        vision_width=80, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=640, transformer_heads=10,
        transformer_layers=12,
    ),
    "RN50x16": dict(
        embed_dim=768, image_resolution=384, vision_layers=(6, 8, 18, 8),
        vision_width=96, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=768, transformer_heads=12,
        transformer_layers=12,
    ),
    "RN50x64": dict(
        embed_dim=1024, image_resolution=448, vision_layers=(3, 15, 36, 10),
        vision_width=128, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=1024, transformer_heads=16,
        transformer_layers=12,
    ),
}


def available_models():
    """Names the towers can be built at (the reference's
    ``clip.available_models()``)."""
    return list(CLIP_CONFIGS)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    t.normal_(0.0, std, generator=generator)


class Dense(nn.Linear):
    """flax ``nn.Dense``: a Linear drawn N(0, 1/fan_in), lecun normal's
    variance (flax truncates it at two deviations), with a zero bias."""

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        _normal_(self.weight, 1.0 / math.sqrt(self.in_features), generator)
        if self.bias is not None:
            self.bias.zero_()


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Dense(width, 4 * width)
        self.c_proj = Dense(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, h, d // h).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ/√dh [causal: -inf above the diagonal]) · v over
    ``[B, h, n, dh]`` heads, as the JAX einsums compute it."""
    dh = q.shape[-1]
    scores = torch.matmul(q * dh**-0.5, k.transpose(-1, -2))
    if causal:
        n = scores.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


class CLIPAttention(nn.Module):
    """Packed-qkv multi-head attention (``torch.nn.MultiheadAttention``'s
    parameters, ``in_proj_weight`` kept ``[d, 3d]``), optionally causal."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(width, 3 * width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Dense(width, width)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        d3, d = self.in_proj_weight.shape[1], self.in_proj_weight.shape[0]
        bound = math.sqrt(6.0 / (d + d3))  # flax xavier_uniform of [d, 3d]
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = torch.matmul(x, self.in_proj_weight).add(self.in_proj_bias).chunk(3, dim=-1)
        out = _attend(_heads(q, self.heads), _heads(k, self.heads), _heads(v, self.heads), causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=self.causal)
        return x + self.mlp(self.ln_2(x))


class VisionTransformer(nn.Module):
    def __init__(self, input_resolution: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512):
        super().__init__()
        self.patch, self.width = patch_size, width
        self.grid = input_resolution // patch_size
        self.conv1_kernel = nn.Parameter(torch.empty(patch_size, patch_size, 3, width))  # HWIO
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(self.grid**2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        scale = self.width**-0.5
        _normal_(self.conv1_kernel, (3 * self.patch**2) ** -0.5, generator)  # fan_in normal
        for t in (self.class_embedding, self.positional_embedding, self.proj):
            _normal_(t, scale, generator)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` -> ``[B, grid², width]``: the VALID stride =
        kernel = patch convolution as one product over each patch's
        (row, column, channel) values, the kernel's HWIO order."""
        b, p, g = x.shape[0], self.patch, self.grid
        x = x[:, : g * p, : g * p].reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        kernel = self.conv1_kernel.reshape(p * p * 3, self.width)
        return torch.matmul(x.reshape(b, g * g, p * p * 3), kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        x = self.patchify(x)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        for blk in self.resblocks:
            x = blk(x)
        return torch.matmul(self.ln_post(x[:, 0, :]), self.proj)


class TextTransformer(nn.Module):
    """Token and positional embedding, causal blocks, ``ln_final``, pooling
    at the EOT token (the highest id of each row), ``text_projection``."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.width = width
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=True) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        _normal_(self.token_embedding, 0.02, generator)
        _normal_(self.positional_embedding, 0.01, generator)
        _normal_(self.text_projection, self.width**-0.5, generator)

    def forward(self, text_tokens: torch.Tensor) -> torch.Tensor:  # [B, L] ids
        x = self.token_embedding[text_tokens] + self.positional_embedding[: text_tokens.shape[1]]
        for blk in self.resblocks:
            x = blk(x)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), text_tokens.argmax(dim=-1)]
        return torch.matmul(pooled, self.text_projection)


# ---------------------------------------------------------------------------
# the ModifiedResNet tower
# ---------------------------------------------------------------------------


class Conv(nn.Conv2d):
    """A bias-free convolution drawn N(0, 1/fan_in), the variance of flax
    ``nn.Conv``'s lecun normal init."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=False)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        _normal_(self.weight, fan_in**-0.5, generator)


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm over NCHW: scale and bias are parameters,
    the running mean and variance buffers (flax ``batch_stats``), ε = 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class ResNetBottleneck(nn.Module):
    """CLIP's anti-aliased Bottleneck (ref ``clip/model.py:10-53``): every
    convolution at stride 1; an average pool strides after conv2 and before
    the 1x1 downsample convolution."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.stride = stride
        self.conv1, self.bn1 = Conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, padding=1), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = Conv(planes, out_ch, 1), FrozenBatchNorm2d(out_ch)
        self.has_downsample = stride > 1 or inplanes != out_ch
        if self.has_downsample:
            self.downsample_conv = Conv(inplanes, out_ch, 1)
            self.downsample_bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling (ref ``clip/model.py:56-91``) with the
    mean-token query alone: the reference's full self-attention keeps only
    token 0, so this is the same output at 1/(HW+1) of the products."""

    def __init__(self, spacial: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.c_proj = Dense(embed_dim, output_dim)

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        _normal_(self.positional_embedding, self.positional_embedding.shape[1] ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        q = _heads(self.q_proj(tokens[:, :1]), self.heads)
        k = _heads(self.k_proj(tokens), self.heads)
        v = _heads(self.v_proj(tokens), self.heads)
        out = _attend(q, k, v).transpose(1, 2).reshape(b, 1, c)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP's ResNet image tower (ref ``clip/model.py:93-164``): a 3-conv
    stem with an average pool, 4 stages of anti-aliased Bottlenecks, then
    attention pooling."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        w = width
        self.conv1, self.bn1 = Conv(3, w // 2, 3, stride=2, padding=1), FrozenBatchNorm2d(w // 2)
        self.conv2, self.bn2 = Conv(w // 2, w // 2, 3, padding=1), FrozenBatchNorm2d(w // 2)
        self.conv3, self.bn3 = Conv(w // 2, w, 3, padding=1), FrozenBatchNorm2d(w)
        inplanes = w
        for stage, (mult, n_blocks) in enumerate(zip((1, 2, 4, 8), layers), start=1):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 1 and i == 0 else 1
                blocks.append(ResNetBottleneck(inplanes, w * mult, stride))
                inplanes = w * mult * 4
            setattr(self, f"layer{stage}", nn.ModuleList(blocks))
        self.attnpool = AttentionPool2d((input_resolution // 32) ** 2, w * 32, heads, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = blk(x)
        return self.attnpool(x.permute(0, 2, 3, 1))


def build_vision_tower(name: str = "ViT-B/32") -> nn.Module:
    """The image tower of ``name`` (parameters uninitialised: load a state,
    or draw them with :func:`imp_torch.ops.attention.init_parameters_`)."""
    c = CLIP_CONFIGS[name]
    if c["vision_patch_size"] is None:  # ModifiedResNet family
        return ModifiedResNet(
            layers=tuple(c["vision_layers"]), output_dim=c["embed_dim"],
            heads=c["vision_width"] * 32 // 64, input_resolution=c["image_resolution"],
            width=c["vision_width"],
        )
    return VisionTransformer(
        input_resolution=c["image_resolution"], patch_size=c["vision_patch_size"],
        width=c["vision_width"], layers=c["vision_layers"], heads=c["vision_width"] // 64,
        output_dim=c["embed_dim"],
    )


def build_text_tower(name: str = "ViT-B/32") -> TextTransformer:
    c = CLIP_CONFIGS[name]
    return TextTransformer(
        context_length=c["context_length"], vocab_size=c["vocab_size"],
        width=c["transformer_width"], heads=c["transformer_heads"],
        layers=c["transformer_layers"], embed_dim=c["embed_dim"],
    )
