"""CLIPOMIC — the CoOp-style omics prompt learner over the CLIP text tower,
the PyTorch counterpart of ``imp_tpu/models/clipomic.py`` (reference
``medmm/modeling/backbone/clipomic.py:21-123``).

The omics vector is cut into ``num_mol`` chunks of ``len_mol`` genes; each
chunk becomes one context-token embedding (``omic_fc``, an SNN block)
spliced into the prompt SOS, ctx, ``.``, EOS, pads.  Each prompt runs
through the causal blocks and ``ln_final``, is pooled at the EOS position
(3) and projected by ``text_projection``; the chunks are then pooled by
gated attention.  Batched per sample, as the JAX module is (the reference
is batch-1).  The text tower's parameters keep the JAX names
(``resblocks.i``, ``ln_final``, ``positional_embedding``,
``text_projection``, ``token_embedding``), so an OpenAI ``state_dict``
loads through :func:`imp_torch.convert.convert_torch_clip_state`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import dropout, train_generator
from ..ops.blocks import Attn_Net_Gated, SNN_Block, masked_attention_pool
from .clip import ResidualAttentionBlock

#: <|startoftext|> X . <|endoftext|> with the standard CLIP vocabulary
DEFAULT_PROMPT_IDS = (49406, 343, 269, 49407)
EOT_POSITION = 3  # EOS is the 4th token of the spliced prompt


class CLIPOMIC(nn.Module):
    def __init__(self, num_mol: int = 5, len_mol: int = 200, model_size_omic: str = "small",
                 dropout: float = 0.25, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 prompt_ids: Sequence[int] = DEFAULT_PROMPT_IDS):
        super().__init__()
        size = {"small": [width, 512, 256], "big": [width, 512, 384]}[model_size_omic]
        self.num_mol, self.len_mol, self.rate, self.width = num_mol, len_mol, dropout, width
        self.out_features = size[2]
        # clamped for shrunken test vocabularies; the real CLIP vocabulary is unaffected
        ids = torch.tensor(prompt_ids, dtype=torch.long).clamp(0, vocab_size - 1)
        self.register_buffer("prompt_ids", ids, persistent=False)
        self.omic_fc = SNN_Block(len_mol, width, dropout=0.25)
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=True) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, width))
        self.fc = nn.Linear(size[0], size[1])
        self.attention_net = Attn_Net_Gated(L=size[1], D=size[2], dropout=dropout > 0)
        self.rho = nn.Linear(size[1], size[2])

    @torch.no_grad()
    def reset_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, self.width**-0.5, generator=generator)

    def prompts(self, ctx: torch.Tensor) -> torch.Tensor:
        """``[B, M, width]`` context tokens -> ``[B·M, L, width]`` prompt
        embeddings (SOS, ctx, ``.``, EOS, pads) plus the positions."""
        b, m, w = ctx.shape
        length = self.positional_embedding.shape[0]
        prompt = self.token_embedding[self.prompt_ids]  # [4, width]
        pad = self.token_embedding[0].expand(length - 4, w)
        fixed = lambda t: t.expand(b, m, *t.shape)  # noqa: E731
        seq = torch.cat([fixed(prompt[:1]), ctx[:, :, None, :], fixed(prompt[2:]), fixed(pad)],
                        dim=2)
        return (seq + self.positional_embedding).reshape(b * m, length, w)

    def forward(self, x_omic: torch.Tensor, generator: Optional[torch.Generator] = None):
        b = x_omic.shape[0]
        chunks = x_omic[:, : self.num_mol * self.len_mol].reshape(b, self.num_mol, self.len_mol)
        x = self.prompts(self.omic_fc(chunks, generator))
        for blk in self.resblocks:
            x = blk(x)
        pooled = self.ln_final(x)[:, EOT_POSITION, :]
        h_omic = torch.matmul(pooled, self.text_projection).reshape(b, self.num_mol, self.width)
        h = dropout(F.relu(self.fc(h_omic)), self.rate, generator)
        scores, h = self.attention_net(h, generator)
        pooled, _ = masked_attention_pool(scores, h)
        return dropout(F.relu(self.rho(pooled[:, 0])), self.rate, generator)


class CLIPOMIC_NET(nn.Module):
    """:class:`CLIPOMIC` (``genomic_backbone``) and a linear classifier, as
    the JAX trainer's network nests them."""

    def __init__(self, num_classes: int, **backbone_kwargs):
        super().__init__()
        self.genomic_backbone = CLIPOMIC(**backbone_kwargs)
        self.classifier = nn.Linear(self.genomic_backbone.out_features, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = train_generator(train, generator)
        return self.classifier(self.genomic_backbone(batch["mol"], g))
