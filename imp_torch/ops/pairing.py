"""Batched greedy top-K path<->omic token pairing — the PyTorch counterpart
of ``imp_tpu/ops/pairing.py``: one cosine-similarity product and K masked
argmax steps, fixed shapes, no per-sample loop."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def cosine_similarity_matrix(
    a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """sim[b,i,j] = cos(a[b,i], b[b,j]) with torch F.cosine_similarity eps
    semantics (denominator clamped at eps)."""
    # products accumulate in float32 and stay float32 under bf16 (JAX's
    # preferred_element_type): the pairing reads float32 similarities
    wide = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    dots = torch.einsum("bid,bjd->bij", a.to(wide), b.to(wide))
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    denom = torch.clamp_min(na[:, :, None] * nb[:, None, :], eps)
    return dots / denom


def greedy_topk_pairs(sim: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy selection of k (row, col) pairs by descending similarity with
    row/col exclusivity.  Ties go to the first flat index, as ``jnp.argmax``.

    Returns (rows [B,k], cols [B,k]) in **selection order**."""
    b, p, o = sim.shape
    neg = -torch.finfo(sim.dtype).max
    s = sim
    rows, cols = [], []
    for _ in range(k):  # k is tiny (3)
        flat_idx = s.reshape(b, p * o).argmax(dim=-1)
        ip = flat_idx // o
        io = flat_idx % o
        rows.append(ip)
        cols.append(io)
        row_hit = F.one_hot(ip, p).bool()
        col_hit = F.one_hot(io, o).bool()
        s = s.masked_fill(row_hit[:, :, None] | col_hit[:, None, :], neg)
    return torch.stack(rows, dim=1), torch.stack(cols, dim=1)


def remove_indices_keep_order(
    tokens: torch.Tensor, removed_idx: torch.Tensor
) -> torch.Tensor:
    """Drop the tokens at ``removed_idx`` ([B,k]) from ``tokens`` ([B,N,D])
    keeping the original order — fixed output shape [B, N-k, D], by a
    stable sort that moves the removed tokens to the back."""
    b, n, d = tokens.shape
    k = removed_idx.shape[1]
    removed = F.one_hot(removed_idx, n).bool().any(dim=1)  # [B, N]
    order = torch.argsort(removed.to(torch.int32), dim=1, stable=True)
    return torch.gather(tokens, 1, order[:, : n - k, None].expand(b, n - k, d))


def gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tokens [B,N,D], idx [B,k] -> [B,k,D]."""
    b, k = idx.shape
    return torch.gather(tokens, 1, idx[..., None].expand(b, k, tokens.shape[-1]))
