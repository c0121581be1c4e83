"""Top-k accuracy and pairwise distances on tensors — the counterpart of
``imp_tpu/evaluation/accuracy.py`` (reference ``medmm/metrics/``)."""

from __future__ import annotations

from typing import List, Sequence

import torch


def compute_accuracy(output: torch.Tensor, target: torch.Tensor,
                     topks: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracies in percent (reference ``metrics/accuracy.py:1-30``).
    Among tied scores the class with the higher index ranks first, as the
    JAX package's reversed stable ``argsort`` orders them."""
    if output.ndim == 1:
        output = output[None, :]
    maxk = max(topks)
    pred = torch.argsort(output, dim=1, stable=True).flip(1)[:, :maxk]  # [B, maxk]
    correct = pred == target[:, None]
    return [correct[:, :k].sum() * (100.0 / target.shape[0]) for k in topks]


def euclidean_squared_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances (reference ``metrics/distance.py``)."""
    xx = (x**2).sum(dim=1, keepdim=True)
    yy = (y**2).sum(dim=1, keepdim=True).T
    return xx + yy - 2.0 * x @ y.T


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, pairwise."""
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    yn = y / torch.linalg.norm(y, dim=1, keepdim=True).clamp_min(1e-12)
    return 1.0 - xn @ yn.T


def compute_distance_matrix(x: torch.Tensor, y: torch.Tensor,
                            metric: str = "euclidean") -> torch.Tensor:
    if metric == "euclidean":
        return euclidean_squared_distance(x, y)
    if metric == "cosine":
        return cosine_distance(x, y)
    raise ValueError(f"Unknown distance metric: {metric}")
