"""Auxiliary ops from the reference that sit outside the live training path —
the counterpart of ``imp_tpu/ops/extras.py`` (reference
``medmm/modeling/ops/utils.py``: sinkhorn, EMA, sharpening, ramp-ups).

The Gumbel draw of :func:`distributed_sinkhorn` takes an explicit
``torch.Generator``; :func:`gumbel_hard_assignment` is the draw's math on
given uniforms, so a caller (or a test) can feed the uniforms of another
generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F


def sharpen_prob(p: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Probability sharpening (reference ``ops/utils.py:11-16``)."""
    p = p ** (1.0 / temperature)
    return p / p.sum(dim=1, keepdim=True)


def create_onehot(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Float32 one-hot rows of ``label`` (JAX's ``jax.nn.one_hot``: an
    out-of-range label gives a row of zeros)."""
    label = label.long()
    valid = (label >= 0) & (label < num_classes)
    hot = F.one_hot(torch.where(valid, label, 0), num_classes).to(torch.float32)
    return hot * valid[..., None]


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential ramp-up from https://arxiv.org/abs/1610.02242
    (reference ``ops/utils.py:42-55``)."""
    if rampup_length == 0:
        return 1.0
    current = min(max(current, 0.0), rampup_length)
    phase = 1.0 - current / rampup_length
    return float(math.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return float(min(max(current / rampup_length, 0.0), 1.0))


def momentum_update(old_value, new_value, momentum: float):
    """EMA update (reference ``ops/utils.py:138-144``)."""
    return momentum * old_value + (1.0 - momentum) * new_value


Params = Union[Dict[str, torch.Tensor], List[torch.Tensor]]


def ema_tree_update(params: Params, ema_params: Params, alpha: float) -> Params:
    """EMA over parameters (reference ``ops/utils.py:74-83``):
    ``alpha * ema + (1 - alpha) * p`` for each entry of a state dict (by
    name) or of a list of tensors (by position); returns new tensors of the
    same structure as ``ema_params``."""
    if isinstance(ema_params, dict):
        if set(ema_params) != set(params):
            raise ValueError("params and ema_params name different tensors")
        return {k: alpha * e + (1.0 - alpha) * params[k] for k, e in ema_params.items()}
    if len(ema_params) != len(params):
        raise ValueError(f"{len(params)} params, {len(ema_params)} ema_params")
    return [alpha * e + (1.0 - alpha) * p for e, p in zip(ema_params, params)]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def sinkhorn_assignment(out: torch.Tensor, sinkhorn_iterations: int = 3,
                        epsilon: float = 0.05) -> torch.Tensor:
    """The Sinkhorn-Knopp soft assignment ``[B, K]`` of scores ``out``."""
    L = torch.exp(out / epsilon).T  # K x B
    K, B = L.shape
    L = L / torch.sum(L)
    for _ in range(sinkhorn_iterations):
        L = L / torch.sum(L, dim=1, keepdim=True) / K
        L = L / torch.sum(L, dim=0, keepdim=True) / B
    return (L * B).T


def gumbel_hard_assignment(L: torch.Tensor, uniforms: torch.Tensor,
                           tau: float = 0.5) -> torch.Tensor:
    """Straight-through Gumbel-softmax hard assignment of ``L`` ``[B, K]``
    with Gumbel noise ``-log(-log(u))`` of the given uniforms: one-hot rows
    forward, the soft rows' gradient backward."""
    gumbel = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    y_soft = torch.softmax((L + gumbel) / tau, dim=1)
    hard = F.one_hot(torch.argmax(y_soft, dim=1), L.shape[1]).to(y_soft.dtype)
    return hard + y_soft - y_soft.detach()


def distributed_sinkhorn(
    out: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    sinkhorn_iterations: int = 3,
    epsilon: float = 0.05,
    tau: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sinkhorn cluster assignment with a Gumbel-softmax hard assignment
    (reference ``ops/utils.py:151-174``): (L_hard ``[B, K]``, the argmax
    cluster of each row of the soft assignment).  The uniforms are drawn
    from ``generator`` (on ``out``'s device)."""
    L = sinkhorn_assignment(out, sinkhorn_iterations, epsilon)
    uniforms = torch.rand(L.shape, generator=generator, dtype=L.dtype, device=L.device)
    return gumbel_hard_assignment(L, uniforms, tau), torch.argmax(L, dim=1)
