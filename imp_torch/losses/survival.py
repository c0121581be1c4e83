"""Survival / classification losses — the PyTorch counterpart of
``imp_tpu/losses/survival.py`` (reference ``medmm/loss/loss.py``).

* :func:`nll_loss` — discrete-time survival NLL over hazards
* :func:`nll_loss_new` — Zadeh & Schmid (2020) NLL over raw logits; the loss
  of the UMEML configs
* :func:`ce_surv_loss` — survival CE variant
* :func:`cox_loss` — Cox partial likelihood with a risk-set matrix
* :func:`kd_loss` — temperature-scaled KL self-distillation
* :func:`cca_loss` — 1 / mean singular value of the std-normalised
  cross-covariance (ddof = 0, as JAX's ``std``; the gradient flows through
  ``torch.linalg.svdvals``)
* :func:`similarity_alignment_loss` — the CCA epoch's per-batch loss
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.registry import Registry

LOSS_REGISTRY = Registry("LOSS")


def hazards_to_survival(hazards: torch.Tensor) -> torch.Tensor:
    """S = cumprod(1 - h) along the time-bin axis."""
    return torch.cumprod(1.0 - hazards, dim=1)


def _gather_bin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x[i, y[i]] as a column vector."""
    return torch.gather(x, 1, y)


def _prep(Y, c, like):
    batch = Y.shape[0]
    return Y.reshape(batch, 1).long(), c.reshape(batch, 1).to(like.dtype)


def nll_loss(hazards, S, Y, c, alpha: float = 0.4, eps: float = 1e-7):
    Y, c = _prep(Y, c, hazards)
    if S is None:
        S = hazards_to_survival(hazards)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    uncensored = -(1.0 - c) * (
        torch.log(_gather_bin(S_padded, Y).clamp_min(eps))
        + torch.log(_gather_bin(hazards, Y).clamp_min(eps))
    )
    censored = -c * torch.log(_gather_bin(S_padded, Y + 1).clamp_min(eps))
    neg_l = censored + uncensored
    loss = (1.0 - alpha) * neg_l + alpha * uncensored
    return loss.mean()


def nll_loss_new(logits, Y, c, alpha: float = 0.0, eps: float = 1e-7, reduction: str = "mean"):
    """Zadeh & Schmid NLL over raw logits (hazards = sigmoid(logits))."""
    Y, c = _prep(Y, c, logits)
    hazards = torch.sigmoid(logits)
    S = hazards_to_survival(hazards)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    s_prev = _gather_bin(S_padded, Y).clamp_min(eps)
    h_this = _gather_bin(hazards, Y).clamp_min(eps)
    s_this = _gather_bin(S_padded, Y + 1).clamp_min(eps)
    uncensored = -(1.0 - c) * (torch.log(s_prev) + torch.log(h_this))
    censored = -c * torch.log(s_this)
    neg_l = censored + uncensored
    loss = (1.0 - alpha) * neg_l + alpha * uncensored
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Bad reduction: {reduction}")


def ce_surv_loss(hazards, S, Y, c, alpha: float = 0.4, eps: float = 1e-7):
    Y, c = _prep(Y, c, hazards)
    if S is None:
        S = hazards_to_survival(hazards)
    S_padded = torch.cat([torch.ones_like(c), S], dim=1)
    reg = -(1.0 - c) * (
        torch.log(_gather_bin(S_padded, Y) + eps)
        + torch.log(_gather_bin(hazards, Y).clamp_min(eps))
    )
    s_y = _gather_bin(S, Y).clamp_min(eps)
    ce_l = -c * torch.log(s_y) - (1.0 - c) * torch.log(1.0 - s_y)
    loss = (1.0 - alpha) * ce_l + alpha * reg
    return loss.mean()


def cox_loss(hazards, times, c):
    """Cox partial likelihood; risk set R[i,j] = (t_j >= t_i)."""
    theta = hazards.reshape(-1)
    risk_set = (times[None, :] >= times[:, None]).to(theta.dtype)
    log_risk = torch.log(torch.sum(torch.exp(theta)[None, :] * risk_set, dim=1))
    return -torch.mean((theta - log_risk) * (1.0 - c))


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.reshape(-1, 1).long()).mean()


def kd_loss(student_logits, teacher_logits, T: float = 5.0):
    """KL(softmax(teacher/T) || softmax(student/T)) * T^2, batchmean."""
    teacher = teacher_logits.detach()
    log_p_s = torch.log_softmax(student_logits / T, dim=1)
    log_p_t = torch.log_softmax(teacher / T, dim=1)
    p_t = torch.softmax(teacher / T, dim=1)
    kl = torch.sum(p_t * (log_p_t - log_p_s), dim=1)
    return kl.mean() * (T * T)


def cca_loss(X, Y, epsilon: float = 1e-8):
    """1 / mean singular value of the standardised cross-covariance."""
    Xc = X - X.mean(dim=0)
    Yc = Y - Y.mean(dim=0)
    Xs = Xc / Xc.std(dim=0, correction=0)
    Ys = Yc / Yc.std(dim=0, correction=0)
    C = Xs.T @ Ys / (X.shape[0] - 1)
    s = torch.linalg.svdvals(C)
    return 1.0 / (s.sum() / s.numel() + epsilon)


def kl_loss(y, y_hat):
    """sum-reduced KL(softmax(y) || softmax(y_hat)) (reference ``KLLoss``)."""
    p = torch.softmax(y, dim=-1)
    return torch.sum(p * (torch.log(p) - torch.log_softmax(y_hat, dim=-1)))


def _cosine_sim(a, b, eps: float = 1e-8):
    na = torch.linalg.vector_norm(a, dim=1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=1).clamp_min(eps)
    return torch.sum(a * b, dim=1) / (na * nb)


def cosine_loss(y, y_hat):
    """1 - cosine_similarity(y, y_hat) per row (reference ``CosineLoss``)."""
    return 1.0 - _cosine_sim(y, y_hat)


def orthogonal_loss(P, P_hat, G, G_hat, gamma: float = 0.5):
    """Reference ``OrthogonalLoss``: pull reconstructions toward their
    (detached) sources, push cross-modal directions apart; per row."""
    P_d, G_d = P.detach(), G.detach()
    pos = (1.0 - torch.abs(_cosine_sim(P_d, P_hat))) + (1.0 - torch.abs(_cosine_sim(G_d, G_hat)))
    neg = (
        torch.abs(_cosine_sim(P, G))
        + torch.abs(_cosine_sim(P_d, G_hat))
        + torch.abs(_cosine_sim(G_d, P_hat))
    )
    return pos + gamma * neg


def similarity_alignment_loss(p_proto_flat, h_omic_flat):
    """MSE between row-normalised Gram matrices of the two modalities — the
    per-batch loss of the CCA epoch."""

    def normed_gram(z):
        g = z @ z.T
        return g / torch.linalg.vector_norm(g, dim=1, keepdim=True)

    return torch.mean((normed_gram(p_proto_flat) - normed_gram(h_omic_flat)) ** 2)


# ---------------------------------------------------------------------------
# registry wrappers (name-compatible with the reference LOSS_REGISTRY)
# ---------------------------------------------------------------------------


class NLLSurvLoss:
    def __init__(self, alpha: float = 0.0, **kw):
        self.alpha = alpha

    def __call__(self, hazards, S, Y, c, alpha: Optional[float] = None):
        return nll_loss(hazards, S, Y, c, self.alpha if alpha is None else alpha)


class NLLSurvLoss_NEW:
    def __init__(self, alpha: float = 0.0, eps: float = 1e-7, reduction: str = "sum"):
        self.alpha, self.eps, self.reduction = alpha, eps, reduction

    def __call__(self, logits, Y, c):
        # the reference passes the model's output tuple and uses logits[0]
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        return nll_loss_new(logits, Y, c, self.alpha, self.eps, self.reduction)


class CrossEntropySurvLoss:
    def __init__(self, alpha: float = 0.15, **kw):
        self.alpha = alpha

    def __call__(self, hazards, S, Y, c, alpha: Optional[float] = None):
        return ce_surv_loss(hazards, S, Y, c, self.alpha if alpha is None else alpha)


class CoxSurvLoss:
    def __init__(self, **kw):
        pass

    def __call__(self, hazards, times, c, **kw):
        return cox_loss(hazards, times, c)


class CrossEntropyLoss:
    def __init__(self, alpha: float = 0.15, **kw):
        self.alpha = alpha

    def __call__(self, X, Y):
        if isinstance(X, (tuple, list)):
            X = X[0]
        return cross_entropy(X, Y)


LOSS_REGISTRY.register_as("nllsurvloss")(NLLSurvLoss)
LOSS_REGISTRY.register_as("nllsurvloss_new")(NLLSurvLoss_NEW)
LOSS_REGISTRY.register_as("cesurvloss")(CrossEntropySurvLoss)
LOSS_REGISTRY.register_as("coxsurvloss")(CoxSurvLoss)
LOSS_REGISTRY.register_as("celoss")(CrossEntropyLoss)


def build_loss(name: str, **kwargs):
    cls = LOSS_REGISTRY.get(name)
    try:
        return cls(**kwargs)
    except TypeError:
        return cls()
