"""Optimizers and epoch-stepped learning-rate schedules — the PyTorch
counterpart of ``imp_tpu/optim/builders.py``.

The JAX package builds optax chains; this module mirrors each transform
(``add_decayed_weights``, ``scale_by_adam``, ``scale_by_amsgrad``,
``scale_by_radam``, ``scale_by_rms``, ``trace``, ``scale_by_learning_rate``)
on lists of tensors, with the same formulas and the same order, so a chain
here takes the parameter path of its optax twin.  ``torch.optim`` is not
used: its AMSGrad keeps the max of the *uncorrected* second moment, its
RAdam decays weights by another rule, and its schedules step by epoch
rather than by the optimizer's own update count.

* Adam (``adam``) is coupled L2: the decay joins the gradient before the
  moments, and a mask (a bool per parameter) leaves some parameters out of
  it (``optax.masked``): MBTRAIN keeps the generators out.
* ``radam`` decays decoupled and *after* the RAdam scaling.
* ``adamw`` decays after Adam and ignores the mask, as the JAX builder does.
* The learning rate at update t is the per-epoch table entry
  ``t // updates_per_epoch`` (clipped to ``MAX_EPOCH``), where t counts this
  optimizer's own updates.

:class:`Optimizer` binds a chain to a list of parameters: ``step(grads)``
applies one update in place; a ``None`` gradient counts as zero, as JAX's
gradient of an unused parameter is.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Tensors = List[torch.Tensor]
_f32 = np.float32


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it (at small counts
    the float32 rounding of 1 - 0.999**t is ~1e-5 relative)."""
    return float(_f32(1.0) - _f32(decay) ** _f32(count))


def lr_at_epoch(optim_cfg, epoch: int) -> float:
    """LR used during ``epoch`` (0-indexed), replicating the torch scheduler
    chain: warmup wrapper + successor with WARMUP_RECOUNT=True."""
    base_lr = float(optim_cfg.LR)
    name = optim_cfg.LR_SCHEDULER
    stepsize = optim_cfg.STEPSIZE
    gamma = float(optim_cfg.GAMMA)
    max_epoch = int(optim_cfg.MAX_EPOCH)
    W = int(optim_cfg.WARMUP_EPOCH)

    if W > 0 and epoch < W:
        if optim_cfg.WARMUP_TYPE == "constant":
            return float(optim_cfg.WARMUP_CONS_LR)
        if optim_cfg.WARMUP_TYPE == "linear":
            if epoch == 0:
                return float(optim_cfg.WARMUP_MIN_LR)
            return base_lr * epoch / W
        raise ValueError(optim_cfg.WARMUP_TYPE)

    # successor epoch index: at the first post-warmup epoch the torch warmup
    # wrapper serves the successor's *initial* (un-stepped) lr, so the
    # successor lags the epoch count by exactly W
    se = epoch - W if W > 0 else epoch

    if name == "single_step":
        ss = stepsize[-1] if isinstance(stepsize, (list, tuple)) else stepsize
        ss = int(ss)
        if ss <= 0:
            ss = max_epoch
        return base_lr * gamma ** (se // ss)
    if name == "multi_step":
        milestones = sorted(int(s) for s in stepsize)
        return base_lr * gamma ** bisect_right(milestones, se)
    if name == "cosine":
        return base_lr * (1 + math.cos(math.pi * se / max_epoch)) / 2
    raise ValueError(f"scheduler must be one of single_step/multi_step/cosine, got {name}")


def build_lr_schedule(optim_cfg, updates_per_epoch: int) -> Callable[[int], float]:
    """count -> lr: the per-epoch table indexed by count // updates_per_epoch."""
    max_epoch = int(optim_cfg.MAX_EPOCH)
    table = [lr_at_epoch(optim_cfg, e) for e in range(max_epoch + 1)]

    def schedule(count: int) -> float:
        return table[min(max(count // updates_per_epoch, 0), max_epoch)]

    return schedule


# ---------------------------------------------------------------------------
# transforms: init(params) -> state; update(updates, state, params) ->
# (updates, state).  States are dicts of tensor lists and ints.
# ---------------------------------------------------------------------------


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _moments(updates, state, b1, b2):
    """mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g², count + 1 (in place)."""
    mu, nu = state["mu"], state["nu"]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, updates, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, updates, updates, value=1.0 - b2)
    state["count"] += 1
    return mu, nu, state["count"]


class AddDecayedWeights:
    """updates + wd * params on the parameters the mask selects."""

    def __init__(self, weight_decay: float, mask: Optional[Sequence[bool]] = None):
        self.wd, self.mask = float(weight_decay), mask

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        keep = range(len(updates)) if self.mask is None else [i for i, m in enumerate(self.mask) if m]
        out = list(updates)
        if keep:
            idx = list(keep)
            new = torch._foreach_add([updates[i] for i in idx], [params[i] for i in idx], alpha=self.wd)
            for i, t in zip(idx, new):
                out[i] = t
        return out, state


class ScaleByAdam:
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, updates, state, params):
        mu, nu, t = _moments(updates, state, self.b1, self.b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, t))
        den = torch._foreach_div(nu, _bias_correction(self.b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        return mu_hat, state


class ScaleByAmsgrad(ScaleByAdam):
    """Adam with the running max of the bias-corrected second moment."""

    def init(self, params):
        return {**super().init(params), "nu_max": _zeros(params)}

    def update(self, updates, state, params):
        mu, nu, t = _moments(updates, state, self.b1, self.b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, t))
        nu_hat = torch._foreach_div(nu, _bias_correction(self.b2, t))
        torch._foreach_maximum_(state["nu_max"], nu_hat)
        den = torch._foreach_sqrt(state["nu_max"])
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        return mu_hat, state


class ScaleByRadam(ScaleByAdam):
    """Rectified Adam: the rectified step once ro >= 5, else plain mu_hat.
    ro and r in float32 as optax computes them (ro cancels ~2000 - ~2000)."""

    threshold = 5.0

    def update(self, updates, state, params):
        mu, nu, t = _moments(updates, state, self.b1, self.b2)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _f32(self.b2) ** _f32(t)
        ro = _f32(ro_inf) - _f32(2 * t) * b2t / (_f32(1.0) - b2t)
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, t))
        if ro < self.threshold:
            return mu_hat, state
        r = float(np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * _f32(ro_inf)
                          / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        den = torch._foreach_div(nu, float(_f32(1.0) - b2t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_mul_(mu_hat, r)
        torch._foreach_div_(mu_hat, den)
        return mu_hat, state


class ScaleByRms:
    def __init__(self, decay=0.9, eps=1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return {"nu": _zeros(params)}

    def update(self, updates, state, params):
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, updates, updates, value=1.0 - self.decay)
        den = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(den)
        return torch._foreach_mul(updates, den), state


class Trace:
    """Momentum: t = g + decay t; the update is t (or g + decay t, Nesterov)."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {"trace": _zeros(params)}

    def update(self, updates, state, params):
        tr = state["trace"]
        torch._foreach_mul_(tr, self.decay)
        torch._foreach_add_(tr, updates)
        if self.nesterov:
            return torch._foreach_add(updates, tr, alpha=self.decay), state
        return [t.clone() for t in tr], state


class ScaleByLearningRate:
    """updates * -lr(count), count + 1 (a constant lr is a constant schedule)."""

    def __init__(self, lr: Union[float, Callable[[int], float]]):
        self.lr = lr if callable(lr) else (lambda _count, v=float(lr): v)

    def init(self, params):
        return {"count": 0}

    def update(self, updates, state, params):
        step = self.lr(state["count"])
        state["count"] += 1
        return torch._foreach_mul(updates, -step), state


class Chain:
    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, updates, state, params):
        for t, s in zip(self.transforms, state):
            updates, _ = t.update(updates, s, params)
        return updates, state


class MultiSteps:
    """``optax.MultiSteps``: gradient accumulation over ``every_k`` calls.
    Each call folds the gradient into the running mean
    ``acc <- (g + n·acc) / (n + 1)`` (n: the mini-step, 0 … k-1); the k-th
    call runs the ``inner`` chain on ``acc``, returns its updates and clears
    ``acc``; the others return None, so the parameters and the inner state
    (moments, counts, the schedule's count) stay as they are.  Nothing is
    flushed at an epoch's end: the accumulation carries on, and lives in the
    state (so in a checkpoint)."""

    def __init__(self, inner: Chain, every_k: int):
        self.inner, self.every_k = inner, int(every_k)

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc": _zeros(params)}

    def update(self, updates, state, params):
        n, acc = state["mini_step"], state["acc"]
        torch._foreach_mul_(acc, float(n))
        torch._foreach_add_(acc, updates)
        torch._foreach_div_(acc, float(n + 1))
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return None, state
        out, state["inner"] = self.inner.update([a.clone() for a in acc], state["inner"], params)
        torch._foreach_zero_(acc)
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return out, state


class Optimizer:
    """A chain bound to a list of parameters (a :class:`MultiSteps` chain
    moves them only on the calls that emit an update)."""

    def __init__(self, params: Sequence[torch.Tensor], tx: Chain):
        self.params = list(params)
        self.tx = tx
        with torch.no_grad():
            self.state = tx.init([p.detach() for p in self.params])
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for g, p in zip(grads, self.params)]
        params = [p.detach() for p in self.params]
        updates, self.state = self.tx.update(grads, self.state, params)
        if updates is not None:
            torch._foreach_add_(params, updates)
        self.count += 1

    @property
    def updates(self) -> int:
        """How many updates moved the parameters (``count`` counts calls)."""
        return self.state["gradient_step"] if isinstance(self.tx, MultiSteps) else self.count

    def state_dict(self) -> Dict:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore in place (tensors copied onto the current ones' devices)."""

        def copy(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
                return dst
            if isinstance(dst, list):
                return [copy(d, s) for d, s in zip(dst, src)]
            if isinstance(dst, dict):
                return {k: copy(dst[k], src[k]) for k in dst}
            return src

        with torch.no_grad():
            self.state = copy(self.state, sd["state"])
        self.count = int(sd["count"])


def gan_optimizer(params, lr: float, weight_decay: float) -> Optimizer:
    """``add_decayed_weights(wd) -> scale_by_adam -> lr``: the chain of the
    three GAN optimizers of MBTRAIN."""
    return Optimizer(params, Chain(AddDecayedWeights(weight_decay), ScaleByAdam(),
                                   ScaleByLearningRate(lr)))


def build_optimizer(
    optim_cfg,
    params: Sequence[torch.Tensor],
    updates_per_epoch: int = 1,
    learning_rate: Union[float, Callable[[int], float], None] = None,
    decay_mask: Optional[Sequence[bool]] = None,
    grad_accum: int = 1,
) -> Optimizer:
    """The optimizer ``OPTIM.NAME`` over ``params`` with the epoch schedule
    (or ``learning_rate``, a constant or a count -> lr function), coupled L2
    restricted to ``decay_mask`` where the JAX builder applies it, and, for
    ``grad_accum`` > 1, one update per ``grad_accum`` calls
    (:class:`MultiSteps`; ``updates_per_epoch`` then counts updates, not
    batches)."""
    name = optim_cfg.NAME
    wd = float(optim_cfg.WEIGHT_DECAY)
    b1, b2 = float(optim_cfg.ADAM_BETA1), float(optim_cfg.ADAM_BETA2)
    momentum = float(optim_cfg.MOMENTUM)
    if learning_rate is None:
        lr = build_lr_schedule(optim_cfg, updates_per_epoch)
    elif callable(learning_rate):
        lr = learning_rate
    else:
        lr = lambda _count, v=float(learning_rate): v  # noqa: E731

    def decay():
        return [AddDecayedWeights(wd, decay_mask)] if wd else []

    if name == "adam":
        steps = [*decay(), ScaleByAdam(b1, b2, 1e-8)]
    elif name == "amsgrad":
        steps = [*decay(), ScaleByAmsgrad(b1, b2, 1e-8)]
    elif name == "adamw":
        steps = [ScaleByAdam(b1, b2, 1e-8), AddDecayedWeights(wd)]
    elif name == "radam":
        # the reference RAdam decays DECOUPLED, after the rectified step
        steps = [ScaleByRadam(b1, b2, 1e-8), *decay()]
    elif name == "sgd":
        steps = [*decay()] + ([Trace(momentum, bool(optim_cfg.SGD_NESTEROV))] if momentum else [])
    elif name == "rmsprop":
        steps = [*decay(), ScaleByRms(float(optim_cfg.RMSPROP_ALPHA), 1e-8)]
        steps += [Trace(momentum)] if momentum else []
    else:
        raise ValueError(f"Unknown optimizer: {name}")
    tx = Chain(*steps, ScaleByLearningRate(lr))
    return Optimizer(params, MultiSteps(tx, grad_accum) if grad_accum > 1 else tx)
