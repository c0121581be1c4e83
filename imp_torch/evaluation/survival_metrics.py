"""Survival metrics: Harrell's C-index and Uno's IPCW C-index — a copy of
``imp_tpu/evaluation/survival_metrics.py``.

scikit-survival is not available in this image, so these re-implement the
exact algorithms the reference relies on
(``sksurv.metrics.concordance_index_censored`` and
``concordance_index_ipcw``, used by reference
``medmm/evaluation/evaluator.py:324,393-415``), vectorized in numpy:

* comparable pairs (i, j): i had an event and (t_i < t_j, or t_i == t_j and
  j is censored);
* concordant when estimate_i > estimate_j (higher risk for the earlier
  event), ties in the estimate within ``tied_tol`` count 0.5;
* IPCW weights are 1/G(t_i)^2 with G the Kaplan-Meier estimator of the
  *censoring* distribution fit on the training cohort (events removed from
  the at-risk set before censorings at the same time — the ``reverse=True``
  convention).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class NoComparablePairError(ValueError):
    pass


#: above this cohort size the O(n^2) boolean matrices of the numpy path get
#: heavy; the C kernel (imp_torch/native/cindex.c) runs with O(1) memory
_NATIVE_THRESHOLD = 2048


def _weighted_concordance(
    event: np.ndarray,
    time: np.ndarray,
    estimate: np.ndarray,
    weights: np.ndarray,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    event = np.asarray(event, dtype=bool)
    time = np.asarray(time, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)

    if len(time) >= _NATIVE_THRESHOLD:
        from ..native import native_weighted_concordance

        result = native_weighted_concordance(event, time, estimate, weights, tied_tol)
        if result is not None:
            return result

    lt = time[:, None] < time[None, :]
    eq = time[:, None] == time[None, :]
    comparable = event[:, None] & (lt | (eq & ~event[None, :]))

    est_diff = estimate[:, None] - estimate[None, :]
    ties = np.abs(est_diff) <= tied_tol
    con = est_diff > 0  # estimate_i > estimate_j

    tied_pairs = comparable & ties
    con_pairs = comparable & con & ~ties

    denominator = float((weights[:, None] * comparable).sum())
    if denominator == 0.0:
        raise NoComparablePairError("Data has no comparable pairs.")
    numerator = float(
        (weights[:, None] * (con_pairs + 0.5 * tied_pairs)).sum()
    )

    concordant = int(con_pairs.sum())
    tied_risk = int(tied_pairs.sum())
    discordant = int(comparable.sum()) - concordant - tied_risk
    tied_time = int((comparable & eq).sum())
    return numerator / denominator, concordant, discordant, tied_risk, tied_time


def concordance_index_censored(
    event_indicator: np.ndarray,
    event_time: np.ndarray,
    estimate: np.ndarray,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    """Harrell's concordance index for right-censored data."""
    weights = np.ones(len(np.asarray(event_time)))
    return _weighted_concordance(event_indicator, event_time, estimate, weights, tied_tol)


def censoring_survival_function(
    event: np.ndarray, time: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Kaplan-Meier estimate G(t) of the censoring distribution
    (events leave the at-risk set before same-time censorings)."""
    event = np.asarray(event, dtype=bool)
    time = np.asarray(time, dtype=np.float64)
    uniq = np.unique(time)
    at_time = time[None, :] == uniq[:, None]
    n_at_risk = (time[None, :] >= uniq[:, None]).sum(axis=1)
    n_events = (at_time & event[None, :]).sum(axis=1)
    n_cens = (at_time & ~event[None, :]).sum(axis=1)
    at_risk = n_at_risk - n_events
    ratio = np.divide(
        n_cens, at_risk, out=np.zeros_like(uniq, dtype=np.float64), where=at_risk > 0
    )
    prob = np.cumprod(1.0 - ratio)
    return uniq, prob


def _step_lookup(uniq: np.ndarray, prob: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Right-continuous step-function lookup with G(-inf)=1."""
    ut = np.r_[-np.inf, uniq]
    pr = np.r_[1.0, prob]
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    if pr[-1] > 0 and np.any(t > ut[-1]):
        raise ValueError(
            "time must be smaller than largest observed time point"
        )
    idx = np.clip(np.searchsorted(ut, t, side="right") - 1, 0, len(pr) - 1)
    return pr[idx]


def concordance_index_ipcw(
    survival_train: Tuple[np.ndarray, np.ndarray],
    survival_test: Tuple[np.ndarray, np.ndarray],
    estimate: np.ndarray,
    tau: Optional[float] = None,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    """Uno's IPCW concordance index.

    ``survival_train`` / ``survival_test`` are (event_bool, time) tuples (the
    role Surv.from_arrays plays in the reference, ``engine/trainer.py:393``).
    """
    train_event, train_time = survival_train
    test_event, test_time = survival_test
    test_event = np.asarray(test_event, dtype=bool)
    test_time = np.asarray(test_time, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)

    if tau is not None:
        mask = test_time < tau
        test_event = test_event[mask]
        test_time = test_time[mask]
        estimate = estimate[mask]

    uniq, prob = censoring_survival_function(
        np.asarray(train_event, dtype=bool), np.asarray(train_time)
    )
    weights = np.zeros(len(test_time))
    if test_event.any():
        G = _step_lookup(uniq, prob, test_time[test_event])
        if np.any(G == 0):
            raise ValueError("censoring survival function is zero at one or more time points")
        weights[test_event] = (1.0 / G) ** 2
    return _weighted_concordance(test_event, test_time, estimate, weights, tied_tol)
