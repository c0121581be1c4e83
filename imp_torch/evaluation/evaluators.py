"""The survival evaluators — the counterparts of
``imp_tpu/evaluation/evaluators.py::{Survival, Survival_UMEML}`` (reference
``medmm/evaluation/evaluator.py:293-428``), with the same ``* C-Index:`` /
``* cindex:`` stdout lines that ``tools/parse_test_res.py`` scrapes.  The
scikit-learn classification metrics come with the slice that uses them."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..utils.registry import Registry
from .survival_metrics import concordance_index_censored, concordance_index_ipcw

EVALUATOR_REGISTRY = Registry("EVALUATOR")


class EvaluatorBase:
    def __init__(self, cfg):
        self.cfg = cfg

    def reset(self):
        raise NotImplementedError

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError


@EVALUATOR_REGISTRY.register()
class Survival(EvaluatorBase):
    """C-index over risk = -sum(S) (reference ``evaluator.py:293-341``);
    the trainer passes the survival curve S."""

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg)
        self.reset()

    def reset(self):
        self._total = 0
        self._all_risk_scores = []
        self._all_censorships = []
        self._all_event_times = []

    def process(self, S, censorship, survival_month):
        censorship = np.asarray(censorship)
        self._total += int(censorship.shape[0])
        self._all_risk_scores.extend((-np.asarray(S).sum(axis=1)).tolist())
        self._all_censorships.extend(censorship.tolist())
        self._all_event_times.extend(np.asarray(survival_month).tolist())

    def evaluate(self):
        results = OrderedDict()
        c_index = 100.0 * concordance_index_censored(
            (1 - np.array(self._all_censorships)).astype(bool),
            np.array(self._all_event_times),
            np.array(self._all_risk_scores),
            tied_tol=1e-08,
        )[0]
        results["c_index"] = c_index
        print("=> result\n" f"* total: {self._total:,}\n" f"* C-Index: {c_index:.1f}%\n")
        return results


@EVALUATOR_REGISTRY.register()
class Survival_UMEML(EvaluatorBase):
    """logits -> hazards -> S -> risk; NaN filtering; C-index + IPCW C-index
    against the pooled train+val censoring baseline
    (reference ``evaluator.py:343-428``)."""

    def __init__(self, cfg, all_survival=None, bins=None, **kwargs):
        super().__init__(cfg)
        self.all_survival = all_survival  # (event_bool, time) tuple
        self.bins = bins
        self.reset()

    def reset(self):
        self._total = 0
        self._all_risk_scores = []
        self._all_censorships = []
        self._all_event_times = []
        self._all_patient_ids = []
        self.all_risk_by_bin_scores = []

    def process(self, patient_id, logits, censorship, survival_month):
        logits = np.asarray(logits, dtype=np.float64)
        censorship = np.asarray(censorship)
        survival_month = np.asarray(survival_month)
        self._total += int(censorship.shape[0])
        hazards = 1.0 / (1.0 + np.exp(-logits))
        S = np.cumprod(1.0 - hazards, axis=1)
        self._all_risk_scores.extend((-S.sum(axis=1)).tolist())
        self._all_patient_ids.extend(list(patient_id))
        self._all_censorships.extend(censorship.tolist())
        self._all_event_times.extend(survival_month.tolist())
        self.all_risk_by_bin_scores.extend(S.tolist())

    def evaluate(self):
        results = OrderedDict()
        risk = np.array(self._all_risk_scores, dtype=np.float64)
        cens = np.array(self._all_censorships, dtype=np.float64)
        times = np.array(self._all_event_times, dtype=np.float64)
        keep = ~np.isnan(risk)
        risk, cens, times = risk[keep], cens[keep], times[keep]

        c_index = concordance_index_censored(
            (1 - cens).astype(bool), times, risk, tied_tol=1e-08
        )[0]
        try:
            c_index_ipcw = concordance_index_ipcw(
                self.all_survival, ((1 - cens).astype(bool), times), estimate=risk
            )[0]
        except Exception:
            print("An error occured while computing c-index ipcw")
            c_index_ipcw = 0.0

        c_index, c_index_ipcw = 100.0 * c_index, 100.0 * c_index_ipcw
        results["c_index"] = c_index
        results["c_index_ipcw"] = c_index_ipcw
        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* cindex: {c_index:.2f}%\n"
            f"* cindex_ipcw: {c_index_ipcw:.2f}%\n"
        )
        return results


def build_evaluator(cfg, **kwargs):
    name = cfg.TEST.EVALUATOR
    if name not in EVALUATOR_REGISTRY:
        raise NotImplementedError(
            f"TEST.EVALUATOR={name!r}: the port has {sorted(EVALUATOR_REGISTRY.registered_names())}"
            " (the others come with the slices that use them, ROADMAP.md §A)"
        )
    return EVALUATOR_REGISTRY.get(name)(cfg, **kwargs)
