"""Evaluators — the counterparts of ``imp_tpu/evaluation/evaluators.py``
(reference ``medmm/evaluation/evaluator.py``): ``Classification`` and
``Classification_UMEML`` (accuracy, error, mean one-vs-rest AUC, macro-F1),
``Survival`` and ``Survival_UMEML`` (C-index), with the same ``* metric:
X%`` stdout lines that ``tools/parse_test_res.py`` scrapes.

The JAX package computes the classification metrics with scikit-learn; the
port computes the same numbers with numpy and scipy (the card's host has no
scikit-learn): the ROC-AUC by the rank statistic, F1 as 2·tp / (true +
predicted), the confusion matrix normalised per true label.
"""

from __future__ import annotations

import os.path as osp
from collections import OrderedDict, defaultdict
from typing import Dict, Sequence

import numpy as np
from scipy.stats import rankdata

from ..utils.registry import Registry
from .survival_metrics import concordance_index_censored, concordance_index_ipcw

EVALUATOR_REGISTRY = Registry("EVALUATOR")


def binary_roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """ROC-AUC of ``score`` for the binary ``y_true`` by the rank statistic
    (Mann-Whitney U with average ranks for ties), the area scikit-learn's
    ``roc_auc_score`` gives; ``nan`` when ``y_true`` holds one class only."""
    pos = np.asarray(y_true, bool)
    n_pos = int(pos.sum())
    n_neg = pos.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(score, np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def auc_com(y_true, y_pred, num_cls) -> float:
    """One-vs-rest mean AUC in percent (reference ``evaluator.py:26-40``);
    a class with no positive or no negative example gives ``nan``, and so
    does the mean."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    scores = [binary_roc_auc(y_true == c, y_pred[:, c]) for c in range(num_cls)]
    return float(sum(scores) / len(scores) * 100)


def per_class_prf(y_true, y_pred, labels: Sequence[int], zero_division: float = 0.0) -> Dict:
    """Precision, recall, F1 and support of each of ``labels`` (arrays in
    that order), as scikit-learn's ``precision_recall_fscore_support``
    computes them: a ratio with a zero denominator is ``zero_division``."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.asarray(labels)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.float64)
    true_sum = np.array([np.sum(y_true == c) for c in labels], np.float64)
    pred_sum = np.array([np.sum(y_pred == c) for c in labels], np.float64)

    def divide(num, den):
        out = num / np.where(den == 0, 1.0, den)
        out[den == 0] = zero_division
        return out

    return {"precision": divide(tp, pred_sum), "recall": divide(tp, true_sum),
            "f1": divide(2.0 * tp, true_sum + pred_sum), "support": true_sum.astype(np.int64)}


def classification_table(y_true, y_pred, labels: Sequence[int]) -> str:
    """The per-class report (``zero_division=1``): precision, recall, F1 and
    support per label, then the macro and support-weighted averages."""
    prf = per_class_prf(y_true, y_pred, labels, zero_division=1.0)
    support = prf["support"]
    lines = [f"{'':>12} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
    for i, label in enumerate(labels):
        lines.append(f"{label!s:>12} {prf['precision'][i]:9.2f} {prf['recall'][i]:9.2f} "
                     f"{prf['f1'][i]:9.2f} {support[i]:9d}")
    for name, w in (("macro avg", None), ("weighted avg", support)):
        avg = [np.average(prf[k], weights=w) for k in ("precision", "recall", "f1")]
        lines.append(f"{name:>12} {avg[0]:9.2f} {avg[1]:9.2f} {avg[2]:9.2f} {support.sum():9d}")
    return "\n".join(lines) + "\n"


def normalized_confusion_matrix(y_true, y_pred) -> np.ndarray:
    """Rows = true labels, columns = predictions, over the sorted union of
    both, each row divided by its count (an empty row stays 0): scikit-learn's
    ``confusion_matrix(normalize="true")``."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    index = {c: i for i, c in enumerate(labels.tolist())}
    cm = np.zeros((labels.size, labels.size), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        cm[index[t], index[p]] += 1
    with np.errstate(all="ignore"):
        cm = cm / cm.sum(axis=1, keepdims=True)
    return np.nan_to_num(cm)


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
class Classification(EvaluatorBase):
    """Accuracy / error / mean one-vs-rest AUC / macro-F1
    (reference ``evaluator.py:57-171``); ``process`` takes the logits and
    the labels of a batch."""

    def __init__(self, cfg, lab2cname=None, **kwargs):
        super().__init__(cfg)
        self._lab2cname = lab2cname
        self._per_class_res = None
        if cfg.TEST.PER_CLASS_RESULT:
            if lab2cname is None:
                raise ValueError("TEST.PER_CLASS_RESULT needs the class names (lab2cname)")
            self._per_class_res = defaultdict(list)
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []
        self._m_out = []
        if self._per_class_res is not None:
            self._per_class_res = defaultdict(list)

    def process(self, mo, gt):
        mo = np.asarray(mo)
        gt = np.asarray(gt)
        pred = mo.argmax(axis=1)
        matches = (pred == gt).astype(np.float64)
        self._correct += int(matches.sum())
        self._total += int(gt.shape[0])
        self._m_out.append(mo)
        self._y_true.extend(gt.tolist())
        self._y_pred.extend(pred.tolist())
        if self._per_class_res is not None:
            for i, label in enumerate(gt.tolist()):
                self._per_class_res[label].append(int(matches[i]))

    def evaluate(self):
        results = OrderedDict()
        acc = 100.0 * self._correct / self._total
        err = 100.0 - acc
        labels = np.unique(self._y_true)
        macro_f1 = 100.0 * float(np.mean(per_class_prf(self._y_true, self._y_pred, labels)["f1"]))
        auc_score = auc_com(self._y_true, np.concatenate(self._m_out, axis=0), int(labels.max() + 1))

        results["accuracy"] = acc
        results["error_rate"] = err
        results["AUC"] = auc_score
        results["macro_f1"] = macro_f1

        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* correct: {self._correct:,}\n"
            f"* accuracy: {acc:.1f}%\n"
            f"* error: {err:.1f}%\n"
            f"* AUC: {auc_score:.1f}%\n"
            f"* macro_f1: {macro_f1:.1f}%\n"
        )
        print(classification_table(self._y_true, self._y_pred, labels))

        if self._per_class_res is not None:
            print("=> per-class result")
            accs = []
            for label in sorted(self._per_class_res.keys()):
                res = self._per_class_res[label]
                correct, total = sum(res), len(res)
                acc_c = 100.0 * correct / total
                accs.append(acc_c)
                print(
                    f"* class: {label} ({self._lab2cname[label]})\t"
                    f"total: {total:,}\tcorrect: {correct:,}\tacc: {acc_c:.1f}%"
                )
            mean_acc = float(np.mean(accs))
            print(f"* average: {mean_acc:.1f}%")
            results["perclass_accuracy"] = mean_acc

        if self.cfg.TEST.COMPUTE_CMAT:
            save_path = osp.join(self.cfg.OUTPUT_DIR, "cmat.npy")
            np.save(save_path, normalized_confusion_matrix(self._y_true, self._y_pred))
            print(f"Confusion matrix is saved to {save_path}")

        return results


@EVALUATOR_REGISTRY.register()
class Classification_UMEML(Classification):
    """The same metrics under the name the UMEML configs use (reference
    ``evaluator.py:174-291`` differs only in how it stacks batched outputs,
    which :meth:`Classification.process` already handles)."""


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
    return EVALUATOR_REGISTRY.get(cfg.TEST.EVALUATOR)(cfg, **kwargs)
