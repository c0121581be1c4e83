from .accuracy import compute_accuracy, compute_distance_matrix
from .evaluators import (
    EVALUATOR_REGISTRY,
    Classification,
    Classification_UMEML,
    Survival_UMEML,
    auc_com,
    build_evaluator,
)
from .survival_metrics import (
    NoComparablePairError,
    censoring_survival_function,
    concordance_index_censored,
    concordance_index_ipcw,
)

__all__ = [
    "EVALUATOR_REGISTRY",
    "Classification",
    "Classification_UMEML",
    "Survival_UMEML",
    "auc_com",
    "build_evaluator",
    "compute_accuracy",
    "compute_distance_matrix",
    "NoComparablePairError",
    "censoring_survival_function",
    "concordance_index_censored",
    "concordance_index_ipcw",
]
