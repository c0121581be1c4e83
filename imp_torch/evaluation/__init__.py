from .evaluators import EVALUATOR_REGISTRY, Survival_UMEML, build_evaluator
from .survival_metrics import (
    NoComparablePairError,
    censoring_survival_function,
    concordance_index_censored,
    concordance_index_ipcw,
)

__all__ = [
    "EVALUATOR_REGISTRY",
    "Survival_UMEML",
    "build_evaluator",
    "NoComparablePairError",
    "censoring_survival_function",
    "concordance_index_censored",
    "concordance_index_ipcw",
]
