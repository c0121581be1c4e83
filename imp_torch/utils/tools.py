"""Misc utilities: seeding, file checks, env info — the counterpart of
``imp_tpu/utils/tools.py`` (reference ``medmm/utils/tools.py``)."""

from __future__ import annotations

import os
import platform
import random
import warnings
from typing import Any, Iterable

import numpy as np


def set_random_seed(seed: int) -> "np.random.Generator":
    """Seed python/numpy and return a numpy Generator for the host pipeline.
    Torch-side randomness comes from explicit ``torch.Generator``s that the
    trainer seeds from the same value."""
    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed)


def check_isfile(fpath: str) -> bool:
    isfile = os.path.isfile(fpath)
    if not isfile:
        warnings.warn(f'No file found at "{fpath}"')
    return isfile


def verify_str_arg(value: Any, arg: str, valid_values: Iterable[Any]) -> str:
    valid = [str(v) for v in valid_values]
    if str(value) not in valid:
        raise ValueError(f"Invalid {arg}: {value!r}. Valid values are {valid}.")
    return str(value)


def collect_env_info() -> str:
    import torch

    lines = [
        f"python: {platform.python_version()}",
        f"torch: {torch.__version__} (cuda {torch.version.cuda})",
        f"cuda available: {torch.cuda.is_available()}",
    ]
    if torch.cuda.is_available():
        lines += [f"device: {torch.cuda.get_device_name(0)}",
                  f"device count: {torch.cuda.device_count()}"]
    return "\n".join(lines)


def count_num_param(module) -> int:
    """Total number of scalars in a module's parameters."""
    return sum(p.numel() for p in module.parameters())
