"""Logging: stdout tee to OUTPUT_DIR/log.txt + scalar metric writer — the
counterpart of ``imp_tpu/utils/logger.py`` (reference
``medmm/utils/logger.py:11-96``; ``tools/parse_test_res.py`` scrapes the
``log.txt`` tee).  Scalars always go to ``scalars.jsonl``; TensorBoard is
used besides when it imports.  The port runs one process, so every writer
is the primary one.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
import time
from typing import Optional


def mkdir_if_missing(path: str) -> None:
    if path:
        os.makedirs(path, exist_ok=True)


class Logger:
    """Tee stdout to a file (results are scraped from this file)."""

    def __init__(self, fpath: Optional[str] = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(osp.dirname(fpath))
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def write(self, msg: str) -> None:
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self) -> None:
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self) -> None:
        self.console.flush()
        if self.file is not None:
            self.file.close()
            self.file = None


def setup_logger(output_dir: Optional[str] = None) -> Optional[Logger]:
    """Tee stdout to ``output_dir/log.txt`` (a timestamped name when one
    exists); returns the tee so a caller can restore ``sys.stdout``."""
    if output_dir is None:
        return None
    fpath = osp.join(output_dir, "log.txt")
    if osp.exists(fpath):
        fpath = fpath + time.strftime("-%Y-%m-%d-%H-%M-%S")
    logger = Logger(fpath)
    sys.stdout = logger
    return logger


class MetricWriter:
    """Scalar writer: JSONL always; TensorBoard when importable."""

    def __init__(self, log_dir: str):
        mkdir_if_missing(log_dir)
        self._jsonl = open(osp.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # optional
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._tb = None

    def write_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        if self._jsonl.closed:  # writes after close (e.g. post-training test)
            return
        rec = {"tag": tag, "value": float(value), "step": step, "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
