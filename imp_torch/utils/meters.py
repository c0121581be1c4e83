"""Running-average meters — a copy of ``imp_tpu/utils/meters.py`` (reference
``medmm/utils/meters.py:7-80``)."""

from __future__ import annotations

from collections import defaultdict


class AverageMeter:
    def __init__(self, ema: bool = False):
        self.ema = ema
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        if self.ema:
            self.avg = self.avg * 0.9 + self.val * 0.1
        else:
            self.avg = self.sum / self.count


class MetricMeter:
    """Meter over a dict of metrics (e.g. per-iteration loss summaries)."""

    def __init__(self, delimiter: str = " "):
        self.meters = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, input_dict) -> None:
        if input_dict is None:
            return
        if not isinstance(input_dict, dict):
            raise TypeError("MetricMeter.update expects a dict")
        for k, v in input_dict.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        out = []
        for name, meter in self.meters.items():
            out.append(f"{name} {meter.val:.4f} ({meter.avg:.4f})")
        return self.delimiter.join(out)
