"""Aggregate per-seed results scraped from the ``log.txt`` files that
``imp_torch.utils.logger`` writes — the port's copy of
``tools/parse_test_res.py`` (reference ``tools/parse_test_res.py:64-157``),
with the same CLI and the same lines:

    python -m imp_torch.tools.parse_test_res output/Survival/UMEML_GAN --keyword cindex
    python -m imp_torch.tools.parse_test_res output/ --multi-exp --ci95

Each sub-directory of ``directory`` that holds a ``log.txt`` is one seed;
its last ``* <keyword>: X%`` line after the end signal (``Finish
training``) is its result.  :func:`parse_function` prints the per-seed
lines and the ``* key: avg% +- std%`` summary; :func:`collect` returns the
same numbers for a caller.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def listdir_nohidden(path: str, sort: bool = False) -> List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    return sorted(items) if sort else items


def compute_ci95(res) -> float:
    return 1.96 * np.std(res) / np.sqrt(len(res))


def metric_regex(keyword: str) -> dict:
    """The metric spec of ``keyword``: its name and the line it reads."""
    return {"name": keyword, "regex": re.compile(rf"\* {keyword}: ([\.\deE+-]+)%")}


def collect(*metrics, directory: str = "", end_signal: Optional[str] = None) -> List[OrderedDict]:
    """One ordered dict per seed directory with a result: ``file`` and, for
    each metric, its last value after ``end_signal`` (every line counts
    when it is None)."""
    outputs = []
    for subdir in listdir_nohidden(directory, sort=True):
        fpath = osp.join(directory, subdir, "log.txt")
        if not osp.isfile(fpath):
            continue
        good_to_go = end_signal is None
        output = OrderedDict()
        with open(fpath, "r") as f:
            for line in f:
                line = line.strip()
                if end_signal and line == end_signal:
                    good_to_go = True
                for metric in metrics:
                    match = metric["regex"].search(line)
                    if match and good_to_go:
                        output.setdefault("file", fpath)
                        output[metric["name"]] = float(match.group(1))
        if output:
            outputs.append(output)
    return outputs


def first_reported(directory: str, keywords: Sequence[str] = ("cindex", "accuracy"),
                   end_signal: Optional[str] = "Finish training"):
    """(keyword, :func:`collect`'s outputs) of the first of ``keywords``
    that the logs under ``directory`` report; (None, []) where none does."""
    for keyword in keywords:
        outputs = collect(metric_regex(keyword), directory=directory, end_signal=end_signal)
        if outputs:
            return keyword, outputs
    return None, []


def summarize(outputs: List[OrderedDict], ci95: bool = False) -> Dict[str, Tuple[float, float]]:
    """{metric: (mean, sd)} over the seeds (sd: the 95 % interval's half
    width with ``ci95``); numpy's population sd, as the JAX tool prints."""
    values = defaultdict(list)
    for output in outputs:
        for key, value in output.items():
            if key != "file":
                values[key].append(value)
    return OrderedDict((k, (float(np.mean(v)), float(compute_ci95(v) if ci95 else np.std(v))))
                       for k, v in values.items())


def parse_function(*metrics, directory: str = "", ci95: bool = False,
                   end_signal: Optional[str] = None) -> "OrderedDict[str, float]":
    """Print each seed's values and the summary; returns {metric: mean}."""
    print(f"Parsing files in {directory}")
    outputs = collect(*metrics, directory=directory, end_signal=end_signal)
    assert len(outputs) > 0, f"Nothing found in {directory}"

    for output in outputs:
        msg = ""
        for key, value in output.items():
            if isinstance(value, float):
                msg += f"{key}: {value:.2f}%. "
            else:
                msg += f"{key}: {value}. "
        print(msg)

    output_results = OrderedDict()
    print("===")
    print(f"Summary of directory: {directory}")
    for key, (avg, std) in summarize(outputs, ci95).items():
        print(f"* {key}: {avg:.2f}% +- {std:.2f}%")
        output_results[key] = avg
    print("===")
    return output_results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory", type=str)
    ap.add_argument("--ci95", action="store_true")
    ap.add_argument("--multi-exp", action="store_true")
    ap.add_argument("--keyword", default="accuracy", type=str)
    ap.add_argument("--end-signal", default="Finish training", type=str)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    metric = metric_regex(args.keyword)
    if args.multi_exp:
        final_results = defaultdict(list)
        for directory in listdir_nohidden(args.directory, sort=True):
            results = parse_function(
                metric, directory=osp.join(args.directory, directory),
                ci95=args.ci95, end_signal=args.end_signal,
            )
            for key, value in results.items():
                final_results[key].append(value)
        print("Average performance")
        for key, values in final_results.items():
            print(f"* {key}: {np.mean(values):.2f}%")
    else:
        parse_function(metric, directory=args.directory, ci95=args.ci95,
                       end_signal=args.end_signal)


if __name__ == "__main__":
    main()
