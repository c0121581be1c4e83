"""The paper's five-fold protocol on the port — the counterpart of
``scripts/run_method.sh`` and its per-method wrappers
(``scripts/{Task}/{method}.sh``):

    python -m imp_torch.tools.run_method <Task> <Method> <Trainer> <DATA_ROOT> \\
        [--seeds 1 2 3 4 5] [--device cuda|cpu] [KEY VALUE ...]

Each seed (= fold) trains through :func:`imp_torch.tools.train.run` in this
process, with ``configs/<Task>/<Method>.yaml`` into
``output/<Task>/<Method>/seed<N>`` (``--output-root`` moves ``output``); a
seed whose directory exists resumes from its last checkpoint, as the
shell script's runs do (a finished run trains no epoch and tests again).
Every argument the runner does not know (``KEY VALUE`` pairs, or flags of
the train CLI such as ``--eval-only``) goes to each seed's run, as the
script's ``"$@"`` does.  The runner ends with
``imp_torch.tools.parse_test_res`` over the seeds' logs: ``cindex``, and
``accuracy`` where no log has a C-index.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Dict, List, Optional, Sequence

from . import parse_test_res
from .train import run as train_run

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
CONFIGS = osp.join(REPO, "configs")
DEFAULT_SEEDS = (1, 2, 3, 4, 5)
KEYWORDS = ("cindex", "accuracy")  # run_method.sh's order


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("task", help="Survival, Classification, Grading or Subtyping")
    ap.add_argument("method", help="the config's name, e.g. UMEML_GAN")
    ap.add_argument("trainer", help="the trainer, e.g. MBTRAIN")
    ap.add_argument("root", help="the data root")
    ap.add_argument("--seeds", nargs="+", default=[str(s) for s in DEFAULT_SEEDS],
                    help="seeds (= folds) to run, in order")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every run (default cuda; 'cpu' only when asked)")
    ap.add_argument("--output-root", default="output",
                    help="the tree's root: <root>/<Task>/<Method>/seed<N>")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None):
    """(args, the arguments passed on to every seed's run).  ``--seeds``
    takes the integers that follow it; what comes after them is passed on."""
    args, rest = build_parser().parse_known_args(argv)
    args.seeds, passed_on = take_seeds(args.seeds)
    return args, passed_on + rest


def take_seeds(tokens: Sequence[str]):
    """(the leading integers of ``tokens``, the rest): ``--seeds`` takes
    the tokens after it, and a ``KEY VALUE`` pair may follow the seeds."""
    n = 0
    while n < len(tokens) and tokens[n].isdigit():
        n += 1
    if n == 0:
        raise SystemExit("--seeds needs at least one integer")
    return [int(s) for s in tokens[:n]], list(tokens[n:])


def method_dir(args) -> str:
    return osp.join(args.output_root, args.task, args.method)


def seed_argv(args, seed: int, extra: Sequence[str]) -> List[str]:
    """The train CLI's arguments of one seed."""
    return ["--root", args.root, "--seed", str(seed), "--trainer", args.trainer,
            "--config-file", osp.join(CONFIGS, args.task, f"{args.method}.yaml"),
            "--output-dir", osp.join(method_dir(args), f"seed{seed}"),
            "--device", args.device, *extra]


def summary(directory: str):
    """(keyword, {metric: (mean, sd)}, per-seed values) of the first of
    :data:`KEYWORDS` that the logs under ``directory`` report, printed by
    ``parse_test_res``; None where none does."""
    keyword, outputs = parse_test_res.first_reported(directory, KEYWORDS)
    if keyword is None:
        return None
    parse_test_res.parse_function(parse_test_res.metric_regex(keyword), directory=directory,
                                  end_signal="Finish training")
    return keyword, parse_test_res.summarize(outputs), [o[keyword] for o in outputs]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run every seed, then parse; returns {"results": {seed: metric the
    run returned}, "keyword", "summary", "parsed"} (the last three from
    the logs, None where no log has a metric line)."""
    args, extra = parse_args(argv)
    results = {}
    for seed in args.seeds:
        out = osp.join(method_dir(args), f"seed{seed}")
        if osp.isdir(out):
            print(f"Results exist in {out} (resuming)", flush=True)
        results[seed] = train_run(seed_argv(args, seed, extra))
    parsed = summary(method_dir(args)) if osp.isdir(method_dir(args)) else None
    keyword, stats, values = parsed if parsed else (None, None, None)
    return {"results": results, "keyword": keyword, "summary": stats, "parsed": values}


if __name__ == "__main__":
    sys.exit(0 if main()["summary"] else 1)
