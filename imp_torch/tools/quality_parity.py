"""Five-fold quality study: the port's MBTRAIN against ``imp_tpu``'s, fold by
fold, on one synthetic root (ROADMAP A3) — the port's counterpart of
``tools/quality_parity.py``.  It imports neither JAX nor ``imp_tpu``: it
compares two five-fold trees that the two protocols write with the same
root, seeds, config and options.

    # the port's side (and the command of the other side, printed)
    python -m imp_torch.tools.quality_parity --run --task Survival --device cpu
    # the JAX side, on a host with JAX, from the repository's root
    bash scripts/run_method.sh Survival UMEML_GAN MBTRAIN <root> [--platform cpu] <options>
    # the table
    python -m imp_torch.tools.quality_parity --compare output/Survival/UMEML_GAN \\
        <work>/torch/Survival/UMEML_GAN

``--run`` materialises the root with ``imp_torch.data.synthetic`` (it draws
the same tree as ``imp_tpu.data.synthetic``), runs the folds through
``imp_torch.tools.run_method`` into ``<work>/torch/<Task>/UMEML_GAN``, and
prints the unmodified JAX protocol's command for the same folds.  The
defaults are the JAX tool's small widths (hidden 64, 48 slides, bags of
16-48 patches, 32 features, 120 genes in groups of 15) with the GAN
curriculum on: 8 epochs, the GAN phase from epoch 3, the replacement ramp
from epoch 5 and a CCA epoch after every epoch but the last.

``--compare JAX_DIR TORCH_DIR`` reads each side's ``seed<N>/log.txt`` with
``imp_torch.tools.parse_test_res`` (``cindex`` for Survival, ``accuracy``
for the classification tasks) and prints one row per fold (imp_tpu,
imp_torch, delta), each side's mean ± sd (numpy's population sd, as
``parse_test_res`` prints it) and the mean |delta|, then Welch's t and its
p (``scipy.stats.ttest_ind(equal_var=False)``) with the verdict at
α = 0.05 in words.
"""

from __future__ import annotations

import argparse
import os.path as osp
import shlex
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import parse_test_res
from .run_method import main as run_method

METHOD, TRAINER = "UMEML_GAN", "MBTRAIN"
TASKS = ("Survival", "Grading")
ALPHA = 0.05


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run", action="store_true",
                      help="materialise the root, run the port's folds, print the JAX command")
    mode.add_argument("--compare", nargs=2, metavar=("JAX_DIR", "TORCH_DIR"),
                      help="the per-fold table of two five-fold trees")
    ap.add_argument("--task", default="Survival", choices=TASKS)
    ap.add_argument("--root", default="qp_data", help="the synthetic root")
    ap.add_argument("--work", default="qp_work",
                    help="the port's tree goes to <work>/torch/<Task>/UMEML_GAN")
    ap.add_argument("--device", default="cuda", help="the port's device (cpu only when asked)")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slides", type=int, default=48)
    ap.add_argument("--bag-min", type=int, default=16)
    ap.add_argument("--bag-max", type=int, default=48)
    ap.add_argument("--bag-pad", type=int, default=64)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--group-size", type=int, default=15)
    ap.add_argument("--gan-start", type=int, default=3, help="GAN phase from this epoch")
    ap.add_argument("--replace-start", type=int, default=5,
                    help="replacement ramp from this epoch")
    ap.add_argument("--no-cca", action="store_true", help="no CCA epoch between epochs")
    return ap


def options(args) -> List[str]:
    """The ``KEY VALUE`` options both protocols get."""
    opts = {
        "DATASET.BAG_PAD": args.bag_pad, "DATASET.PATH.DIM": args.feat_dim,
        "MODEL.HIDDEN_DIM": args.hidden, "MODEL.PROJECT_DIM": args.hidden,
        "DATALOADER.TRAIN.BATCH_SIZE": args.batch, "DATALOADER.TEST.BATCH_SIZE": args.batch,
        "OPTIM.MAX_EPOCH": args.epochs,
        "TRAIN.CURRICULUM.GAN_START_EPOCH": args.gan_start,
        "TRAIN.CURRICULUM.REPLACE_START_EPOCH": args.replace_start,
        "TRAIN.CURRICULUM.CCA_EVERY_EPOCH": not args.no_cca,
        "TPU.PREFETCH": 0,
    }
    return [str(x) for kv in opts.items() for x in kv]


def seeds(args) -> List[str]:
    return [str(s) for s in range(1, args.folds + 1)]


def jax_command(args) -> str:
    """The JAX protocol's command for the same folds (run from the
    repository's root on a host with JAX; its tree is
    ``output/<Task>/UMEML_GAN``).  ``scripts/run_method.sh`` runs seeds
    1-5; ``--platform cpu`` keeps JAX off an accelerator."""
    cmd = ["bash", "scripts/run_method.sh", args.task, METHOD, TRAINER, osp.abspath(args.root)]
    if args.device == "cpu":
        cmd += ["--platform", "cpu"]
    return " ".join(shlex.quote(c) for c in cmd + options(args))


def run(args) -> Dict:
    """Materialise the root (once), run the port's folds, print the JAX
    command; returns ``run_method``'s result."""
    from ..data import synthetic

    if not osp.isdir(osp.join(args.root, "tcga_glioma")):
        synthetic.materialize(args.root, num_slides=args.slides, bag_min=args.bag_min,
                              bag_max=args.bag_max, feat_dim=args.feat_dim,
                              num_genes=args.genes, group_size=args.group_size, seed=0)
    out = run_method([args.task, METHOD, TRAINER, args.root, "--seeds", *seeds(args),
                      "--device", args.device, "--output-root", osp.join(args.work, "torch"),
                      *options(args)])
    print("\nThe JAX side of the same folds (from the repository's root, on a host with JAX):")
    print(jax_command(args))
    print("then: python -m imp_torch.tools.quality_parity --compare "
          f"output/{args.task}/{METHOD} {osp.join(args.work, 'torch', args.task, METHOD)}")
    return out


def fold_values(directory: str) -> Tuple[str, Dict[str, float]]:
    """(metric, {seed directory: value}) of a five-fold tree: the first of
    ``cindex`` / ``accuracy`` that its logs report after training."""
    keyword, outputs = parse_test_res.first_reported(directory)
    if keyword is None:
        raise SystemExit(f"no cindex or accuracy line after 'Finish training' under {directory}")
    return keyword, {osp.basename(osp.dirname(o["file"])): o[keyword] for o in outputs}


def welch(a: Sequence[float], b: Sequence[float]) -> Tuple[float, float]:
    """Welch's t and its two-sided p (``scipy.stats.ttest_ind``, unequal
    variances)."""
    from scipy import stats

    res = stats.ttest_ind(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_var=False)
    return float(res.statistic), float(res.pvalue)


def verdict(p: float, alpha: float = ALPHA) -> str:
    if not np.isfinite(p):
        return "no test: both sides are constant over the folds"
    if p < alpha:
        return (f"p = {p:.4f} < {alpha}: the fold means of imp_tpu and imp_torch differ "
                f"at alpha = {alpha}")
    return (f"p = {p:.4f} >= {alpha}: no significant difference between imp_tpu and "
            f"imp_torch at alpha = {alpha}")


def compare(jax_dir: str, torch_dir: str) -> Dict:
    """Print the per-fold table, the means and Welch's test; returns them."""
    key_j, jax_vals = fold_values(jax_dir)
    key_t, torch_vals = fold_values(torch_dir)
    if key_j != key_t:
        raise SystemExit(f"the two trees report different metrics: {key_j} and {key_t}")
    folds = sorted(set(jax_vals) & set(torch_vals), key=lambda s: (len(s), s))
    if not folds:
        raise SystemExit("the two trees share no fold")
    j = np.array([jax_vals[f] for f in folds])
    t = np.array([torch_vals[f] for f in folds])
    name = {"cindex": "C-index", "accuracy": "accuracy"}[key_j]
    print(f"| fold | imp_tpu {name} | imp_torch {name} | delta |")
    print("|---|---|---|---|")
    for f, a, b in zip(folds, j, t):
        print(f"| {f} | {a:.2f} | {b:.2f} | {b - a:+.2f} |")
    print(f"| **mean±sd** | {j.mean():.2f}±{j.std():.2f} | {t.mean():.2f}±{t.std():.2f} "
          f"| {np.abs(t - j).mean():.2f} (mean abs) |")
    stat, p = welch(j, t)
    print(f"Welch's t = {stat:.4f}, p = {p:.4f} over {len(folds)} folds a side")
    print(verdict(p))
    return {"metric": key_j, "folds": folds, "imp_tpu": j.tolist(), "imp_torch": t.tolist(),
            "mean_abs_delta": float(np.abs(t - j).mean()), "t": stat, "p": p}


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    return run(args) if args.run else compare(*args.compare)


if __name__ == "__main__":
    main()
