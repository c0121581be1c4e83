"""Standalone 5-fold split writer — the counterpart of ``tools/kfold.py``
(reference ``tools/kfold.py:13-27``), without pandas or scikit-learn.

Usage:
    python -m imp_torch.tools.kfold --labels all_labels.csv --out labels/survival \
        --task survival [--extra-cols survival_months censorship] [--seed 42]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.labeling import read_csv, write_kfold_splits


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--labels", required=True, help="CSV with features+labels cols")
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", required=True)
    ap.add_argument("--extra-cols", nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    rows = read_csv(args.labels)
    write_kfold_splits(rows, args.out, args.task, seed=args.seed,
                       extra_cols=tuple(args.extra_cols))
    print(f"Wrote 5-fold splits for {len(rows)} samples under {args.out}")


if __name__ == "__main__":
    main()
