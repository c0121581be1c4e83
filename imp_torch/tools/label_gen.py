"""Generate task labels + 5-fold splits from a clinical/molecular metadata
table — the counterpart of ``tools/label_gen.py`` (reference
``tools/label_gen.py`` + ``tools/kfold.py``), without pandas.

Input: a CSV/XLSX with columns for patient barcode, IDH status, 1p/19q
codeletion, histology, CDKN2A/B status, grade, OS, OS.time, and the
feature-file mapping.  Output: ``labels/{task}/{task}_{train,test}_{fold}.csv``.

Usage:
    python -m imp_torch.tools.label_gen --meta clinical.csv --wsi-dir features_dir \
        --out DATASET/tcga_glioma/labels --task survival
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import List, Optional, Sequence

from ..data.labeling import (
    Row,
    diag_grading,
    diag_grading4,
    diag_grading6,
    diag_subtyping,
    read_csv,
    survival_bins,
    write_kfold_splits,
)
from ..data.xlsx import read_xlsx

LABELERS = {
    "grading": diag_grading,
    "subtyping": diag_subtyping,
    "classification": diag_grading6,
    "classification4": diag_grading4,
}


def map_wsi_files(rows: Sequence[Row], wsi_dir: str, id_col: str) -> List[Row]:
    """Attach every .h5 whose name starts with the patient barcode."""
    files = sorted(f for f in os.listdir(wsi_dir) if f.endswith(".h5"))
    return [dict(row, features=f) for row in rows for f in files
            if f.startswith(str(row[id_col]))]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta", required=True, help="clinical metadata CSV/XLSX")
    ap.add_argument("--wsi-dir", required=True, help="feature .h5 dir")
    ap.add_argument("--out", required=True, help="labels output root")
    ap.add_argument("--task", required=True,
                    choices=["survival", "grading", "subtyping", "classification"])
    ap.add_argument("--id-col", default="bcr_patient_barcode")
    ap.add_argument("--idh-col", default="IDH status")
    ap.add_argument("--p19q-col", default="1p/19q codeletion")
    ap.add_argument("--his-col", default="histological_type")
    ap.add_argument("--cdkn-col", default="CDKN2AB")
    ap.add_argument("--grade-col", default="neoplasm_histologic_grade")
    ap.add_argument("--n-bins", type=int, default=4)
    args = ap.parse_args(argv)

    meta = read_xlsx(args.meta) if args.meta.endswith(".xlsx") else read_csv(args.meta)

    if args.task == "survival":
        surv = survival_bins(meta, n_bins=args.n_bins, id_col=args.id_col)
        rows = map_wsi_files(surv, args.wsi_dir, "patients")
        out_dir = osp.join(args.out, "survival")
        write_kfold_splits(rows, out_dir, "survival",
                           extra_cols=("survival_months", "censorship"))
    else:
        labeler = LABELERS[args.task]
        labelled = []
        for r in meta:
            label = labeler(r[args.idh_col], r[args.p19q_col], r[args.his_col],
                            r[args.cdkn_col], r[args.grade_col])
            if label is not None:
                labelled.append(dict(r, labels=int(label)))
        rows = map_wsi_files(labelled, args.wsi_dir, args.id_col)
        out_dir = osp.join(args.out, args.task)
        write_kfold_splits(rows, out_dir, args.task)
    print(f"Wrote 5-fold splits under {out_dir}")


if __name__ == "__main__":
    main()
