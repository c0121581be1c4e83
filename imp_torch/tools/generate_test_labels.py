"""Generate external-cohort (CPTAC) test labels — the counterpart of
``tools/generate_test_labels.py`` (reference
``tools/generate_test_labels.py:4-167``), without pandas: OS days ->
months, event flip to censorship, quantile survival binning over the
uncensored patients, and the WHO-2021 labelers for grading (3-level) and
classification (6-class integrated diagnosis).

Column defaults match the reference's CPTAC workbook
(``DATASET/test/labels/survival/CPTAC.xlsx``: WSI_ID / OS / event /
IDH status / 1p/19q codeletion / Histology / CDKN2A / 2016-Grade).  An
``.xlsx`` goes through :func:`imp_torch.data.xlsx.read_xlsx`, a CSV
through :func:`imp_torch.data.labeling.read_csv`.

Usage:
    python -m imp_torch.tools.generate_test_labels --meta CPTAC.xlsx \
        --task survival --out DATASET/test/labels
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

from ..data.labeling import (
    diag_grading,
    diag_grading6,
    read_csv,
    survival_bins,
    write_csv,
)
from ..data.xlsx import read_xlsx


def read_meta(path: str) -> list:
    """The rows of a metadata CSV or ``.xlsx`` workbook (a legacy binary
    ``.xls`` is not read)."""
    if path.endswith(".xls"):
        raise ValueError(f"{path}: a binary .xls workbook; save it as .xlsx or CSV")
    return read_xlsx(path) if path.endswith(".xlsx") else read_csv(path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta", required=True)
    ap.add_argument("--task", choices=["survival", "grading", "classification"],
                    required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--id-col", default="WSI_ID")
    ap.add_argument("--os-days-col", default="OS")
    ap.add_argument("--os-event-col", default="event")
    ap.add_argument("--idh-col", default="IDH status")
    ap.add_argument("--codel-col", default="1p/19q codeletion")
    ap.add_argument("--his-col", default="Histology")
    ap.add_argument("--cdkn-col", default="CDKN2A")
    ap.add_argument("--grade-col", default="2016-Grade")
    args = ap.parse_args(argv)

    meta = read_meta(args.meta)
    out_dir = osp.join(args.out, args.task)
    os.makedirs(out_dir, exist_ok=True)

    if args.task == "survival":
        # the exact reference Survival_T math (ref :4-52): months = OS days
        # / 30.44 rounded to 2, event flipped to censorship, 4 quantile
        # bins over the UNCENSORED patients clipped to the global range
        rows = survival_bins(meta, time_col=args.os_days_col, event_col=args.os_event_col,
                             id_col=args.id_col)
        rows = [dict(r, patients=str(r["patients"]).strip()) for r in rows]
        write_csv(osp.join(out_dir, "survival_test.csv"), rows,
                  ["patients", "labels", "survival_months", "censorship"])
    else:
        labeler = diag_grading if args.task == "grading" else diag_grading6
        rows: list = []
        for r in meta:
            label = labeler(r.get(args.idh_col), r.get(args.codel_col), r.get(args.his_col),
                            r.get(args.cdkn_col), r.get(args.grade_col))
            if label is not None:
                rows.append({"patients": str(r[args.id_col]).strip(), "labels": int(label)})
        write_csv(osp.join(out_dir, f"{args.task}_test.csv"), rows, ["patients", "labels"])
    print(f"Wrote {out_dir}")


if __name__ == "__main__":
    main()
