"""WHO-2021 integrated-diagnosis labelers, survival binning and k-fold split
writing — the counterpart of ``imp_tpu/data/labeling.py`` (reference
``tools/label_gen.py`` and ``tools/kfold.py``), without pandas or
scikit-learn.

A table is a list of rows, each a dict from column name to value.
:func:`read_csv` reads one with pandas' default typing of each column
(ints, floats where a number is missing or fractional, ``True``/``False``,
else strings; pandas' missing-value spellings become NaN), so a labeler
sees the same Python values as under ``pd.read_csv``.  :func:`write_csv`
writes one through :mod:`csv` as ``DataFrame.to_csv(index=False)`` writes it
(``repr`` of floats, empty NaN cells, ``\\n`` line ends).

Molecular-marker inputs: IDH status ("WT"/"Mutant"), 1p/19q codeletion
("codel"/"non-codel"), histology description, CDKN2A/B status ("-1"/"-2"
means homozygous deletion), and histological grade ("G2"/"G3").
"""

from __future__ import annotations

import csv
import math
import numbers
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

DAYS_IN_MONTH = 30.44

Row = Dict[str, object]

#: the cells ``pd.read_csv`` reads as missing by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _is_g4_astro(His: str, CDKN: str) -> bool:
    return str(His) == "glioblastoma" or str(CDKN) in ("-1", "-2")


def diag_grading(IDH, p19q, His, CDKN, Grade) -> Optional[int]:
    """3-level grading {0: Grade 4, 1: Grade 3, 2: Grade 2}
    (reference ``label_gen.py:6-42``)."""
    if str(IDH) == "WT":
        return 0  # G4 GBM
    if str(IDH) == "Mutant":
        if str(p19q) == "codel":
            return 2 if Grade == "G2" else 1  # G2 / G3 Oligo
        if str(p19q) == "non-codel":
            if _is_g4_astro(His, CDKN):
                return 0  # G4 Astro
            if Grade == "G2":
                return 2
            if Grade == "G3":
                return 1
            return None
    return None


def diag_subtyping(IDH, p19q, His, CDKN, Grade) -> Optional[int]:
    """{0: GBM, 1: Astro, 2: Oligo} (reference ``label_gen.py:47-84``)."""
    if str(IDH) == "WT":
        return 0
    if str(IDH) == "Mutant":
        if str(p19q) == "codel":
            return 2
        if str(p19q) == "non-codel":
            if _is_g4_astro(His, CDKN):
                return 1
            if Grade in ("G2", "G3"):
                return 1
            return None
    return None


def diag_grading6(IDH, p19q, His, CDKN, Grade) -> Optional[int]:
    """6-class integrated diagnosis {0: G4 GBM, 1: G4 Astro, 2: G3 Astro,
    3: G2 Astro, 4: G3 Oligo, 5: G2 Oligo} (reference ``label_gen.py:85-121``)."""
    if str(IDH) == "WT":
        return 0
    if str(IDH) == "Mutant":
        if str(p19q) == "codel":
            return 5 if Grade == "G2" else 4
        if str(p19q) == "non-codel":
            if _is_g4_astro(His, CDKN):
                return 1
            if Grade == "G2":
                return 3
            if Grade == "G3":
                return 2
            return None
    return None


def diag_grading4(IDH, p19q, His, CDKN, Grade) -> Optional[int]:
    """4-class {0: G4 GBM, 1: G4 Astro, 2: G2/3 Astro, 3: Oligo}
    (reference ``label_gen.py:125-161``)."""
    if str(IDH) == "WT":
        return 0
    if str(IDH) == "Mutant":
        if str(p19q) == "codel":
            return 3
        if str(p19q) == "non-codel":
            if _is_g4_astro(His, CDKN):
                return 1
            if Grade in ("G2", "G3"):
                return 2
            return None
    return None


# ---------------------------------------------------------------------------
# tables: lists of row dicts, typed per column as pandas types them
# ---------------------------------------------------------------------------


def is_missing(value) -> bool:
    """``pd.isna`` of one cell: None or a float NaN."""
    return value is None or (isinstance(value, float) and math.isnan(value))


_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _is_bool(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def _number(text: str):
    if "_" in text:  # Python reads 1_000, pandas does not
        raise ValueError(text)
    try:
        return int(text)
    except ValueError:
        return float(text)


def type_column(values: Sequence) -> list:
    """One column as a DataFrame built from these values types it: all
    integers → ints; numbers (no bools) with a fraction or a missing cell →
    floats, missing as NaN; all bools → bools; anything else keeps its
    values, missing as NaN."""
    present = [v for v in values if not is_missing(v)]
    whole = len(present) == len(values)
    nan = float("nan")
    if present and whole and all(_is_bool(v) for v in present):
        return [bool(v) for v in values]
    if all(isinstance(v, numbers.Real) and not _is_bool(v) for v in present):
        if whole and all(isinstance(v, numbers.Integral) for v in values):
            return [int(v) for v in values]
        return [nan if is_missing(v) else float(v) for v in values]
    return [nan if is_missing(v) else v for v in values]


def unique_names(header: Sequence) -> List[str]:
    """Column names as pandas makes them unique: a repeated ``x`` becomes
    ``x.1``, ``x.2``, …"""
    names, seen = [], {}
    for name in header:
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        seen.setdefault(name, 0)
        names.append(name)
    return names


def _parse_column(cells: Sequence[str]) -> list:
    """A CSV column as ``pd.read_csv`` types it (see :func:`type_column`):
    numbers and booleans parsed, missing spellings as NaN."""
    values = [None if c in NA_STRINGS else c for c in cells]
    present = [v for v in values if v is not None]
    if present and len(present) == len(values) and all(v in _TRUE + _FALSE for v in present):
        return [v in _TRUE for v in values]
    try:
        return type_column([None if v is None else _number(v) for v in values])
    except ValueError:
        return type_column(values)


def read_csv(path: str) -> List[Row]:
    """The rows of a CSV file with a header row, each column typed as
    ``pd.read_csv`` types it."""
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    if not table:
        return []
    header, body = unique_names(table[0]), table[1:]
    columns = [_parse_column([r[c] if c < len(r) else "" for r in body])
               for c in range(len(header))]
    return [dict(zip(header, vals)) for vals in zip(*columns)]


def typed(rows: Sequence[Row], columns: Sequence[str]) -> List[Row]:
    """``rows`` with each of ``columns`` typed over all rows as a DataFrame
    built from them types it (:func:`type_column`)."""
    cols = {c: type_column([r[c] for r in rows]) for c in columns}
    return [{**r, **{c: cols[c][i] for c in columns}} for i, r in enumerate(rows)]


def _cell(value) -> str:
    """A cell as ``DataFrame.to_csv`` writes it."""
    if is_missing(value):
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def write_csv(path: str, rows: Iterable[Row], columns: Sequence[str]) -> None:
    """``rows`` (their ``columns``, in order) to ``path`` as
    ``DataFrame.to_csv(path, index=False)`` writes each cell; type the
    columns first (:func:`typed`) where the rows come from several
    sources."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([_cell(r[c]) for c in columns] for r in rows)


# ---------------------------------------------------------------------------
# survival bins and k-fold splits
# ---------------------------------------------------------------------------


def survival_bins(
    rows: Sequence[Row],
    n_bins: int = 4,
    eps: float = 1e-6,
    time_col: str = "OS.time",
    event_col: str = "OS",
    id_col: str = "bcr_patient_barcode",
) -> List[Row]:
    """Quantile survival binning over uncensored patients, clipped to the
    global min/max, left-closed intervals (reference ``Survival_T``,
    ``label_gen.py:165-202``).  The raw event column is flipped so the
    output ``censorship`` is 1 = censored.  Returns rows of ``patients``,
    ``labels``, ``survival_months`` and ``censorship``; rows without a
    survival time are dropped.  Raises ValueError, as ``pd.qcut`` does,
    when the quantile edges are not unique."""
    kept = []
    for r in rows:
        t = r[time_col]
        if is_missing(t) or t == "#N/A":
            continue
        months = round(float(t) / DAYS_IN_MONTH, 2)
        event = r[event_col]
        censor = {0: 1, 1: 0}.get(event, event) if not is_missing(event) else event
        kept.append((r[id_col], months, censor))
    months = np.array([m for _, m, _ in kept], np.float64)
    uncensored = np.array([m for _, m, c in kept if c == 0], np.float64)
    q_bins = np.quantile(uncensored, np.linspace(0, 1, n_bins + 1))
    if len(np.unique(q_bins)) != len(q_bins):
        raise ValueError(f"Bin edges must be unique: {q_bins!r}")
    q_bins[-1] = months.max() + eps
    q_bins[0] = months.min() - eps
    labels = np.searchsorted(q_bins, months, side="right") - 1  # [a, b) intervals
    return [{"patients": pid, "labels": int(lab), "survival_months": float(m),
             "censorship": int(c)} for (pid, m, c), lab in zip(kept, labels)]


def kfold_indices(n: int, n_splits: int = 5, seed: int = 42):
    """(train, test) index arrays of each fold, as scikit-learn's
    ``KFold(n_splits, shuffle=True, random_state=seed).split`` gives them:
    the indices shuffled by ``np.random.RandomState(seed)``, cut into folds
    whose first ``n % n_splits`` hold one more, each side in ascending
    order."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"cannot split {n} samples into {n_splits} folds")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def write_kfold_splits(
    rows: Sequence[Row],
    out_dir: str,
    task: str,
    n_splits: int = 5,
    seed: int = 42,
    extra_cols=(),
) -> None:
    """5-fold split CSVs ``{task}_{train,test}_{fold}.csv`` of the
    ``features``, ``labels`` and ``extra_cols`` columns (reference
    ``tools/kfold.py:13-27``; KFold(shuffle=True, seed 42))."""
    os.makedirs(out_dir, exist_ok=True)
    cols = ["features", "labels", *extra_cols]
    rows = typed(rows, cols)
    for fold, (train_idx, test_idx) in enumerate(kfold_indices(len(rows), n_splits, seed),
                                                 start=1):
        write_csv(f"{out_dir}/{task}_train_{fold}.csv", [rows[i] for i in train_idx], cols)
        write_csv(f"{out_dir}/{task}_test_{fold}.csv", [rows[i] for i in test_idx], cols)
