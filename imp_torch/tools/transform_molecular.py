"""GDC RNA-seq TSVs -> per-WSI molecular CSVs without pandas — the port's
copy of ``tools/transform_molecular.py`` (reference
``tools/transform_molecular.py:12-101``), with the same CLI, the same lines
and the same bytes in every file it writes.  It selects the top-variance
genes plus the six signature-category genes and writes one
``gene_name,fpkm_uq_unstranded`` CSV per WSI feature file:

    python -m imp_torch.tools.transform_molecular --gdc-meta metadata.cart.json \\
        --gene-variance TCGA_GBM_gene_sorted.csv --origin-dir origin_molecular \\
        --feature-dir features_clip_vit_b16 --out-dir molecular --top-k 1039

The JAX tool reads and writes through pandas; this one does what pandas
does with ``csv`` and ``json``:

* a cell is missing (NaN) when it is one of pandas' NA strings
  (:data:`NA_VALUES`, the empty cell among them);
* a column is integer when every cell is an integer and none is missing,
  else float when every present cell is a number, else text; numbers are
  read as pandas' C parser reads them (:func:`parse_float`, which can sit
  an ulp from ``float()`` on 17-digit strings);
* the genes are ranked by ``sort_values("variance", ascending=False)``,
  i.e. pandas' ``nargsort``: numpy's quicksort over the reversed present
  values, reversed back, missing values last — ties at the top-k
  boundary fall as pandas lets them fall;
* missing gene names are dropped after the top k are taken;
* the TSV's first line (GDC's comment) is skipped, and blank lines;
* ``to_csv(index=False)`` writes an integer column as integers, a float
  column by the shortest repr (``12.50`` as ``12.5``, ``3`` as ``3.0``),
  text as read, and a missing value as an empty field.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import os.path as osp
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*$")
_INF = re.compile(r"\s*([+-]?)inf(inity)?\s*$", re.IGNORECASE)
_POW10 = [float(f"1e{n}") for n in range(309)]
_INT64 = (-(2**63), 2**63 - 1)


def parse_float(text: str) -> float:
    """``text`` as pandas' C parser reads a float (its ``precise_xstrtod``:
    up to 17 digits gathered in a double, then one product or quotient by
    a power of ten); ValueError where it is no number."""
    m = _INF.match(text)
    if m:
        return float(m.group(1) + "inf")
    p = text.strip()
    i, negative = 0, False
    if p[:1] in ("+", "-"):
        negative, i = p[0] == "-", 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < len(p) and p[i].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(p[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < len(p) and p[i] == ".":
        i += 1
        while digits < 17 and i < len(p) and p[i].isdigit():
            number = number * 10.0 + (ord(p[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < len(p) and p[i].isdigit():
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(text)
    if negative:
        number = -number
    if i < len(p) and p[i] in "eE":
        i += 1
        exp_negative = i < len(p) and p[i] == "-"
        i += i < len(p) and p[i] in "+-"
        if i == len(p) or not p[i].isdigit():
            raise ValueError(text)
        n = 0
        while i < len(p) and p[i].isdigit():
            n = n * 10 + ord(p[i]) - 48
            i += 1
        exponent += -n if exp_negative else n
    if i != len(p):
        raise ValueError(text)
    if exponent > 308:
        return -np.inf if negative else np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return -0.0 if negative else 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def type_column(cells: Sequence[str]) -> Tuple[str, list]:
    """(kind, values) of one column as pandas types it: ``"int"`` (ints),
    ``"float"`` (floats, NaN where missing) or ``"text"`` (strings, None
    where missing)."""
    present = [c for c in cells if c not in NA_VALUES]
    if len(present) == len(cells) and present and all(_INT.match(c) for c in cells):
        ints = [int(c) for c in cells]
        if all(_INT64[0] <= v <= _INT64[1] for v in ints):
            return "int", ints
    try:
        return "float", [np.nan if c in NA_VALUES else parse_float(c) for c in cells]
    except ValueError:
        return "text", [None if c in NA_VALUES else c for c in cells]


def read_table(path: str, delimiter: str = ",", skiprows: int = 0):
    """(header, {column: (kind, values)}) of a delimited file as
    ``pd.read_csv(path, sep=delimiter, skiprows=skiprows)`` reads it."""
    with open(path, newline="") as f:
        for _ in range(skiprows):
            f.readline()
        rows = [r for r in csv.reader(f, delimiter=delimiter) if r]
    header, body = rows[0], rows[1:]
    width = len(header)
    body = [r + [""] * (width - len(r)) for r in body]
    return header, {name: type_column([r[j] for r in body]) for j, name in enumerate(header)}


def format_cell(kind: str, value) -> str:
    """One cell as ``DataFrame.to_csv`` writes it."""
    if value is None or (kind == "float" and np.isnan(value)):
        return ""
    if kind == "int":
        return str(value)
    if kind == "float":
        return repr(float(value))
    return value


def top_variance_genes(path: str, top_k: int) -> List[str]:
    """``read_csv(path).sort_values(by="variance", ascending=False)
    .head(top_k)["gene_name"].dropna().tolist()``."""
    _, cols = read_table(path)
    kind, variance = cols["variance"]
    if kind == "text":
        raise ValueError(f"{path}: the variance column is not numeric")
    items = np.asarray(variance, np.int64 if kind == "int" else np.float64)
    missing = np.isnan(items) if kind == "float" else np.zeros(len(items), bool)
    idx = np.arange(len(items))
    present, present_idx = items[~missing][::-1], idx[~missing][::-1]
    order = present_idx[present.argsort(kind="quicksort")][::-1]  # pandas' nargsort
    order = np.concatenate([order, np.nonzero(missing)[0]])[:top_k]
    name_kind, names = cols["gene_name"]
    return [names[i] for i in order
            if not (names[i] is None or (name_kind == "float" and np.isnan(names[i])))]


def select_rows(path: str, genes: List[str]) -> List[List[str]]:
    """The ``gene_name,fpkm_uq_unstranded`` rows (header first) of the GDC
    TSV at ``path`` whose gene is in ``genes``, in the file's order."""
    _, cols = read_table(path, delimiter="\t", skiprows=1)
    wanted = set(genes)
    name_kind, names = cols["gene_name"]
    value_kind, values = cols["fpkm_uq_unstranded"]
    rows = [["gene_name", "fpkm_uq_unstranded"]]
    for name, value in zip(names, values):
        if name is not None and name in wanted:
            rows.append([format_cell(name_kind, name), format_cell(value_kind, value)])
    return rows


def write_rows(path: str, rows: List[List[str]]) -> None:
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gdc-meta", required=True, help="GDC metadata.cart JSON")
    ap.add_argument("--gene-variance", required=True,
                    help="CSV with gene_name + variance columns")
    ap.add_argument("--origin-dir", required=True, help="raw GDC TSV root")
    ap.add_argument("--feature-dir", required=True, help="per-WSI .h5 dir")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--top-k", type=int, default=1039)
    args = ap.parse_args(argv)

    c_gene_list = top_variance_genes(args.gene_variance, args.top_k)
    with open(args.gdc_meta) as f:
        meta = json.load(f)

    os.makedirs(args.out_dir, exist_ok=True)
    wsi_ids = os.listdir(args.feature_dir)
    count = 0
    for entry in meta:
        file_path = osp.join(args.origin_dir, entry["file_id"], entry["file_name"])
        if not osp.isfile(file_path):
            continue
        subparts = entry["associated_entities"][0]["entity_submitter_id"].split("-")[:3]
        entity_id = "-".join(subparts)
        rows = select_rows(file_path, c_gene_list)
        for wsi in wsi_ids:
            if entity_id in wsi and wsi.endswith(".h5"):
                out = osp.join(args.out_dir, wsi.replace(".h5", ".csv"))
                write_rows(out, rows)
                count += 1
                print(f"wrote {out}")
    print(f"total files: {count}")
    return count


if __name__ == "__main__":
    main()
