"""Minimal stdlib ``.xlsx`` reader (zipfile + ElementTree) — the counterpart
of ``imp_tpu/data/xlsx.py``, returning rows instead of a DataFrame.

The reference reads the external CPTAC label workbook with
``pd.read_excel`` (``tools/generate_test_labels.py:132``), which needs
pandas and the optional ``openpyxl`` engine.  :func:`read_xlsx` parses the
subset of OOXML that plain data workbooks use — one sheet of cells with
shared / inline strings, numbers, booleans, errors and blanks — into a list
of row dicts (:mod:`imp_torch.data.labeling`'s tables), with the header-row
semantics of ``pd.read_excel``: blank header cells become ``Unnamed: N``,
repeated names ``x.1``, …, missing and error cells NaN, and each column
typed as a DataFrame types it.

Two limits it shares with the JAX package's reader: sheet ``i`` is the
``i``-th worksheet file by the number in its name (``sheet2.xml`` before
``sheet10.xml``), not by the order of ``xl/workbook.xml``, which can differ
after sheets are reordered or deleted; and date-styled numeric cells come
back as Excel serial numbers.
"""

from __future__ import annotations

import re
import zipfile
from typing import List
from xml.etree import ElementTree as ET

from .labeling import Row, type_column, unique_names

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _col_index(ref: str) -> int:
    """'A' -> 0, 'Z' -> 25, 'AA' -> 26 …"""
    i = 0
    for ch in ref:
        i = i * 26 + (ord(ch) - ord("A") + 1)
    return i - 1


def _shared_strings(z: zipfile.ZipFile):
    try:
        root = ET.fromstring(z.read("xl/sharedStrings.xml"))
    except KeyError:
        return []
    return ["".join(t.text or "" for t in si.iter(f"{_NS}t")) for si in root.iter(f"{_NS}si")]


def _cell_value(cell, shared):
    ctype = cell.get("t", "n")
    if ctype == "inlineStr":
        return "".join(t.text or "" for t in cell.iter(f"{_NS}t"))
    v = cell.find(f"{_NS}v")
    if v is None or v.text is None:
        return None
    if ctype == "s":
        return shared[int(v.text)]
    if ctype == "str":
        return v.text
    if ctype == "b":
        return bool(int(v.text))
    if ctype == "e":
        # error cells (#N/A, #DIV/0!, ...) -> NaN, as pd.read_excel reads them
        return None
    try:
        f = float(v.text)
    except ValueError:
        return v.text
    return int(f) if f.is_integer() and abs(f) < 2**53 else f


def read_xlsx(path: str, sheet: int = 0) -> List[Row]:
    """Read a data worksheet into rows (first row = header), matching
    ``pd.read_excel(path)`` for plain tabular workbooks."""
    with zipfile.ZipFile(path) as z:
        shared = _shared_strings(z)
        # numeric sort: 'sheet10.xml' must come after 'sheet2.xml'
        sheets = sorted(
            (n for n in z.namelist() if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)),
            key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)),
        )
        root = ET.fromstring(z.read(sheets[sheet]))
    rows = {}
    max_col = -1
    for row in root.iter(f"{_NS}row"):
        for cell in row.iter(f"{_NS}c"):
            m = _CELL_REF.fullmatch(cell.get("r", ""))
            if not m:
                continue
            c, r = _col_index(m.group(1)), int(m.group(2)) - 1
            val = _cell_value(cell, shared)
            if val is not None:
                rows.setdefault(r, {})[c] = val
                max_col = max(max_col, c)
    if not rows:
        return []
    header_r = min(rows)
    ncols = max_col + 1  # keep trailing header-less data columns too
    names = unique_names(
        [f"Unnamed: {c}" if rows[header_r].get(c) is None else rows[header_r][c]
         for c in range(ncols)])
    body = [r for r in sorted(rows) if r != header_r]
    columns = [type_column([rows[r].get(c) for r in body]) for c in range(ncols)]
    return [dict(zip(names, vals)) for vals in zip(*columns)]
