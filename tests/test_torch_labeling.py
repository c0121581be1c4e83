"""Labelling, ``.xlsx`` reading and the three label tools of the PyTorch
port (``imp_torch.data.{labeling,xlsx}``, ``imp_torch.tools.{kfold,
label_gen,generate_test_labels}``, no pandas) against ``imp_tpu.data.
{labeling,xlsx}`` and the root ``tools/`` (pandas, scikit-learn's KFold) on
synthetic tables, as ``tests/test_etl_tools.py`` drives the JAX package's:
the labelers on a grid of markers, column typing as ``pd.read_csv`` and
``pd.read_excel`` type, survival bins, KFold's folds, and every file the
tools write, byte for byte but for floats that pandas' parser read an ulp
off (:func:`same_files`)."""

import importlib.util
import math
import os
import os.path as osp
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest

from imp_torch.data import labeling
from imp_torch.data.xlsx import read_xlsx
from imp_torch.tools import generate_test_labels, kfold, label_gen
from imp_tpu.data import labeling as jlabeling
from imp_tpu.data.xlsx import read_xlsx as jax_read_xlsx

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
LABELERS = ("diag_grading", "diag_subtyping", "diag_grading6", "diag_grading4")


def run_jax_tool(name, argv, monkeypatch):
    """``tools/<name>.py`` of the JAX package, its ``main`` under ``argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def _float(cell):
    try:
        return float(cell) if "." in cell or "e" in cell else None
    except ValueError:
        return None


def same_files(a, b):
    """Every file under directory ``a`` and ``b``: the same names and the
    same bytes, but that a float cell may sit within 2 ulp: pandas' default
    CSV parser reads some floats an ulp off Python's ``float()``, which the
    port uses (25.136363636363637 comes back ...633), and writes what it
    read."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(osp.join(a, name), "rb") as fa, open(osp.join(b, name), "rb") as fb:
            want, got = fa.read(), fb.read()
        if got == want:
            continue
        want_lines, got_lines = want.decode().split("\n"), got.decode().split("\n")
        assert len(got_lines) == len(want_lines), name
        for gl, wl in zip(got_lines, want_lines):
            for g, w in zip(gl.split(","), wl.split(","), strict=True):
                if g != w:
                    gf, wf = _float(g), _float(w)
                    assert gf is not None and wf is not None, (name, g, w)
                    assert abs(gf - wf) <= 2 * np.spacing(abs(wf)), (name, g, w)


def same_cell(got, want):
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want), (got, want)


def records(df):
    """A DataFrame's rows as Python values (``DataFrame.to_dict`` keeps
    numpy scalars; ``.item()`` gives their Python value)."""
    return [{k: (v.item() if hasattr(v, "item") else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def test_labelers_match_jax_on_a_grid_of_markers():
    values = {
        "IDH": ("WT", "Mutant", None, float("nan"), "x"),
        "p19q": ("codel", "non-codel", None),
        "His": ("glioblastoma", "astrocytoma", float("nan")),
        "CDKN": ("-1", "-2", "0", -1, -2, -1.0, None),
        "Grade": ("G2", "G3", "G4", None),
    }
    n = 0
    for idh in values["IDH"]:
        for p19q in values["p19q"]:
            for his in values["His"]:
                for cdkn in values["CDKN"]:
                    for grade in values["Grade"]:
                        for name in LABELERS:
                            args = (idh, p19q, his, cdkn, grade)
                            assert getattr(labeling, name)(*args) == getattr(
                                jlabeling, name)(*args), (name, args)
                            n += 1
    assert n == 4 * 5 * 3 * 3 * 7 * 4


def test_read_csv_types_columns_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(
        "id,int,float,gap,text,flag,cdkn,dup,dup\n"
        "a ,1,2.5,3,x,True,-1,1,2\n"
        "b,2,3,,NA,False,,3,4\n"
        "c,-3,1e-05,7,#N/A,True,-2,5,6\n")
    got = labeling.read_csv(str(path))
    want = records(pd.read_csv(path))
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for key in w:
            same_cell(g[key], w[key])
    assert labeling.read_csv(str(tmp_path / "t.csv"))[1]["cdkn"] != labeling.read_csv(
        str(tmp_path / "t.csv"))[0]["cdkn"]


def test_survival_bins_match_jax():
    rng = np.random.default_rng(0)
    n = 60
    df = pd.DataFrame({
        "bcr_patient_barcode": [f"TCGA-{i:04d}" for i in range(n)],
        "OS.time": rng.integers(30, 3000, n).astype(float),
        "OS": rng.integers(0, 2, n),
    })
    df.loc[[3, 17], "OS.time"] = np.nan  # no survival time: dropped by both
    want = records(jlabeling.survival_bins(df))
    got = labeling.survival_bins(records(df))
    assert len(got) == len(want) == n - 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            same_cell(g[key], w[key])
    assert {r["labels"] for r in got} == {0, 1, 2, 3}


def test_survival_bins_refuse_repeated_edges_as_qcut_does():
    rows = [{"bcr_patient_barcode": f"p{i}", "OS.time": 100.0, "OS": 1} for i in range(6)]
    with pytest.raises(ValueError, match="Bin edges must be unique"):
        jlabeling.survival_bins(pd.DataFrame(rows))
    with pytest.raises(ValueError, match="Bin edges must be unique"):
        labeling.survival_bins(rows)


@pytest.mark.parametrize("n", [5, 23, 24])
def test_kfold_indices_match_scikit_learn(n):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=5, shuffle=True, random_state=42).split(np.arange(n)))
    got = list(labeling.kfold_indices(n))
    assert len(got) == len(want) == 5
    for (gt, ge), (wt, we) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)


def test_kfold_tool_writes_the_files_of_jax(tmp_path, monkeypatch):
    n = 23
    labels = tmp_path / "all_labels.csv"
    pd.DataFrame({
        "features": [f"s{i}.h5" for i in range(n)],
        "labels": np.arange(n) % 3,
        "survival_months": np.linspace(1, 60, n),
        "censorship": np.arange(n) % 2,
    }).to_csv(labels, index=False)
    argv = ["--labels", str(labels), "--task", "survival", "--extra-cols",
            "survival_months", "censorship"]
    run_jax_tool("kfold", argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    kfold.main(argv + ["--out", str(tmp_path / "port")])
    same_files(tmp_path / "jax", tmp_path / "port")


def _meta(n=40, seed=1):
    rng = np.random.default_rng(seed)
    meta = pd.DataFrame({
        "bcr_patient_barcode": [f"TCGA-{i:02d}" for i in range(n)],
        "IDH status": rng.choice(["WT", "Mutant"], n),
        "1p/19q codeletion": rng.choice(["codel", "non-codel"], n),
        "histological_type": rng.choice(["glioblastoma", "astrocytoma", "oligodendroglioma"], n),
        "CDKN2AB": rng.choice([-2, -1, 0], n).astype(float),
        "neoplasm_histologic_grade": rng.choice(["G2", "G3", "G4"], n),
        "OS.time": rng.integers(30, 3000, n).astype(float),
        "OS": rng.integers(0, 2, n),
    })
    meta.loc[4, "CDKN2AB"] = np.nan  # a gap makes the column float: "-1.0", as pandas reads it
    return meta


@pytest.mark.parametrize("task", ["survival", "grading", "subtyping", "classification"])
def test_label_gen_tool_writes_the_files_of_jax(tmp_path, monkeypatch, task):
    meta = tmp_path / "clinical.csv"
    _meta().to_csv(meta, index=False)
    wsi = tmp_path / "wsi"
    wsi.mkdir()
    for i in range(0, 40, 1):
        for suffix in ("-01Z-00-DX1", "-01Z-00-DX2")[: 1 + (i % 5 == 0)]:
            (wsi / f"TCGA-{i:02d}{suffix}.h5").write_bytes(b"")
    (wsi / "notes.txt").write_text("not a slide")
    argv = ["--meta", str(meta), "--wsi-dir", str(wsi), "--task", task]
    run_jax_tool("label_gen", argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    label_gen.main(argv + ["--out", str(tmp_path / "port")])
    same_files(tmp_path / "jax" / task, tmp_path / "port" / task)


def _cptac(n=24, seed=2):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "WSI_ID": [f"C3L-{i:05d}" + (" " if i % 7 == 0 else "") for i in range(n)],
        "OS": rng.integers(30, 2000, n).astype(float),
        "event": rng.integers(0, 2, n),
        "IDH status": rng.choice(["WT", "Mutant"], n),
        "1p/19q codeletion": rng.choice(["codel", "non-codel"], n),
        "Histology": rng.choice(["glioblastoma", "astrocytoma"], n),
        "CDKN2A": rng.choice(["-1", "0"], n),
        "2016-Grade": rng.choice(["G2", "G3"], n),
    })


def _write_xlsx(path, df):
    """A plain workbook of ``df``: strings shared, numbers as numbers."""
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    strings, index = [], {}

    def cell(ref, value):
        if isinstance(value, str):
            if value not in index:
                index[value] = len(strings)
                strings.append(value)
            return f'<c r="{ref}" t="s"><v>{index[value]}</v></c>'
        return f'<c r="{ref}"><v>{value!r}</v></c>'

    def col(c):
        return chr(ord("A") + c)

    rows = [[cell(f"{col(c)}1", name) for c, name in enumerate(df.columns)]]
    for r, values in enumerate(df.itertuples(index=False), start=2):
        rows.append([cell(f"{col(c)}{r}", v.item() if hasattr(v, "item") else v)
                     for c, v in enumerate(values)])
    sheet = "".join(f'<row r="{i + 1}">{"".join(r)}</row>' for i, r in enumerate(rows))
    shared = "".join(f"<si><t>{s}</t></si>" for s in strings)
    types = ('<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/package/'
             '2006/content-types"><Override PartName="/xl/workbook.xml" ContentType="application/'
             'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/></Types>')
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("[Content_Types].xml", types)  # what tells pandas the zip is a workbook
        z.writestr("xl/workbook.xml", f'<?xml version="1.0"?><workbook xmlns="{ns}"/>')
        z.writestr("xl/sharedStrings.xml", f'<?xml version="1.0"?><sst xmlns="{ns}">{shared}</sst>')
        z.writestr("xl/worksheets/sheet1.xml", f'<?xml version="1.0"?><worksheet xmlns="{ns}">'
                                               f"<sheetData>{sheet}</sheetData></worksheet>")


@pytest.mark.parametrize("fmt", ["csv", "xlsx"])
@pytest.mark.parametrize("task", ["survival", "grading", "classification"])
def test_generate_test_labels_tool_writes_the_files_of_jax(tmp_path, monkeypatch, task, fmt):
    meta = tmp_path / f"CPTAC.{fmt}"
    if fmt == "csv":
        _cptac().to_csv(meta, index=False)
    else:  # pandas has no openpyxl here: the JAX tool falls back to its read_xlsx
        _write_xlsx(meta, _cptac())
    argv = ["--meta", str(meta), "--task", task]
    run_jax_tool("generate_test_labels", argv + ["--out", str(tmp_path / "jax")], monkeypatch)
    generate_test_labels.main(argv + ["--out", str(tmp_path / "port")])
    same_files(tmp_path / "jax" / task, tmp_path / "port" / task)


def test_read_xlsx_matches_jax_on_edge_cells(tmp_path):
    """Shared and inline strings, booleans, an error cell, a gap, a repeated
    and a blank header, a column past Z, trailing header-less data, and
    the sheet order by file number (sheet2 before sheet10)."""
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    shared = (f'<?xml version="1.0"?><sst xmlns="{ns}"><si><t>name</t></si>'
              "<si><t>hello world</t></si></sst>")
    sheet = (
        f'<?xml version="1.0"?><worksheet xmlns="{ns}"><sheetData>'
        '<row r="1"><c r="A1" t="s"><v>0</v></c>'
        '<c r="B1" t="inlineStr"><is><t>num</t></is></c>'
        '<c r="C1" t="inlineStr"><is><t>num</t></is></c>'
        '<c r="AA1" t="inlineStr"><is><t>far</t></is></c></row>'
        '<row r="2"><c r="A2" t="s"><v>1</v></c><c r="B2"><v>3.5</v></c>'
        '<c r="C2"><v>9</v></c><c r="D2" t="b"><v>0</v></c>'
        '<c r="AA2"><v>7</v></c><c r="AB2"><v>42</v></c></row>'
        '<row r="3"><c r="B3" t="b"><v>1</v></c><c r="C3"><v>10</v></c>'
        '<c r="D3" t="b"><v>1</v></c><c r="AA3" t="e"><v>#N/A</v></c></row>'
        "</sheetData></worksheet>")
    other = (f'<?xml version="1.0"?><worksheet xmlns="{ns}"><sheetData>'
             '<row r="1"><c r="A1" t="inlineStr"><is><t>second</t></is></c></row>'
             '<row r="2"><c r="A2"><v>1</v></c></row></sheetData></worksheet>')
    path = tmp_path / "edge.xlsx"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/sharedStrings.xml", shared)
        z.writestr("xl/worksheets/sheet10.xml", other)
        z.writestr("xl/worksheets/sheet2.xml", sheet)
    for sheet_index in (0, 1):
        want = records(jax_read_xlsx(str(path), sheet_index))
        got = read_xlsx(str(path), sheet_index)
        assert [list(r) for r in got] == [list(r) for r in want]
        for g, w in zip(got, want):
            for key in w:
                same_cell(g[key], w[key])
    assert list(read_xlsx(str(path))[0])[:4] == ["name", "num", "num.1", "Unnamed: 3"]
