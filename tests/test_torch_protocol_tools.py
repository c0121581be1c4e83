"""The port's protocol tools against the JAX package's tools on the CPU:

* ``imp_torch.tools.parse_test_res`` against ``tools/parse_test_res.py`` on
  the same seed logs: the same stdout for ``--keyword``, ``--ci95``,
  ``--multi-exp`` and ``--end-signal``;
* ``imp_torch.tools.transform_molecular`` against
  ``tools/transform_molecular.py`` (pandas) on the GDC fixture of
  ``tests/fixtures/gdc`` (variance ties at the top-k boundary, missing gene
  names among the top k, a missing value, an integer column, ``12.50``, a
  17-digit number, the GDC comment line): the same bytes in every file and
  the same stdout, both equal to ``tests/fixtures/gdc/expected`` (written by
  the JAX tool at ``--top-k 12``);
* ``imp_torch.tools.gen_configs --out-dir`` equal to the 52 committed
  ``configs/*/*.yaml`` byte for byte;
* ``imp_torch.tools.run_method`` on the CPU for 2 seeds at small widths:
  the ``output/<Task>/<Method>/seed<N>`` tree, the resume of a finished
  seed, and the parse line against the values the runs returned;
* ``imp_torch.tools.quality_parity --compare`` on two hand-written trees:
  the per-fold table, the means and Welch's p equal to scipy's;
* the six modules import, and the ETL runs, where neither JAX nor pandas
  can be imported.
"""

import filecmp
import importlib.util
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
from scipy import stats

from imp_torch.data import synthetic
from imp_torch.tools import gen_configs, parse_test_res, quality_parity, run_method
from imp_torch.tools import transform_molecular

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GDC = osp.join(REPO, "tests", "fixtures", "gdc")
GDC_TOP_K = 12
NEW_MODULES = ("parse_test_res", "run_method", "quality_parity", "full_schedule_gate",
               "transform_molecular", "gen_configs")


def _jax_tool(name):
    """The JAX package's tool ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(main, argv, monkeypatch, capsys, as_argv=True):
    """What ``main`` prints, with ``argv`` as sys.argv[1:] (or passed)."""
    capsys.readouterr()
    if as_argv:
        monkeypatch.setattr(sys, "argv", ["tool", *argv])
        main()
    else:
        main(argv)
    return capsys.readouterr().out


def _log(path, *lines):
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture
def seed_logs(tmp_path):
    """Two experiments of seed logs: metric lines before and after the end
    signal, a seed without a log, a hidden directory, an exponent."""
    root = tmp_path / "logs"
    for exp, vals in (("expA", (71.234, 65.5, 80.0)), ("expB", (55.0, 1.25e1, 90.125))):
        for i, v in enumerate(vals, 1):
            _log(str(root / exp / f"seed{i}" / "log.txt"),
                 "* cindex: 99.99%", "* accuracy: 12.00%", "Finish training",
                 f"* cindex: {v}%", f"* accuracy: {v / 2:.3f}%", "Elapsed: 0:00:01")
        os.makedirs(root / exp / "seed9")  # no log: not a seed
        _log(str(root / exp / ".hidden" / "log.txt"), "* cindex: 1.0%")
    _log(str(root / "expA" / "seed4" / "log.txt"), "* cindex: 5e1%")  # no end signal
    return str(root)


@pytest.mark.parametrize("flags", [
    ["--keyword", "cindex"],
    ["--keyword", "accuracy", "--ci95"],
    ["--keyword", "cindex", "--end-signal", "* accuracy: 12.00%"],
    ["--keyword", "cindex", "--ci95", "--end-signal", "Finish training"],
    ["--multi-exp", "--keyword", "cindex"],
    ["--multi-exp", "--keyword", "accuracy", "--ci95"],
])
def test_parse_test_res_prints_what_the_jax_tool_prints(seed_logs, flags, monkeypatch, capsys):
    jax_tool = _jax_tool("parse_test_res")
    directory = seed_logs if "--multi-exp" in flags else osp.join(seed_logs, "expA")
    want = _stdout(jax_tool.main, [directory, *flags], monkeypatch, capsys)
    got = _stdout(parse_test_res.main, [directory, *flags], monkeypatch, capsys, as_argv=False)
    assert got == want and "* " in got


def test_parse_test_res_returns_the_seeds_and_the_summary(seed_logs):
    metric = parse_test_res.metric_regex("cindex")
    outputs = parse_test_res.collect(metric, directory=osp.join(seed_logs, "expA"),
                                     end_signal="Finish training")
    values = [o["cindex"] for o in outputs]
    assert values == [71.234, 65.5, 80.0]
    assert parse_test_res.summarize(outputs)["cindex"] == pytest.approx(
        (np.mean(values), np.std(values)))
    ci = parse_test_res.summarize(outputs, ci95=True)["cindex"][1]
    assert ci == pytest.approx(1.96 * np.std(values) / np.sqrt(3))


def _gdc_args(out):
    return ["--gdc-meta", osp.join(GDC, "metadata.cart.json"),
            "--gene-variance", osp.join(GDC, "gene_variance.csv"),
            "--origin-dir", osp.join(GDC, "origin"), "--feature-dir", osp.join(GDC, "features"),
            "--out-dir", out, "--top-k", str(GDC_TOP_K)]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


def test_transform_molecular_writes_the_jax_tools_bytes(tmp_path, monkeypatch, capsys):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _stdout(_jax_tool("transform_molecular").main, _gdc_args(jax_out), monkeypatch,
                   capsys)
    got = _stdout(transform_molecular.main, _gdc_args(port_out), monkeypatch, capsys,
                  as_argv=False)
    assert got.replace(port_out, "OUT") == want.replace(jax_out, "OUT")
    assert got.splitlines()[-1] == "total files: 3"
    _same_files(jax_out, port_out)
    _same_files(osp.join(GDC, "expected"), port_out)
    # the fixture holds each case the tool must get right
    text = open(osp.join(port_out, "TCGA-02-0001-01Z-00-DX1.csv")).read()
    assert "G00,12.5\n" in text and "G01,3.0\n" in text and "G05,\n" in text
    assert "G01,825\n" in open(osp.join(port_out, "TCGA-02-0002-01Z-00-DX1.csv")).read()


def test_transform_molecular_ranks_ties_as_pandas_not_stably():
    import pandas as pd

    df = pd.read_csv(osp.join(GDC, "gene_variance.csv"))
    ranked = df.sort_values(by="variance", ascending=False)
    stable = df.sort_values(by="variance", ascending=False, kind="stable")
    port = transform_molecular.top_variance_genes(osp.join(GDC, "gene_variance.csv"), GDC_TOP_K)
    assert port == ranked.head(GDC_TOP_K)["gene_name"].dropna().tolist()
    assert sorted(port) != sorted(stable.head(GDC_TOP_K)["gene_name"].dropna().tolist())


def test_transform_molecular_reads_numbers_as_pandas_does():
    import io

    import pandas as pd

    rng = np.random.default_rng(0)
    cells = ([f"{v:.4f}" for v in rng.random(2000) * 10.0 ** rng.integers(-2, 6, 2000)]
             + [repr(float(v)) for v in rng.random(2000) * 10.0 ** rng.integers(-300, 300, 2000)]
             + ["-0.0", "1e-320", "123456789012345678901234", "1.5E3", "+7", ".5", "inf"])
    want = pd.read_csv(io.StringIO("a\n" + "\n".join(cells) + "\n"))["a"].to_numpy()
    got = np.array([transform_molecular.parse_float(c) for c in cells])
    np.testing.assert_array_equal(got, want)
    assert transform_molecular.type_column(["3", "12"])[0] == "int"
    assert transform_molecular.type_column(["3", ""])[0] == "float"
    assert transform_molecular.type_column(["3", "x"])[0] == "text"


def test_gen_configs_writes_the_committed_configs(tmp_path, capsys):
    gen_configs.main(["--out-dir", str(tmp_path)])
    assert capsys.readouterr().out == "configs generated\n"
    written = sorted(osp.relpath(osp.join(d, f), tmp_path)
                     for d, _, fs in os.walk(tmp_path) for f in fs)
    assert len(written) == 52
    for rel in written:
        with open(osp.join(tmp_path, rel), "rb") as a, open(osp.join(REPO, "configs", rel),
                                                              "rb") as b:
            assert a.read() == b.read(), rel


@pytest.fixture
def quiet_runs(monkeypatch):
    """No TensorBoard, no matplotlib (slow imports), one torch thread."""
    import torch

    for name in ("matplotlib", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_method_runs_seeds_resumes_and_parses(tmp_path, quiet_runs, monkeypatch, capsys):
    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=8, bag_max=32, feat_dim=16,
                          num_genes=60, group_size=10, seed=0)
    monkeypatch.chdir(tmp_path)  # the tree goes to ./output, as the shell script's
    argv = ["Survival", "UMEML_GAN", "MBTRAIN", root, "--seeds", "1", "2",
            "DATASET.BAG_PAD", "32", "DATASET.PATH.DIM", "16", "MODEL.HIDDEN_DIM", "32",
            "MODEL.PROJECT_DIM", "32", "OPTIM.MAX_EPOCH", "1", "TPU.PREFETCH", "0",
            "VERBOSE", "False", "--device", "cpu"]
    first = run_method.main(argv)
    out = capsys.readouterr().out
    method_dir = osp.join("output", "Survival", "UMEML_GAN")
    assert sorted(os.listdir(method_dir)) == ["seed1", "seed2"]
    for seed in (1, 2):
        sdir = osp.join(method_dir, f"seed{seed}")
        assert {"log.txt", "model", "tensorboard"} <= set(os.listdir(sdir))
        assert open(osp.join(sdir, "model", "checkpoint")).read().strip() == "model.ckpt-1"
        assert "Finish training" in open(osp.join(sdir, "log.txt")).read()
    values = [first["results"][s] for s in (1, 2)]
    assert first["keyword"] == "cindex" and first["parsed"] == pytest.approx(values, abs=5e-3)
    mean, sd = first["summary"]["cindex"]
    assert f"* cindex: {mean:.2f}% +- {sd:.2f}%" in out
    assert mean == pytest.approx(np.mean(values), abs=5e-3)
    assert sd == pytest.approx(np.std(values), abs=5e-3)
    assert "(resuming)" not in out

    # a second call finds both seeds finished: it resumes them (no epoch
    # trained), tests again and reports the same values
    again = run_method.main(argv)
    out = capsys.readouterr().out
    assert out.count("(resuming)") == 2 and "epoch [1/1] batch" not in out
    assert [again["results"][s] for s in (1, 2)] == pytest.approx(values)
    assert again["summary"] == first["summary"]


def test_run_method_passes_on_what_it_does_not_know():
    args, extra = run_method.parse_args(["Grading", "UMEML", "MBTRAIN", "/data", "--seeds", "3",
                                         "4", "OPTIM.MAX_EPOCH", "2", "--eval-only"])
    assert args.seeds == [3, 4] and args.device == "cuda"
    assert extra == ["OPTIM.MAX_EPOCH", "2", "--eval-only"]
    argv = run_method.seed_argv(args, 3, extra)
    assert argv[argv.index("--output-dir") + 1] == osp.join("output", "Grading", "UMEML", "seed3")
    assert argv[argv.index("--config-file") + 1] == osp.join(REPO, "configs", "Grading",
                                                             "UMEML.yaml")
    assert argv[-3:] == extra and argv[argv.index("--device") + 1] == "cuda"


def test_quality_parity_compares_two_trees(tmp_path, capsys):
    jax_vals = [71.5, 64.25, 80.0, 58.75, 77.0]
    port_vals = [70.0, 66.5, 79.25, 61.0, 75.5]
    for side, vals in (("jax", jax_vals), ("torch", port_vals)):
        for i, v in enumerate(vals, 1):
            _log(str(tmp_path / side / f"seed{i}" / "log.txt"), "* cindex: 1.00%",
                 "Finish training", f"* cindex: {v:.2f}%")
    res = quality_parity.main(["--compare", str(tmp_path / "jax"), str(tmp_path / "torch")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "| fold | imp_tpu C-index | imp_torch C-index | delta |"
    assert out[2] == "| seed1 | 71.50 | 70.00 | -1.50 |"
    assert out[6] == "| seed5 | 77.00 | 75.50 | -1.50 |"
    j, t = np.array(jax_vals), np.array(port_vals)
    assert out[7] == (f"| **mean±sd** | {j.mean():.2f}±{j.std():.2f} | {t.mean():.2f}±{t.std():.2f} "
                      f"| {np.abs(t - j).mean():.2f} (mean abs) |")
    want = stats.ttest_ind(j, t, equal_var=False)
    assert res["p"] == pytest.approx(want.pvalue, rel=1e-12)
    assert res["t"] == pytest.approx(want.statistic, rel=1e-12)
    assert out[8] == f"Welch's t = {want.statistic:.4f}, p = {want.pvalue:.4f} over 5 folds a side"
    assert out[9].startswith(f"p = {want.pvalue:.4f} >= 0.05: no significant difference")
    assert "differ at alpha = 0.05" in quality_parity.verdict(0.01)


def test_quality_parity_prints_the_jax_protocols_command():
    args = quality_parity.build_parser().parse_args(["--run", "--task", "Grading", "--device",
                                                     "cpu", "--root", "data"])
    cmd = quality_parity.jax_command(args)
    assert cmd.startswith(f"bash scripts/run_method.sh Grading UMEML_GAN MBTRAIN "
                          f"{osp.abspath('data')} --platform cpu DATASET.BAG_PAD 64 ")
    assert ("OPTIM.MAX_EPOCH 8 TRAIN.CURRICULUM.GAN_START_EPOCH 3 "
            "TRAIN.CURRICULUM.REPLACE_START_EPOCH 5 TRAIN.CURRICULUM.CCA_EVERY_EPOCH True") in cmd


def test_the_new_modules_need_neither_jax_nor_pandas(tmp_path):
    """Import the six modules and run the ETL in a process where ``jax``,
    ``imp_tpu`` and ``pandas`` cannot be imported."""
    out = str(tmp_path / "etl")
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'imp_tpu', 'pandas', 'flax', 'optax'):",
        "    sys.modules[name] = None",
        "import importlib",
        f"for name in {NEW_MODULES!r}:",
        "    importlib.import_module('imp_torch.tools.' + name)",
        "from imp_torch.tools import transform_molecular",
        f"transform_molecular.main({_gdc_args(out)!r})",
        "assert not any(m.split('.')[0] in ('jax', 'pandas') for m in sys.modules"
        " if sys.modules[m] is not None)",
    ])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    _same_files(osp.join(GDC, "expected"), out)
