"""The external-cohort (CPTAC) evaluation of the PyTorch port against
``imp_tpu`` on the CPU, and the serving of a Classification export.

A synthetic external tree under ``<root>/test/``: label CSVs for Grading and
Survival over 7 patients, 6 of them with an .h5 bag (the seventh is left
out by both readers) and 2 of those without a molecular CSV.

* ``imp_torch.data.external`` reads the tree to the same items as
  ``imp_tpu.data.external`` (exact: bags, masks, omics, labels, the
  ``without_omic`` flags and the survival fields);
* ``MBTRAIN.test_new`` of a Grading UMEML_GAN (bilinear fusion, hidden 64)
  on weights of the JAX trainer carried by ``imp_torch.convert``, with the
  seed-42 sample ablation and in-sample deletion on: every metric of the
  evaluator and every row of ``test_new_{path,omic}.txt`` against the JAX
  trainer's ``test_new`` (1e-5), the slides without omics served through
  the generator;
* ``python -m imp_torch.tools.test_new --device cpu`` after a one-epoch
  ``imp_torch.tools.train`` run;
* a Classification UMEML_GAN (bilinear) export: it loads, ``predict``
  gives the model's own logits and importances, and ``risk`` is refused.
"""

import csv
import os
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.umeml_gan as jug
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.data.external import build_test_new as jax_build_test_new
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.data import synthetic
from imp_torch.data.external import build_test_new
from imp_torch.engine import build_trainer
from imp_torch.models import build_model
from imp_torch.serving import (
    even_gene_groups,
    export_model,
    load_model,
    mbtrain_batch_template,
    rebuild_model,
)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FEAT, BAG, GENES, HIDDEN = 32, 40, 60, 64
N_EXT, NO_BAG, NO_OMICS = 7, 3, (1, 4)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic TCGA tree plus an external cohort under ``test/``."""
    import h5py

    root = str(tmp_path_factory.mktemp("exttree"))
    synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=0)
    ext = osp.join(root, "test")
    for sub in ("labels/grading", "labels/survival", "features_clip_vit_b16", "molecular"):
        os.makedirs(osp.join(ext, sub), exist_ok=True)
    rng = np.random.default_rng(4)
    grading, survival = [], []
    for i in range(N_EXT):
        pid = f"C3L-{i:05d}"
        if i != NO_BAG:
            with h5py.File(osp.join(ext, "features_clip_vit_b16", pid + ".h5"), "w") as f:
                f.create_dataset("clip_vit_b32_feature",
                                 data=rng.normal(size=(int(rng.integers(3, BAG + 9)), FEAT))
                                 .astype(np.float32))
        if i not in NO_OMICS:
            _write_csv(osp.join(ext, "molecular", pid + ".csv"), ["gene_name", "fpkm_uq_unstranded"],
                       [[f"GENE{g}", repr(float(v))]
                        for g, v in enumerate(rng.lognormal(size=GENES).astype(np.float32))])
        grading.append([f" {pid}", i % 3])
        survival.append([pid, i % 4, repr(10.0 + 7.5 * i), i % 2])
    _write_csv(osp.join(ext, "labels/grading/grading_test.csv"), ["patients", "labels"], grading)
    _write_csv(osp.join(ext, "labels/survival/survival_test.csv"),
               ["patients", "labels", "survival_months", "censorship"], survival)
    return root


def _cfg(get_default, task, root, out=""):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs", task, "UMEML_GAN.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TRAIN.BATCH_SIZE, cfg.DATALOADER.TEST.BATCH_SIZE = 4, 4
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.TPU.PREFETCH = 0
    return cfg


@pytest.mark.parametrize("task", ["Grading", "Survival"])
def test_external_items_match_jax(tree, task):
    _, loader = build_test_new(_cfg(get_cfg_default, task, tree), omic_dim=GENES)
    _, jloader = jax_build_test_new(_cfg(jax_cfg_default, task, tree), omic_dim=GENES)
    got, want = loader.dataset, jloader.dataset
    assert len(got) == len(want) == N_EXT - 1
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w), i
        for k in w:
            if k == "patient_id":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    flags = [got[i]["without_omic"] for i in range(len(got))]
    assert flags == [1.0 if i in NO_OMICS else 0.0 for i in range(N_EXT) if i != NO_BAG]
    assert not got[1]["mol"].any()


@pytest.fixture(scope="module")
def jax_test_new(tree, tmp_path_factory):
    """The JAX trainer's ``test_new`` of an initialised Grading UMEML_GAN:
    its params, metrics and importance rows."""
    out = str(tmp_path_factory.mktemp("jax_out"))
    jcfg = _cfg(jax_cfg_default, "Grading", tree, out)
    jcfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows
    # the trainer's init, compiled: run op by op it takes most of a minute
    init = jug.UMEML_GAN.init

    def jit_init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, method=method, **kw))(rngs, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(jug.UMEML_GAN, "init", jit_init)
    try:
        trainer = jax_build_trainer(jcfg)
    finally:
        mp.undo()
    result = trainer.test_new(jcfg, umeml_gan_test_without_omic_ratio=0.4,
                              umeml_gan_test_insample_without_omic_ratio=0.2)
    metrics = trainer.evaluator.evaluate()
    rows = {m: np.loadtxt(osp.join(out, f"test_new_{m}.txt")) for m in ("path", "omic")}
    params = {"/".join(k): np.asarray(v)
              for k, v in flatten_dict(jax.device_get(trainer.state["params"])).items()}
    return params, result, metrics, rows


def test_test_new_matches_the_jax_trainer(tree, tmp_path, jax_test_new, capsys):
    params, want_result, want, want_rows = jax_test_new
    cfg = _cfg(get_cfg_default, "Grading", tree, str(tmp_path))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    trainer.model.load_state_dict(umeml_gan_state_dict(params), strict=True)
    served = []
    forward = trainer.model.forward
    trainer.model.forward = lambda b, **kw: (served.append(b["without_omic"].clone()),
                                             forward(b, **kw))[1]
    result = trainer.test_new(cfg, umeml_gan_test_without_omic_ratio=0.4,
                              umeml_gan_test_insample_without_omic_ratio=0.2)
    log = capsys.readouterr().out
    assert "Evaluate on the *external test* set (6 samples)" in log and "* accuracy:" in log
    got = trainer.evaluator.evaluate()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, equal_nan=True, err_msg=k)
    assert result == pytest.approx(want_result, abs=TOL)
    for m in ("path", "omic"):
        rows = np.loadtxt(tmp_path / f"test_new_{m}.txt")
        assert rows.shape == (N_EXT - 1, cfg.MODEL.UMEML.PROTOTYPES)
        np.testing.assert_allclose(rows, want_rows[m], rtol=TOL, atol=TOL, err_msg=m)
    # the slides without omics (rows 1 and 3 of the cohort) always use the generator
    without = torch.cat(served).numpy()
    assert without[1] == without[3] == 1.0 and 0 < without.sum() < len(without)


def test_test_new_cli_runs_on_the_cpu(tree, tmp_path, capsys, monkeypatch):
    from imp_torch.tools.test_new import run as run_test_new
    from imp_torch.tools.train import run as run_train

    # the metric writer's JSONL alone: importing TensorBoard can take longer than the run
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    train_out, ext_out = str(tmp_path / "train"), str(tmp_path / "ext")
    common = ["--root", tree, "--seed", "1", "--trainer", "MBTRAIN", "--device", "cpu",
              "--config-file", osp.join(REPO, "configs/Grading/UMEML_GAN.yaml")]
    opts = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT), "MODEL.HIDDEN_DIM",
            str(HIDDEN), "DATALOADER.TRAIN.BATCH_SIZE", "4", "OPTIM.MAX_EPOCH", "1",
            "TPU.PREFETCH", "0", "VERBOSE", "False"]
    run_train(common + ["--output-dir", train_out] + opts)
    capsys.readouterr()
    result = run_test_new(common + ["--model-dir", train_out, "--output-dir", ext_out] + opts)
    log = capsys.readouterr().out
    assert "Loaded model weights from" in log and "* accuracy:" in log and "* macro_f1:" in log
    assert 0.0 <= result <= 100.0
    for m in ("path", "omic"):
        assert np.loadtxt(osp.join(ext_out, f"test_new_{m}.txt")).shape == (N_EXT - 1, 6)
    # training wrote the splits' importance rows too
    for split in ("train", "val", "test"):
        assert osp.getsize(osp.join(train_out, f"{split}_path.txt")) > 0


def test_classification_export_loads_predicts_and_refuses_risk(tmp_path):
    cfg = _cfg(get_cfg_default, "Classification", "")
    cfg.DATASET.OMIC.DIM = GENES
    cfg.freeze()
    groups = even_gene_groups(GENES, 6)
    model = build_model("umeml_gan", cfg=cfg, num_classes=6, gene_group_indexes=groups,
                        device="cpu", generator=torch.Generator().manual_seed(3))
    assert model.fusion == "bilinear"
    template = mbtrain_batch_template(cfg, 2, GENES)
    omic_means = np.random.default_rng(1).lognormal(size=GENES).astype(np.float32)
    manifest = export_model(model, cfg, template, str(tmp_path), omic_means)
    assert manifest["task"] == "Classification" and manifest["num_classes"] == 6

    served = load_model(str(tmp_path), device="cpu")
    assert rebuild_model(str(tmp_path), device="cpu").fusion == "bilinear"
    rng = np.random.default_rng(2)
    slides = {"img": [rng.normal(size=(n, FEAT)).astype(np.float32) for n in (30, 7)],
              "mol": rng.lognormal(size=(2, GENES)).astype(np.float32),
              "without_omic": np.array([0.0, 1.0], np.float32)}
    got = served.predict(slides)
    img, mask = served._pad_bags(slides["img"])
    batch = {"img": img, "img_mask": mask, "mol": slides["mol"],
             "without_omic": slides["without_omic"],
             "insample_without_omic": np.zeros((2, GENES), np.int32), "omic_means": omic_means}
    with torch.no_grad():
        want = model({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert got["logits"].shape == (2, 6)
    for key in ("logits", "importance_path", "importance_omic"):
        np.testing.assert_allclose(got[key], want[key].numpy(), rtol=0, atol=0, err_msg=key)
    with pytest.raises(ValueError, match="only defined for survival"):
        served.predict_risk(slides)
