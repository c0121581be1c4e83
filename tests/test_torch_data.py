"""The port's framework-free pieces against ``imp_tpu`` on the CPU: the
synthetic tree, the data pipeline (stdlib ``csv`` in place of pandas), the
survival evaluator and the native C-index.

Both packages materialise a tree from the same seed; each package's
DataManager then reads the other's tree, and the batches, gene groups and
omic means must be identical (exact: the same numbers pass through the same
float32 conversions); the float64 survival baselines agree to 1e-15.  The evaluator and the C-index
run in float64 on both sides: 1e-12.
"""

import numpy as np
import pytest

from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.data import DataManager as JaxDataManager
from imp_tpu.data import synthetic as jax_synthetic
from imp_tpu.evaluation import build_evaluator as jax_build_evaluator
from imp_tpu.evaluation.survival_metrics import _weighted_concordance as jax_concordance
from imp_torch.config import get_cfg_default
from imp_torch.data import DataManager, synthetic
from imp_torch.evaluation import build_evaluator
from imp_torch.evaluation.survival_metrics import _weighted_concordance
from imp_torch.native import native_weighted_concordance


def _cfg(get_default, root):
    cfg = get_default()
    cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = "TCGA_Glioma_S_UMEML"
    cfg.DATASET.FEATURE_NAME = "features_clip_vit_b16"
    cfg.DATASET.BAG_PAD = 48
    cfg.DATASET.FOLD = 2
    cfg.TASK.NAME = "Survival"
    cfg.TEST.EVALUATOR = "Survival_UMEML"
    cfg.DATALOADER.TRAIN.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 3
    cfg.TPU.PREFETCH = 0
    cfg.SEED = 3
    return cfg


def _tree(tmp_path_factory, materialize, name):
    root = str(tmp_path_factory.mktemp(name))
    materialize(root, num_slides=15, bag_min=10, bag_max=60, feat_dim=8, num_genes=48,
                group_size=7, seed=5)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return (_tree(tmp_path_factory, jax_synthetic.materialize, "jax_tree"),
            _tree(tmp_path_factory, synthetic.materialize, "port_tree"))


@pytest.mark.parametrize("which", [0, 1], ids=["jax_tree", "port_tree"])
def test_data_manager_matches_jax(trees, which):
    root = trees[which]
    want = JaxDataManager(_cfg(jax_cfg_default, root))
    got = DataManager(_cfg(get_cfg_default, root))
    assert got.gene_group_indexes == want.gene_group_indexes
    assert got.omic_dim == want.omic_dim and got.num_classes == want.num_classes
    np.testing.assert_array_equal(got.compute_omic_means(), want.compute_omic_means())
    # float64 event times: pandas' fast CSV float parser may sit one ulp from
    # Python's correctly rounded float()
    for a, b in zip(got.train_set.get_event_and_censorship(), want.train_set.get_event_and_censorship()):
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)
    for loader in ("train_loader", "test_loader"):
        gl, wl = getattr(got, loader), getattr(want, loader)
        gl.set_epoch(1)
        wl.set_epoch(1)
        assert len(gl) == len(wl)
        for gb, wb in zip(gl, wl):
            assert gb.keys() == wb.keys()
            for k in wb:
                if k == "patient_id":
                    assert gb[k] == wb[k]
                else:
                    assert gb[k].dtype == wb[k].dtype, k
                    np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_port_tree_equals_jax_tree(trees):
    """Same seed, same numbers: every label and molecular value agrees."""
    jax_root, port_root = trees
    a = DataManager(_cfg(get_cfg_default, jax_root))
    b = DataManager(_cfg(get_cfg_default, port_root))
    for sa, sb in ((a.train_set, b.train_set), (a.test_set, b.test_set)):
        assert [d.patientid for d in sa.data_source] == [d.patientid for d in sb.data_source]
        for i in range(len(sa)):
            x, y = sa[i], sb[i]
            for k in ("img", "img_mask", "mol", "label", "survival_month", "censorship"):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_survival_evaluator_and_cindex_match_jax(trees):
    rng = np.random.default_rng(0)
    n = 40
    logits = rng.normal(size=(n, 4))
    cens = (rng.random(n) < 0.3).astype(np.float32)
    months = rng.uniform(1, 60, size=n).astype(np.float32)
    months[5] = months[6]  # a tie in time
    ids = [f"P{i}" for i in range(n)]
    train_surv = ((rng.random(30) < 0.7), rng.uniform(0.5, 70, size=30))
    results = []
    for build, cfg in ((jax_build_evaluator, _cfg(jax_cfg_default, trees[0])),
                       (build_evaluator, _cfg(get_cfg_default, trees[0]))):
        ev = build(cfg, all_survival=train_surv, bins=None)
        for s in range(0, n, 8):
            ev.process(ids[s:s + 8], logits[s:s + 8], cens[s:s + 8], months[s:s + 8])
        results.append(ev.evaluate())
    assert results[0].keys() == results[1].keys()
    for k in results[0]:
        assert results[1][k] == pytest.approx(results[0][k], rel=1e-12, abs=1e-12)

    event = rng.random(300) < 0.6
    time = rng.integers(1, 50, size=300).astype(np.float64)
    est, w = rng.normal(size=300), rng.uniform(0.5, 2, size=300)
    want = jax_concordance(event, time, est, w)
    assert _weighted_concordance(event, time, est, w) == pytest.approx(want, rel=1e-12)
    native = native_weighted_concordance(event, time, est, w)
    if native is not None:  # built with the host C compiler when one exists
        assert native == pytest.approx(want, rel=1e-12)
