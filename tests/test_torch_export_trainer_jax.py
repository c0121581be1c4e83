"""Served outputs of the PyTorch port against the JAX package's, both
exported from a trainer: ``imp_tpu.serving.export_trainer`` → ``load_model``
→ ``predict_many`` beside ``imp_torch.serving.export_trainer`` → the
port's ``load_model`` → ``predict_many``, on the same synthetic root, the
JAX trainer's weights carried by ``imp_torch.convert`` and the same ragged
request (5 slides, so both chunk it at the exported batch of 3).

This file: MBTRAIN's UMEML_GAN at Survival and Classification (bilinear).
``tests/test_torch_export_trainer_unimodal.py``: TransMIL under flash and
Nyström, ABMIL, SNN; ``tests/test_torch_export_trainer_fusion.py``: HFB
(its BatchNorm statistics) and CMTA (files of their own, so that each stays
well under a minute).  Every output within 1e-4 (float32 on both sides,
different summation orders)."""

import os.path as osp

import flax.linen
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.ops.attention as jattn
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.serving import export_trainer as jax_export_trainer
from imp_tpu.serving import load_model as jax_load_model
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.serving import export_trainer, load_model

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FEAT, BAG, GENES = 32, 36, 1000
TOL = 1e-4
LENGTHS = (5, 36, 50, 1, 20)  # 50 > BAG: truncated by both hosts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("servetree"))
    synthetic.materialize(root, num_slides=15, bag_min=8, bag_max=40, feat_dim=FEAT,
                          num_genes=GENES, group_size=30, seed=0)
    return root


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(jax.device_get(tree)).items()}


def small_cfg(get_default, root, out, trainer, config, task="Survival", opts=()):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs", task, f"{config}.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TEST.BATCH_SIZE = 3
    cfg.TRAINER.NAME = trainer
    cfg.TPU.PREFETCH = 0
    cfg.TPU.MESH_SHAPE = (1,)  # the JAX export refuses a mesh of several devices
    cfg.merge_from_list(list(opts))
    return cfg


def request(with_omics: bool, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"img": [rng.normal(size=(n, FEAT)).astype(np.float32) for n in LENGTHS]}
    if with_omics:
        batch["mol"] = rng.lognormal(size=(len(LENGTHS), GENES)).astype(np.float32)
        batch["without_omic"] = np.array([0, 1, 0, 0, 1], np.float32)
    return batch


def served_pair(tree, tmp_path, trainer, config, state_dict, task="Survival", opts=(),
                with_omics=True):
    """(JAX outputs, port outputs, JAX manifest, port manifest) for the same
    request through each package's export of the same trainer."""
    mp = pytest.MonkeyPatch()
    # the JAX trainer sets its process-wide TransLayer default from
    # TPU.ATTENTION; the old value comes back after
    mp.setattr(jattn, "_DEFAULT_ATTENTION_IMPL", jattn._DEFAULT_ATTENTION_IMPL)
    init = flax.linen.Module.init  # compiled: run op by op it takes many seconds

    def jit_init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, method=method, **kw))(rngs, *args)

    mp.setattr(flax.linen.Module, "init", jit_init)
    try:
        jtr = jax_build_trainer(small_cfg(jax_cfg_default, tree, str(tmp_path / "jax"), trainer,
                                          config, task, opts))
        jmanifest = jax_export_trainer(jtr, str(tmp_path / "jax_art"))
        want = jax_load_model(str(tmp_path / "jax_art")).predict_many(request(with_omics))
    finally:
        mp.undo()
    params = jtr.state["params"] if trainer == "MBTRAIN" else {**jtr.params, **jtr.model_state}

    cfg = small_cfg(get_cfg_default, tree, str(tmp_path / "port"), trainer, config, task, opts)
    cfg.freeze()
    tr = build_trainer(cfg, device="cpu")
    tr.model.load_state_dict(state_dict(flat(params)), strict=True)
    manifest = export_trainer(tr, str(tmp_path / "port_art"))
    got = load_model(str(tmp_path / "port_art"), device="cpu").predict_many(request(with_omics))
    return want, got, jmanifest, manifest


def check(want, got, jmanifest, manifest):
    assert manifest["kind"] == jmanifest["kind"] and manifest["outputs"] == jmanifest["outputs"]
    assert manifest["batch_size"] == jmanifest["batch_size"] == 3
    assert manifest["batch_keys"].keys() == jmanifest["batch_keys"].keys()
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].shape[0] == len(LENGTHS)
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("task", ["Survival", "Classification"])
def test_umeml_gan_serves_as_jax_does(tree, tmp_path, task):
    out = served_pair(tree, tmp_path, "MBTRAIN", "UMEML_GAN", umeml_gan_state_dict, task,
                      ("MODEL.HIDDEN_DIM", "64"))
    check(*out)
    assert out[2]["kind"] == "mbtrain" and out[1]["logits"].shape[1] == (
        4 if task == "Survival" else 6)
