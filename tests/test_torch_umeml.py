"""UMEML, the fully-paired model, and its MBTRAIN path in the PyTorch port
against ``imp_tpu`` on the CPU.

Weights come from a JAX ``init`` of ``imp_tpu``'s UMEML and reach the port
through ``imp_torch.convert.umeml_state_dict``; the batch comes from the
port's loader of a synthetic tree.  Hidden 256, so the
TransLayers have 128 landmarks and the fused pseudo-inverse takes every
one of them (m = 128, the kernels' gate); 32 features, bags padded to 48,
60 genes, batch 3.  Dropout cannot share bits across the two frameworks,
so both sides run at rate 0: ``MODEL.DROPOUT 0`` and the TransLayers'
fixed 0.1 set to 0 (on the JAX side by binding ``dropout=0`` into the
``TransLayer`` its modules build, for the test only).

* the train forward's logits and ``modular_loss`` under both pinv modes to
  1e-5 (relative to the largest value), and the eval forward;
* one MBTRAIN step (the non-GAN path: one forward, task + modularity, one
  update) against a JAX step built as the JAX trainer's non-GAN
  ``train_step`` is (``imp_tpu/engine/mbtrain.py:270-288``: ``UMEML.apply``,
  the task loss, the optimizer of ``build_optimizer``), under both modes:
  the loss to 1e-5, every gradient to 1e-4 of its largest value (the
  Nyström pseudo-inverse amplifies rounding) and the updated parameters to
  rtol 1e-4 / atol 1e-6, except where Adam's first step e / (|e| + eps)
  turns float32 noise into a share of the step (|g + wd·p| < 1e-6 on
  either side, under 5 % of the entries here; see
  ``tests/test_torch_train.py::_ill_conditioned``), held to two
  learning-rate steps;
* a 2-epoch run of ``python -m imp_torch.tools.train --trainer MBTRAIN
  --config-file configs/Survival/UMEML.yaml`` at a tiny size, with resume:
  the twin of ``tests/test_train_e2e.py::test_mbtrain_umeml_nongan_survival``.
"""

import functools
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import optax
from flax.traverse_util import flatten_dict

import imp_tpu.models.layers as jlayers
import imp_tpu.models.umeml as jumeml
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_tpu.optim import build_optimizer as jax_build_optimizer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.models.umeml import UMEML
from imp_torch.ops.attention import NystromAttention

FEAT, BAG, GENES, BATCH, HIDDEN = 32, 48, 60, 3, 256
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(get_default, root, out):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs/Survival/UMEML.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TRAIN.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = BATCH
    cfg.MODEL.DROPOUT = 0.0
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.TPU.PREFETCH = 0
    return cfg


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("umemltree"))
    synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=0)
    return root


@pytest.fixture(scope="module")
def jax_step(tree, tmp_path_factory):
    """JAX's UMEML (TransLayer dropout 0) initialised by JAX, one train batch
    of the port's loader, and one step of the JAX trainer's non-GAN
    ``train_step`` body on it: the loss and outputs, the gradients and the
    updated parameters."""
    cfg = _cfg(get_cfg_default, tree, str(tmp_path_factory.mktemp("batch")))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    batch = next(iter(trainer.train_loader))
    db = {k: jnp.asarray(v.numpy()) for k, v in trainer._device_batch(batch).items()}
    jcfg = _cfg(jax_cfg_default, tree, "")
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jumeml, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    try:
        model = jax_build_model("umeml", cfg=jcfg, num_classes=4)
        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
        params = jax.jit(functools.partial(model.init, train=False))(rngs, db)
        task_loss = jax_task_loss(jcfg)
        main_tx = jax_build_optimizer(jcfg.OPTIM, max(1, len(trainer.train_loader)))

        @jax.jit
        def step(params, batch):  # imp_tpu/engine/mbtrain.py:270-288
            def loss_fn(p):
                out = model.apply(p, batch, train=True, rngs={"dropout": jax.random.PRNGKey(3)})
                return task_loss(out["logits"], batch) + out["modular_loss"], out

            (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = main_tx.update(grads, main_tx.init(params), params)
            return loss, out, grads, optax.apply_updates(params, updates)

        loss, out, grads, new_params = step(params, db)
    finally:
        mp.undo()
    return {"params": params, "batch": batch, "loss": float(loss), "out": out,
            "grads": grads, "new_params": new_params}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _port_trainer(tree, out, js, pinv_mode):
    """The port's MBTRAIN on the same tree with the JAX weights, TransLayer
    dropout 0, every Nyström pseudo-inverse in ``pinv_mode``."""
    cfg = _cfg(get_cfg_default, tree, out)
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    assert isinstance(trainer.model, UMEML) and not trainer.is_gan
    trainer.model.load_state_dict(umeml_state_dict(_flat(js["params"])), strict=True)
    nystrom = [m for m in trainer.model.modules() if isinstance(m, NystromAttention)]
    assert len(nystrom) == 6 and all(m.num_landmarks == 128 for m in nystrom)
    for m in nystrom:
        m.dropout, m.pinv_mode = 0.0, pinv_mode
    return trainer


@pytest.mark.parametrize("pinv_mode", ["chain", "fused"])
def test_umeml_forward_and_modular_loss_match_jax(tree, tmp_path, jax_step, pinv_mode):
    trainer = _port_trainer(tree, str(tmp_path), jax_step, pinv_mode)
    db = trainer._device_batch(jax_step["batch"])
    out = trainer.model(db, train=True, generator=trainer.generator)
    _close(out["logits"].detach(), jax_step["out"]["logits"], TOL, "logits")
    _close(out["modular_loss"].detach(), jax_step["out"]["modular_loss"], TOL, "modular_loss")
    assert abs(out["modular_loss"].item()) > 1e-3  # the loss is really there
    with torch.no_grad():  # at dropout 0 eval differs only by the loss
        ev = trainer.model(db)
    torch.testing.assert_close(ev["logits"], out["logits"].detach(), rtol=0, atol=0)
    assert ev["modular_loss"].item() == 0.0


@pytest.mark.parametrize("pinv_mode", ["chain", "fused"])
def test_one_mbtrain_step_matches_the_jax_trainer(tree, tmp_path, jax_step, pinv_mode):
    trainer = _port_trainer(tree, str(tmp_path), jax_step, pinv_mode)
    names = [n for n, _ in trainer.model.named_parameters()]
    assert trainer.main_params == list(trainer.model.parameters())
    assert list(trainer._optimizers()) == ["opt_state"]
    seen = {}
    step = trainer.main_opt.step
    trainer.main_opt.step = lambda grads: (seen.update(zip(names, grads)), step(grads))
    got = trainer.train_step(trainer._device_batch(jax_step["batch"]))
    np.testing.assert_allclose(got["loss"].item(), jax_step["loss"], rtol=TOL, atol=TOL)

    p0 = umeml_state_dict(_flat(jax_step["params"]))
    g_jax = umeml_state_dict(_flat(jax_step["grads"]))
    want = umeml_state_dict(_flat(jax_step["new_params"]))
    wd, lr = float(trainer.cfg.OPTIM.WEIGHT_DECAY), float(trainer.cfg.OPTIM.WARMUP_CONS_LR)
    new = trainer.model.state_dict()
    n_ill = 0
    for k, w in want.items():
        _close(seen[k], g_jax[k], GRAD_TOL, f"gradient {k}")
        e_jax, e_port = g_jax[k] + wd * p0[k], seen[k] + wd * p0[k]
        ill = (((e_jax.abs() < 1e-6) | (e_port.abs() < 1e-6)) & ~((e_jax == 0) & (e_port == 0))).numpy()
        n_ill += int(ill.sum())
        g, w = new[k].numpy(), w.numpy()
        np.testing.assert_allclose(g[~ill], w[~ill], rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(g - w)[ill] <= 2 * lr), k
        assert not np.array_equal(g, p0[k].numpy()), f"{k} did not move"
    assert n_ill < 0.05 * sum(v.numel() for v in want.values())


def test_umeml_trains_through_the_cli_checkpoints_and_resumes(tree, tmp_path, capsys,
                                                             monkeypatch):
    from imp_torch.tools.train import run

    # the metric writer's JSONL alone: importing TensorBoard (and TensorFlow
    # with it) can take longer than the whole run
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "out")
    flags = ["--root", tree, "--seed", "1", "--trainer", "MBTRAIN", "--device", "cpu",
             "--config-file", osp.join(REPO, "configs/Survival/UMEML.yaml"), "--output-dir", out]
    opts = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT), "MODEL.HIDDEN_DIM", "64",
            "DATALOADER.TRAIN.BATCH_SIZE", "4", "OPTIM.MAX_EPOCH", "2",
            "TRAIN.CHECKPOINT_FREQ", "1", "TPU.PREFETCH", "0", "VERBOSE", "False"]
    first = run(flags + opts)
    log = capsys.readouterr().out
    assert "epoch [1/2]" in log and "epoch [2/2]" in log and "gan=False rr=0.000" in log
    assert "CCA" not in log and "* cindex:" in log
    assert osp.getsize(osp.join(out, "tensorboard", "scalars.jsonl")) > 0
    mdir = osp.join(out, "model")
    ckpt = torch.load(osp.join(mdir, "model.ckpt-1"), weights_only=True)
    assert ckpt["epoch"] == 1 and set(ckpt) == {"model", "opt_state", "epoch", "val_result"}
    assert open(osp.join(mdir, "checkpoint")).read().strip() == "model.ckpt-2"

    # point at epoch 1 and run again: it resumes there and trains epoch 2 only
    with open(osp.join(mdir, "checkpoint"), "w") as f:
        f.write("model.ckpt-1")
    second = run(flags + opts)
    log = capsys.readouterr().out
    assert "resume at epoch 1" in log and "epoch [2/2]" in log and "epoch [1/2]" not in log
    for r in (first, second):
        assert 0.0 <= r <= 100.0
