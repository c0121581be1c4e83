"""The zoo's trainers in the PyTorch port, the twins of
``tests/test_fusion_baselines.py``, against ``imp_tpu`` on the CPU.

* one epoch of each of the eight zoo trainers (MCAT, CMTA, Porpoise,
  ConCAT, ADD, HFB, SNN, SNNM) through ``python -m imp_torch.tools.train
  --device cpu``, with a finite C-index and the epoch's checkpoint;
* MCAT's default ``OPTIM.GRAD_ACCUM`` of 32, and a config's own value kept;
* one ``StandardTrainer`` step of CMTA against JAX's: in
  ``tests/test_torch_zoo_cmta_step.py``, a file of its own so that each
  stays well under a minute;
* the ``MultiSteps`` optimizer against ``optax.MultiSteps`` over 7 steps at
  k = 3 with 2 updates per epoch (so across an epoch boundary of the
  schedule), through a checkpoint reload in the middle of an accumulation:
  the parameters, the running mean, the mini-step and the update count;
* HFB's BatchNorm buffers after one train step against JAX's
  ``batch_stats`` to 1e-6, and the eval logits after it;
* every one of the 49 configs that does not name CLIPOMIC builds a port
  trainer, and the 4 CLIPOMIC configs raise the deferral naming item 7.
"""

import glob
import io
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.data import synthetic
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.optim import build_optimizer as jax_build_optimizer
from imp_torch.config import get_cfg_default
from imp_torch.convert import zoo_state_dict
from imp_torch.engine import build_trainer
from imp_torch.optim import build_optimizer
from imp_torch.tools.train import run

from test_torch_zoo import _flat, no_dropout

__all__ = ["no_dropout"]  # a fixture of this file

FEAT, BAG, GENES = 32, 36, 1000
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ZOO = ["MCAT", "CMTA", "Porpoise", "ConCAT", "ADD", "HFB", "SNN", "SNNM"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zootree"))
    synthetic.materialize(root, num_slides=18, bag_min=16, bag_max=32, feat_dim=FEAT,
                          num_genes=GENES, group_size=30, seed=0)
    return root


def _small(cfg, root, out, trainer):
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.TRAINER.NAME = trainer
    cfg.TPU.PREFETCH = 0
    return cfg


def zoo_cfg(get_default, root, out, trainer, task="Survival"):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs", task, f"{trainer}.yaml"))
    return _small(cfg, root, out, trainer)


@pytest.mark.parametrize("trainer", ZOO)
def test_zoo_trainer_one_epoch_through_the_cli(tree, tmp_path, capsys, monkeypatch, trainer):
    # the metric writer's JSONL alone: importing TensorBoard (and TensorFlow
    # with it) can take longer than the whole run
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "out")
    result = run(["--root", tree, "--seed", "1", "--trainer", trainer, "--device", "cpu",
                  "--config-file", osp.join(REPO, "configs/Survival", f"{trainer}.yaml"),
                  "--output-dir", out, "DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM",
                  str(FEAT), "DATALOADER.TRAIN.BATCH_SIZE", "3", "DATALOADER.TEST.BATCH_SIZE",
                  "3", "OPTIM.MAX_EPOCH", "1", "TPU.PREFETCH", "0"])
    log = capsys.readouterr().out
    assert result is not None and np.isfinite(result) and "* C-Index:" in log
    state = torch.load(osp.join(out, "model", "model.ckpt-1"), weights_only=True)
    assert state["epoch"] == 1 and set(state) >= {"model", "opt_state"}


def test_mcat_accumulates_32_steps_by_default(tree, tmp_path):
    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "a"), "MCAT")
    assert build_trainer(cfg, device="cpu").cfg.OPTIM.GRAD_ACCUM == 32
    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "b"), "MCAT")
    cfg.OPTIM.GRAD_ACCUM = 4
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.cfg.OPTIM.GRAD_ACCUM == 4 and trainer.optimizer.tx.every_k == 4


def jax_trainer(tree, out, trainer, **overrides):
    cfg = zoo_cfg(jax_cfg_default, tree, out, trainer)
    cfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows in the loss
    for key, value in overrides.items():
        setattr(cfg.DATALOADER.TRAIN, key, value)
    return jax_build_trainer(cfg)


def test_multisteps_matches_optax_across_an_epoch_and_a_reload():
    cfg = get_cfg_default()
    cfg.merge_from_file(osp.join(REPO, "configs/Survival/MCAT.yaml"))
    cfg.OPTIM.MAX_EPOCH, cfg.OPTIM.LR = 4, 1e-2  # warmup, then a cosine over 3 epochs
    k, updates_per_epoch = 3, 2  # 4 batches an epoch: ceil(4 / 3) updates
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (2, 4)]
    p_np = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(7)]

    tx = optax.MultiSteps(jax_build_optimizer(cfg.OPTIM, updates_per_epoch), k)
    jp = [jnp.asarray(p) for p in p_np]
    jstate = tx.init(jp)
    params = [torch.tensor(p) for p in p_np]
    opt = build_optimizer(cfg.OPTIM, params, updates_per_epoch, grad_accum=k)
    for i, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        if i == 4:  # mid-accumulation (mini-step 2 of 3): save, rebuild, reload
            buf = io.BytesIO()
            torch.save(opt.state_dict(), buf)
            opt = build_optimizer(cfg.OPTIM, params, updates_per_epoch, grad_accum=k)
            opt.load_state_dict(torch.load(io.BytesIO(buf.getvalue()), weights_only=True))
        before = [p.clone() for p in params]
        opt.step([torch.tensor(x) for x in g])
        emitted = (i + 1) % k == 0
        assert all(torch.equal(a, b) for a, b in zip(before, params)) != emitted, i
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
        assert opt.state["mini_step"] == int(jstate.mini_step)
        assert opt.updates == int(jstate.gradient_step) == (i + 1) // k
        for a, b in zip(opt.state["acc"], jstate.acc_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_hfb_batch_statistics_after_one_step_match_jax(tree, tmp_path, no_dropout):
    jtrainer = jax_trainer(tree, str(tmp_path / "jax"), "HFB", BATCH_SIZE=3)
    variables = {"params": jax.tree_util.tree_map(np.asarray, jtrainer.params["params"]),
                 **jax.tree_util.tree_map(np.asarray, jtrainer.model_state)}
    batch = next(iter(jtrainer.train_loader))
    jtrainer.train_step(batch)
    eval_batch = next(iter(jtrainer.test_loader))
    want_logits = np.asarray(jtrainer.eval_logits(eval_batch, "test", 0))
    want = zoo_state_dict(_flat({**jtrainer.params, **jtrainer.model_state}))

    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "port"), "HFB")
    cfg.DATALOADER.TRAIN.BATCH_SIZE = 3
    trainer = build_trainer(cfg, device="cpu")
    trainer.model.load_state_dict(zoo_state_dict(_flat(variables)), strict=True)
    trainer.train_step(trainer._device_batch(batch))
    got = trainer.model.state_dict()
    for key in ("fusion_module.norm.running_mean", "fusion_module.norm.running_var"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert not torch.equal(got["fusion_module.norm.running_var"], torch.ones(384))
    with torch.no_grad():
        logits = trainer.model(trainer._device_batch(eval_batch))["logits"]
    np.testing.assert_allclose(logits.numpy(), want_logits[: len(logits)], rtol=1e-4, atol=1e-4)


def _configs():
    return sorted(glob.glob(osp.join(REPO, "configs", "*", "*.yaml")))


def test_every_config_but_clipomic_builds_a_port_trainer(tree, tmp_path):
    built, deferred = [], []
    for i, path in enumerate(_configs()):
        cfg = get_cfg_default()
        cfg.merge_from_file(path)
        name = osp.splitext(osp.basename(path))[0]
        trainer = "MBTRAIN" if name.startswith("UMEML") else name
        _small(cfg, tree, str(tmp_path / str(i)), trainer)
        if trainer == "CLIPOMIC":
            with pytest.raises(NotImplementedError, match="item 7"):
                build_trainer(cfg, device="cpu")
            deferred.append(path)
        else:
            assert build_trainer(cfg, device="cpu").model is not None, path
            built.append(path)
    assert len(built) == 49 and len(deferred) == 4
