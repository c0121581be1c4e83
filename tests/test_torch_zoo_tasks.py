"""The zoo's eight trainers of the PyTorch port, and CLIPOMIC (its text
tower at the sizes of ``tests/test_clipomic.py``), on the other three tasks of
the paper (Classification with 6 classes, Grading and Subtyping with 3):
one epoch each through ``python -m imp_torch.tools.train --device cpu`` on
its ``configs/<Task>/<Trainer>.yaml``, the ``* accuracy`` block in the log,
and a strict reload of the epoch's checkpoint (moved from the init) into a
freshly built net, whose eval logits are finite with a column per class
(MCAT at ``OPTIM.GRAD_ACCUM 2``, so that its epoch updates).  The tree and
sizes are those of ``tests/test_torch_zoo_trainers.py`` (1 000 genes, bags
of 16-32 patches padded to 36, 32 features), in a file of their own so
that each file stays well under a minute.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

from imp_torch.config import get_cfg_default
from imp_torch.engine import build_trainer
from imp_torch.tools.train import run

from test_torch_zoo_trainers import (BAG, FEAT, REPO, TEXT_OPTS, ZOO, one_torch_thread, tree,
                                     zoo_cfg)

__all__ = ["one_torch_thread", "tree"]  # fixtures of this file

CLASSES = {"Classification": 6, "Grading": 3, "Subtyping": 3}


@pytest.mark.parametrize("task", list(CLASSES))
@pytest.mark.parametrize("trainer", ZOO + ["CLIPOMIC"])
def test_zoo_trainer_trains_and_reloads_at_the_task(tree, tmp_path, capsys, monkeypatch, trainer,
                                                    task):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL metrics only
    out = str(tmp_path / "out")
    result = run(["--root", tree, "--seed", "1", "--trainer", trainer, "--device", "cpu",
                  "--config-file", osp.join(REPO, "configs", task, f"{trainer}.yaml"),
                  "--output-dir", out, "DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM",
                  str(FEAT), "DATALOADER.TRAIN.BATCH_SIZE", "3", "DATALOADER.TEST.BATCH_SIZE",
                  "3", "OPTIM.MAX_EPOCH", "1", "TPU.PREFETCH", "0", "OPTIM.GRAD_ACCUM",
                  "2" if trainer == "MCAT" else "1", *TEXT_OPTS])
    log = capsys.readouterr().out
    assert result is not None and np.isfinite(result) and "* accuracy:" in log

    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "fresh"), trainer, task)
    fresh = build_trainer(cfg, device="cpu")
    assert fresh.model.classifier.out_features == CLASSES[task]
    init = fresh.model.state_dict()
    state = torch.load(osp.join(out, "model", "model.ckpt-1"), weights_only=True)
    assert any(not torch.equal(init[k], v) for k, v in state["model"].items())
    fresh.model.load_state_dict(state["model"], strict=True)
    db = fresh._device_batch(next(iter(fresh.test_loader)))
    with torch.no_grad():
        logits = fresh.model(db)
        logits = logits["logits"] if isinstance(logits, dict) else logits
    assert logits.shape == (len(db["label"]), CLASSES[task]) and torch.isfinite(logits).all()
