"""Trainer engine — the PyTorch counterpart of ``imp_tpu/engine/trainer.py``
(reference ``medmm/engine/trainer.py``): the epoch loop's hooks, val
selection, best/last checkpoints and the ``* metric: X%`` log lines
``tools/parse_test_res.py`` scrapes.  The port's one trainer is MBTRAIN
(survival, ``Survival_UMEML``); its epoch loop is ``MBTRAIN.train``.

One process drives one device (``cuda`` unless the caller passes
``device="cpu"``); the JAX package's mesh, sequence parallelism and device
bag cache have no counterpart here yet.  Randomness comes from one
``torch.Generator`` on the device, seeded from ``cfg.SEED``.
"""

from __future__ import annotations

import datetime
import os.path as osp
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data import DataManager
from ..evaluation import build_evaluator
from ..losses.survival import build_loss, hazards_to_survival
from ..optim import lr_at_epoch
from ..utils.checkpoint import (
    best_checkpoint_path,
    load_checkpoint,
    resume_from_checkpoint,
    save_checkpoint,
)
from ..utils.logger import MetricWriter, mkdir_if_missing

ARRAY_KEYS = (
    "img",
    "img_mask",
    "mol",
    "label",
    "survival_month",
    "censorship",
    "without_omic",
    "insample_without_omic",
    "omic_means",
)


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array fields of a host batch as tensors on ``device``; host
    fields (patient_id, index) stay behind."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()
            if k in ARRAY_KEYS}


def make_task_loss(cfg) -> Callable:
    """TASK.NAME + TASK.LOSS -> callable(logits, batch) -> loss (the
    per-engine dispatch of the reference, ``mbtrain.py:167-189``)."""
    task = cfg.TASK.NAME
    name = cfg.TASK.LOSS
    alpha = float(cfg.LOSS.ALPHA)
    reduction = cfg.LOSS.REDUCTION
    if task != "Survival":
        loss_obj = build_loss("celoss")
        return lambda logits, batch: loss_obj(logits, batch["label"])
    if name == "nllsurvloss_new":
        loss_obj = build_loss(name, alpha=alpha, reduction=reduction)
        return lambda logits, batch: loss_obj(logits, batch["label"], batch["censorship"])
    if name in ("nllsurvloss", "cesurvloss"):
        loss_obj = build_loss(name)

        def fn(logits, batch):
            hazards = torch.sigmoid(logits)
            return loss_obj(hazards, hazards_to_survival(hazards), batch["label"],
                            batch["censorship"])

        return fn
    if name == "coxsurvloss":
        loss_obj = build_loss(name)
        return lambda logits, batch: loss_obj(
            logits[:, :1], batch["survival_month"], batch["censorship"]
        )
    raise ValueError(f"Unknown TASK.LOSS: {name}")


class TrainerBase:
    """Shared scaffolding: data, evaluator, logging, checkpoints."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.check_cfg(cfg)
        self.start_epoch = self.epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.output_dir = cfg.OUTPUT_DIR
        mkdir_if_missing(self.output_dir)

        self.dm = DataManager(cfg)
        self.train_loader = self.dm.train_loader
        self.val_loader = self.dm.val_loader
        self.test_loader = self.dm.test_loader
        self.num_classes = self.dm.num_classes
        self.lab2cname = self.dm.lab2cname
        if cfg.VERBOSE:
            self.dm.show_summary()

        # survival baseline for IPCW (ref trainer.py:383-399)
        tr_t, tr_c = self.dm.train_set.get_event_and_censorship()
        if self.dm.val_set is not None:
            va_t, va_c = self.dm.val_set.get_event_and_censorship()
        else:
            va_t, va_c = np.empty(0), np.empty(0)
        all_c = np.concatenate([tr_c, va_c], axis=0)
        all_t = np.concatenate([tr_t, va_t], axis=0)
        self.all_survival = ((1 - all_c).astype(bool), all_t)
        self.evaluator = build_evaluator(cfg, all_survival=self.all_survival, bins=None)

        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0))
        self.best_result = -np.inf
        self.writer: Optional[MetricWriter] = None
        self.time_start = None
        self.task_loss = make_task_loss(cfg)
        self.build_model()

    # -- to be provided by subclasses ---------------------------------------
    def check_cfg(self, cfg):
        pass

    def build_model(self):
        raise NotImplementedError

    def state_dict(self) -> Dict:
        raise NotImplementedError

    def load_state_dict(self, state: Dict) -> None:
        raise NotImplementedError

    # -- the epoch loop's hooks ------------------------------------------------
    def before_train(self):
        directory = self.cfg.RESUME or self.output_dir
        state, epoch = resume_from_checkpoint(osp.join(directory, "model"), self.device)
        if epoch > 0:
            self.load_state_dict(state)
            self.start_epoch = epoch
        self.writer = MetricWriter(osp.join(self.output_dir, "tensorboard"))
        self.time_start = time.time()

    def before_epoch(self):
        self.train_loader.set_epoch(self.epoch)

    def after_epoch(self):
        last_epoch = (self.epoch + 1) == self.max_epoch
        freq = self.cfg.TRAIN.CHECKPOINT_FREQ
        meet_freq = (self.epoch + 1) % freq == 0 if freq > 0 else False
        model_dir = osp.join(self.output_dir, "model")
        if not self.cfg.TEST.NO_TEST:
            curr = self.test(split="val")
            if self.cfg.TEST.FINAL_MODEL == "best_val" and curr > self.best_result:
                self.best_result = curr
                save_checkpoint(self.state_dict(), model_dir, self.epoch + 1, is_best=True,
                                model_name="model-best.ckpt")
        if meet_freq or last_epoch:
            save_checkpoint(self.state_dict(), model_dir, self.epoch + 1)

    def after_train(self):
        print("Finish training")
        result = None
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                best = best_checkpoint_path(osp.join(self.output_dir, "model"))
                if best:
                    self.load_state_dict(load_checkpoint(best, self.device))
            else:
                print("Deploy the last-epoch model")
            result = self.test()
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")
        if self.writer:
            self.writer.close()
        return result

    def process_eval_batch(self, logits: np.ndarray, batch: Dict) -> None:
        self.evaluator.process(batch["patient_id"], logits, batch["censorship"],
                               batch["survival_month"])

    def get_current_lr(self) -> float:
        return lr_at_epoch(self.cfg.OPTIM, self.epoch)

    def load_model(self, directory: Optional[str] = None, epoch: Optional[int] = None):
        """Load for eval (reference ``trainer.py:210-239``): the checkpoint of
        ``epoch``, else the best, else the one the pointer file names."""
        mdir = osp.join(directory or self.output_dir, "model")
        if epoch is not None:
            path = osp.join(mdir, f"model.ckpt-{epoch}")
        else:
            path = best_checkpoint_path(mdir)
            if path is None:
                with open(osp.join(mdir, "checkpoint")) as f:
                    path = osp.join(mdir, f.read().strip())
        self.load_state_dict(load_checkpoint(path, self.device))
        print(f"Loaded model weights from {path}")

