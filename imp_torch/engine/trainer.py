"""Trainer engine — the PyTorch counterpart of ``imp_tpu/engine/trainer.py``
(reference ``medmm/engine/trainer.py``): the generic epoch loop
(``train`` → ``run_epoch`` → ``after_epoch``), evaluation (``test``), val
selection, best/last checkpoints and the ``* metric: X%`` log lines
``tools/parse_test_res.py`` scrapes.

Two trainers stand on :class:`TrainerBase`: MBTRAIN (``engine/mbtrain.py``,
UMEML_GAN with its own curriculum loop) and :class:`StandardTrainer`, the
one-optimizer loop of the baselines (``engine/baselines.py``: ABMIL,
TransMIL, SNN, SNNM, CLIPOMIC; ``engine/fusion_trainers.py``: MCAT, CMTA,
Porpoise, ConCAT, ADD, HFB).  Both run the four tasks: Survival (C-index, from a survival
head of 4 bins) and Classification, Grading and Subtyping (cross-entropy;
accuracy, AUC and macro-F1 from ``evaluation/evaluators.py``).

One process drives one device (``cuda`` unless the caller passes
``device="cpu"``).  Under ``torchrun`` (or
:func:`imp_torch.parallel.launch.spawn`) the ranks form the mesh of
``TPU.MESH_AXES``/``TPU.MESH_SHAPE`` (:func:`imp_torch.parallel.make_mesh`;
axes ``data`` and ``seq``, one rank per card on ``cuda:LOCAL_RANK``); a
single process is the world of one.  Every rank loads the whole global
batch and keeps its part (:meth:`TrainerBase._device_batch`: dim 0 split
over ``data`` after a wrap-pad, the bag's token dim over ``seq`` for a net
that has a sequence-parallel layout, ``omic_means`` whole).  A step seeds
1/world of its replicated loss and sums the parameter gradients over the
world (:meth:`TrainerBase._grads`), which gives the single-device gradient
of the global batch mean (JAX's ``pmean`` over ``data``); evaluation
gathers the outputs over ``data`` onto every rank, so val selection agrees
everywhere; rank 0 alone writes checkpoints, metric lines and dumps.
``TPU.SP_ATTENTION`` (``gather``/``ring``) picks the sequence-parallel
layout of TransMIL and UMEML_GAN.  The JAX package's device bag cache has
no counterpart yet.  Randomness comes from one ``torch.Generator`` on the
device, seeded from ``cfg.SEED`` plus the rank's data index (each data
shard draws its own dropout; the ranks of one seq group draw alike).

``TRAINER.PREC`` bf16 (or fp16/amp) runs every train and eval forward of a
trainer through :func:`imp_torch.engine.precision.amp_call` (bfloat16
copies of the float32 parameters and batch, float32 outputs) inside
:func:`~imp_torch.engine.precision.bf16_matmul_scope`;
``MODEL.INIT_WEIGHTS`` loads a checkpoint's matching parameters into the
fresh model before any parameter is frozen
(:func:`imp_torch.utils.checkpoint.load_pretrained_params`).
"""

from __future__ import annotations

import contextlib
import datetime
import os.path as osp
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data import DataManager
from ..evaluation import build_evaluator
from ..errors import deferred
from ..losses.survival import build_loss, hazards_to_survival
from ..models import build_model, survival_num_classes
from ..ops.attention import set_batch_axis
from ..optim import build_optimizer, lr_at_epoch
from ..parallel import (
    all_reduce_grads,
    barrier,
    fetch_global,
    is_primary,
    make_mesh,
    maybe_initialize_distributed,
    replicate_module,
    shard_batch,
)
from ..parallel.collectives import _all_reduce
from ..utils.checkpoint import (
    best_checkpoint_path,
    load_checkpoint,
    load_pretrained_params,
    resume_from_checkpoint,
    save_checkpoint,
)
from .precision import amp_call, bf16_matmul_scope, compute_dtype_of
from ..utils.logger import MetricWriter, mkdir_if_missing
from ..utils.meters import AverageMeter, MetricMeter
from ..utils.tools import count_num_param

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


#: batch fields that are not per sample: whole on every rank
REPLICATED_KEYS = ("omic_means",)
#: the bag's fields, whose token dim a sequence-parallel net splits over seq
SEQ_SHARDED_KEYS = ("img", "img_mask")


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array fields of a host batch as tensors on ``device``; host
    fields (patient_id, index) stay behind."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()
            if k in ARRAY_KEYS}


def pad_ragged_dim0(arrays: Dict, n_shards: int) -> Dict:
    """Wrap-pad every per-sample field's dim 0 to a multiple of ``n_shards``
    (pad rows repeat real samples, ``idx % B``, as JAX pads).  Evaluation
    drops the pad rows after the gather; a training batch that pads
    unevenly weighs its samples slightly differently from one device."""
    per_sample = [k for k in arrays if k not in REPLICATED_KEYS]
    if not per_sample:
        return arrays
    b = int(np.asarray(arrays[per_sample[0]]).shape[0])
    pad = (-b) % n_shards
    if pad == 0:
        return arrays
    idx = np.arange(b + pad) % b
    return {k: (v if k in REPLICATED_KEYS else np.asarray(v)[idx]) for k, v in arrays.items()}


def validated_sp_mode(cfg) -> str:
    """``cfg.TPU.SP_ATTENTION``, checked where it is read: a typo would
    otherwise fall through every ``== "ring"`` test to the gather layout."""
    mode = cfg.TPU.SP_ATTENTION
    if mode not in ("gather", "ring"):
        raise ValueError(f"TPU.SP_ATTENTION must be 'gather' or 'ring', got {mode!r}")
    return mode


class _NoWriter:
    """The metric writer of a rank other than 0: writes nothing."""

    def write_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


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
        self.device = maybe_initialize_distributed(device)
        self.mesh = make_mesh(cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE, self.device)
        self.sp_axis = None  # the seq axis, for a net that splits the bag over it
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

        if cfg.TASK.NAME == "Survival":
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
        else:
            self.all_survival = None
            self.evaluator = build_evaluator(cfg, lab2cname=self.lab2cname)

        self.generator = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0) + self.mesh.data.index)
        self.cdtype = compute_dtype_of(cfg)  # bfloat16 under TRAINER.PREC bf16/fp16/amp
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

    def train_step(self, db: Dict[str, torch.Tensor], **kwargs) -> Dict[str, torch.Tensor]:
        """One update on a device batch; returns device scalars (``loss``)."""
        raise NotImplementedError

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """This rank's part of a host batch, on its device (see the module
        docstring)."""
        arrays = {k: v for k, v in batch.items() if k in ARRAY_KEYS}
        if self.mesh.data.size > 1:
            arrays = pad_ragged_dim0(arrays, self.mesh.data.size)
        return shard_batch(arrays, self.mesh, SEQ_SHARDED_KEYS if self.sp_axis else (),
                           REPLICATED_KEYS)

    @contextlib.contextmanager
    def _scope(self):
        """What every forward of the trainer runs under: the precision
        policy's matmul setting."""
        with bf16_matmul_scope(self.cdtype):
            yield

    def check_mesh(self, model: nn.Module) -> None:
        """Refuse what the port does not run on a mesh of more than one
        rank, then broadcast rank 0's parameters and take the Nyström
        normaliser over the data axis."""
        if self.mesh.size == 1:
            return
        if self.sp_axis is not None and self.cdtype is not None:
            raise deferred("TRAINER.PREC bf16 under sequence parallelism", 8)
        if any(n.endswith("running_mean") for n, _ in model.named_buffers()):
            raise deferred("a net with batch statistics (HFB's BatchNorm) on a mesh of "
                           "more than one rank", 8)
        replicate_module(model, self.mesh)
        set_batch_axis(model, self.mesh.data)

    def _grads(self, loss: torch.Tensor, params) -> List[Optional[torch.Tensor]]:
        """The gradient of the global batch mean of ``loss`` (replicated over
        seq, one value per data shard) with respect to ``params``: 1/world
        of it seeded here, the gradients summed over the world."""
        grads = torch.autograd.grad(loss / self.mesh.size if self.mesh.size > 1 else loss,
                                    params, allow_unused=True)
        return all_reduce_grads(grads, self.mesh.world)

    def _global_mean(self, value: torch.Tensor) -> torch.Tensor:
        """A per-data-shard scalar averaged over the data axis (no gradient)."""
        value = value.detach()
        if self.mesh.size == 1:
            return value
        return _all_reduce(self.mesh.world, value) / self.mesh.size

    def _gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """A data-split output's rows from every rank, without the pad rows
        beyond the host batch's ``n``."""
        return fetch_global(t, self.mesh)[:n]

    def _save(self, state: Dict, model_dir: str, epoch: int, **kwargs) -> None:
        """``save_checkpoint`` on rank 0; every rank waits for it."""
        if is_primary():
            save_checkpoint(state, model_dir, epoch, **kwargs)
        barrier()

    def _log_extras(self, **step_kwargs) -> List[str]:
        """Fields a subclass appends to the epoch's progress lines."""
        return []

    # -- the generic loop ------------------------------------------------------
    def train(self, *args, **kwargs):
        """The epoch loop.  The positional arguments are the CLI's omics
        ablation ratios, which only MBTRAIN reads."""
        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        return self.after_train()

    def run_epoch(self, **step_kwargs):
        """One training epoch of :meth:`train_step` (``step_kwargs`` passed
        on); the step metrics are read back (which waits for the card) only
        at print points and at the end."""
        losses, batch_time = MetricMeter(), AverageMeter()
        num_batches = len(self.train_loader)
        n_slides = 0
        pending = []

        def flush():
            for bi, metrics in pending:
                metrics = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(metrics["loss"]):
                    raise FloatingPointError("Loss is infinite or NaN!")
                losses.update(metrics)
                for name, value in metrics.items():
                    self.writer.write_scalar("train/" + name, value, self.epoch * num_batches + bi)
            pending.clear()

        end = time.time()
        for batch_idx, batch in enumerate(self.train_loader):
            pending.append((batch_idx, self.train_step(self._device_batch(batch), **step_kwargs)))
            n_slides += len(batch["patient_id"])
            batch_time.update(time.time() - end)
            freq = self.cfg.TRAIN.PRINT_FREQ
            if (batch_idx + 1) % freq == 0 or num_batches < freq:
                flush()
                print(" ".join([
                    f"epoch [{self.epoch + 1}/{self.max_epoch}]",
                    f"batch [{batch_idx + 1}/{num_batches}]",
                    f"time {batch_time.val:.3f} ({batch_time.avg:.3f})",
                    f"{losses}",
                    f"lr {self.get_current_lr():.4e}",
                ] + self._log_extras(**step_kwargs)))
            end = time.time()
        flush()
        self.writer.write_scalar("train/slides_per_sec", n_slides / max(batch_time.sum, 1e-9),
                                 self.epoch)

    def _eval_split(self, split: Optional[str]):
        """(split, loader): ``val`` where there is a val set, else ``test``."""
        if split is None:
            split = self.cfg.TEST.SPLIT
        if split == "val" and self.val_loader is not None:
            return "val", self.val_loader
        return "test", self.test_loader

    def _eval_batch(self, batch: Dict, split: str, batch_index: int) -> Dict[str, torch.Tensor]:
        return self._device_batch(batch)

    def init_weights(self, model: nn.Module) -> None:
        """``MODEL.INIT_WEIGHTS``: the named checkpoint's parameters whose
        name and shape match, into ``model`` (the JAX trainers load them
        right after init, before freezing any)."""
        if self.cfg.MODEL.INIT_WEIGHTS:
            load_pretrained_params(self.cfg.MODEL.INIT_WEIGHTS, model)

    def _eval_output(self, out: Dict[str, torch.Tensor], batch: Dict) -> None:
        """What a subclass keeps of one eval batch's model outputs besides
        the logits (called in batch order, after the loop)."""

    def test(self, split: Optional[str] = None, **kwargs) -> float:
        """Evaluate on ``split``; returns the evaluator's first metric."""
        split, loader = self._eval_split(split)
        print(f"Evaluate on the *{split}* set")
        return self._evaluate(split, loader)

    def _evaluate(self, split: str, loader) -> float:
        """The eval forward over ``loader`` into the evaluator, its results
        written under ``split``; returns the first metric.  The outputs are
        read back once, after the loop."""
        self.evaluator.reset()
        pending = []
        with torch.no_grad(), self._scope():
            for batch_index, batch in enumerate(loader):
                out = amp_call(self.model, "forward", self.cdtype,
                               self._eval_batch(batch, split, batch_index), train=False)
                out = out if isinstance(out, dict) else {"logits": out}
                n = len(batch["patient_id"])
                out = {k: self._gather_rows(v, n) for k, v in out.items()
                       if k in ("logits", "importance_path", "importance_omic")}
                pending.append((out, batch))
        for out, batch in pending:
            self._eval_output(out, batch)
            self.process_eval_batch(out["logits"].cpu().numpy(), batch)
        results = self.evaluator.evaluate()
        for k, v in results.items():
            if self.writer:
                self.writer.write_scalar(f"{split}/{k}", v, self.epoch)
        return list(results.values())[0]

    # -- the epoch loop's hooks ------------------------------------------------
    def before_train(self):
        directory = self.cfg.RESUME or self.output_dir
        state, epoch = resume_from_checkpoint(osp.join(directory, "model"), self.device)
        if epoch > 0:
            self.load_state_dict(state)
            self.start_epoch = epoch
        self.writer = (MetricWriter(osp.join(self.output_dir, "tensorboard")) if is_primary()
                       else _NoWriter())
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
                self._save(self.state_dict(), model_dir, self.epoch + 1, is_best=True,
                           model_name="model-best.ckpt")
        if meet_freq or last_epoch:
            self._save(self.state_dict(), model_dir, self.epoch + 1)

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
        if self.cfg.TASK.NAME != "Survival":
            self.evaluator.process(logits, batch["label"])
        elif type(self.evaluator).__name__ == "Survival_UMEML":
            self.evaluator.process(batch["patient_id"], logits, batch["censorship"],
                                   batch["survival_month"])
        else:  # the baselines' Survival evaluator takes the survival curve
            hazards = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
            self.evaluator.process(np.cumprod(1.0 - hazards, axis=1), batch["censorship"],
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



class StandardTrainer(TrainerBase):
    """The one-optimizer trainer of nets called as ``model(batch, train,
    generator)``, which return the logits or a dict holding them under
    ``"logits"`` (the MIL, genomic and fusion baselines; reference
    ``engine/{abmil,transmil,snn,snnm,mcat,...}.py``): one
    ``build_optimizer`` chain over every parameter (one update per
    ``OPTIM.GRAD_ACCUM`` steps), the task loss plus :meth:`extra_loss`, and
    a state of model (with its buffers: HFB's BatchNorm statistics),
    optimizer and epoch."""

    #: the registered model builder (``imp_torch.models.build_model``) of the net
    MODEL_NAME = ""

    def build_kwargs(self) -> Dict:
        """The builder's arguments beyond cfg, classes, device and generator."""
        return {}

    def build_network(self) -> nn.Module:
        """The net ``MODEL_NAME`` on ``self.device``, initialised from
        ``cfg.SEED``."""
        cfg = self.cfg
        return build_model(
            self.MODEL_NAME, cfg=cfg,
            num_classes=survival_num_classes(cfg.TASK.NAME, self.num_classes),
            device=self.device, generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
            **self.build_kwargs(),
        )

    def extra_loss(self, out, batch: Dict[str, torch.Tensor]):
        """An auxiliary loss on the net's output (CMTA's alignment)."""
        return 0.0

    def network_seq_axis(self):
        """The seq axis for a net with a sequence-parallel layout (TransMIL)
        on a mesh whose seq axis has more than one rank, else None: the
        other nets take the whole bag on every rank of a seq group."""
        return None

    def param_labels(self) -> Optional[Dict[str, str]]:
        """``"train"`` or ``"frozen"`` for each parameter name of the net, or
        None (every parameter trains): the labels of the JAX trainer's
        ``optax.multi_transform``, whose ``frozen`` part is
        ``set_to_zero``.  A frozen parameter stays out of the optimizer (no
        update, no weight decay, no optimizer state) and takes no gradient
        of its own; gradients still flow through it to the parameters that
        train, and it is saved and loaded with the model."""
        return None

    def build_model(self):
        self.sp_axis = self.network_seq_axis()
        self.model = self.build_network()
        self.init_weights(self.model)
        self.check_mesh(self.model)
        print(f"# params: {count_num_param(self.model):,}")
        params = list(self.model.parameters())
        labels = self.param_labels()
        if labels is not None:
            named = list(self.model.named_parameters())
            frozen = [p for n, p in named if labels[n] == "frozen"]
            for p in frozen:
                p.requires_grad_(False)
            print(f"# frozen params: {sum(p.numel() for p in frozen):,}")
            params = [p for n, p in named if labels[n] == "train"]
        accum = max(1, self.cfg.OPTIM.GRAD_ACCUM)
        self.optimizer = build_optimizer(self.cfg.OPTIM, params,
                                         max(1, -(-len(self.train_loader) // accum)),
                                         grad_accum=accum)

    def train_step(self, db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with self._scope():
            out = amp_call(self.model, "forward", self.cdtype, db, train=True,
                           generator=self.generator)
            logits = out["logits"] if isinstance(out, dict) else out
            loss = self.task_loss(logits, db) + self.extra_loss(out, db)
            self.optimizer.step(self._grads(loss, self.optimizer.params))
        return {"loss": self._global_mean(loss)}

    def state_dict(self) -> Dict:
        return {
            "model": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "epoch": self.epoch + 1,
            "val_result": float(self.best_result) if np.isfinite(self.best_result) else -1.0,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["opt_state"])


class OmicTrainer(StandardTrainer):
    """A ``StandardTrainer`` whose net reads the omics: its builder takes the
    dataset's gene count (SNN, SNNM and the fusion baselines)."""

    def build_kwargs(self) -> Dict:
        return {"omic_dim": self.dm.omic_dim or 1000}
