"""MBTRAIN — the trainer for UMEML and UMEML_GAN; the PyTorch counterpart of
``imp_tpu/engine/mbtrain.py`` (reference ``medmm/engine/mbtrain.py``, the
curriculum of ``engine/trainer.py:280-305`` and the CCA epoch of
``:672-739``).

UMEML (``MODEL.NAME=umeml``): one optimizer over every parameter (coupled
L2 on all of them), and one step is one train forward, loss = task +
modularity, one backward, one update; no curriculum, no CCA epoch.

One UMEML_GAN training step (:meth:`MBTRAIN.train_step`):

* ONE encode forward of the bag, with its graph kept;
* the GAN phase on the detached ``h_path``/``h_omic``, in order: the
  generator, then the pathology and omics discriminators, each optimizer
  stepping on ``torch.autograd.grad`` of its own loss with respect to its
  own parameters (so gradients never mix between phases), the
  discriminators seeing the updated generator;
* the main loss (task + modularity + self-distillation) through
  ``finish`` with the updated generator, differentiated with respect to
  every non-discriminator parameter in one backward through ``finish`` and
  the kept encode graph — the JAX step's ``enc_vjp``, without a second
  encode.  Coupled L2 skips the generators (the JAX ``optax.masked``).

The CCA epoch accumulates up to ``CCA_ACCUM_BATCHES`` batches, takes the
cotangents of ``cca_loss`` over the whole group, then recomputes each
batch's forward with the same dropout draws (the generator state is saved
and restored) and backpropagates ``<hp, g_hp> + <ho, g_ho> + w·sim``, as the
JAX package's two-pass linearisation does; a fresh Adam(CCA_LR) steps once
per group.

Under ``TPU.ATTENTION=flash`` every TransLayer call with grad runs the flash
forward K1 and, in the backward, K2 and K3 — the CCA epoch's recompute
pass included; evaluation and the CCA value pass run K1 only.

The models' TransLayers take ``pinv_mode`` (the Nyström pseudo-inverse as
the chain of products or through K6/K7), which has no cfg key: the trainer
builds them with its default, ``"chain"``, as JAX does.

Not ported here (ROADMAP.md §A): ``umeml_gan_plot``, ``DATASET.USE_BSM``,
``TRAINER.PREC`` other than fp32 and ``MODEL.INIT_WEIGHTS`` raise;
``test_new`` (CPTAC) and the importance ``.txt`` dumps and PNG plots are
absent.  ``TPU.REMAT``/``TPU.DONATE`` need no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import TRAINER_REGISTRY
from .trainer import TrainerBase, deferred, device_batch
from ..losses.survival import cca_loss, similarity_alignment_loss
from ..models import build_model, survival_num_classes
from ..optim import build_optimizer, gan_optimizer
from ..optim.builders import Chain, Optimizer, ScaleByAdam, ScaleByLearningRate
from ..utils.tools import count_num_param

GEN_KEYS = ("gan_generator_p2o", "gan_generator_o2p")
DIS_KEYS = ("gan_discriminator_p", "gan_discriminator_o")


def get_omic_delete_mask(batch_size, num_features, ratio, seed=None):
    """Deterministic per-batch omics-deletion mask (ref ``mbtrain.py:270-279``)."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((batch_size, num_features), dtype=np.int32)
    num_selected = int(num_features * max(ratio, 0.0))
    for i in range(batch_size):
        mask[i, rng.choice(num_features, num_selected, replace=False)] = 1
    return mask


@TRAINER_REGISTRY.register()
class MBTRAIN(TrainerBase):
    """Trainer for the UMEML family."""

    def check_cfg(self, cfg):
        assert cfg.MODEL.NAME in ("umeml", "umeml_gan", "umeml_gan_plot")
        if cfg.MODEL.NAME == "umeml_gan_plot":
            raise deferred(f"MODEL.NAME={cfg.MODEL.NAME!r} under MBTRAIN")
        if cfg.DATASET.USE_BSM:
            raise deferred("DATASET.USE_BSM (the chunk-averaged estimator)")
        if cfg.TRAINER.PREC != "fp32":
            raise deferred(f"TRAINER.PREC={cfg.TRAINER.PREC!r}")
        if cfg.MODEL.INIT_WEIGHTS:
            raise deferred("MODEL.INIT_WEIGHTS")

    # ------------------------------------------------------------------ #
    # model and optimizers                                                 #
    # ------------------------------------------------------------------ #
    def build_model(self):
        cfg = self.cfg
        self.is_gan = cfg.MODEL.NAME == "umeml_gan"
        genes = ({"gene_group_indexes": self.dm.gene_group_indexes or ()} if self.is_gan
                 else {"omic_dim": self.dm.omic_dim})
        self.model = build_model(
            cfg.MODEL.NAME, cfg=cfg,
            num_classes=survival_num_classes(cfg.TASK.NAME, self.num_classes),
            device=self.device, generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
            **genes,
        )
        self.omic_means = self.dm.compute_omic_means()
        print(f"# params: {count_num_param(self.model):,}")
        updates_per_epoch = max(1, len(self.train_loader))
        if not self.is_gan:
            self.main_params = list(self.model.parameters())
            self.main_opt = build_optimizer(cfg.OPTIM, self.main_params, updates_per_epoch)
            return

        named = dict(self.model.named_parameters())

        def part(keep):
            return [n for n in named if keep(n.split(".")[0])]

        main_names = part(lambda top: top not in DIS_KEYS)
        self.main_params = [named[n] for n in main_names]
        self.main_opt = build_optimizer(
            cfg.OPTIM, self.main_params, updates_per_epoch,
            decay_mask=[n.split(".")[0] not in GEN_KEYS for n in main_names],
        )
        gan_lr, gan_wd = float(cfg.MODEL.UMEML.GAN_LR), float(cfg.MODEL.UMEML.GAN_WD)
        self.gen_opt = gan_optimizer([named[n] for n in part(lambda t: t in GEN_KEYS)],
                                     gan_lr, gan_wd)
        self.dis_p_opt = gan_optimizer(
            [named[n] for n in part(lambda t: t == "gan_discriminator_p")], gan_lr, gan_wd)
        self.dis_o_opt = gan_optimizer(
            [named[n] for n in part(lambda t: t == "gan_discriminator_o")], gan_lr, gan_wd)

    def _optimizers(self) -> Dict[str, Optimizer]:
        if not self.is_gan:
            return {"opt_state": self.main_opt}
        return {"opt_state": self.main_opt, "gen_opt": self.gen_opt,
                "dis_p_opt": self.dis_p_opt, "dis_o_opt": self.dis_o_opt}

    # ------------------------------------------------------------------ #
    # batches                                                              #
    # ------------------------------------------------------------------ #
    def _device_batch(self, batch: Dict, without_omic: Optional[np.ndarray] = None,
                    insample_mask: Optional[np.ndarray] = None) -> Dict:
        b, g = batch["img"].shape[0], batch["mol"].shape[1]
        out = dict(batch)
        out["without_omic"] = (
            without_omic if without_omic is not None else np.zeros((b,), np.float32)
        )
        out["insample_without_omic"] = (
            insample_mask if insample_mask is not None else np.zeros((b, g), np.int32)
        )
        out["omic_means"] = np.asarray(self.omic_means, np.float32)
        return device_batch(out, self.device)

    # ------------------------------------------------------------------ #
    # one training step                                                    #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _step(opt: Optimizer, loss: torch.Tensor) -> None:
        opt.step(torch.autograd.grad(loss, opt.params, allow_unused=True))

    def train_step(self, db: Dict[str, torch.Tensor], train_gan: bool = False,
                   replace_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
        """One MBTRAIN step on a device batch; returns device scalars."""
        model, g = self.model, self.generator
        if not self.is_gan:
            out = model(db, train=True, generator=g)
            loss = self.task_loss(out["logits"], db) + out["modular_loss"]
            self._step(self.main_opt, loss)
            return {"loss": loss.detach()}
        enc = model.encode(db, train=True, generator=g)
        metrics = {}
        if train_gan:
            hp, ho = enc["h_path"].detach(), enc["h_omic"].detach()
            for name, opt, loss_fn in (
                ("loss_gen", self.gen_opt, model.gen_loss),
                ("loss_dis_p", self.dis_p_opt, model.dis_p_loss),
                ("loss_dis_o", self.dis_o_opt, model.dis_o_loss),
            ):
                loss = loss_fn(hp, ho)
                self._step(opt, loss)
                metrics[name] = loss.detach()
        out = model.finish(enc, db, train=True, replace_ratio=replace_ratio, generator=g)
        loss = self.task_loss(out["logits"], db) + out["modular_loss"] + out["loss_kd"]
        self._step(self.main_opt, loss)
        metrics["loss"] = loss.detach()
        return metrics

    # ------------------------------------------------------------------ #
    # training loop with curriculum                                        #
    # ------------------------------------------------------------------ #
    def train(self, umeml_gan_test_without_omic_ratio: float = -1,
              umeml_gan_test_insample_without_omic_ratio: float = 0):
        self._test_without_ratio = umeml_gan_test_without_omic_ratio
        self._test_insample_ratio = umeml_gan_test_insample_without_omic_ratio
        cur = self.cfg.TRAIN.CURRICULUM
        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            if not self.is_gan or not cur.ENABLE or self.epoch < cur.GAN_START_EPOCH:
                self.run_epoch(train_gan=False, replace_ratio=0.0)
            elif self.epoch < cur.REPLACE_START_EPOCH:
                self.run_epoch(train_gan=True, replace_ratio=0.0)
            else:
                rs = cur.REPLACE_START_EPOCH
                ratio = (self.epoch + 1 - rs) / (self.max_epoch + 1 - rs) / 2
                self.run_epoch(train_gan=True, replace_ratio=ratio)
            if (self.is_gan and cur.ENABLE and cur.CCA_EVERY_EPOCH
                    and self.epoch < self.max_epoch - 1):
                self.run_epoch_cca()
            self.after_epoch()
        return self.after_train()

    def _log_extras(self, train_gan: bool, replace_ratio: float):
        return [f"gan={train_gan}", f"rr={replace_ratio:.3f}"]

    def _cca_forward(self, db, train: bool):
        """(h_path, h_omic flattened per slide, similarity-alignment loss)."""
        out = self.model(db, train=train, cca=True, generator=self.generator if train else None)
        b = out["h_path"].shape[0]
        sim = similarity_alignment_loss(out["p_proto_before"].reshape(b, -1),
                                        out["h_omic_bag_before"].reshape(b, -1))
        return out["h_path"].reshape(b, -1), out["h_omic"].reshape(b, -1), sim

    def run_epoch_cca(self):
        """CCA alignment epoch (ref ``trainer.py:672-739``): exact gradients
        through the accumulated group, a fresh Adam per epoch."""
        cur = self.cfg.TRAIN.CURRICULUM
        threshold = int(cur.CCA_ACCUM_BATCHES)
        train = bool(cur.CCA_DROPOUT)
        cca_opt = Optimizer(self.main_params,
                            Chain(ScaleByAdam(), ScaleByLearningRate(float(cur.CCA_LR))))
        num_batches = len(self.train_loader)
        group: List = []
        for batch_idx, batch in enumerate(self.train_loader):
            db = self._device_batch(batch)
            rng_state = self.generator.get_state()
            with torch.no_grad():
                hp, ho, sim = self._cca_forward(db, train)
            group.append((db, rng_state, hp, ho, sim))
            if batch_idx == num_batches - 1 or len(group) == threshold:
                cca_val = self.cca_update(group, cca_opt, train)
                batch_loss = torch.stack([g[4] for g in group]).mean()
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] CCA "
                    f"batch [{batch_idx + 1}/{num_batches}] "
                    f"cca_loss {float(cca_val):.4f} batch_loss {float(batch_loss):.4f}"
                )
                self.writer.write_scalar("train/cca_loss", float(cca_val),
                                         self.epoch * num_batches + batch_idx)
                group = []

    def cca_update(self, group, cca_opt: Optimizer, train: bool) -> torch.Tensor:
        """One CCA update over a group of (batch, generator state, hp, ho,
        sim); returns the group's cca_loss."""
        hp_all = torch.cat([g[2] for g in group]).requires_grad_()
        ho_all = torch.cat([g[3] for g in group]).requires_grad_()
        cca_val = cca_loss(hp_all, ho_all)
        g_hp, g_ho = torch.autograd.grad(cca_val, (hp_all, ho_all))
        w_sim = 1.0 / len(group)
        grad_sum = [torch.zeros_like(p) for p in self.main_params]
        offset = 0
        for db, rng_state, hp0, _, _ in group:
            b = hp0.shape[0]
            self.generator.set_state(rng_state)  # the same dropout as the first pass
            hp, ho, sim = self._cca_forward(db, train)
            surrogate = ((hp * g_hp[offset:offset + b]).sum()
                         + (ho * g_ho[offset:offset + b]).sum() + w_sim * sim)
            grads = torch.autograd.grad(surrogate, self.main_params, allow_unused=True)
            for acc, gi in zip(grad_sum, grads):
                if gi is not None:
                    acc += gi
            offset += b
        cca_opt.step(grad_sum)
        return cca_val.detach()

    # ------------------------------------------------------------------ #
    # evaluation with omics-ablation knobs                                 #
    # ------------------------------------------------------------------ #
    def after_epoch(self):
        # route the omics-ablation ratios into test (ref after_epoch)
        self._eval_ratios = (
            getattr(self, "_test_without_ratio", 0),
            getattr(self, "_test_insample_ratio", 0),
        )
        super().after_epoch()

    def test(self, split: Optional[str] = None,
             umeml_gan_test_without_omic_ratio: Optional[float] = None,
             umeml_gan_test_insample_without_omic_ratio: Optional[float] = None,
             **kwargs) -> float:
        without_ratio, insample_ratio = getattr(self, "_eval_ratios", (0, 0))
        if umeml_gan_test_without_omic_ratio is not None:
            without_ratio = umeml_gan_test_without_omic_ratio
        if umeml_gan_test_insample_without_omic_ratio is not None:
            insample_ratio = umeml_gan_test_insample_without_omic_ratio
        without_ratio = max(float(without_ratio), 0.0)
        insample_ratio = max(float(insample_ratio), 0.0)

        split, loader = self._eval_split(split)
        # sample-level omics removal, seed 42 (ref mbtrain.py:303-310)
        num_samples = len(loader.dataset)
        self._ablation = {
            "without": np.random.RandomState(42).choice(
                num_samples, int(num_samples * without_ratio), replace=False),
            "insample_ratio": insample_ratio,
            "start": 0,  # the first sample of the next batch
        }
        return super().test(split)

    def _eval_batch(self, batch: Dict, split: str, batch_index: int) -> Dict:
        ab = self._ablation
        b = batch["img"].shape[0]
        without = np.isin(np.arange(ab["start"], ab["start"] + b), ab["without"]).astype(np.float32)
        ab["start"] += b
        seed = (10000 if split == "val" else 20000) + batch_index
        insample = get_omic_delete_mask(b, batch["mol"].shape[1], ab["insample_ratio"], seed=seed)
        return self._device_batch(batch, without_omic=without, insample_mask=insample)

    # ------------------------------------------------------------------ #
    # state                                                                #
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict:
        return {
            "model": self.model.state_dict(),
            **{k: opt.state_dict() for k, opt in self._optimizers().items()},
            "epoch": self.epoch + 1,
            "val_result": float(self.best_result) if np.isfinite(self.best_result) else -1.0,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        for k, opt in self._optimizers().items():
            opt.load_state_dict(state[k])
