"""MBTRAIN — the trainer for UMEML and UMEML_GAN; the PyTorch counterpart of
``imp_tpu/engine/mbtrain.py`` (reference ``medmm/engine/mbtrain.py``, the
curriculum of ``engine/trainer.py:280-305`` and the CCA epoch of
``:672-739``).

UMEML (``MODEL.NAME=umeml``): one optimizer over every parameter (coupled
L2 on all of them), and one step is one train forward, loss = task +
modularity, one backward, one update; no curriculum, no CCA epoch.  With
``DATASET.USE_BSM`` a step is the chunk-averaged estimator instead
(:meth:`MBTRAIN.bsm_loss`): the bag padded to a multiple of
``DATASET.BS_MICRO``, its tokens permuted (:meth:`MBTRAIN.bsm_permutation`)
and cut into chunks of that many, sorted within each chunk, and the mean
over chunks of task + ``MODEL.UMEML.ALPHA`` · modularity, one backward, one
update.  UMEML_GAN ignores ``USE_BSM``, as in JAX.

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

Every evaluation (:meth:`MBTRAIN.test` on val or test, :meth:`test_new` on
the external cohort) writes UMEML_GAN's per-prototype importances, one row
per slide, to ``<OUTPUT_DIR>/<split>_{path,omic}.txt``, and each training
epoch writes the train steps' rows to ``train_{path,omic}.txt``, as the JAX
trainer does.  :meth:`test_new` evaluates on ``<DATASET.ROOT>/test/``
(``data/external.py``), where a slide without a molecular CSV is served with
``without_omic = 1`` and its omics come from the generator.

``TRAINER.PREC`` bf16 (fp16, amp) runs the encode, the main phase's
``finish``, the UMEML step and every evaluation under the precision policy
(:func:`imp_torch.engine.precision.amp_call`: bfloat16 copies of the
float32 parameters, batch and encode outputs, float32 outputs), as JAX's
``_amp_apply`` does; the GAN losses and the CCA epoch run in float32, as
JAX applies them without ``_amp_apply``.  ``MODEL.INIT_WEIGHTS`` loads a
checkpoint's matching parameters before the optimizers are built.

``umeml_gan_plot`` is UMEML_GAN with, after each evaluation, one
``plots/sim_<patient>.png`` per slide: the bottleneck's pre-pairing path ×
omics similarity grid (:func:`imp_torch.models.layers.sow_similarity`).
Each training epoch renders its importance dumps to PNGs beside them.
Both plots import matplotlib when they run and return without output where
it is absent, as JAX does.  ``TPU.REMAT``/``TPU.DONATE`` need no
counterpart.

On a mesh (``TPU.MESH_AXES``, see :mod:`imp_torch.engine.trainer`) every
optimizer phase — generator, the two discriminators, the main update — and
the CCA epoch take the gradient of the global batch mean (JAX's ``_gmean``:
1/world of each loss seeded, gradients summed over the world).  A ``seq``
axis of more than one rank splits UMEML_GAN's bag (``sp_mode`` from
``TPU.SP_ATTENTION``: the prototype cross-attention over every rank's keys,
the modularity pair in the gather or ring layout); UMEML raises, as in JAX.
The CCA loss and the similarity alignment read the whole batch, gathered
over ``data``; importances and similarity grids are gathered onto every
rank and written by rank 0.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from . import TRAINER_REGISTRY
from .precision import amp_call
from .trainer import TrainerBase, validated_sp_mode
from ..losses.survival import cca_loss, similarity_alignment_loss
from ..models import build_model, survival_num_classes
from ..models.layers import sow_similarity
from ..parallel import all_gather, all_reduce_grads, is_primary
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

    # ------------------------------------------------------------------ #
    # model and optimizers                                                 #
    # ------------------------------------------------------------------ #
    def build_model(self):
        cfg = self.cfg
        self.is_gan = cfg.MODEL.NAME in ("umeml_gan", "umeml_gan_plot")
        genes = ({"gene_group_indexes": self.dm.gene_group_indexes or ()} if self.is_gan
                 else {"omic_dim": self.dm.omic_dim})
        if self.mesh.seq.size > 1:
            if not self.is_gan:
                raise ValueError("sequence parallelism is implemented for the umeml_gan "
                                 "trainer path only")
            self.sp_axis = self.mesh.seq
            genes.update(seq=self.sp_axis, sp_mode=validated_sp_mode(cfg))
        self.model = build_model(
            cfg.MODEL.NAME, cfg=cfg,
            num_classes=survival_num_classes(cfg.TASK.NAME, self.num_classes),
            device=self.device, generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
            **genes,
        )
        self.init_weights(self.model)
        self.check_mesh(self.model)
        self.omic_means = self.dm.compute_omic_means()
        self._train_importance = None  # a list of the steps' importances during run_epoch
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
        self._batch_rows = b  # the host batch's slides, before any data-axis pad
        return super()._device_batch(out)

    # ------------------------------------------------------------------ #
    # one training step                                                    #
    # ------------------------------------------------------------------ #
    def _step(self, opt: Optimizer, loss: torch.Tensor) -> None:
        opt.step(self._grads(loss, opt.params))

    def train_step(self, db: Dict[str, torch.Tensor], train_gan: bool = False,
                   replace_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
        """One MBTRAIN step on a device batch; returns device scalars."""
        with self._scope():
            return self._train_step(db, train_gan, replace_ratio)

    def bsm_permutation(self, npad: int) -> torch.Tensor:
        """The token permutation of one ``USE_BSM`` step, drawn from the
        trainer's generator (JAX draws it with ``jax.random``, so the bits
        differ; a test fixes it by replacing this method)."""
        return torch.randperm(npad, generator=self.generator, device=self.device)

    def bsm_loss(self, db: Dict[str, torch.Tensor], perm: torch.Tensor) -> torch.Tensor:
        """The chunk-averaged loss of a UMEML batch (JAX ``train_step_bsm``,
        reference ``split_chunk`` + BSM branch): the bag padded with masked
        tokens to a multiple of ``BS_MICRO``, the chunks the rows of
        ``perm`` cut into ``BS_MICRO`` columns and sorted, and the mean over
        chunks of task + ``ALPHA`` · modularity."""
        cfg = self.cfg
        micro, alpha = int(cfg.DATASET.BS_MICRO), float(cfg.MODEL.UMEML.ALPHA)
        img, mask = db["img"], db["img_mask"]
        b, n = mask.shape
        n_chunks = -(-n // micro)
        pad = n_chunks * micro - n
        img_p = torch.cat([img, img.new_zeros(b, pad, img.shape[2])], dim=1)
        mask_p = torch.cat([mask, mask.new_zeros(b, pad)], dim=1)
        total = 0.0
        for take in perm.reshape(n_chunks, micro).sort(dim=1).values:
            sub = dict(db, img=img_p[:, take], img_mask=mask_p[:, take])
            out = amp_call(self.model, "forward", self.cdtype, sub, train=True,
                           generator=self.generator)
            total = total + self.task_loss(out["logits"], db) + alpha * out["modular_loss"]
        return total / n_chunks

    def _train_step(self, db, train_gan, replace_ratio):
        model, g = self.model, self.generator
        if not self.is_gan:
            if self.cfg.DATASET.USE_BSM:
                micro = int(self.cfg.DATASET.BS_MICRO)
                npad = -(-db["img"].shape[1] // micro) * micro  # padded to whole chunks
                loss = self.bsm_loss(db, self.bsm_permutation(npad))
            else:
                out = amp_call(model, "forward", self.cdtype, db, train=True, generator=g)
                loss = self.task_loss(out["logits"], db) + out["modular_loss"]
            self._step(self.main_opt, loss)
            return {"loss": self._global_mean(loss)}
        enc = amp_call(model, "encode", self.cdtype, db, train=True, generator=g)
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
                metrics[name] = self._global_mean(loss)
        out = amp_call(model, "finish", self.cdtype, enc, db, train=True,
                       replace_ratio=replace_ratio, generator=g)
        loss = self.task_loss(out["logits"], db) + out["modular_loss"] + out["loss_kd"]
        self._step(self.main_opt, loss)
        metrics["loss"] = self._global_mean(loss)
        if self._train_importance is not None:  # inside run_epoch
            n = getattr(self, "_batch_rows", out["logits"].shape[0])
            self._train_importance.append((self._gather_rows(out["importance_path"], n),
                                           self._gather_rows(out["importance_omic"], n)))
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

    def run_epoch(self, **step_kwargs):
        """One training epoch; the importances of its steps go to
        ``train_{path,omic}.txt``, read back once, after the epoch."""
        self._open_imp_files("train")
        self._train_importance = []
        super().run_epoch(**step_kwargs)
        for imp_path, imp_omic in self._train_importance:
            self._dump_importance(imp_path.cpu().numpy(), imp_omic.cpu().numpy())
        self._train_importance = None
        self._plot_importance()

    def _log_extras(self, train_gan: bool, replace_ratio: float):
        return [f"gan={train_gan}", f"rr={replace_ratio:.3f}"]

    def _cca_forward(self, db, train: bool):
        """(h_path, h_omic flattened per slide, similarity-alignment loss);
        the loss over the whole batch, gathered over ``data``."""
        with self._scope():
            out = self.model(db, train=train, cca=True,
                             generator=self.generator if train else None)
        b = out["h_path"].shape[0]
        pp = out["p_proto_before"].reshape(b, -1)
        hb = out["h_omic_bag_before"].reshape(b, -1)
        if self.mesh.data.size > 1:
            pp, hb = all_gather(pp, self.mesh.data, 0), all_gather(hb, self.mesh.data, 0)
        sim = similarity_alignment_loss(pp, hb)
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
        sim); returns the group's cca_loss.  On a mesh the cca_loss reads
        every data shard's rows; each rank backpropagates the cotangents of
        its own rows (seeded 1/seq, the rows being replicated over seq) and
        1/world of the similarity term, and the gradients sum over the
        world."""
        mesh = self.mesh
        hp_all = torch.cat([self._gather_rows(g[2], len(g[2]) * mesh.data.size)
                            for g in group]).requires_grad_()
        ho_all = torch.cat([self._gather_rows(g[3], len(g[3]) * mesh.data.size)
                            for g in group]).requires_grad_()
        cca_val = cca_loss(hp_all, ho_all)
        g_hp, g_ho = torch.autograd.grad(cca_val, (hp_all, ho_all))
        w_sim = 1.0 / len(group)
        grad_sum = [torch.zeros_like(p) for p in self.main_params]
        offset = 0
        for db, rng_state, hp0, _, _ in group:
            b = hp0.shape[0]
            mine = slice(offset + mesh.data.index * b, offset + (mesh.data.index + 1) * b)
            self.generator.set_state(rng_state)  # the same dropout as the first pass
            hp, ho, sim = self._cca_forward(db, train)
            surrogate = ((hp * g_hp[mine]).sum() + (ho * g_ho[mine]).sum()) / mesh.seq.size
            surrogate = surrogate + w_sim * sim / mesh.size
            grads = all_reduce_grads(
                torch.autograd.grad(surrogate, self.main_params, allow_unused=True), mesh.world)
            for acc, gi in zip(grad_sum, grads):
                if gi is not None:
                    acc += gi
            offset += b * mesh.data.size
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
        split, loader = self._eval_split(split)
        self._set_ablation(loader, without_ratio, insample_ratio)
        self._open_imp_files(split)
        print(f"Evaluate on the *{split}* set")
        result = self._evaluate(split, loader)
        if self.cfg.MODEL.NAME.endswith("_plot"):
            self._plot_similarity(loader)
        return result

    def test_new(self, cfg=None, split: str = "test",
                 umeml_gan_test_without_omic_ratio: float = 0,
                 umeml_gan_test_insample_without_omic_ratio: float = 0, **kwargs) -> float:
        """External-cohort (CPTAC) evaluation (reference ``mbtrain.py:379-489``
        and ``dataset_new.py``) on ``<DATASET.ROOT>/test/``: the ablation of
        :meth:`test`, and every slide without omics served through the
        generator; returns the first metric, written under ``test_new``."""
        from ..data.external import build_test_new

        _, loader = build_test_new(self.cfg, omic_dim=self.dm.omic_dim)
        self._set_ablation(loader, umeml_gan_test_without_omic_ratio,
                           umeml_gan_test_insample_without_omic_ratio)
        self._open_imp_files("test_new")
        print(f"Evaluate on the *external test* set ({len(loader.dataset)} samples)")
        return self._evaluate("test_new", loader)

    def _set_ablation(self, loader, without_ratio: float, insample_ratio: float) -> None:
        """Sample-level omics removal drawn with seed 42 (ref
        ``mbtrain.py:303-310``) and the in-sample deletion ratio for the
        evaluation over ``loader``."""
        num_samples = len(loader.dataset)
        without_ratio = max(float(without_ratio), 0.0)
        self._ablation = {
            "without": np.random.RandomState(42).choice(
                num_samples, int(num_samples * without_ratio), replace=False),
            "insample_ratio": max(float(insample_ratio), 0.0),
            "start": 0,  # the first sample of the next batch
        }

    def _eval_batch(self, batch: Dict, split: str, batch_index: int) -> Dict:
        ab = self._ablation
        b = batch["img"].shape[0]
        without = np.isin(np.arange(ab["start"], ab["start"] + b), ab["without"]).astype(np.float32)
        if "without_omic" in batch:  # external slides with no omics always use the generator
            without = np.maximum(without, batch["without_omic"])
        ab["start"] += b
        seed = (10000 if split == "val" else 20000) + batch_index
        insample = get_omic_delete_mask(b, batch["mol"].shape[1], ab["insample_ratio"], seed=seed)
        return self._device_batch(batch, without_omic=without, insample_mask=insample)

    def _eval_output(self, out: Dict[str, torch.Tensor], batch: Dict) -> None:
        if "importance_path" in out:
            self._dump_importance(out["importance_path"].cpu().numpy(),
                                  out["importance_omic"].cpu().numpy())

    # ------------------------------------------------------------------ #
    # interpretability dumps                                               #
    # ------------------------------------------------------------------ #
    def _open_imp_files(self, prefix: str) -> None:
        """Truncate the importance dumps ``<prefix>_{path,omic}.txt`` (ref
        ``trainer.py:617-618``) and make them the current ones."""
        self._imp_files = {}
        for mod in ("path", "omic"):
            fp = osp.join(self.output_dir, f"{prefix}_{mod}.txt")
            if is_primary():
                open(fp, "w").close()
            self._imp_files[mod] = fp

    def _dump_importance(self, imp_path: np.ndarray, imp_omic: np.ndarray) -> None:
        """Append one line per slide: its prototypes' importances (rank 0)."""
        if not is_primary():
            return
        for mod, arr in (("path", imp_path), ("omic", imp_omic)):
            with open(self._imp_files[mod], "a") as f:
                for row in arr:
                    f.write(" ".join(str(float(x)) for x in row) + "\n")

    def similarity_grids(self, batch: Dict) -> torch.Tensor:
        """The pre-pairing path × omics similarity grid of each slide of a
        host batch ([B, P + 1, P + 1]): the bottleneck's first pass of the
        float32 eval forward, as JAX's sown ``similarity`` (no ablation)."""
        db = self._device_batch(batch)
        with torch.no_grad(), self._scope(), sow_similarity(self.model.bottleattn) as sown:
            self.model(db, train=False)
        return self._gather_rows(sown[0][:db["img"].shape[0]], batch["img"].shape[0])

    def _plot_similarity(self, loader) -> None:
        """One ``plots/sim_<patient>.png`` block grid per slide of
        ``loader`` (the ``umeml_gan_plot`` variant, reference
        ``umeml_gan_plot.py:124-168``); nothing without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from matplotlib import patches as mpatches
        except Exception:
            return
        plot_dir = osp.join(self.output_dir, "plots")
        os.makedirs(plot_dir, exist_ok=True)
        for batch in loader:
            sim = self.similarity_grids(batch).float().cpu().numpy()  # every rank's forward
            if not is_primary():
                continue
            for i, pid in enumerate(batch["patient_id"]):
                grid = sim[i]
                grid = (grid - grid.min()) / (grid.max() - grid.min() + 1e-6)
                grid = grid * 0.5 + 0.5  # the reference's rescale into the upper Blues half
                gap, block = 5, 20
                fig_size = (block + gap) * grid.shape[1] / 100
                fig, ax = plt.subplots(figsize=(fig_size, fig_size), dpi=100)
                for r in range(grid.shape[0]):
                    for c in range(grid.shape[1]):
                        ax.add_patch(mpatches.Rectangle(
                            (c * (block + gap), r * (block + gap)), block, block,
                            linewidth=0, facecolor=plt.cm.Blues(grid[r, c])))
                ax.set_xlim(0, grid.shape[1] * (block + gap))
                ax.set_ylim(0, grid.shape[0] * (block + gap))
                ax.invert_yaxis()
                ax.axis("off")
                fig.patch.set_alpha(0.0)
                fig.savefig(osp.join(plot_dir, f"sim_{pid}.png"), bbox_inches="tight",
                            pad_inches=0.1, transparent=True)
                plt.close(fig)

    def _plot_importance(self) -> None:
        """Render the current importance dumps to PNGs beside them
        (reference ``trainer.py:27-44``); nothing without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        if not is_primary():
            return
        for fp in getattr(self, "_imp_files", {}).values():
            if not osp.isfile(fp) or osp.getsize(fp) == 0:  # UMEML dumps no importances
                continue
            data = np.loadtxt(fp)
            data = np.atleast_2d(data)
            fig = plt.figure(figsize=(data.shape[1] / 10, max(data.shape[0], 1) / 10))
            ax = fig.add_axes([0, 0, 1, 1])
            ax.imshow(data, cmap="Blues", aspect="auto", interpolation="nearest")
            ax.axis("off")
            fig.savefig(fp.replace(".txt", ".png"), dpi=100)
            plt.close(fig)

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
