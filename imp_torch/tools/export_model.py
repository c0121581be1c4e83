"""Export a serving artifact of the PyTorch port (``imp_torch.serving``): the
eval forward as a ``torch.export`` program (``model.pt2``) with its params,
manifest and aux arrays.  The counterpart of ``tools/export_model.py``.

From a trained checkpoint, any trainer (JAX's route)::

    python -m imp_torch.tools.export_model --root DATA --seed 1 --trainer MBTRAIN \
        --config-file configs/Survival/UMEML_GAN.yaml \
        --model-dir output/umeml_gan_s1 --export-dir exported/umeml_gan_s1 \
        [--load-epoch N] [--check] [--device cuda|cpu] [KEY VALUE ...]

The trainer is built from the config (``imp_torch.engine.build_trainer``),
loads the checkpoint of ``--model-dir`` (``--load-epoch``, else the best,
else the last) and exports its eval forward at the shapes of its first test
batch (``imp_torch.serving.export_trainer``).  ``--check`` reloads the
artifact and asserts that its outputs match the trainer's eval forward on
that batch (1e-5).

A UMEML_GAN from a state dict or seeded weights::

    python -m imp_torch.tools.export_model --export-dir DIR \
        --config-file configs/Survival/UMEML_GAN.yaml \
        (--params WEIGHTS.pt | --random-init --seed N) \
        [--attention nystrom|flash] [--batch-size 8] [--omic-means MEANS.npy] \
        [--device cuda|cpu] [KEY VALUE ...]

``--params`` is a state dict of the port's UMEML_GAN (``torch.save``), for
example from :func:`imp_torch.convert.umeml_gan_state_dict`.  The head has
4 survival bins for Survival and one logit per class of the task's label
set otherwise (6 for Classification, 3 for Grading and Subtyping).  The gene
groups are the DataManager's even-chunk fallback over
``DATASET.OMIC.DIM`` genes; ``omic_means`` defaults to zeros.

The program runs on the device it was exported on (``--device``, default
``cuda``).  Either artifact is what ``python -m imp_torch.tools.serve
--artifact DIR`` hosts.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

#: the largest difference ``--check`` accepts between the served program and
#: the trainer's eval forward
CHECK_TOL = 1e-5


def setup_cfg(args):
    from imp_torch.config import clean_cfg, get_cfg_default

    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.trainer:
        if args.root:
            cfg.DATASET.ROOT = args.root
        if args.seed:
            cfg.SEED = args.seed
            cfg.DATASET.FOLD = args.seed  # the seed is the fold id
        cfg.TRAINER.NAME = args.trainer
        if args.model_dir:
            cfg.OUTPUT_DIR = args.model_dir
        # export needs the eval program of one device
        cfg.TPU.MESH_SHAPE = tuple(1 for _ in cfg.TPU.MESH_AXES)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.attention:
        cfg.TPU.ATTENTION = args.attention
    if args.trainer:
        clean_cfg(cfg, args.trainer)
    cfg.freeze()
    return cfg


def check_trainer_artifact(trainer, export_dir: str) -> float:
    """The largest difference between the artifact served on the trainer's
    device and the trainer's eval forward, over every output, on the batch
    the artifact was exported at; raises AssertionError above
    :data:`CHECK_TOL`."""
    from imp_torch.engine.precision import amp_call
    from imp_torch.serving import example_eval_batch, load_model

    served = load_model(export_dir, device=trainer.device)
    batch, _ = example_eval_batch(trainer)
    with torch.no_grad(), trainer._scope():
        want = amp_call(trainer.model, "forward", trainer.cdtype, batch, train=False)
    want = want if isinstance(want, dict) else {"logits": want}
    got = served.predict({k: v.cpu().numpy() for k, v in batch.items()})
    err = max(float(np.max(np.abs(got[k] - want[k].float().cpu().numpy()))) for k in got)
    if not err <= CHECK_TOL:  # not an assert: it must hold under python -O too
        raise AssertionError(f"served program vs the trainer's eval forward: {err}")
    return err


def export_from_trainer(args) -> dict:
    from imp_torch.engine import build_trainer
    from imp_torch.serving import export_trainer
    from imp_torch.utils.tools import set_random_seed

    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        set_random_seed(cfg.SEED)
    trainer = build_trainer(cfg, device=args.device)
    if args.model_dir:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
    manifest = export_trainer(trainer, args.export_dir)
    print(f"exported {manifest['model']} ({manifest['trainer']}, {manifest['task']}, kind "
          f"{manifest['kind']}, batch {manifest['batch_size']}, device {manifest['device']}) "
          f"-> {args.export_dir}")
    if args.check:
        err = check_trainer_artifact(trainer, args.export_dir)
        print(f"check OK: the served program matches the trainer's eval forward ({err:.2e})")
        manifest = dict(manifest, check_max_abs_diff=err)
    return manifest


def export_from_params(args) -> dict:
    from imp_torch.data.datasets import TASK_SPECS
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.serving import even_gene_groups, export_model, mbtrain_batch_template

    if args.random_init == bool(args.params):
        raise SystemExit("give exactly one of --params FILE and --random-init")
    if args.check:
        raise SystemExit("--check compares with a trainer: give --trainer")
    cfg = setup_cfg(args)
    num_genes = cfg.DATASET.OMIC.DIM
    groups = even_gene_groups(num_genes, cfg.MODEL.UMEML.PROTOTYPES)
    model = build_model(
        cfg.MODEL.NAME,
        cfg=cfg,
        num_classes=survival_num_classes(
            cfg.TASK.NAME, len(TASK_SPECS[cfg.TASK.NAME.lower()]["classnames"])),
        gene_group_indexes=groups,
        device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.params:
        model.load_state_dict(torch.load(args.params, map_location=args.device,
                                         weights_only=True))
    omic_means = (
        np.load(args.omic_means) if args.omic_means else np.zeros(num_genes, np.float32)
    )
    manifest = export_model(
        model, cfg, mbtrain_batch_template(cfg, args.batch_size, num_genes),
        args.export_dir, omic_means,
    )
    print(
        f"exported {manifest['model']} ({manifest['task']}, batch "
        f"{manifest['batch_size']}, attention {manifest['attention']}, device "
        f"{manifest['device']}) -> {args.export_dir}"
    )
    return manifest


def main(args) -> dict:
    """Export (and with ``--check``, verify) one artifact; returns its
    manifest (plus ``check_max_abs_diff`` after a check)."""
    return export_from_trainer(args) if args.trainer else export_from_params(args)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--export-dir", required=True, help="artifact output directory")
    p.add_argument("--config-file", default="")
    p.add_argument("--root", default="", help="dataset root (trainer route)")
    p.add_argument("--trainer", default="", help="trainer name: export from a checkpoint")
    p.add_argument("--model-dir", default="",
                   help="training OUTPUT_DIR holding the checkpoint to export")
    p.add_argument("--load-epoch", type=int, default=None)
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare with the trainer's eval forward")
    p.add_argument("--params", default="", help="state dict (.pt) of the port's model")
    p.add_argument("--random-init", action="store_true", help="seeded random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed (= fold id) of the trainer route; init seed of --random-init")
    p.add_argument("--attention", choices=("nystrom", "flash"), default="")
    p.add_argument("--batch-size", type=int, default=8, help="exported batch size")
    p.add_argument("--omic-means", default="", help=".npy of train-set gene means")
    p.add_argument("--device", default="cuda",
                   help="device to export on and the program's (default cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` (default: the process's) and run :func:`main`."""
    return main(parser().parse_args(argv))


if __name__ == "__main__":
    run()
