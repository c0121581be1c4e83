"""Export a UMEML_GAN serving artifact of the PyTorch port.

Usage:
    python -m imp_torch.tools.export_model --export-dir DIR \
        --config-file configs/Survival/UMEML_GAN.yaml \
        (--params WEIGHTS.pt | --random-init --seed N) \
        [--attention nystrom|flash] [--batch-size 8] [--omic-means MEANS.npy] \
        [KEY VALUE ...]

``--params`` is a state dict of the port's UMEML_GAN (``torch.save``), for
example from :func:`imp_torch.convert.umeml_gan_state_dict`.  The head has
4 survival bins for Survival and one logit per class of the task's label
set otherwise (6 for Classification, 3 for Grading and Subtyping).  The gene
groups are the DataManager's even-chunk fallback over
``DATASET.OMIC.DIM`` genes; ``omic_means`` defaults to zeros.  The artifact
is what ``python -m imp_torch.tools.serve --artifact DIR`` hosts.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def setup_cfg(args):
    from imp_torch.config import get_cfg_default

    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.attention:
        cfg.TPU.ATTENTION = args.attention
    cfg.freeze()
    return cfg


def main(args) -> dict:
    from imp_torch.data.datasets import TASK_SPECS
    from imp_torch.models import build_model, survival_num_classes
    from imp_torch.serving import even_gene_groups, export_model, mbtrain_batch_template

    if args.random_init == bool(args.params):
        raise SystemExit("give exactly one of --params FILE and --random-init")
    cfg = setup_cfg(args)
    num_genes = cfg.DATASET.OMIC.DIM
    groups = even_gene_groups(num_genes, cfg.MODEL.UMEML.PROTOTYPES)
    model = build_model(
        cfg.MODEL.NAME,
        cfg=cfg,
        num_classes=survival_num_classes(
            cfg.TASK.NAME, len(TASK_SPECS[cfg.TASK.NAME.lower()]["classnames"])),
        gene_group_indexes=groups,
        device="cpu",
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.params:
        model.load_state_dict(torch.load(args.params, map_location="cpu", weights_only=True))
    omic_means = (
        np.load(args.omic_means) if args.omic_means else np.zeros(num_genes, np.float32)
    )
    manifest = export_model(
        model, cfg, mbtrain_batch_template(cfg, args.batch_size, num_genes),
        args.export_dir, omic_means,
    )
    print(
        f"exported {manifest['model']} ({manifest['task']}, batch "
        f"{manifest['batch_size']}, attention {manifest['attention']}) "
        f"-> {args.export_dir}"
    )
    return manifest


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--export-dir", required=True, help="artifact output directory")
    p.add_argument("--config-file", default="")
    p.add_argument("--params", default="", help="state dict (.pt) of the port's model")
    p.add_argument("--random-init", action="store_true", help="seeded random weights")
    p.add_argument("--seed", type=int, default=0, help="init seed for --random-init")
    p.add_argument("--attention", choices=("nystrom", "flash"), default="")
    p.add_argument("--batch-size", type=int, default=8, help="exported batch size")
    p.add_argument("--omic-means", default="", help=".npy of train-set gene means")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
