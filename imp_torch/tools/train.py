"""Training / evaluation entry point of the PyTorch port — the counterpart of
``tools/train.py``, with the same CLI minus ``--platform`` plus ``--device``:

    python -m imp_torch.tools.train --root DATA --seed 1 --trainer MBTRAIN \\
        --config-file configs/Survival/UMEML_GAN.yaml \\
        --output-dir output/umeml_gan_s1 [--device cuda] [KEY VALUE ...]

``--trainer`` is MBTRAIN, TransMIL or ABMIL (each with its config file).

On several cards, one process each, under ``torchrun``:

    torchrun --standalone --nproc-per-node 2 -m imp_torch.tools.train ... \
        TPU.MESH_AXES "('data','seq')" TPU.MESH_SHAPE "(1,2)" \
        TPU.SP_ATTENTION ring

(``(2,1)`` splits the batch instead; ``gather`` is the other layout).  One
process is the world of one.  Rank 0 writes the log file, the metric lines
and the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Iterator, Optional, Sequence

import torch.distributed as dist

from ..config import clean_cfg, get_cfg_default
from ..parallel import is_primary, maybe_initialize_distributed
from ..utils.logger import setup_logger
from ..utils.tools import collect_env_info, set_random_seed


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed:
        cfg.SEED = args.seed
        # the 5-fold protocol reuses the seed as the fold id
        # (reference tools/train.py:40-42)
        cfg.DATASET.FOLD = args.seed
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone


def setup_cfg(args):
    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    clean_cfg(cfg, args.trainer)
    cfg.freeze()
    return cfg


@contextlib.contextmanager
def session(args) -> Iterator:
    """The frozen cfg of ``args``, with the seed set and the log written to
    ``OUTPUT_DIR/log.txt`` until the block ends."""
    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)
    tee = setup_logger(cfg.OUTPUT_DIR) if is_primary() else None
    try:
        if cfg.VERBOSE:
            print("*** Config ***")
            print(cfg)
            print("*** Env info ***")
            print(collect_env_info())
        yield cfg
    finally:
        if tee is not None:  # restore stdout for an in-process caller
            sys.stdout = tee.console
            tee.close()


def main(args) -> Optional[float]:
    owns_group = not dist.is_initialized()
    device = maybe_initialize_distributed(args.device)  # torchrun's ranks, else one
    try:
        return _run(args, device)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> Optional[float]:
    with session(args) as cfg:
        from ..engine import build_trainer

        trainer = build_trainer(cfg, device=device)
        if args.eval_only:
            trainer.load_model(args.model_dir or cfg.OUTPUT_DIR, epoch=args.load_epoch)
            return trainer.test(
                umeml_gan_test_without_omic_ratio=args.umeml_gan_test_without_omic_ratio,
                umeml_gan_test_insample_without_omic_ratio=args.umeml_gan_test_insample_without_omic_ratio,
            )
        if not args.no_train:
            return trainer.train(
                args.umeml_gan_test_without_omic_ratio,
                args.umeml_gan_test_insample_without_omic_ratio,
            )
        return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument("--resume", type=str, default="", help="checkpoint directory to resume from")
    parser.add_argument("--seed", type=int, default=-1, help="seed (= fold id)")
    parser.add_argument("--config-file", type=str, default="", help="path to config file")
    parser.add_argument("--trainer", type=str, default="", help="name of trainer")
    parser.add_argument("--backbone", type=str, default="", help="name of backbone")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument("--model-dir", type=str, default="",
                        help="load model for eval-only from this directory")
    parser.add_argument("--load-epoch", type=int, default=None, help="load model saved at this epoch")
    parser.add_argument("--no-train", action="store_true", help="do not call trainer.train()")
    parser.add_argument("--umeml_gan_test_without_omic_ratio", type=float, default=-1,
                        help="fraction of eval samples whose omics are removed entirely")
    parser.add_argument("--umeml_gan_test_insample_without_omic_ratio", type=float, default=0,
                        help="fraction of omics features deleted per eval sample")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="modify config via KEY VALUE pairs")
    return parser


def run(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    """Parse ``argv`` (default: the process's) and run :func:`main`."""
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    run()
