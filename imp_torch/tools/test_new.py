"""External-cohort (CPTAC) evaluation entry point of the PyTorch port — the
counterpart of ``tools/test_new.py``, with the same CLI minus ``--platform``
plus ``--device``: loads a trained model and runs ``trainer.test_new``
against ``<DATASET.ROOT>/test/`` (``imp_torch/data/external.py``).

    python -m imp_torch.tools.test_new --root DATA --seed 1 --trainer MBTRAIN \\
        --config-file configs/Grading/UMEML_GAN.yaml \\
        --model-dir output/umeml_gan_g1 --output-dir output/umeml_gan_g1_cptac \\
        [--device cuda] [KEY VALUE ...]

The importance rows go to ``<OUTPUT_DIR>/test_new_{path,omic}.txt``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .train import build_parser, session


def main(args) -> float:
    with session(args) as cfg:
        from ..engine import build_trainer

        trainer = build_trainer(cfg, device=args.device)
        trainer.load_model(args.model_dir or cfg.OUTPUT_DIR, epoch=args.load_epoch)
        return trainer.test_new(
            cfg,
            umeml_gan_test_without_omic_ratio=max(args.umeml_gan_test_without_omic_ratio, 0),
            umeml_gan_test_insample_without_omic_ratio=args.umeml_gan_test_insample_without_omic_ratio,
        )


def run(argv: Optional[Sequence[str]] = None) -> float:
    """Parse ``argv`` (default: the process's) and run :func:`main`."""
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    run()
