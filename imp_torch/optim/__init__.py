from .builders import (
    Optimizer,
    build_lr_schedule,
    build_optimizer,
    gan_optimizer,
    lr_at_epoch,
)

__all__ = ["Optimizer", "build_lr_schedule", "build_optimizer", "gan_optimizer", "lr_at_epoch"]
