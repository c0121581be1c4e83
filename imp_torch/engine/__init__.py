from ..utils.registry import Registry

TRAINER_REGISTRY = Registry("TRAINER")


def build_trainer(cfg, device="cuda"):
    """The trainer ``cfg.TRAINER.NAME`` on ``device`` (the port has MBTRAIN,
    ABMIL and TransMIL)."""
    from . import baselines, mbtrain  # noqa: F401  (register)
    from ..utils.registry import check_availability

    check_availability(cfg.TRAINER.NAME, list(TRAINER_REGISTRY.registered_names()))
    if cfg.VERBOSE:
        print(f"Loading trainer: {cfg.TRAINER.NAME}")
    return TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg, device=device)
