from ..utils.registry import Registry

TRAINER_REGISTRY = Registry("TRAINER")


def build_trainer(cfg, device="cuda"):
    """The trainer ``cfg.TRAINER.NAME`` on ``device``: MBTRAIN, the
    unimodal baselines (ABMIL, TransMIL, SNN, SNNM) and the fusion baselines
    (MCAT, CMTA, Porpoise, ConCAT, ADD, HFB); CLIPOMIC raises its
    deferral."""
    from . import baselines, fusion_trainers, mbtrain  # noqa: F401  (register)
    from ..utils.registry import check_availability

    check_availability(cfg.TRAINER.NAME, list(TRAINER_REGISTRY.registered_names()))
    if cfg.VERBOSE:
        print(f"Loading trainer: {cfg.TRAINER.NAME}")
    return TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg, device=device)
