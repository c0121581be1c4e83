"""The config system and the loss exports of the PyTorch port against
``imp_tpu`` (ROADMAP A10): the defaults and each of the 53 configs under
``configs/`` give the same ``dump()`` in both packages (the YAML a run
logs), and ``imp_torch.losses`` exports the 19 names of
``imp_tpu.losses``, each one of the port's loss functions or classes."""

import glob
import os.path as osp

import pytest

import imp_torch.losses
import imp_tpu.losses
from imp_torch.config import get_cfg_default
from imp_tpu.config import get_cfg_default as jax_cfg_default

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = sorted(osp.relpath(p, REPO)
                 for p in glob.glob(osp.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def test_there_are_53_configs():
    assert len(CONFIGS) == 53


@pytest.mark.parametrize("config", [None] + CONFIGS)
def test_config_dumps_match_jax(config):
    cfg, jcfg = get_cfg_default(), jax_cfg_default()
    if config:
        cfg.merge_from_file(osp.join(REPO, config))
        jcfg.merge_from_file(osp.join(REPO, config))
    assert cfg.dump() == jcfg.dump()


def test_losses_export_the_names_of_jax():
    assert imp_torch.losses.__all__ == imp_tpu.losses.__all__
    assert len(imp_torch.losses.__all__) == 19
    for name in imp_torch.losses.__all__:
        obj = getattr(imp_torch.losses, name)
        assert getattr(obj, "__module__", "imp_torch.losses.survival").startswith(
            "imp_torch"), name
    assert set(imp_torch.losses.LOSS_REGISTRY.registered_names()) == set(
        imp_tpu.losses.LOSS_REGISTRY.registered_names())
