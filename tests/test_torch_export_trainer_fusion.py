"""Served outputs of the PyTorch port against the JAX package's for the
fusion baselines, both exported from a trainer (see
``tests/test_torch_export_trainer_jax.py``): HFB (its BatchNorm running
statistics travel in the program's buffers) and CMTA (eight Nyström
TransLayers); weights carried by ``imp_torch.convert.zoo_state_dict``;
every output within 1e-4."""

import pytest

from imp_torch.convert import zoo_state_dict

from test_torch_export_trainer_jax import check, one_torch_thread, served_pair, tree

__all__ = ["one_torch_thread", "tree"]  # fixtures of this file


@pytest.mark.parametrize("trainer", ["HFB", "CMTA"])
def test_zoo_trainer_serves_as_jax_does(tree, tmp_path, trainer):
    out = served_pair(tree, tmp_path, trainer, trainer, zoo_state_dict)
    check(*out)
    assert out[3]["kind"] == "generic"
