"""Served outputs of the PyTorch port against the JAX package's for the
unimodal baselines, both exported from a trainer (see
``tests/test_torch_export_trainer_jax.py``): TransMIL under flash and
Nyström and ABMIL (weights carried by ``imp_torch.convert.mil_state_dict``),
SNN (by ``zoo_state_dict``); every output within 1e-4."""

import pytest

from imp_torch.convert import mil_state_dict, zoo_state_dict

from test_torch_export_trainer_jax import check, one_torch_thread, served_pair, tree

__all__ = ["one_torch_thread", "tree"]  # fixtures of this file


@pytest.mark.parametrize("attention", ["flash", "nystrom"])
def test_transmil_serves_as_jax_does(tree, tmp_path, attention):
    out = served_pair(tree, tmp_path, "TransMIL", "TransMIL", mil_state_dict,
                      opts=("TPU.ATTENTION", attention), with_omics=False)
    check(*out)
    assert out[3]["kind"] == "generic" and out[3]["attention"] == attention


def test_abmil_serves_as_jax_does(tree, tmp_path):
    out = served_pair(tree, tmp_path, "ABMIL", "ABMIL", mil_state_dict, with_omics=False)
    check(*out)
    assert out[3]["kind"] == "generic" and out[3]["attention"] == "none"


def test_snn_serves_as_jax_does(tree, tmp_path):
    out = served_pair(tree, tmp_path, "SNN", "SNN", zoo_state_dict)
    check(*out)
    assert out[3]["kind"] == "generic" and list(out[3]["batch_keys"]) == list(
        out[2]["batch_keys"])
