"""CMTA (under Nyström and under flash's plain path) and HFB of the PyTorch
port against ``imp_tpu`` on the CPU, in eval and in train mode: the logits
and CMTA's four cls tokens to 1e-4, every parameter gradient to 1e-4 of the
larger of 1 and its largest value (or, with the JAX one, to 1e-4 of the
port's float64 gradient where float32 cannot resolve it), HFB's running
statistics to 1e-6 of flax's.  The checks, sizes and fixtures are those of
``tests/test_torch_zoo.py``, kept in a file of their own so that each file
stays well under a minute.
"""

import pytest

from test_torch_zoo import check_net, jax_attention, no_dropout, one_torch_thread

__all__ = ["jax_attention", "no_dropout", "one_torch_thread"]  # fixtures of this file


@pytest.mark.parametrize("name", ["cmta_nystrom", "cmta_flash", "hfb"])
def test_net_outputs_and_gradients_match_jax(name, no_dropout, jax_attention):
    if name == "cmta_flash":
        jax_attention("flash")
    check_net(name)
