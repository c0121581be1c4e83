"""``TRAINER.PREC`` bf16 (``fp16`` for CMTA) in ``StandardTrainer``: one step
of CMTA under flash and of HFB (its BatchNorm statistics stay float32 and
fold in the bf16 batch's statistics as flax's do), the port against the
JAX trainer's ``_train_body`` on the CPU at batch 4, with the criterion of
``tests/test_torch_precision.py`` (the body is
``tests/test_torch_precision_nets.py``'s, in a file of its own so that each
file stays near a minute).

CMTA's L1 alignment is a sum of signs of differences of near-equal cls
tokens: a 0.1 % change of CMTA's weights moves its float32 gradients by
13 %, so bf16 cannot resolve them in either framework.  CMTA's gradients
are held with ``LOSS.CMTA_ALPHA 0``, and the alignment term's value at its
configured weight to the same criterion.
"""

import pytest

from test_torch_precision import one_torch_thread
from test_torch_precision_nets import check_standard_step
from test_torch_zoo import no_dropout
from test_torch_zoo_trainers import tree

__all__ = ["no_dropout", "one_torch_thread", "tree"]  # fixtures of this file


@pytest.mark.parametrize("name", ["CMTA", "HFB"])
def test_one_fusion_trainer_step_under_bf16_matches_jax(name, tree, tmp_path, no_dropout):
    check_standard_step(name, tree, tmp_path)
