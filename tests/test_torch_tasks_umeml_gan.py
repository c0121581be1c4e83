"""UMEML_GAN with ``fusion="bilinear"`` (the Classification, Grading and
Subtyping configs) in the PyTorch port against ``imp_tpu`` on the CPU, at 3
classes (Grading) and 6 (Classification): the eval forward (logits and both
importance rows) to 1e-5 and one MBTRAIN main step against a JAX step built
as ``imp_tpu/engine/mbtrain.py`` builds it (loss to 1e-5, every gradient to
1e-4 of its largest value; a row without omics, so the main loss reaches
the generator).  The checks, sizes and fixtures are those of
``tests/test_torch_tasks.py``, kept in a file of their own so that each
file stays well under a minute.
"""

import pytest

from test_torch_tasks import TASKS, check_bilinear_model, jax_dropout_zero, one_torch_thread, tree

__all__ = ["jax_dropout_zero", "one_torch_thread", "tree"]  # fixtures of this file


@pytest.mark.parametrize("task", list(TASKS))
def test_bilinear_umeml_gan_forward_and_main_step_match_jax(tree, tmp_path, jax_dropout_zero,
                                                            task):
    check_bilinear_model(tree, tmp_path, task, "UMEML_GAN")
