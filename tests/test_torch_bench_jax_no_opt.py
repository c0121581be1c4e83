"""The port's bench step with ``no_opt`` against the JAX package's
(``bench.build_step(no_opt=True)``) on the CPU, at the size and dropout of
``test_torch_bench_jax.py``: the loss of one step, whose gradients are
consumed as ``loss + 0 * sum(g)``, and no main parameter moves."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imp_torch.convert import umeml_gan_state_dict
from test_torch_bench_jax import _flat, _port, jax_build, RTOL, ATOL
from test_torch_train import no_jax_dropout, one_torch_thread  # noqa: F401  (fixtures)


def test_no_opt_loss_matches_jax(no_jax_dropout):
    jstep, jstate, jbatch, _ = jax_build(no_opt=True)
    step, state, batch = _port(no_opt=True)
    model = state["model"]
    model.load_state_dict(umeml_gan_state_dict(_flat(jstate["params"])), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, jloss = jstep(jstate, jbatch, jax.random.PRNGKey(3), jnp.float32(0.0))
    loss = step(state, batch, torch.Generator().manual_seed(0), 0.0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    moved = [k for k, v in model.state_dict().items()
             if not k.startswith("gan_") and not torch.equal(v, before[k])]
    assert not moved  # no main update
