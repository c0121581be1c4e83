"""The auxiliary ops of the PyTorch port (``imp_torch.ops.extras``) against
``imp_tpu.ops.extras`` on the CPU: sharpening, one-hot rows (an
out-of-range label gives zeros, as ``jax.nn.one_hot``), the ramp-ups, the
EMA updates over a state dict and a list, L2 normalisation of a zero row,
and the Sinkhorn assignment with its straight-through Gumbel draw fed JAX's
own uniforms: the hard rows, the argmax clusters and the gradient through
the soft rows.  Float32 on both sides; 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imp_torch.ops import extras
from imp_tpu.ops import extras as jextras

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_sharpen_onehot_and_l2_normalize_match_jax():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(5), size=4).astype(np.float32)
    np.testing.assert_allclose(extras.sharpen_prob(_t(p), 3.0).numpy(),
                               np.asarray(jextras.sharpen_prob(jnp.asarray(p), 3.0)),
                               rtol=TOL, atol=TOL)
    labels = np.array([0, 3, 5, -1, 2])
    got = extras.create_onehot(torch.from_numpy(labels), 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jextras.create_onehot(jnp.asarray(labels), 5)))
    x = rng.normal(size=(3, 7)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(extras.l2_normalize(_t(x)).numpy(),
                               np.asarray(jextras.l2_normalize(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length", [0, 5, 80])
def test_rampups_match_jax(length):
    for current in (-3, 0, 1.5, 4, 5, 79, 80, 200):
        assert extras.sigmoid_rampup(current, length) == jextras.sigmoid_rampup(current, length)
        assert extras.linear_rampup(current, length) == jextras.linear_rampup(current, length)


def test_momentum_and_ema_updates_match_jax():
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    ema = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    want = jax.tree_util.tree_map(np.asarray, jextras.ema_tree_update(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in ema.items()}, 0.99))
    got = extras.ema_tree_update({k: _t(v) for k, v in params.items()},
                                 {k: _t(v) for k, v in ema.items()}, 0.99)
    as_list = extras.ema_tree_update([_t(params["a"]), _t(params["b"])],
                                     [_t(ema["a"]), _t(ema["b"])], 0.99)
    for i, k in enumerate(("a", "b")):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(as_list[i].numpy(), got[k].numpy())
    np.testing.assert_allclose(
        extras.momentum_update(_t(ema["a"]), _t(params["a"]), 0.9).numpy(),
        np.asarray(jextras.momentum_update(jnp.asarray(ema["a"]), jnp.asarray(params["a"]), 0.9)),
        rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="different tensors"):
        extras.ema_tree_update({"a": _t(params["a"])}, {"c": _t(ema["a"])}, 0.5)


def test_sinkhorn_with_jax_uniforms_matches_jax():
    """JAX's ``distributed_sinkhorn`` with a key, against the port's
    Sinkhorn assignment and Gumbel draw fed the uniforms that key gives
    (``jax.random.uniform(key, [B, K])``, as JAX draws them inside)."""
    rng = np.random.default_rng(2)
    out = rng.uniform(-1, 1, size=(12, 6)).astype(np.float32)  # cosine scores
    weights = rng.normal(size=(12, 6)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jloss(o):
        hard, _ = jextras.distributed_sinkhorn(o, key, 3, 0.05, 0.5)
        return jnp.sum(hard * weights)

    jhard, jidx = jextras.distributed_sinkhorn(jnp.asarray(out), key, 3, 0.05, 0.5)
    jgrad = jax.grad(jloss)(jnp.asarray(out))
    uniforms = _t(jax.random.uniform(key, out.shape))

    o = _t(out).requires_grad_()
    L = extras.sinkhorn_assignment(o, 3, 0.05)
    hard = extras.gumbel_hard_assignment(L, uniforms, 0.5)
    (hard * _t(weights)).sum().backward()
    np.testing.assert_allclose(hard.detach().numpy(), np.asarray(jhard), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(torch.argmax(L, dim=1).numpy(), np.asarray(jidx))
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    assert np.allclose(hard.detach().numpy().sum(axis=1), 1.0)


def test_distributed_sinkhorn_draws_from_its_generator():
    out = _t(np.random.default_rng(3).uniform(-1, 1, size=(8, 4)))
    a, ia = extras.distributed_sinkhorn(out, torch.Generator().manual_seed(7))
    b, ib = extras.distributed_sinkhorn(out, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and torch.equal(ia, ib)
    assert torch.equal(a.round(), a.round().clamp(0, 1)) and torch.allclose(a.sum(1), torch.ones(8))
    L = extras.sinkhorn_assignment(out)  # its last step normalises each sample's row
    np.testing.assert_allclose(L.sum(1).numpy(), np.ones(8), rtol=1e-5)
