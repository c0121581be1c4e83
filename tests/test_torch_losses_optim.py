"""Losses and optimizers of the PyTorch port against ``imp_tpu`` / optax on
the CPU.

Losses: every function behind ``build_loss`` plus the CCA-epoch losses, on
the same numpy inputs, values (and for ``cca_loss`` and
``similarity_alignment_loss`` gradients) to rtol 1e-5 / atol 1e-6 — float32
on both sides, different summation order.  ``cca_loss`` runs on a wide
matrix (rank-deficient cross-covariance, as in training) through
``torch.linalg.svdvals``; its gradient is held to 1e-4.

Optimizers: 12-step parameter paths of every ``OPTIM.NAME`` against the JAX
builder's optax chain, with the 1-epoch linear warmup and the cosine
schedule over 3 updates per epoch (so the path crosses every epoch) and a
decay mask; the gradients are the same numpy function of each side's own
parameters.  Updated parameters to rtol 1e-4, atol 1e-6 (float32; Adam's
rescaling amplifies rounding).  Then the GAN optimizers' chain and the
schedule table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imp_tpu.losses as JL
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.optim import build_lr_schedule as jax_schedule
from imp_tpu.optim import build_optimizer as jax_build_optimizer
from imp_torch.config import get_cfg_default
from imp_torch.losses import survival as L
from imp_torch.optim import build_lr_schedule, build_optimizer, gan_optimizer, lr_at_epoch

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _surv_inputs(seed=0, b=6, bins=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, bins)).astype(np.float32)
    y = rng.integers(0, bins, size=b).astype(np.int32)
    c = (rng.random(b) < 0.4).astype(np.float32)
    t = rng.uniform(1, 50, size=b).astype(np.float32)
    return logits, y, c, t


@pytest.mark.parametrize("alpha,reduction", [(0.0, "mean"), (0.5, "mean"), (0.4, "sum")])
def test_nll_loss_new_matches_jax(alpha, reduction):
    logits, y, c, _ = _surv_inputs()
    want = JL.build_loss("nllsurvloss_new", alpha=alpha, reduction=reduction)(
        jnp.asarray(logits), jnp.asarray(y), jnp.asarray(c))
    got = L.build_loss("nllsurvloss_new", alpha=alpha, reduction=reduction)(
        torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(c))
    _close(got, want)


def test_hazard_losses_match_jax():
    logits, y, c, t = _surv_inputs(seed=1)
    jh = jax.nn.sigmoid(jnp.asarray(logits))
    th = torch.sigmoid(torch.from_numpy(logits))
    _close(L.hazards_to_survival(th), JL.hazards_to_survival(jh))
    jy, jc, ty, tc = jnp.asarray(y), jnp.asarray(c), torch.from_numpy(y), torch.from_numpy(c)
    for name in ("nllsurvloss", "cesurvloss"):
        want = JL.build_loss(name)(jh, JL.hazards_to_survival(jh), jy, jc)
        got = L.build_loss(name)(th, L.hazards_to_survival(th), ty, tc)
        _close(got, want)
        # S omitted: computed from the hazards
        _close(L.build_loss(name)(th, None, ty, tc), want)
    _close(L.build_loss("coxsurvloss")(torch.from_numpy(logits[:, :1]), torch.from_numpy(t), tc),
           JL.build_loss("coxsurvloss")(jnp.asarray(logits[:, :1]), jnp.asarray(t), jc))
    _close(L.build_loss("celoss")(torch.from_numpy(logits), ty),
           JL.build_loss("celoss")(jnp.asarray(logits), jy))


def test_kd_kl_cosine_orthogonal_match_jax():
    rng = np.random.default_rng(2)
    a, b, p, g = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(4))
    ja, jb, jp, jg = map(jnp.asarray, (a, b, p, g))
    ta, tb, tp, tg = map(torch.from_numpy, (a, b, p, g))
    _close(L.kd_loss(ta, tb, T=5.0), JL.kd_loss(ja, jb, T=5.0))
    _close(L.kl_loss(ta, tb), JL.kl_loss(ja, jb))
    _close(L.cosine_loss(ta, tb), JL.cosine_loss(ja, jb))
    _close(L.orthogonal_loss(ta, tb, tp, tg), JL.orthogonal_loss(ja, jb, jp, jg))


def test_cca_and_similarity_alignment_values_and_gradients_match_jax():
    rng = np.random.default_rng(3)
    # 8 slides x (7 tokens x 16): a rank-deficient 112 x 112 cross-covariance
    x = rng.normal(size=(8, 112)).astype(np.float32)
    y = (0.5 * x + rng.normal(size=(8, 112))).astype(np.float32)
    want, (wgx, wgy) = jax.value_and_grad(JL.cca_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    got = L.cca_loss(tx, ty)
    got.backward()
    _close(got, want)
    _close(tx.grad, wgx, rtol=1e-4, atol=1e-6)
    _close(ty.grad, wgy, rtol=1e-4, atol=1e-6)

    p, h = x[:, :48], y[:, 48:96]
    want, (wgp, wgh) = jax.value_and_grad(JL.similarity_alignment_loss, argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(h))
    tp, th = torch.from_numpy(p).requires_grad_(), torch.from_numpy(h).requires_grad_()
    got = L.similarity_alignment_loss(tp, th)
    got.backward()
    _close(got, want)
    _close(tp.grad, wgp, rtol=1e-4, atol=1e-6)
    _close(th.grad, wgh, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

STEPS, UPDATES_PER_EPOCH = 12, 3
SHAPES = {"a": (4, 3), "b": (5,), "gen": (3, 2)}
MASK = {"a": True, "b": True, "gen": False}  # "gen" stays out of the decay


def _optim_cfgs(name, nesterov=False):
    cfgs = []
    for get in (jax_cfg_default, get_cfg_default):
        cfg = get()
        o = cfg.OPTIM
        o.NAME, o.LR, o.WEIGHT_DECAY, o.MAX_EPOCH = name, 0.01, 0.05, 4
        o.LR_SCHEDULER, o.WARMUP_EPOCH, o.WARMUP_TYPE, o.WARMUP_MIN_LR = "cosine", 1, "linear", 1e-3
        o.MOMENTUM, o.SGD_NESTEROV = 0.9, nesterov
        cfgs.append(cfg)
    return cfgs


def _grad(name, p, t, rng_seed=5):
    """The same numpy gradient for both sides: a pull toward a target plus
    step noise, from each side's own parameters."""
    rng = np.random.default_rng(rng_seed * 1000 + t * 10 + sorted(SHAPES).index(name))
    target = np.linspace(-1, 1, int(np.prod(SHAPES[name]))).reshape(SHAPES[name])
    return (0.5 * (p - target) + rng.normal(size=SHAPES[name])).astype(np.float32)


@pytest.mark.parametrize("name,nesterov", [
    ("adam", False), ("amsgrad", False), ("adamw", False), ("radam", False),
    ("sgd", False), ("sgd", True), ("rmsprop", False),
])
def test_optimizer_paths_match_optax(name, nesterov):
    jcfg, tcfg = _optim_cfgs(name, nesterov)
    rng = np.random.default_rng(4)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}

    tx = jax_build_optimizer(jcfg.OPTIM, UPDATES_PER_EPOCH, decay_mask=MASK)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    names = sorted(SHAPES)
    tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in names]
    opt = build_optimizer(tcfg.OPTIM, tparams, UPDATES_PER_EPOCH,
                          decay_mask=[MASK[k] for k in names])
    for t in range(STEPS):
        jg = {k: jnp.asarray(_grad(k, np.asarray(jp[k]), t)) for k in SHAPES}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(_grad(k, p.detach().numpy(), t)) for k, p in zip(names, tparams)])
        for k, p in zip(names, tparams):
            _close(p, jp[k], rtol=1e-4, atol=1e-6)
    assert opt.count == STEPS


def test_optimizer_state_round_trip_and_none_gradients():
    _, tcfg = _optim_cfgs("adam")
    rng = np.random.default_rng(6)
    mk = lambda: [torch.nn.Parameter(torch.from_numpy(rng.normal(size=s).astype(np.float32)))  # noqa: E731
                  for s in SHAPES.values()]
    a = mk()
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    oa, ob = build_optimizer(tcfg.OPTIM, a, 3), build_optimizer(tcfg.OPTIM, b, 3)
    grads = [torch.ones_like(p) for p in a]
    oa.step(grads)
    ob.load_state_dict(oa.state_dict())
    for p, q in zip(a, b):
        q.data.copy_(p.data)
    oa.step([None, grads[1], None])  # None = a zero gradient, as JAX's for an unused param
    ob.step([torch.zeros_like(a[0]), grads[1], torch.zeros_like(a[2])])
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_gan_chain_matches_optax():
    lr, wd = 1e-4, 1e-4
    chain = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                        optax.scale_by_learning_rate(lr))
    rng = np.random.default_rng(7)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = chain.init(jp)
    names = sorted(SHAPES)
    tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in names]
    opt = gan_optimizer(tparams, lr, wd)
    for t in range(STEPS):
        jg = {k: jnp.asarray(_grad(k, np.asarray(jp[k]), t, 9)) for k in SHAPES}
        updates, state = chain.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(_grad(k, p.detach().numpy(), t, 9)) for k, p in zip(names, tparams)])
    for k, p in zip(names, tparams):
        _close(p, jp[k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("sched", ["cosine", "single_step", "multi_step"])
def test_schedule_table_matches_jax(sched):
    jcfg, tcfg = _optim_cfgs("adam")
    for cfg in (jcfg, tcfg):
        cfg.OPTIM.LR_SCHEDULER, cfg.OPTIM.STEPSIZE = sched, (2, 3)
    js, ts = jax_schedule(jcfg.OPTIM, UPDATES_PER_EPOCH), build_lr_schedule(tcfg.OPTIM, UPDATES_PER_EPOCH)
    for count in range(0, 20):
        assert ts(count) == pytest.approx(float(js(count)), rel=1e-6)
        # the lr of update t is the epoch table entry t // updates_per_epoch
        assert ts(count) == lr_at_epoch(tcfg.OPTIM, min(count // UPDATES_PER_EPOCH, 4))
