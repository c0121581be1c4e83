"""The port's bench step (``imp_torch.tools.bench.build_step``) against the
JAX package's (``bench.build_step`` at the repository's root) on the CPU.

Small size: batch 2, bags padded to 64 tokens of 32 features, hidden 32,
the fixed 3 360 genes in the reference's six groups.  Both sides draw the
batch from ``default_rng(0)``: the two batches are equal.  JAX's initial
parameters are copied into the port's model (in place, so its optimizers
keep them) before the first step.  Dropout is 0 on both sides
(``MODEL.DROPOUT`` through each package's ``build_model``, which the bench
looks up when it builds; the TransLayers' fixed 0.1 through
``test_torch_train.no_jax_dropout`` and the port's attention modules), and
the replacement ratio is 0.

* Two full steps: both losses; the gradients each of the four optimizers
  (generators, ``dis_p``, ``dis_o``, main) receives in each step, to rtol
  1e-4 plus an atol of 1e-4 of the tensor's max-abs gradient; and every
  parameter after each step to rtol 1e-4 / atol 1e-6, except the entries
  that ``test_torch_train._ill_conditioned`` flags for either step (Adam's
  input g + wd·p below 1e-6 on either side, where its first steps turn
  float32 noise into a share of the step); those are held to one
  learning-rate step per update they took.  The bench decays every main parameter, the
  generators' too, whose weights are small and whose gradients are tiny at
  this width: ~17 % of all entries are flagged, nearly all of them the
  generators'; outside the generators the flagged share stays under 5 %.
  The gradients held above hold those entries too.  The JAX gradients each
  optimizer receives come out of the jitted step through
  ``jax.debug.callback`` in wrappers of its optax transforms, set by the
  test; ``bench.py`` is not edited.

``no_opt`` is held in ``test_torch_bench_jax_no_opt.py`` (another compiled
JAX step: one file each keeps both well under a minute).
"""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import flax
import torch

import bench as jax_bench
import imp_tpu.models as jmodels
import imp_tpu.optim as joptim
import imp_torch.models as tmodels
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention
from imp_torch.tools import bench
from imp_tpu.engine.mbtrain import _merge
from test_torch_train import (  # noqa: F401  (fixtures)
    _assert_params_close, _flat, _ill_conditioned, no_jax_dropout, one_torch_thread,
)

SHAPE = {"batch_size": 2, "bag_pad": 64, "feat_dim": 32, "num_genes": 3360, "hidden": 32}
RTOL, ATOL = 1e-4, 1e-6
#: gradients: rtol, and an atol relative to each tensor's max-abs gradient
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
WD, GAN_LR = 1e-4, 1e-4
MAIN_LR = 1e-5  # the cosine schedule's warm-up epoch starts at WARMUP_MIN_LR


GEN = "gan_generator_"


def _share(masks) -> float:
    return sum(int(m.sum()) for m in masks.values()) / sum(m.numel() for m in masks.values())


def _phase(tree) -> str:
    keys = set(tree["params"])
    for phase, key in (("gen", "gan_generator_p2o"), ("dis_p", "gan_discriminator_p"),
                       ("dis_o", "gan_discriminator_o")):
        if key in keys and len(keys) <= 2:
            return phase
    return "main"


def _recording(tx, sink):
    """``tx`` whose ``update`` first hands its gradients to ``sink``."""

    def update(updates, state, params=None):
        jax.debug.callback(lambda u: sink.append(jax.tree_util.tree_map(np.asarray, u)), updates)
        return tx.update(updates, state, params)

    return optax.GradientTransformation(tx.init, update)


def _zero_dropout(build):
    def wrapped(name, cfg, **kw):
        cfg.MODEL.DROPOUT = 0.0
        return build(name, cfg=cfg, **kw)

    return wrapped


def jax_build(**knock):
    """JAX's (jitted step, initial state as numpy, batch, gradient sink) at
    dropout 0, its ``init`` compiled (run op by op it takes many seconds)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodels, "build_model", _zero_dropout(jmodels.build_model))
    init = flax.linen.Module.init

    def jit_init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, method=method, **kw))(rngs, *args)

    mp.setattr(flax.linen.Module, "init", jit_init)
    sink = []
    mp.setattr(optax, "chain", lambda *t, _c=optax.chain: _recording(_c(*t), sink))
    mp.setattr(joptim, "build_optimizer",
               lambda *a, _b=joptim.build_optimizer, **k: _recording(_b(*a, **k), sink))
    try:
        step, state, batch = jax_bench.build_step(**SHAPE, **knock)
    finally:
        mp.undo()
    return step, jax.tree_util.tree_map(np.asarray, state), batch, sink  # the step donates


@pytest.fixture(scope="module")
def jax_step(no_jax_dropout):
    return jax_build()


def _port(**knock):
    """The port's (step, state, batch) at dropout 0."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tmodels, "build_model", _zero_dropout(tmodels.build_model))
    try:
        step, state, batch = bench.build_step(**SHAPE, device="cpu", **knock)
    finally:
        mp.undo()
    for m in state["model"].modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    return step, state, batch


def _record(model, opts, sink):
    """Wrap each optimizer's step to append {phase: {name: gradient}}."""
    names = {id(p): n for n, p in model.named_parameters()}
    for phase, opt in opts.items():
        def record(grads, opt=opt, step=opt.step, phase=phase):
            sink.append((phase, {names[id(p)]: torch.zeros_like(p) if g is None else g.clone()
                                 for p, g in zip(opt.params, grads)}))
            step(grads)

        opt.step = record


def _assert_grads_close(params, jgrads, pgrads, what):
    """Each phase's gradients, the port's against JAX's, to GRAD_RTOL plus
    GRAD_ATOL_REL of the tensor's max-abs gradient."""
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    for phase, tree in jgrads.items():
        want = umeml_gan_state_dict(_flat(_merge(zeros, tree)))
        for k, got in pgrads[phase].items():
            w = want[k].numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * np.abs(w).max(),
                                       err_msg=f"{what}: {phase} gradient of {k}")


def test_two_bench_steps_match_jax(jax_step):
    jstep, jstate, jbatch, jsink = jax_step
    step, state, batch = _port()
    assert set(batch) == set(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    model = state["model"]
    model.load_state_dict(umeml_gan_state_dict(_flat(jstate["params"])), strict=True)
    psink = []
    _record(model, {"gen": state["gen_opt"], "dis_p": state["dis_p_opt"],
                    "dis_o": state["dis_o_opt"], "main": state["opt_state"]}, psink)
    g = torch.Generator().manual_seed(0)
    params_before = jstate["params"]
    masks = []
    for i in range(2):
        jsink.clear()
        jstate, jloss = jstep(jstate, jbatch, jax.random.PRNGKey(10 + i), jnp.float32(0.0))
        jax.effects_barrier()
        loss = step(state, batch, g, 0.0)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL, atol=ATOL,
                                   err_msg=f"loss of step {i}")
        jgrads = {_phase(t): t for t in jsink}
        pgrads = dict(psink[-4:])
        assert set(jgrads) == set(pgrads) == {"gen", "dis_p", "dis_o", "main"}
        _assert_grads_close(params_before, jgrads, pgrads, f"step {i}")
        masks.append(_ill_conditioned(params_before, jgrads, pgrads, lambda phase, k: WD))
        params_before = jax.tree_util.tree_map(np.asarray, jstate["params"])
        ill = {k: masks[0][k] | m for k, m in masks[-1].items()}
        assert _share(ill) < 0.2
        assert _share({k: m for k, m in ill.items() if not k.startswith(GEN)}) < 0.05
        # a flagged entry may move one learning-rate step the other way per
        # update: the generators take two a step (their own and the main's)
        _assert_params_close(model, jstate["params"], f"after step {i}", ill,
                             max_step=2 * (i + 1) * (GAN_LR + MAIN_LR))
