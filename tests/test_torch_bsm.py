"""``DATASET.USE_BSM`` — the chunk-averaged estimator of UMEML under MBTRAIN
(``imp_tpu/engine/mbtrain.py:290-343``) — in the PyTorch port against
``imp_tpu`` on the CPU, at a fixed token permutation (the permutation
cannot share bits across the frameworks: the port's step draws it from
:meth:`MBTRAIN.bsm_permutation`, which the test replaces).

UMEML at hidden 256 (Nyström over 128 landmarks), 32 features, bags padded to 48 and cut into chunks of
``BS_MICRO`` 20 (the bag is padded to 60 with masked tokens: three chunks),
``MODEL.UMEML.ALPHA`` 5, dropout 0 on both sides, JAX weights carried by
``imp_torch.convert.umeml_state_dict``.  The JAX loss is the body of its
``train_step_bsm`` on the same chunks: the mean over chunks of task +
ALPHA · modularity, one gradient.  Loss to 1e-5, every gradient to 1e-5 of
its largest value.  Where float32 cannot resolve a gradient that closely
(UMEML's ``layer_norm_o.weight``: here JAX's float32 gradient is 9.8e-5
and the port's 1.1e-4 of its largest value from the port's float64 replay
of the same loss, see also ``tests/test_torch_umeml.py``), the port's
gradient must lie no farther from the float64 replay than twice JAX's
(the fallback of ``tests/test_torch_precision.py``, with float64 in the
place of float32).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imp_tpu.models.layers as jlayers
import imp_tpu.models.umeml as jumeml
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.ops.attention import NystromAttention

import test_torch_umeml as U

MICRO, HIDDEN, TOL = 20, 256, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(get_default, root, out):
    cfg = U._cfg(get_default, root, out)
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.DATASET.USE_BSM, cfg.DATASET.BS_MICRO = True, MICRO
    cfg.MODEL.UMEML.ALPHA = 5.0
    return cfg


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def test_one_bsm_step_matches_jax_at_a_fixed_permutation(tmp_path):
    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=U.BAG, feat_dim=U.FEAT,
                          num_genes=U.GENES, group_size=10, seed=0)
    cfg = _cfg(get_cfg_default, root, str(tmp_path / "out"))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    db = trainer._device_batch(next(iter(trainer.train_loader)))
    n = db["img"].shape[1]
    n_chunks = -(-n // MICRO)
    assert (n, n_chunks) == (U.BAG, 3)
    perm = np.random.default_rng(5).permutation(n_chunks * MICRO)
    idx = np.sort(perm.reshape(n_chunks, MICRO), axis=1)  # what both steps run

    jcfg = _cfg(jax_cfg_default, root, "")
    jb = {k: jnp.asarray(v.numpy()) for k, v in db.items()}
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jumeml, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    try:
        model = jax_build_model("umeml", cfg=jcfg, num_classes=4)
        params = jax.jit(functools.partial(model.init, train=False))(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jb)
        task_loss = jax_task_loss(jcfg)
        img_p = jnp.pad(jb["img"], ((0, 0), (0, n_chunks * MICRO - n), (0, 0)))
        mask_p = jnp.pad(jb["img_mask"], ((0, 0), (0, n_chunks * MICRO - n)))

        def loss_fn(p):  # the body of train_step_bsm (mbtrain.py:319-340)
            def chunk(acc, take):
                sub = dict(jb, img=jnp.take(img_p, take, axis=1),
                           img_mask=jnp.take(mask_p, take, axis=1))
                out = model.apply(p, sub, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
                return acc + task_loss(out["logits"], jb) + 5.0 * out["modular_loss"], None

            total, _ = jax.lax.scan(chunk, jnp.float32(0.0), jnp.asarray(idx))
            return total / n_chunks

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        mp.undo()

    trainer.model.load_state_dict(umeml_state_dict(U._flat(params)), strict=True)
    for m in trainer.model.modules():
        if isinstance(m, NystromAttention):
            m.dropout = 0.0
    # the float64 replay of the same loss (what float32 resolves)
    model32 = trainer.model
    trainer.model = copy.deepcopy(model32).double()
    db64 = {k: v.double() if v.is_floating_point() else v for k, v in db.items()}
    params64 = list(trainer.model.parameters())
    grads64 = dict(zip(names := [n for n, _ in model32.named_parameters()],
                       torch.autograd.grad(trainer.bsm_loss(db64, torch.from_numpy(perm)),
                                           params64)))
    trainer.model = model32
    # the step draws its permutation from bsm_permutation: fixed here
    drawn = []
    trainer.bsm_permutation = lambda npad: drawn.append(npad) or torch.from_numpy(perm)
    seen = {}
    step = trainer.main_opt.step
    trainer.main_opt.step = lambda grads: (seen.update(zip(names, grads)), step(grads))
    got = trainer.train_step(db)
    assert drawn == [n_chunks * MICRO] and trainer.main_opt.count == 1
    _close(got["loss"].item(), float(want_loss), TOL, "loss")
    g_jax = umeml_state_dict(U._flat(want_grads))
    assert set(g_jax) == set(seen)
    for k, w in g_jax.items():
        err = (seen[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        if err > TOL:  # float32 cannot resolve it: against the float64 replay
            f64, scale = grads64[k].float(), grads64[k].abs().max().item()
            ours = (seen[k] - f64).abs().max().item() / scale
            theirs = (w - f64).abs().max().item() / scale
            print(f"gradient {k}: {err:.3g} from JAX; from float64 {ours:.3g} "
                  f"(JAX {theirs:.3g})")
            assert ours <= 2 * theirs, k
    # the estimator is not the plain step: every chunk's modularity is in it
    with torch.no_grad():
        plain = trainer.model(db, train=True, generator=trainer.generator)
    assert abs(plain["modular_loss"].item()) > 1e-3


def test_bsm_pads_with_masked_tokens_and_permutes_every_token():
    """The chunks cover every padded token once, sorted within each chunk,
    and the pad tokens carry a False mask; UMEML_GAN ignores USE_BSM (JAX
    reads it on the non-GAN path only)."""
    from imp_torch.engine.mbtrain import MBTRAIN

    seen = []

    class Probe:
        cfg = get_cfg_default()
        cdtype = None

        def task_loss(self, logits, db):
            return logits.sum() * 0

        model = generator = None

    probe = Probe()
    probe.cfg.DATASET.BS_MICRO = 4

    def fake_amp(model, method, dtype, sub, **kw):
        seen.append((sub["img"].clone(), sub["img_mask"].clone()))
        return {"logits": torch.zeros(2, 4), "modular_loss": torch.zeros(())}

    mp = pytest.MonkeyPatch()
    mp.setattr("imp_torch.engine.mbtrain.amp_call", fake_amp)
    try:
        img = torch.arange(2 * 10, dtype=torch.float32).reshape(2, 10, 1)
        mask = torch.ones(2, 10, dtype=torch.bool)
        perm = torch.from_numpy(np.random.default_rng(0).permutation(12))
        MBTRAIN.bsm_loss(probe, {"img": img, "img_mask": mask}, perm)
    finally:
        mp.undo()
    assert len(seen) == 3
    tokens = torch.cat([s[0] for s in seen], dim=1)[0, :, 0]
    valid = torch.cat([s[1] for s in seen], dim=1)[0]
    assert sorted(tokens[valid].tolist()) == list(range(10))  # each real token once
    assert int((~valid).sum()) == 2 and (tokens[~valid] == 0).all()  # two masked pads
    for s in seen:  # sorted within each chunk: pads (index 10, 11) come last
        order = torch.where(s[1][0], s[0][0, :, 0], torch.tensor(10.0))
        assert torch.equal(order, order.sort().values)
