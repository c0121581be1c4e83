"""The MIL baselines of the PyTorch port (TransMIL, ABMIL and their
``StandardTrainer``) against ``imp_tpu`` on the CPU.

Weights come from a JAX ``init`` and reach the port through
``imp_torch.convert.mil_state_dict``; inputs come from a numpy seed.  Small
sizes: 32 features, bags padded to 36 (a 6 × 6 grid plus cls), batch 3
with ragged masks; TransMIL's width is its fixed 512 (8 heads of 64).

* ``square_pad``, ``PPEG`` and ``masked_attention_pool`` to 1e-5;
* ``TransMIL_NET`` (under Nyström and under flash) and ``ABMIL_NET``: the
  logits and every parameter gradient to 1e-4 (float32 on both sides,
  other summation orders; the Nyström pseudo-inverse amplifies rounding);
* one ``StandardTrainer`` step of TransMIL under flash against the JAX
  trainer's ``_train_step`` (one device, TransLayer dropout bound to 0 on
  both sides): the gradients to 1e-4 and the updated parameters to rtol
  1e-4 / atol 1e-6, except where Adam's first step e / (|e| + eps) turns
  float32 noise into a share of the step (|g + wd·p| < 1e-6 on either side,
  see ``tests/test_torch_train.py::_ill_conditioned``), held to two
  learning-rate steps;
* the twins of ``tests/test_flash_trainer.py``: TransMIL under flash for
  one epoch through ``python -m imp_torch.tools.train --device cpu``; ABMIL
  with ``CHECKPOINT_FREQ 1`` writing ``model.ckpt-1`` and ``-2``;
  ``Nystromformer`` with a mask;
* the baselines' ``Survival`` evaluator against JAX's.
"""

import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.mil as jmil
import imp_tpu.ops.attention as jattn
import imp_tpu.ops.blocks as jblocks
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.data import synthetic as jax_synthetic
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.evaluation.evaluators import Survival as JaxSurvival
from imp_tpu.models.nets import ABMIL_NET as JaxABMIL
from imp_tpu.models.nets import TransMIL_NET as JaxTransMIL
from imp_torch.config import get_cfg_default
from imp_torch.convert import _torch_key, mil_state_dict
from imp_torch.engine import build_trainer
from imp_torch.evaluation.evaluators import Survival
from imp_torch.models.nets import ABMIL_NET, TransMIL_NET
from imp_torch.ops import blocks
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention, Nystromformer

FEAT, BAG, BATCH = 32, 36, 3
LENGTHS = (36, 20, 5)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def jax_attention():
    """Set the JAX package's process-wide TransLayer default (what its
    trainer does from TPU.ATTENTION); the old value comes back after."""
    mp = pytest.MonkeyPatch()
    yield lambda impl: mp.setattr(jattn, "_DEFAULT_ATTENTION_IMPL", impl)
    mp.undo()


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _batch(seed=2):
    rng = np.random.default_rng(seed)
    mask = np.arange(BAG)[None, :] < np.array(LENGTHS)[:, None]
    return {
        "img": rng.normal(size=(BATCH, BAG, FEAT)).astype(np.float32) * mask[..., None],
        "img_mask": mask,
    }


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def test_square_pad_ppeg_and_pool_match_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 10, 4)).astype(np.float32)
    valid = np.arange(10)[None, :] < np.array([10, 3])[:, None]
    jf, jv, jside = jblocks.square_pad(jnp.asarray(feats), jnp.asarray(valid))
    f, v, side = blocks.square_pad(_t(feats), torch.from_numpy(valid))
    assert side == jside == 4 and f.shape == (2, 16, 4)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))

    c, hw = 16, 5
    x = rng.normal(size=(2, 1 + hw * hw, c)).astype(np.float32)
    jppeg = jblocks.PPEG(dim=c)
    variables = jppeg.init(jax.random.PRNGKey(1), jnp.asarray(x), hw, hw)
    ppeg = blocks.PPEG(c)
    ppeg.load_state_dict({_torch_key(k)[0]: _t(v) for k, v in _flat(variables).items()}, strict=True)
    np.testing.assert_allclose(ppeg(_t(x), hw, hw).detach().numpy(),
                               np.asarray(jppeg.apply(variables, jnp.asarray(x), hw, hw)),
                               rtol=1e-5, atol=1e-5)

    scores = rng.normal(size=(2, 10, 1)).astype(np.float32)
    jp, jw = jblocks.masked_attention_pool(jnp.asarray(scores), jnp.asarray(feats), jnp.asarray(valid))
    p, w = blocks.masked_attention_pool(_t(scores), _t(feats), torch.from_numpy(valid))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


def _net_pair(name, attention):
    if name == "abmil":
        return JaxABMIL(num_classes=4, path_input_dim=FEAT, dropout=0.0), \
            ABMIL_NET(4, FEAT, dropout=0.0)
    return JaxTransMIL(num_classes=4, path_input_dim=FEAT), \
        TransMIL_NET(4, FEAT, attention=attention)


@pytest.mark.parametrize("name,attention", [("transmil", "nystrom"), ("transmil", "flash"),
                                            ("abmil", None)])
def test_net_logits_and_gradients_match_jax(name, attention, jax_attention):
    if attention:
        jax_attention(attention)
    jnet, net = _net_pair(name, attention)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jnet.init(jax.random.PRNGKey(3), jb)
    w = np.random.default_rng(4).normal(size=(BATCH, 4)).astype(np.float32)

    def jloss(p):
        logits = jnet.apply(p, jb)
        return jnp.sum(logits * w), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    net.load_state_dict(mil_state_dict(_flat(params)), strict=True)
    logits = net({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    names, ps = zip(*net.named_parameters())
    got = dict(zip(names, torch.autograd.grad((logits * _t(w)).sum(), ps)))
    want_grads = mil_state_dict(_flat(jgrads))
    assert set(want_grads) == set(got)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def _cfg(get_default, root, out, trainer="TransMIL"):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs/Survival", f"{trainer}.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TRAIN.BATCH_SIZE = BATCH
    cfg.TRAINER.NAME = trainer
    cfg.TPU.ATTENTION = "flash"
    cfg.TPU.PREFETCH = 0
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miltree"))
    jax_synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=BAG, feat_dim=FEAT,
                              num_genes=60, group_size=10, seed=0)
    return root


def test_one_standard_trainer_step_matches_jax(tree, tmp_path):
    mp = pytest.MonkeyPatch()
    mp.setattr(jmil, "TransLayer", functools.partial(jattn.TransLayer, dropout=0.0))
    try:
        jcfg = _cfg(jax_cfg_default, tree, str(tmp_path / "jax"))
        jcfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows in the loss
        jtrainer = jax_build_trainer(jcfg)
        params = jax.tree_util.tree_map(np.asarray, jtrainer.params)
        batch = next(iter(jtrainer.train_loader))
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k in ("img", "img_mask", "label",
                                                                    "censorship", "survival_month")}
        jgrads = jax.jit(jax.grad(lambda p: jtrainer.task_loss(
            jtrainer.model.apply(p, jb, train=True), jb)))(params)
        jtrainer.train_step(batch)
        want = mil_state_dict(_flat(jtrainer.params))
    finally:
        mp.undo()
        jattn.set_default_attention_impl("nystrom")

    cfg = _cfg(get_cfg_default, tree, str(tmp_path / "port"))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    p0 = mil_state_dict(_flat(params))
    trainer.model.load_state_dict(p0, strict=True)
    for m in trainer.model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    assert all(isinstance(layer.attn, ExactSelfAttention)
               for layer in (trainer.model.mil.layer1, trainer.model.mil.layer2))
    names = [n for n, _ in trainer.model.named_parameters()]
    seen = {}
    step = trainer.optimizer.step
    trainer.optimizer.step = lambda grads: (seen.update(zip(names, grads)), step(grads))
    trainer.train_step(trainer._device_batch(batch))

    g_jax = mil_state_dict(_flat(jgrads))
    wd, lr = float(cfg.OPTIM.WEIGHT_DECAY), float(cfg.OPTIM.WARMUP_CONS_LR)
    got = trainer.model.state_dict()
    n_ill = 0
    for k, w in want.items():
        np.testing.assert_allclose(seen[k].numpy(), g_jax[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"gradient {k}")
        e_jax, e_port = g_jax[k] + wd * p0[k], seen[k] + wd * p0[k]
        ill = (((e_jax.abs() < 1e-6) | (e_port.abs() < 1e-6)) & ~((e_jax == 0) & (e_port == 0))).numpy()
        n_ill += int(ill.sum())
        g, w = got[k].numpy(), w.numpy()
        np.testing.assert_allclose(g[~ill], w[~ill], rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(g - w)[ill] <= 2 * lr), k
        assert not np.array_equal(g, p0[k].numpy()), f"{k} did not move"
    assert n_ill < 0.01 * sum(v.numel() for v in want.values())


def test_transmil_trains_under_flash_through_the_cli(tree, tmp_path, capsys):
    from imp_torch.tools.train import run

    result = run(["--root", tree, "--seed", "1", "--trainer", "TransMIL", "--device", "cpu",
                  "--config-file", osp.join(REPO, "configs/Survival/TransMIL.yaml"),
                  "--output-dir", str(tmp_path / "out"),
                  "DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT),
                  "DATALOADER.TRAIN.BATCH_SIZE", str(BATCH), "OPTIM.MAX_EPOCH", "1",
                  "TPU.ATTENTION", "flash", "TPU.PREFETCH", "0"])
    log = capsys.readouterr().out
    assert np.isfinite(result) and "* C-Index:" in log and "epoch [1/1]" in log
    state = torch.load(osp.join(tmp_path, "out", "model", "model.ckpt-1"), weights_only=True)
    assert set(state) >= {"model", "opt_state", "epoch"} and state["epoch"] == 1


def test_abmil_checkpoints_every_epoch(tree, tmp_path):
    cfg = _cfg(get_cfg_default, tree, str(tmp_path / "out"), trainer="ABMIL")
    cfg.TEST.NO_TEST = True
    cfg.OPTIM.MAX_EPOCH = 2
    cfg.TRAIN.CHECKPOINT_FREQ = 1
    cfg.freeze()
    build_trainer(cfg, device="cpu").train()
    mdir = osp.join(cfg.OUTPUT_DIR, "model")
    assert osp.exists(osp.join(mdir, "model.ckpt-1"))
    assert osp.exists(osp.join(mdir, "model.ckpt-2"))


def test_nystromformer_runs_with_a_mask():
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(2, 40, 64)))
    mask = torch.from_numpy(np.arange(40)[None, :] < np.array([[30], [40]]))
    mod = Nystromformer(dim=64, depth=2, dim_head=8, heads=8, num_landmarks=8)
    y = mod(x, mask=mask)
    assert y.shape == x.shape and torch.isfinite(y).all()
    y2 = mod(x, mask=mask, generator=torch.Generator().manual_seed(0))  # dropout 0: the same
    assert torch.equal(y, y2)


def _nystromformer_key(flax_key: str) -> str:
    """The port's key for one flattened key of JAX's ``Nystromformer``:
    ``PreNorm_{2i}`` / ``PreNorm_{2i+1}`` hold layer i's two LayerNorms,
    ``NystromAttention_i`` and ``FeedForward_i/TorchLinear_{0,1}`` its two
    ``fn`` modules."""
    _, top, *rest = flax_key.split("/")
    kind, i = top.rsplit("_", 1)
    i = int(i)
    if kind == "PreNorm":
        prefix = f"layers.{i // 2}.{i % 2}"
    elif kind == "NystromAttention":
        prefix = f"layers.{i}.0.fn"
    else:
        assert kind == "FeedForward", flax_key
        prefix = f"layers.{i}.1.fn"
        rest[0] = {"TorchLinear_0": "fc1", "TorchLinear_1": "fc2"}[rest[0]]
    return f"{prefix}.{_torch_key('params/' + '/'.join(rest))[0]}"


def test_nystromformer_output_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([[30], [40]])
    w = rng.normal(size=x.shape).astype(np.float32)
    jmod = jattn.Nystromformer(dim=64, depth=2, dim_head=8, heads=8, num_landmarks=8)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x), mask=jnp.asarray(mask))

    def jloss(p, xx):
        y = jmod.apply(p, xx, mask=jnp.asarray(mask))
        return jnp.sum(y * w), y

    (_, want), (jgrads, jdx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    mod = Nystromformer(dim=64, depth=2, dim_head=8, heads=8, num_landmarks=8)
    flat = _flat(params)
    transposed = {k for k in flat if k.endswith("/kernel")}
    mod.load_state_dict({_nystromformer_key(k): _t(v.T if k in transposed else v)
                         for k, v in flat.items()}, strict=True)
    xt = _t(x).requires_grad_()
    y = mod(xt, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    names, ps = zip(*mod.named_parameters())
    grads = torch.autograd.grad((y * _t(w)).sum(), (xt, *ps))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    got = dict(zip(names, grads[1:]))
    want_grads = {_nystromformer_key(k): v.T if k in transposed else v
                  for k, v in _flat(jgrads).items()}
    assert set(want_grads) == set(got)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got[k].numpy(), g, rtol=1e-4, atol=1e-4, err_msg=k)


def test_survival_evaluator_matches_jax(capsys):
    rng = np.random.default_rng(1)
    want, got = JaxSurvival(None), Survival(None)
    for _ in range(3):
        logits = rng.normal(size=(4, 4))
        S = np.cumprod(1.0 - 1.0 / (1.0 + np.exp(-logits)), axis=1)
        cens = (rng.random(4) < 0.3).astype(np.float32)
        months = rng.uniform(1, 100, 4).astype(np.float32)
        want.process(S, cens, months)
        got.process(S, cens, months)
    assert got.evaluate() == want.evaluate()
    out = capsys.readouterr().out
    assert out.count("* C-Index:") == 2
