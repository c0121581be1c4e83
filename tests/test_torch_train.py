"""The training slice of the PyTorch port against ``imp_tpu`` on the CPU.

Weights come from a JAX ``init`` and reach the port through
``imp_torch.convert.umeml_gan_state_dict``; batches come from a numpy seed.
Small widths: hidden 64, 6 prototypes, 60 genes in 6 groups, bags of <= 64
tokens with ragged masks, batch 3 with one ``without_omic`` row (so the
main loss reaches the generator).  Dropout cannot share bits across the two
frameworks, so both sides run at rate 0: ``MODEL.DROPOUT 0`` and the
TransLayers' fixed 0.1 set to 0 (on the JAX side by binding ``dropout=0``
into the ``TransLayer`` its modules build, for the test only); the
replacement ratio is 0.

* the train-mode forward (``encode``, ``finish``, the three GAN losses,
  ``modular_loss``) to 1e-5;
* one full MBTRAIN GAN step — the port's ``MBTRAIN.train_step`` against a
  JAX step built from ``UMEML_GAN.apply`` and optax exactly as
  ``imp_tpu/engine/mbtrain.py:357-466`` does (not through the JAX trainer):
  the loss and the three GAN losses to 1e-5, the updated parameters of all
  four partitions to rtol 1e-4 / atol 1e-6 — except the entries (under 5 %,
  ~4 % here) whose Adam input g + wd p is below 1e-6 on either side (and not 0
  on both), where the first step e / (|e| + eps) turns float32 noise into a
  share of the step; those are held to within one learning-rate step per
  phase; the same step again under ``TPU.ATTENTION=flash`` (the port's
  TransLayers through the flash autograd.Function, the JAX ones through
  their dense fallback), with the same weights;
* with dropout on, the CCA update's two-pass gradient against the direct
  gradient of the group objective under the same draws (rtol 1e-4);
* one CCA update (two batches, ``CCA_DROPOUT False``) against the JAX
  two-pass linearisation (``mbtrain.py:514-600``), to the same tolerances
  (here the CCA loss's per-column standardisation makes some gradients,
  such as the LayerNorm biases', zero in exact arithmetic);
* a 2-epoch run of the port's MBTRAIN through ``python -m
  imp_torch.tools.train`` on the port's synthetic tree, which trains, writes
  checkpoints, resumes from them and reports a C-index.

Tolerances: float32 on both sides with different summation orders (the
Nyström pseudo-inverse and the modularity sums reassociate); Adam's first
step divides by |g|, which amplifies rounding where a gradient is small.
"""

import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.layers as jlayers
import imp_tpu.ops.attention as jattn
import imp_tpu.models.umeml_gan as jug
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine.mbtrain import DIS_KEYS, GEN_KEYS, _merge, _take
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.losses import cca_loss as jax_cca_loss
from imp_tpu.losses import similarity_alignment_loss as jax_sim_loss
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_tpu.optim import build_optimizer as jax_build_optimizer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.engine.trainer import device_batch
from imp_torch.losses.survival import cca_loss as L_cca
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention
from imp_torch.ops.attention import TransLayer as TorchTransLayer
from imp_torch.ops.pairing import cosine_similarity_matrix
from imp_torch.optim.builders import Chain, Optimizer, ScaleByAdam, ScaleByLearningRate

HIDDEN, N_PROTO, GENES, FEAT, BATCH, BAG = 64, 6, 60, 32, 3, 64
GROUPS = [list(range(i * 10, (i + 1) * 10)) for i in range(N_PROTO)]
TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def no_jax_dropout():
    """JAX side at dropout 0: the TransLayers its modules build get
    ``dropout=0.0`` (restored after the file)."""
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jug, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    yield
    mp.undo()


def _cfg(get_default, root="", out=""):
    cfg = get_default()
    cfg.MODEL.NAME = "umeml_gan"
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.MODEL.UMEML.PROTOTYPES = N_PROTO
    cfg.MODEL.FUSION = "concat"
    cfg.MODEL.DROPOUT = 0.0
    cfg.DATASET.NAME = "TCGA_Glioma_S_UMEML"
    cfg.DATASET.FEATURE_NAME = "features_clip_vit_b16"
    cfg.DATASET.PATH.DIM = FEAT
    cfg.DATASET.BAG_PAD = BAG
    cfg.DATASET.ROOT = root
    cfg.DATASET.FOLD = 1
    cfg.TASK.NAME, cfg.TASK.LOSS = "Survival", "nllsurvloss_new"
    cfg.LOSS.ALPHA, cfg.LOSS.REDUCTION = 0.5, "mean"
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.WEIGHT_DECAY = "adam", 2e-4, 1e-4
    cfg.OPTIM.LR_SCHEDULER, cfg.OPTIM.WARMUP_EPOCH, cfg.OPTIM.WARMUP_TYPE = "cosine", 1, "linear"
    cfg.OPTIM.MAX_EPOCH = 10
    cfg.TEST.EVALUATOR = "Survival_UMEML"
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.TRAIN.CURRICULUM.CCA_DROPOUT = False
    cfg.DATALOADER.TRAIN.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = BATCH
    cfg.TPU.PREFETCH = 0
    cfg.OUTPUT_DIR = out
    cfg.VERBOSE = False
    cfg.SEED = 1
    return cfg


def _batch(seed=7):  # a seed whose greedy pairs lead by > 9e-4 (asserted below)
    rng = np.random.default_rng(seed)
    lens = np.array([BAG, 41, 5])
    mask = np.arange(BAG)[None, :] < lens[:, None]
    img = rng.normal(size=(BATCH, BAG, FEAT)).astype(np.float32) * mask[..., None]
    return {
        "img": img,
        "img_mask": mask,
        "mol": rng.lognormal(size=(BATCH, GENES)).astype(np.float32),
        "label": np.array([0, 3, 1], np.int32),
        "censorship": np.array([0.0, 1.0, 0.0], np.float32),
        "survival_month": np.array([12.0, 40.0, 7.0], np.float32),
        "without_omic": np.array([0, 1, 0], np.float32),
        "insample_without_omic": (rng.random((BATCH, GENES)) < 0.2).astype(np.int32),
        "omic_means": rng.normal(size=(GENES,)).astype(np.float32),
    }


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _init_eval_and_gan(module, batch):
    """Touch every submodule (eval forward + the GAN loss): the tree
    ``init_all`` makes, without tracing the train-mode modularity loss."""
    out = module(batch, train=False)
    return module.gen_loss(out["h_path"], out["h_omic"])


@pytest.fixture(scope="module")
def jax_side(no_jax_dropout):
    model = jax_build_model("umeml_gan", cfg=_cfg(jax_cfg_default), num_classes=4,
                            gene_group_indexes=GROUPS)
    init_batch = {k: (v if k == "omic_means" else v[:1]) for k, v in _batch().items()}
    rngs = {n: jax.random.key(i, impl="rbg") for i, n in enumerate(("params", "dropout", "gan"))}
    params = jax.jit(lambda r, b: model.init(r, b, method=_init_eval_and_gan))(rngs, _jnp(init_batch))
    return model, params


def _flat(params):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, jax_side):
    """The port's MBTRAIN on a synthetic tree of the same widths (the tree's
    signatures give the test's gene groups)."""
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic.materialize(root, num_slides=12, bag_min=8, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=0)
    cfg = _cfg(get_cfg_default, root, str(tmp_path_factory.mktemp("out")))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    assert [list(g) for g in trainer.model.gene_group_indexes] == GROUPS
    return trainer


@pytest.fixture(scope="module")
def port_flash_trainer(tmp_path_factory, port_trainer):
    """The port's MBTRAIN of ``port_trainer``'s tree under TPU.ATTENTION=flash."""
    cfg = port_trainer.cfg.clone()
    cfg.defrost()
    cfg.TPU.ATTENTION = "flash"
    cfg.OUTPUT_DIR = str(tmp_path_factory.mktemp("out_flash"))
    cfg.freeze()
    return build_trainer(cfg, device="cpu")


def _fresh(trainer, params):
    """New model and optimizers, JAX weights, TransLayer dropout 0."""
    trainer.build_model()
    trainer.model.load_state_dict(umeml_gan_state_dict(_flat(params)), strict=True)
    for m in trainer.model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    return trainer


def _greedy_gap(sim, k=3):
    s = sim.clone()
    b, _, o = s.shape
    gaps = []
    for _ in range(k):
        flat = s.reshape(b, -1)
        top2 = flat.topk(2, dim=1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        idx = flat.argmax(dim=1)
        for i in range(b):
            s[i, idx[i] // o, :] = -torch.inf
            s[i, :, idx[i] % o] = -torch.inf
    return min(gaps)


def test_train_forward_and_gan_losses_match_jax(jax_side, port_trainer):
    model, params = jax_side
    batch = _batch()
    jb = _jnp(batch)
    rngs = {"dropout": jax.random.key(5, impl="rbg"), "gan": jax.random.key(6, impl="rbg")}
    want = jax.jit(lambda p, b: model.apply(p, b, train=True, replace_ratio=0.0, rngs=rngs))(params, jb)
    want_gan = {
        name: model.apply(params, want["h_path"], want["h_omic"], method=getattr(jug.UMEML_GAN, name))
        for name in ("gen_loss", "dis_p_loss", "dis_o_loss")
    }

    tm = _fresh(port_trainer, params).model
    seen = {}

    def keep_similarity(_module, args):  # returns None: the inputs pass unchanged
        seen.setdefault("sim", cosine_similarity_matrix(args[0], args[1]))

    hook = tm.bottleattn.register_forward_pre_hook(keep_similarity)
    g = torch.Generator().manual_seed(0)
    tb = device_batch(batch, "cpu")
    enc = tm.encode(tb, train=True, generator=g)
    got = tm.finish(enc, tb, train=True, replace_ratio=0.0, generator=g)
    hook.remove()
    assert _greedy_gap(seen["sim"].detach()) > 1e-4  # no near-tie in the greedy pairing
    for key in ("logits", "logits_first_pass", "loss_kd", "modular_loss", "h_path", "h_omic",
                "importance_path", "importance_omic"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert abs(got["modular_loss"].item()) > 1e-3  # the loss is really there
    for name, w in want_gan.items():
        v = getattr(tm, name)(got["h_path"], got["h_omic"])
        np.testing.assert_allclose(v.item(), float(w), rtol=TOL, atol=TOL, err_msg=name)
    # init_all runs every path once (random draws from the generator)
    losses = tm.init_all(tb, torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in losses.values())
    with pytest.raises(ValueError, match="torch.Generator"):
        tm.encode(tb, train=True)


def _jax_step(model, cfg, updates_per_epoch, params, batch, rng, replace_ratio):
    """One MBTRAIN GAN step as imp_tpu/engine/mbtrain.py:357-466 builds it."""
    task_loss = jax_task_loss(cfg)
    main_keys = tuple(k for k in params["params"] if k not in DIS_KEYS)

    def decay_mask(sub):
        return {"params": {k: jax.tree_util.tree_map(lambda _: k not in GEN_KEYS, v)
                           for k, v in sub["params"].items()}}

    main_tx = jax_build_optimizer(cfg.OPTIM, updates_per_epoch, decay_mask=decay_mask)
    gan_tx = optax.chain(
        optax.add_decayed_weights(float(cfg.MODEL.UMEML.GAN_WD)),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
        optax.scale_by_learning_rate(float(cfg.MODEL.UMEML.GAN_LR)),
    )
    opt_state = main_tx.init(_take(params, main_keys))
    opts = {k: gan_tx.init(_take(params, keys)) for k, keys in
            (("gen", GEN_KEYS), ("dis_p", ("gan_discriminator_p",)), ("dis_o", ("gan_discriminator_o",)))}

    @jax.jit
    def step(params, opt_state, opts, batch, rng):
        rng_d, rng_g = jax.random.split(rng)
        enc, enc_vjp = jax.vjp(lambda p: model.apply(p, batch, train=True, method=jug.UMEML_GAN.encode,
                                                     rngs={"dropout": rng_d}), params)
        h_path, h_omic = enc["h_path"], enc["h_omic"]
        metrics, opts, all_grads = {}, dict(opts), {}
        for name, keys, method in (("gen", GEN_KEYS, jug.UMEML_GAN.gen_loss),
                                   ("dis_p", ("gan_discriminator_p",), jug.UMEML_GAN.dis_p_loss),
                                   ("dis_o", ("gan_discriminator_o",), jug.UMEML_GAN.dis_o_loss)):
            sub = _take(params, keys)
            loss, grads = jax.value_and_grad(
                lambda s: model.apply(_merge(params, s), h_path, h_omic, method=method))(sub)
            upd, opts[name] = gan_tx.update(grads, opts[name], sub)
            params = _merge(params, optax.apply_updates(sub, upd))
            metrics[name], all_grads[name] = loss, grads
        mg_sub = _take(params, main_keys)

        def main_fn(sub, enc_in):
            out = model.apply(_merge(params, sub), enc_in, batch, train=True, replace_ratio=replace_ratio,
                              rngs={"dropout": jax.random.fold_in(rng_d, 1), "gan": rng_g},
                              method=jug.UMEML_GAN.finish)
            return task_loss(out["logits"], batch) + out["modular_loss"] + out["loss_kd"], out

        (loss, _), (g_sub, g_enc) = jax.value_and_grad(main_fn, argnums=(0, 1), has_aux=True)(mg_sub, enc)
        (g_enc_params,) = enc_vjp(g_enc)
        grads = jax.tree_util.tree_map(jnp.add, g_sub, _take(g_enc_params, main_keys))
        mu, opt_state = main_tx.update(grads, opt_state, mg_sub)
        params = _merge(params, optax.apply_updates(mg_sub, mu))
        metrics["loss"], all_grads["main"] = loss, grads
        return params, metrics, all_grads

    return step(params, opt_state, opts, batch, rng)


def _ill_conditioned(params, jax_grads, port_grads, decay_of, below=1e-6):
    """Per port parameter: True where some phase's Adam input — the
    gradient plus its coupled decay, e = g + wd p — is below 1e-6 on either
    side but not exactly 0 on both.  There the first step e / (|e| + eps)
    turns float32 noise in g (summation order, or a gradient that is zero
    in exact arithmetic, such as a key bias under softmax, coming out as
    ~1e-9 on one side and 0 on the other) into a visible share of the step."""
    p0 = umeml_gan_state_dict(_flat(params))
    mask = {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in p0.items()}
    for phase, grads in jax_grads.items():
        g_jax = umeml_gan_state_dict(_flat(_merge(jax.tree_util.tree_map(jnp.zeros_like, params), grads)))
        for k, g_port in port_grads[phase].items():
            decay = decay_of(phase, k)
            e_jax = g_jax[k] + decay * p0[k]
            e_port = g_port + decay * p0[k]
            both_zero = (e_jax == 0) & (e_port == 0)
            mask[k] |= ((e_jax.abs() < below) | (e_port.abs() < below)) & ~both_zero
    return mask


def _record_grads(trainer, port_grads, opts):
    """Wrap each optimizer's step to keep the gradients it receives."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for phase, opt in opts.items():
        def record(grads, opt=opt, step=opt.step, phase=phase):
            port_grads[phase] = {names[id(p)]: torch.zeros_like(p) if g is None else g.detach().clone()
                                 for p, g in zip(opt.params, grads)}
            step(grads)

        opt.step = record


def _assert_params_close(model, jax_params, what, ill_conditioned=None, max_step=0.0):
    """Updated parameters to rtol 1e-4 / atol 1e-6; entries flagged as
    ill-conditioned (see :func:`_ill_conditioned`) only to within
    ``max_step``, one learning-rate step per phase."""
    want = umeml_gan_state_dict(_flat(jax_params))
    got = model.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        keep = np.ones(g.shape, bool) if ill_conditioned is None else ~ill_conditioned[k].numpy()
        np.testing.assert_allclose(g[keep], w[keep], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {k}")
        assert np.all(np.abs(g - w)[~keep] <= max_step), f"{what}: {k}"


def test_one_gan_step_matches_jax(jax_side, port_trainer):
    _check_one_gan_step(*jax_side, _fresh(port_trainer, jax_side[1]))


def test_one_gan_step_under_flash_matches_jax(jax_side, port_flash_trainer):
    trainer = _fresh(port_flash_trainer, jax_side[1])
    assert all(isinstance(m.attn, ExactSelfAttention) for m in trainer.model.modules()
               if isinstance(m, TorchTransLayer))
    mp = pytest.MonkeyPatch()  # the JAX TransLayers follow the process default
    mp.setattr(jattn, "_DEFAULT_ATTENTION_IMPL", "flash")
    try:
        _check_one_gan_step(*jax_side, trainer)
    finally:
        mp.undo()


def _check_one_gan_step(model, params, trainer):
    batch = _batch()
    upe = len(trainer.train_loader)
    cfg = _cfg(jax_cfg_default)
    new_params, want, grads = _jax_step(model, cfg, upe, params, _jnp(batch),
                                        jax.random.key(3, impl="rbg"), 0.0)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    port_grads = {}
    _record_grads(trainer, port_grads, {"gen": trainer.gen_opt, "dis_p": trainer.dis_p_opt,
                                        "dis_o": trainer.dis_o_opt, "main": trainer.main_opt})
    got = trainer.train_step(device_batch(batch, "cpu"), train_gan=True, replace_ratio=0.0)
    for name, key in (("gen", "loss_gen"), ("dis_p", "loss_dis_p"), ("dis_o", "loss_dis_o"),
                      ("loss", "loss")):
        np.testing.assert_allclose(got[key].item(), float(want[name]), rtol=TOL, atol=TOL, err_msg=key)
    gan_wd, wd = float(cfg.MODEL.UMEML.GAN_WD), float(cfg.OPTIM.WEIGHT_DECAY)
    ill = _ill_conditioned(params, grads, port_grads, lambda phase, k: (
        gan_wd if phase != "main" else 0.0 if k.split(".")[0] in GEN_KEYS else wd))
    assert sum(int(m.sum()) for m in ill.values()) < 0.05 * sum(m.numel() for m in ill.values())
    _assert_params_close(trainer.model, new_params, "after one GAN step", ill,
                         max_step=2 * (float(cfg.MODEL.UMEML.GAN_LR) + float(cfg.OPTIM.WARMUP_MIN_LR)))
    # every partition moved: generators, discriminators, the main params
    after = trainer.model.state_dict()
    for prefix in ("gan_generator_p2o.", "gan_generator_o2p.", "gan_discriminator_p.",
                   "gan_discriminator_o.", "path_net.", "p_proto", "classifier."):
        moved = [k for k in after if k.startswith(prefix) and not torch.equal(after[k], before[k])]
        assert moved, prefix
    assert trainer.main_opt.count == trainer.gen_opt.count == 1


def _jax_cca_update(model, cfg, params, batches):
    """One CCA update as imp_tpu/engine/mbtrain.py:514-600 computes it
    (values pass, cca cotangents, per-batch surrogate gradients, Adam)."""
    main_keys = tuple(k for k in params["params"] if k not in DIS_KEYS)

    def sim_of(out):
        b = out["h_path"].shape[0]
        return jax_sim_loss(out["p_proto_before"].reshape(b, -1), out["h_omic_bag_before"].reshape(b, -1))

    def values(p, batch):
        out = model.apply(p, batch, train=False, cca=True)
        b = out["h_path"].shape[0]
        return out["h_path"].reshape(b, -1), out["h_omic"].reshape(b, -1), sim_of(out)

    vals = [jax.jit(values)(params, b) for b in batches]
    hp_all = jnp.concatenate([v[0] for v in vals])
    ho_all = jnp.concatenate([v[1] for v in vals])
    cca_val, (g_hp, g_ho) = jax.value_and_grad(jax_cca_loss, argnums=(0, 1))(hp_all, ho_all)
    w_sim = 1.0 / len(batches)

    def surrogate(sub, batch, ghp, gho):
        out = model.apply(_merge(params, sub), batch, train=False, cca=True)
        b = out["h_path"].shape[0]
        return (jnp.sum(out["h_path"].reshape(b, -1) * ghp) + jnp.sum(out["h_omic"].reshape(b, -1) * gho)
                + w_sim * sim_of(out))

    sub = _take(params, main_keys)
    grad_fn = jax.jit(jax.grad(surrogate))
    grad_sum, offset = None, 0
    for batch, v in zip(batches, vals):
        b = v[0].shape[0]
        gi = grad_fn(sub, batch, g_hp[offset:offset + b], g_ho[offset:offset + b])
        grad_sum = gi if grad_sum is None else jax.tree_util.tree_map(jnp.add, grad_sum, gi)
        offset += b
    tx = optax.adam(float(cfg.TRAIN.CURRICULUM.CCA_LR))
    updates, _ = tx.update(grad_sum, tx.init(sub), sub)
    return _merge(params, optax.apply_updates(sub, updates)), cca_val, grad_sum


def test_one_cca_update_matches_jax(jax_side, port_trainer):
    model, params = jax_side
    trainer = _fresh(port_trainer, params)
    batches = [_batch(7), _batch(0)]
    want_params, want_val, want_grads = _jax_cca_update(model, _cfg(jax_cfg_default), params,
                                                        [_jnp(b) for b in batches])
    group = []
    for b in batches:
        db = device_batch(b, "cpu")
        state = trainer.generator.get_state()
        with torch.no_grad():
            group.append((db, state, *trainer._cca_forward(db, train=False)))
    opt = Optimizer(trainer.main_params, Chain(ScaleByAdam(), ScaleByLearningRate(1e-3)))
    port_grads = {}
    _record_grads(trainer, port_grads, {"cca": opt})
    got_val = trainer.cca_update(group, opt, train=False)
    np.testing.assert_allclose(got_val.item(), float(want_val), rtol=TOL, atol=TOL)
    ill = _ill_conditioned(params, {"cca": want_grads}, port_grads, lambda phase, k: 0.0)
    assert sum(int(m.sum()) for m in ill.values()) < 0.05 * sum(m.numel() for m in ill.values())
    _assert_params_close(trainer.model, want_params, "after one CCA update", ill, max_step=2e-3)


def test_cca_update_with_dropout_is_the_exact_group_gradient(jax_side, port_trainer):
    """With dropout on (CCA_DROPOUT True, the default) the two-pass update
    must apply the exact gradient of cca_loss(group) + mean(sim): the second
    pass replays each batch's dropout draws from the saved generator state."""
    _, params = jax_side
    trainer = _fresh(port_trainer, params)
    for m in trainer.model.modules():  # dropout on everywhere
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.1
    trainer.model.dropout_rate = 0.25
    dbs = [device_batch(_batch(7), "cpu"), device_batch(_batch(0), "cpu")]
    states, group = [], []
    for db in dbs:
        states.append(trainer.generator.get_state())
        with torch.no_grad():
            group.append((db, states[-1], *trainer._cca_forward(db, train=True)))
    end_state = trainer.generator.get_state()

    # the direct gradient, replaying the same draws
    hps, hos, sims = [], [], []
    for db, state in zip(dbs, states):
        trainer.generator.set_state(state)
        hp, ho, sim = trainer._cca_forward(db, train=True)
        hps.append(hp), hos.append(ho), sims.append(sim)
    objective = L_cca(torch.cat(hps), torch.cat(hos)) + torch.stack(sims).mean()
    want = torch.autograd.grad(objective, trainer.main_params, allow_unused=True)

    opt = Optimizer(trainer.main_params, Chain(ScaleByAdam(), ScaleByLearningRate(1e-3)))
    port_grads = {}
    _record_grads(trainer, port_grads, {"cca": opt})
    trainer.cca_update(group, opt, train=True)
    assert torch.equal(trainer.generator.get_state(), end_state)
    names = [n for n, p in trainer.model.named_parameters() if n.split(".")[0] not in DIS_KEYS]
    for name, w in zip(names, want):
        w = torch.zeros_like(port_grads["cca"][name]) if w is None else w
        np.testing.assert_allclose(port_grads["cca"][name].numpy(), w.numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def test_two_epoch_run_trains_checkpoints_resumes_and_reports_cindex(tmp_path, capsys):
    from imp_torch.tools.train import run

    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=8, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=1)
    out = str(tmp_path / "out")
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    flags = ["--root", root, "--seed", "1", "--trainer", "MBTRAIN", "--device", "cpu",
             "--config-file", osp.join(repo, "configs/Survival/UMEML_GAN.yaml"), "--output-dir", out]
    opts = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT), "MODEL.HIDDEN_DIM", str(HIDDEN),
            "OPTIM.MAX_EPOCH", "2", "TRAIN.CURRICULUM.GAN_START_EPOCH", "1",
            "TRAIN.CURRICULUM.REPLACE_START_EPOCH", "1", "TRAIN.CHECKPOINT_FREQ", "1",
            "TPU.PREFETCH", "0", "VERBOSE", "False"]
    # epoch 1 plain, then a CCA epoch; epoch 2 with the GAN phase and replacement
    first = run(flags + opts)
    log = capsys.readouterr().out
    assert "epoch [1/2]" in log and "gan=False rr=0.000" in log
    assert "gan=True rr=0.250" in log and "CCA batch" in log and "* cindex:" in log
    mdir = osp.join(out, "model")
    ckpt = torch.load(osp.join(mdir, "model.ckpt-1"), weights_only=True)
    assert ckpt["epoch"] == 1 and set(ckpt) >= {"model", "opt_state", "gen_opt", "dis_p_opt", "dis_o_opt"}
    assert open(osp.join(mdir, "checkpoint")).read().strip() == "model.ckpt-2"

    # point at epoch 1 and run again: it resumes there and trains epoch 2 only
    with open(osp.join(mdir, "checkpoint"), "w") as f:
        f.write("model.ckpt-1")
    second = run(flags + opts)
    log = capsys.readouterr().out
    assert "resume at epoch 1" in log and "epoch [2/2]" in log and "epoch [1/2]" not in log
    for r in (first, second):
        assert 0.0 <= r <= 100.0
    # eval-only reloads the last checkpoint and reports the same C-index
    again = run(flags + ["--eval-only"] + opts)
    assert again == pytest.approx(second)
