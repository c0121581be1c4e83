"""``TRAINER.PREC`` bf16: one UMEML_GAN step under MBTRAIN (the generator,
both discriminators, then the main loss; Nyström) in the PyTorch port
against the JAX trainer's step body (``_amp_apply`` around encode and
finish, the GAN losses as JAX applies them), with the criterion of
``tests/test_torch_precision.py`` (:func:`check_bf16`).  Sizes and batch
are ``tests/test_torch_train.py``'s (hidden 64, batch 3), dropout 0.

The generator's cycle loss is an L1 (a sum of signs of differences): a
0.1 % change of the weights moves the float32 generator gradient by
0.7–3.7 %, so bf16 cannot resolve it in either framework; the step is held
at ``MODEL.UMEML.LAMBDA_CYC 0``, and the generator loss's value at the
configured weight on the step's own encode outputs.  The GAN optimizers
step at learning rate 0, so that each phase's gradients are taken at the
same weights in both frameworks: Adam's first step lr·e/(|e|+eps) turns
bf16 noise in a tiny gradient entry into a step of ±lr.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import imp_tpu.models.layers as jlayers
import imp_tpu.models.umeml_gan as jug
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine.mbtrain import DIS_KEYS, GEN_KEYS, _merge, _take
from imp_tpu.engine.trainer import cast_floats as jcast
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.engine.precision import amp_call
from imp_torch.engine.trainer import device_batch

import test_torch_train as T
from test_torch_precision import _flat, _port_grads, _record_logits, check_bf16, one_torch_thread

__all__ = ["one_torch_thread"]  # fixtures of this file


def _jax_gan_step_grads(model, cfg, params, batch, rng, cd):
    """The losses, gradients, logits and encode outputs of one JAX MBTRAIN GAN step
    (``imp_tpu/engine/mbtrain.py:357-466``) under compute dtype ``cd``:
    encode and finish through ``_amp_apply``, the GAN losses as JAX applies
    them (no cast), each optimizer stepping in turn."""
    import optax

    from imp_tpu.optim import build_optimizer as jax_build_optimizer

    task_loss = jax_task_loss(cfg)
    main_keys = tuple(k for k in params["params"] if k not in DIS_KEYS)

    def amp(p, *args, **kw):  # mbtrain.py:_amp_apply
        out = model.apply(jcast(p, cd), *(jcast(a, cd) for a in args), **kw)
        return jcast(out, jnp.float32) if cd else out

    def decay_mask(sub):
        return {"params": {k: jax.tree_util.tree_map(lambda _: k not in GEN_KEYS, v)
                           for k, v in sub["params"].items()}}

    main_tx = jax_build_optimizer(cfg.OPTIM, 4, decay_mask=decay_mask)
    gan_tx = optax.chain(optax.add_decayed_weights(float(cfg.MODEL.UMEML.GAN_WD)),
                         optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                         optax.scale_by_learning_rate(float(cfg.MODEL.UMEML.GAN_LR)))

    @jax.jit
    def step(params, batch, rng):
        rng_d, rng_g = jax.random.split(rng)
        enc, enc_vjp = jax.vjp(lambda p: amp(p, batch, train=True, method=jug.UMEML_GAN.encode,
                                             rngs={"dropout": rng_d}), params)
        metrics, grads_of = {}, {}
        for name, keys, method in (("gen", GEN_KEYS, jug.UMEML_GAN.gen_loss),
                                   ("dis_p", ("gan_discriminator_p",), jug.UMEML_GAN.dis_p_loss),
                                   ("dis_o", ("gan_discriminator_o",), jug.UMEML_GAN.dis_o_loss)):
            sub = _take(params, keys)
            loss, grads = jax.value_and_grad(lambda s: model.apply(
                _merge(params, s), enc["h_path"], enc["h_omic"], method=method))(sub)
            upd, _ = gan_tx.update(grads, gan_tx.init(sub), sub)
            params = _merge(params, optax.apply_updates(sub, upd))
            metrics[name], grads_of[name] = loss, grads

        def main_fn(sub, enc_in):
            out = amp(_merge(params, sub), enc_in, batch, train=True, replace_ratio=0.0,
                      rngs={"dropout": jax.random.fold_in(rng_d, 1), "gan": rng_g},
                      method=jug.UMEML_GAN.finish)
            loss = task_loss(out["logits"], batch) + out["modular_loss"] + out["loss_kd"]
            return loss, out["logits"]

        mg = _take(params, main_keys)
        (loss, logits), (g_sub, g_enc) = jax.value_and_grad(main_fn, argnums=(0, 1),
                                                            has_aux=True)(mg, enc)
        (g_enc_params,) = enc_vjp(g_enc)
        grads_of["main"] = jax.tree_util.tree_map(jnp.add, g_sub, _take(g_enc_params, main_keys))
        metrics["loss"] = loss
        return metrics, grads_of, logits, (enc["h_path"], enc["h_omic"])

    return step(params, batch, rng)


def test_one_umeml_gan_gan_step_under_bf16_matches_jax(T_jax_side, tmp_path):
    model, params = T_jax_side
    batch = T._batch()
    cfg = T._cfg(jax_cfg_default)
    cfg.MODEL.UMEML.GAN_LR = 0.0
    rng = jax.random.key(3, impl="rbg")
    smooth = model.clone(lambda_cyc=0.0)
    want = {cd: _jax_gan_step_grads(smooth, cfg, params, T._jnp(batch), rng, cd)
            for cd in (jnp.bfloat16, None)}

    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=8, bag_max=T.BAG, feat_dim=T.FEAT,
                          num_genes=T.GENES, group_size=10, seed=0)
    pcfg = T._cfg(get_cfg_default, root, str(tmp_path / "out"))
    pcfg.TRAINER.PREC = "bf16"
    pcfg.MODEL.UMEML.GAN_LR = 0.0
    pcfg.freeze()
    trainer = T._fresh(build_trainer(pcfg, device="cpu"), params)
    assert trainer.cdtype == torch.bfloat16
    db = device_batch(batch, "cpu")
    # the generator loss's value at the configured cycle weight, on the
    # bf16 encode outputs of each framework (the step's own, before it)
    with torch.no_grad():
        enc = amp_call(trainer.model, "encode", trainer.cdtype, db, train=True,
                       generator=torch.Generator().manual_seed(0))
        gen_got = trainer.model.gen_loss(enc["h_path"], enc["h_omic"])
    gen_want = {}
    for cd, (_, _, _, (hp, ho)) in want.items():
        gen_want[cd] = float(model.apply(params, hp, ho, method=jug.UMEML_GAN.gen_loss))
    check_bf16("loss_gen at LAMBDA_CYC 10", gen_got, gen_want[jnp.bfloat16], gen_want[None])

    trainer.model.lambda_cyc = 0.0
    seen = _port_grads(trainer, {"gen": trainer.gen_opt, "dis_p": trainer.dis_p_opt,
                                 "dis_o": trainer.dis_o_opt, "main": trainer.main_opt},
                       {id(p): n for n, p in trainer.model.named_parameters()})
    logits = _record_logits(trainer)
    got = trainer.train_step(db, train_gan=True, replace_ratio=0.0)
    (m16, g16, l16, _), (m32, g32, l32, _) = want[jnp.bfloat16], want[None]
    for phase, key in (("gen", "loss_gen"), ("dis_p", "loss_dis_p"), ("dis_o", "loss_dis_o"),
                       ("loss", "loss")):
        check_bf16(key, got[key], m16[phase], m32[phase])
    check_bf16("logits", logits["logits"], l16, l32, computed_in_bf16=True)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    n = 0
    for phase in ("gen", "dis_p", "dis_o", "main"):
        w16 = umeml_gan_state_dict(_flat(_merge(zeros, g16[phase])))
        w32 = umeml_gan_state_dict(_flat(_merge(zeros, g32[phase])))
        for k, g in seen[phase].items():
            check_bf16(f"{phase} gradient {k}", g, w16[k].numpy(), w32[k].numpy())
            n += 1
    assert n == len(list(trainer.model.parameters())) + len(trainer.gen_opt.params)
    # the parameters stay float32
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


@pytest.fixture(scope="module")
def T_jax_side():
    """test_torch_train's JAX UMEML_GAN (TransLayer dropout 0) and its init."""
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jug, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    model = jax_build_model("umeml_gan", cfg=T._cfg(jax_cfg_default), num_classes=4,
                            gene_group_indexes=T.GROUPS)
    init_batch = {k: (v if k == "omic_means" else v[:1]) for k, v in T._batch().items()}
    rngs = {n: jax.random.key(i, impl="rbg") for i, n in enumerate(("params", "dropout", "gan"))}
    params = jax.jit(lambda r, b: model.init(r, b, method=T._init_eval_and_gan))(
        rngs, T._jnp(init_batch))
    yield model, params
    mp.undo()
