"""``TRAINER.PREC`` bf16 in ``StandardTrainer``: one step of TransMIL under
flash (the flash plain versions here: K1–K3's bf16 entries on the card) and
ABMIL, the port against the JAX trainer's ``_train_body`` (``cast_floats``
of parameters and batch, logits cast to float32 before the loss) on the
CPU, with the criterion of ``tests/test_torch_precision.py``
(:func:`check_bf16`).  CMTA and HFB are in
``tests/test_torch_precision_fusion.py``.

The nets run at batch 4 on the zoo's synthetic tree
(``tests/test_torch_zoo_trainers.py``; dropout the identity on both sides).
At batch 1 a ReLU unit whose pre-activation lies within bf16 rounding of 0
is on in one framework and off in the other, and that flip is the unit's
whole gradient: JAX's own bf16 step is then 7 % off its float32 step in
CMTA's ``mm_fc2.bias``.  At batch 4 each flip is a quarter of a row sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imp_tpu.ops.attention as jattn
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.engine.trainer import cast_floats as jcast
from imp_torch.config import get_cfg_default
from imp_torch.convert import mil_state_dict, zoo_state_dict
from imp_torch.engine import build_trainer
from imp_torch.engine.precision import amp_call
from imp_torch.ops.attention import ExactSelfAttention

from test_torch_precision import _flat, _port_grads, _record_logits, check_bf16, one_torch_thread
from test_torch_zoo import no_dropout
from test_torch_zoo_trainers import tree, zoo_cfg

__all__ = ["no_dropout", "one_torch_thread", "tree"]  # fixtures of this file

NETS = {  # trainer -> (TPU.ATTENTION, state-dict converter)
    "TransMIL": ("flash", mil_state_dict),
    "ABMIL": ("auto", mil_state_dict),
    "CMTA": ("flash", zoo_state_dict),
    "HFB": ("auto", zoo_state_dict),
}
#: CMTA's L1 alignment is a sum of signs of differences of near-equal cls
#: tokens, which bf16 cannot resolve in either framework: its gradients are
#: held without it (its value below, at the configured weight)
ALIGNMENT_OFF = {"CMTA": 0.0}


@pytest.mark.parametrize("name", ["TransMIL", "ABMIL"])
def test_one_standard_trainer_step_under_bf16_matches_jax(name, tree, tmp_path, no_dropout):
    check_standard_step(name, tree, tmp_path)


def check_standard_step(name, tree, tmp_path):
    """One bf16 step of trainer ``name`` against JAX's, at batch 4."""
    attention, convert = NETS[name]
    jcfg = zoo_cfg(jax_cfg_default, tree, str(tmp_path / "jax"), name)
    jcfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows in the loss
    jcfg.TPU.ATTENTION = attention
    jcfg.DATALOADER.TRAIN.BATCH_SIZE = 4
    try:
        jtr = jax_build_trainer(jcfg)
        params = jax.tree_util.tree_map(np.asarray, jtr.params)
        state = jax.tree_util.tree_map(np.asarray, jtr.model_state)
        batch = next(iter(jtr.train_loader))
        jb = {k: jnp.asarray(v) for k, v in batch.items()
              if k in ("img", "img_mask", "mol", "label", "censorship", "survival_month")}
        keys = sorted(state)
        if name in ALIGNMENT_OFF:  # the alignment term's value at its weight, then off
            align = {cd: float(jtr.extra_loss(jtr.model.apply(
                jcast(params, cd), jcast(jb, cd), train=True,
                rngs={"dropout": jax.random.PRNGKey(0)}), jb)) for cd in (jnp.bfloat16, None)}
            jtr.cfg.defrost()  # the JAX extra_loss reads its weight when called
            jtr.cfg.LOSS.CMTA_ALPHA = ALIGNMENT_OFF[name]

        def grads_at(cd):  # trainer.py:628-655
            def loss_fn(p):
                variables = {**jcast(p, cd), **state}
                kw = dict(train=True, rngs={"dropout": jax.random.PRNGKey(0)})
                if keys:
                    out, new_state = jtr.model.apply(variables, jcast(jb, cd), mutable=keys, **kw)
                else:
                    out, new_state = jtr.model.apply(variables, jcast(jb, cd), **kw), state
                logits = (out["logits"] if isinstance(out, dict) else out).astype(jnp.float32)
                loss = jtr.task_loss(logits, jb) + jtr.extra_loss(out, jb)
                return loss, (logits, new_state)

            return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

        want = {cd: grads_at(cd) for cd in (jnp.bfloat16, None)}
    finally:
        jattn.set_default_attention_impl("nystrom")

    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "port"), name)
    cfg.TPU.ATTENTION = attention
    cfg.DATALOADER.TRAIN.BATCH_SIZE = 4
    cfg.TRAINER.PREC = "fp16" if name == "CMTA" else "bf16"
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.cdtype == torch.bfloat16
    trainer.model.load_state_dict(convert(_flat({**params, **state})), strict=True)
    if name in ALIGNMENT_OFF:
        db = trainer._device_batch(batch)
        with torch.no_grad():
            out = amp_call(trainer.model, "forward", trainer.cdtype, db, train=True,
                           generator=trainer.generator)
        check_bf16("alignment", trainer.extra_loss(out, db), align[jnp.bfloat16], align[None])
        cfg.LOSS.CMTA_ALPHA = ALIGNMENT_OFF[name]
    cfg.freeze()
    if attention == "flash":
        assert any(isinstance(m, ExactSelfAttention) for m in trainer.model.modules())
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    seen = _port_grads(trainer, {"main": trainer.optimizer}, names)
    logits = _record_logits(trainer)
    got = trainer.train_step(trainer._device_batch(batch))
    ((l16, (lg16, st16)), g16), ((l32, (lg32, st32)), g32) = want[jnp.bfloat16], want[None]
    check_bf16("loss", got["loss"], l16, l32)
    check_bf16("logits", logits["logits"], lg16, lg32, computed_in_bf16=True)
    w16, w32 = convert(_flat({**g16, **state})), convert(_flat({**g32, **state}))
    for k, g in seen["main"].items():
        check_bf16(f"gradient {k}", g, w16[k].numpy(), w32[k].numpy())
    assert len(seen["main"]) == len(list(trainer.model.parameters()))
    buffers = dict(trainer.model.named_buffers())
    assert all(b.dtype == torch.float32 for b in buffers.values())  # HFB's statistics
    if keys:  # the batch statistics the bf16 step folded in, against flax's
        s16, s32 = convert(_flat({**params, **st16})), convert(_flat({**params, **st32}))
        for k in buffers:
            check_bf16(k, buffers[k], s16[k].numpy(), s32[k].numpy())
