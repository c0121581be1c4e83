"""One ``StandardTrainer`` step of CMTA in the PyTorch port, its alignment
loss included, against the JAX trainer's ``_train_step`` on the CPU (one
device, dropout the identity on both sides, the weights of the JAX trainer's
init carried by ``imp_torch.convert.zoo_state_dict``): the gradients to
rtol 1e-4 / atol 1e-6 and the updated parameters to rtol 1e-4 / atol 1e-6,
except where Adam's first step e / (|e| + eps) turns float32 noise into a
share of the step (|g + wd·p| < 1e-6 on either side and not the same bits,
as in ``tests/test_torch_mil.py``), held to two learning-rate steps: 5.2 %
of CMTA's entries, whose genomics paths carry many gradients near 1e-6 at
init (under 10 % asserted).  The tree, configs and fixtures are those of
``tests/test_torch_zoo_trainers.py``, in a file of their own so that each
file stays well under a minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imp_torch.config import get_cfg_default
from imp_torch.convert import zoo_state_dict
from imp_torch.engine import build_trainer

from test_torch_zoo import _flat, no_dropout
from test_torch_zoo_trainers import jax_trainer, one_torch_thread, tree, zoo_cfg

__all__ = ["no_dropout", "one_torch_thread", "tree"]  # fixtures of this file


def test_one_cmta_step_with_its_alignment_loss_matches_jax(tree, tmp_path, no_dropout):
    jtrainer = jax_trainer(tree, str(tmp_path / "jax"), "CMTA")
    params = jax.tree_util.tree_map(np.asarray, jtrainer.params)
    batch = next(iter(jtrainer.train_loader))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k in ("img", "img_mask", "mol", "label", "censorship", "survival_month")}

    def jloss(p):
        out = jtrainer.model.apply(p, jb, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jtrainer.task_loss(out["logits"], jb) + jtrainer.extra_loss(out, jb)

    jgrads = jax.jit(jax.grad(jloss))(params)
    jtrainer.train_step(batch)
    want = zoo_state_dict(_flat(jtrainer.params))

    cfg = zoo_cfg(get_cfg_default, tree, str(tmp_path / "port"), "CMTA")
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    p0 = zoo_state_dict(_flat(params))
    trainer.model.load_state_dict(p0, strict=True)
    names = [n for n, _ in trainer.model.named_parameters()]
    seen = {}
    step = trainer.optimizer.step
    trainer.optimizer.step = lambda grads: (seen.update(zip(names, grads)), step(grads))
    db = trainer._device_batch(batch)
    with torch.no_grad():
        out = trainer.model(db, train=True, generator=trainer.generator)
    assert float(trainer.extra_loss(out, db)) > 0  # the alignment term is in the loss
    trainer.train_step(db)

    g_jax = zoo_state_dict(_flat(jgrads))
    wd, lr = float(cfg.OPTIM.WEIGHT_DECAY), float(cfg.OPTIM.WARMUP_CONS_LR)
    got = trainer.model.state_dict()
    n_ill = 0
    for k, w in want.items():
        np.testing.assert_allclose(seen[k].numpy(), g_jax[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"gradient {k}")
        e_jax, e_port = g_jax[k] + wd * p0[k], seen[k] + wd * p0[k]
        # a gradient exactly 0 on both sides (a dead ReLU unit at batch 1)
        # leaves e = wd·p, the same bits on both: no noise to amplify
        ill = (((e_jax.abs() < 1e-6) | (e_port.abs() < 1e-6)) & (e_jax != e_port)).numpy()
        n_ill += int(ill.sum())
        g, w = got[k].numpy(), w.numpy()
        np.testing.assert_allclose(g[~ill], w[~ill], rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(g - w)[ill] <= 2 * lr), k
    # at init CMTA's genomics paths (six tokens, the five signatures' SNN
    # chains) carry many gradients near 1e-6: 5.2 % of the entries
    assert n_ill < 0.1 * sum(v.numel() for v in want.values())
