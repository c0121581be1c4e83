"""CLIPOMIC in the PyTorch port (``imp_torch.models.clipomic`` and its
trainer) against ``imp_tpu`` on the CPU, at the sizes of
``tests/test_clipomic.py``: text width 64, 2 layers, 4 heads, vocabulary 128
(the prompt ids clamp to it), context 16; the zoo's synthetic tree (1 000
genes: 5 chunks of 200).

* the backbone in eval mode and its every parameter gradient in train mode
  at dropout 0 (the identity on both sides, ``no_dropout``), weights of a
  JAX ``init``: outputs to 1e-5, gradients to 1e-4 of the larger of 1 and
  their largest value (the repository's rule);
* one ``StandardTrainer`` step against the JAX trainer's: the trainable
  gradients to rtol 1e-4 / atol 1e-6, the updated trainable parameters
  likewise (Adam's ill-conditioned first-step entries, |g + wd·p| < 1e-6 on
  one side and not the same bits, to two learning-rate steps), and every
  frozen text-tower tensor the same bits before and after, in both
  packages; the port's optimizer holds the trainable tensors only;
* ``MODEL.BACKBONE.CLIP_CHECKPOINT``: an OpenAI-layout text ``state_dict``
  lands in the backbone as JAX's conversion has it (exactly), and a tower
  of another width is refused;
* one Survival epoch through ``python -m imp_torch.tools.train`` under a
  decoupled weight decay of 0.1 (``adamw``): the frozen tensors keep their
  bits (no decay reaches them), the trainable ones move, and the
  checkpoint, frozen tensors included, reloads strictly.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.models import clip as J
from imp_tpu.models.clipomic import CLIPOMIC as JaxCLIPOMIC
from imp_torch.config import get_cfg_default
from imp_torch.convert import _torch_key, clip_state_dict, zoo_state_dict
from imp_torch.engine import build_trainer
from imp_torch.models.clipomic import CLIPOMIC
from imp_torch.tools.train import run

from test_torch_clip import _block_state
from test_torch_zoo import _flat, no_dropout
from test_torch_zoo_trainers import (FEAT, BAG, REPO, TEXT, TEXT_OPTS, one_torch_thread, tree,
                                     zoo_cfg)

__all__ = ["no_dropout", "one_torch_thread", "tree"]  # fixtures of this file

WIDTH, HEADS, LAYERS, VOCAB, CONTEXT = (TEXT[f"MODEL.BACKBONE.TEXT_{k}"]
                                        for k in ("WIDTH", "HEADS", "LAYERS", "VOCAB", "CONTEXT"))
FROZEN = ("token_embedding", "positional_embedding", "text_projection", "ln_final", "resblocks")


def clipomic_cfg(get_default, tree, out, task="Survival", **extra):
    cfg = zoo_cfg(get_default, tree, out, "CLIPOMIC", task)
    cfg.merge_from_list([str(x) for kv in extra.items() for x in kv])
    cfg.DATALOADER.TRAIN.BATCH_SIZE = 3
    return cfg


def text_state(seed=0, width=WIDTH):
    """A random OpenAI-layout text-tower ``state_dict`` at the test widths."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(0.05 * rng.normal(size=s).astype(np.float32))  # noqa: E731
    state = {"token_embedding.weight": r(VOCAB, width), "positional_embedding": r(CONTEXT, width),
             "text_projection": r(width, width), "ln_final.weight": 1 + r(width),
             "ln_final.bias": r(width)}
    for i in range(LAYERS):
        state.update(_block_state(rng, f"transformer.resblocks.{i}.", width))
    return state


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def test_backbone_eval_outputs_and_gradients_match_jax(no_dropout):
    rng = np.random.default_rng(0)
    x = rng.lognormal(size=(3, 1000)).astype(np.float32)
    w = rng.normal(size=(3, 256)).astype(np.float32)
    kwargs = dict(num_mol=5, len_mol=200, width=WIDTH, heads=HEADS, layers=LAYERS,
                  vocab_size=VOCAB, context_length=CONTEXT)
    jm = JaxCLIPOMIC(**kwargs)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return (out * w).sum()

    jgrads = jax.jit(jax.grad(jloss))(variables)
    port = CLIPOMIC(**kwargs)
    state = {}
    for key, value in _flat(variables).items():
        tkey, transpose = _torch_key(key)
        state[tkey] = torch.from_numpy(np.array(value.T if transpose else value))
    port.load_state_dict(state, strict=True)
    assert port.prompt_ids.tolist() == [VOCAB - 1] * 4  # every prompt id clamped
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    loss = (port(torch.from_numpy(x), torch.Generator()) * torch.from_numpy(w)).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(port.parameters()))))
    for key, value in _flat(jgrads).items():
        tkey, transpose = _torch_key(key)
        want_g = value.T if transpose else value
        assert _rel(grads[tkey].numpy(), want_g) <= 1e-4, tkey


def test_one_trainer_step_trains_the_prompt_side_and_freezes_the_tower(tree, tmp_path,
                                                                       no_dropout):
    jcfg = clipomic_cfg(jax_cfg_default, tree, str(tmp_path / "jax"))
    jcfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows in the loss
    jtrainer = jax_build_trainer(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.params)
    batch = next(iter(jtrainer.train_loader))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k in ("mol", "label", "censorship")}

    def jloss(p):
        logits = jtrainer.model.apply(p, jb, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jtrainer.task_loss(logits, jb)

    jgrads = jax.jit(jax.grad(jloss))(params)
    jtrainer.train_step(batch)
    want = zoo_state_dict(_flat(jtrainer.params))
    p0 = zoo_state_dict(_flat(params))

    cfg = clipomic_cfg(get_cfg_default, tree, str(tmp_path / "port"))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    trainer.model.load_state_dict(p0, strict=True)
    labels = trainer.param_labels()
    frozen = [n for n, lab in labels.items() if lab == "frozen"]
    assert {n.split(".")[1] for n in frozen} == set(FROZEN)
    named = dict(trainer.model.named_parameters())
    assert all(not named[n].requires_grad for n in frozen)
    trainable = [n for n, lab in labels.items() if lab == "train"]
    assert [id(p) for p in trainer.optimizer.params] == [id(named[n]) for n in trainable]
    adam = next(s for s in trainer.optimizer.state if "mu" in s)
    assert len(adam["mu"]) == len(trainable)  # no moments for the tower
    seen = {}
    step = trainer.optimizer.step
    trainer.optimizer.step = lambda grads: (seen.update(zip(trainable, grads)), step(grads))
    trainer.train_step(trainer._device_batch(batch))

    g_jax = zoo_state_dict(_flat(jgrads))
    wd, lr = float(cfg.OPTIM.WEIGHT_DECAY), float(cfg.OPTIM.WARMUP_CONS_LR)
    got = trainer.model.state_dict()
    for k in frozen:  # the same bits before and after, on both sides
        assert torch.equal(got[k], p0[k]) and torch.equal(want[k], p0[k]), k
    for k in trainable:
        np.testing.assert_allclose(seen[k].numpy(), g_jax[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"gradient {k}")
        e_jax, e_port = g_jax[k] + wd * p0[k], seen[k] + wd * p0[k]
        ill = (((e_jax.abs() < 1e-6) | (e_port.abs() < 1e-6)) & (e_jax != e_port)).numpy()
        g, w = got[k].numpy(), want[k].numpy()
        np.testing.assert_allclose(g[~ill], w[~ill], rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(g - w)[ill] <= 2 * lr), k
        assert not torch.equal(got[k], p0[k]), f"trainable {k} did not move"


def test_clip_checkpoint_loads_the_text_tower_as_jax_converts_it(tree, tmp_path):
    state = text_state()
    path = str(tmp_path / "clip_text.pt")
    torch.save(state, path)
    cfg = clipomic_cfg(get_cfg_default, tree, str(tmp_path / "port"),
                       **{"MODEL.BACKBONE.CLIP_CHECKPOINT": path})
    backbone = build_trainer(cfg, device="cpu").model.genomic_backbone.state_dict()
    _, jtxt = J.convert_torch_clip_state(state, "ViT-B/16")
    want = clip_state_dict({"/".join(k): np.asarray(v) for k, v in flatten_dict(jtxt).items()})
    assert set(want) == {k for k in backbone if k.startswith(FROZEN)}
    for k, v in want.items():
        assert torch.equal(backbone[k], v), k
    torch.save(text_state(width=32), path)
    with pytest.raises(ValueError, match="CLIP text param"):
        build_trainer(cfg, device="cpu")


def test_survival_epoch_through_the_cli_keeps_the_tower_under_decoupled_decay(
        tree, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # JSONL metrics only
    ckpt = str(tmp_path / "clip_text.pt")
    torch.save(text_state(1), ckpt)
    out = str(tmp_path / "out")
    opts = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT),
            "DATALOADER.TRAIN.BATCH_SIZE", "3", "DATALOADER.TEST.BATCH_SIZE", "3",
            "OPTIM.MAX_EPOCH", "1", "TPU.PREFETCH", "0", "OPTIM.NAME", "adamw",
            "OPTIM.WEIGHT_DECAY", "0.1", "MODEL.BACKBONE.CLIP_CHECKPOINT", ckpt, *TEXT_OPTS]
    cfg = clipomic_cfg(get_cfg_default, tree, str(tmp_path / "init"))
    cfg.merge_from_list(opts[opts.index("OPTIM.NAME"):])
    init = build_trainer(cfg, device="cpu").model.state_dict()
    result = run(["--root", tree, "--seed", "1", "--trainer", "CLIPOMIC", "--device", "cpu",
                  "--config-file", f"{REPO}/configs/Survival/CLIPOMIC.yaml", "--output-dir", out,
                  *opts])
    log = capsys.readouterr().out
    assert result is not None and np.isfinite(result) and "* C-Index:" in log
    assert "# frozen params:" in log and "loaded pretrained CLIP text tower" in log
    state = torch.load(f"{out}/model/model.ckpt-1", weights_only=True)
    for k, v in state["model"].items():
        tower = k.split(".")[1].startswith(FROZEN) if k.startswith("genomic_backbone") else False
        assert torch.equal(v, init[k]) == tower, k  # the tower keeps its bits, the rest moved
    fresh = build_trainer(cfg, device="cpu")
    fresh.model.load_state_dict(state["model"], strict=True)
    fresh.optimizer.load_state_dict(state["opt_state"])
