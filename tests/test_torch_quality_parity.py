"""Whole MBTRAIN runs of the PyTorch port against whole runs of ``imp_tpu``'s
trainer on the CPU: the paper's curriculum end to end, not one step.

The JAX ``MBTRAIN`` is built through ``imp_tpu.engine.build_trainer`` on a
one-device mesh; its initial ``state["params"]`` (all four partitions: the
main model, the generator and both discriminators) reach the port's MBTRAIN
through ``imp_torch.convert.umeml_gan_state_dict``, and ``.train()`` runs on
both sides over the same synthetic tree (the same slides, folds and
epoch-seeded batch order).  The committed ``configs/<Task>/UMEML_GAN.yaml``
is read by both packages, at the small widths of ``test_torch_train.py``
(hidden 64, 6 prototypes, 60 genes in six groups of 10, features 32, bags
of <= 64, batch 3) with:

* dropout 0 on both sides (``MODEL.DROPOUT 0``; the TransLayers' fixed 0.1
  and the bilinear fusion's 0.25 bound to 0 in JAX as
  ``test_torch_tasks.jax_dropout_zero`` binds them, set to 0 on the port's
  modules);
* the replacement ratio 0 (its draw cannot share bits): the replacement
  ramp never starts;
* ``CCA_EVERY_EPOCH`` on with ``CCA_DROPOUT False``;
* 3 epochs with the GAN phase from the second: a plain epoch, two GAN
  epochs and the CCA epochs after the first two.

Survival (C-index, concat fusion) and Grading (accuracy, bilinear fusion)
are two cases of one test.  Checked: the curriculum flags of every epoch
(``gan=``, ``rr=``) and the CCA lines, the per-epoch mean of the main loss
and of the three GAN losses, the final test logits of every slide, and the
final metric.

A JAX run takes ~40 s here (tracing and compiling the jitted steps), so
both run at once in child processes (``python
tests/test_torch_quality_parity.py TASK ROOT OUT``, this file's
``__main__``), which write the initial parameters as soon as the trainer is
built and the run's log, logits and metric at its end; each case trains the
port while its JAX child trains.

Tolerances, from the drift measured between the two runs on this tree.
Float32 on both sides with different summation orders; Adam's first step
is e / (|e| + eps), so a gradient that is rounding noise on both sides
(the CCA loss's per-column standardisation makes some exactly zero in exact
arithmetic) moves its parameter by a full learning-rate step in a
direction that differs between the two; each CCA epoch starts a fresh Adam
at 1e-3, and the difference grows from ~1e-6 at the first step:

* per-epoch loss means: measured at most 7.8e-4 relative (Survival, main
  loss, epoch 3) and 1.4e-4 (Grading, generator loss); held to
  ``LOSS_RTOL`` = 3e-3;
* final test logits: measured at most 7.5e-4 absolute (Survival) and
  3.4e-6 (Grading); held to ``LOGIT_ATOL`` = 3e-3;
* the final metric: equal (a ranking or an argmax of those logits).
"""

import contextlib
import io
import json
import os
import os.path as osp
import re
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
HIDDEN, FEAT, BAG, GENES, SLIDES, BATCH, EPOCHS = 64, 32, 64, 60, 15, 3, 3
LOSS_RTOL = 3e-3
LOGIT_ATOL = 3e-3
LOSSES = ("loss", "loss_gen", "loss_dis_p", "loss_dis_o")
METRIC = {"Survival": "cindex", "Grading": "accuracy"}
CHILD_TIMEOUT = 600
SLOW_IMPORTS = ("matplotlib", "torch.utils.tensorboard")


def _cfg(get_default, task, root, out):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs", task, "UMEML_GAN.yaml"))
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.OUTPUT_DIR = out
    cfg.SEED = 1
    cfg.VERBOSE = False
    cfg.DATASET.ROOT = root
    cfg.DATASET.FOLD = 1
    cfg.DATASET.BAG_PAD = BAG
    cfg.DATASET.PATH.DIM = FEAT
    cfg.MODEL.HIDDEN_DIM = cfg.MODEL.PROJECT_DIM = HIDDEN
    cfg.MODEL.DROPOUT = 0.0
    cfg.DATALOADER.TRAIN.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = BATCH
    cfg.OPTIM.MAX_EPOCH = EPOCHS
    cur = cfg.TRAIN.CURRICULUM
    cur.GAN_START_EPOCH, cur.REPLACE_START_EPOCH = 1, EPOCHS + 1
    cur.CCA_EVERY_EPOCH, cur.CCA_DROPOUT = True, False
    cfg.TPU.PREFETCH = 0
    return cfg


def _record_eval_logits(trainer):
    """The logits the trainer's evaluator receives, one list per evaluation."""
    evals, ev = [], trainer.evaluator
    reset, process = ev.reset, ev.process

    def on_reset():
        evals.append([])
        reset()

    def on_process(*args):
        evals[-1].append(np.asarray(args[1] if len(args) == 4 else args[0], np.float64))
        process(*args)

    ev.reset, ev.process = on_reset, on_process
    return evals


def jax_side(task, root, out):
    """The JAX run of ``task`` (this file's ``__main__``, in a child
    process): ``params.npz`` as soon as the trainer is built, then
    ``logits.npy`` (the final test's logits) and ``result.json`` (metric,
    log, the number of evaluations and of steps an epoch) when it has
    trained.  Neither TensorBoard nor matplotlib is imported (the trainer
    then keeps the scalars' JSONL only and draws no PNG; their imports cost
    ~15 s cold here)."""
    import functools

    import flax
    import jax

    jax.config.update("jax_platforms", "cpu")
    import imp_tpu.models.layers as jlayers
    import imp_tpu.models.umeml as jumeml
    import imp_tpu.models.umeml_gan as jug
    from flax.traverse_util import flatten_dict
    from imp_tpu.config import get_cfg_default as jax_cfg_default
    from imp_tpu.engine import build_trainer as jax_build_trainer
    from imp_tpu.ops.attention import TransLayer
    from imp_tpu.ops.blocks import BilinearFusion

    for name in SLOW_IMPORTS:
        sys.modules[name] = None
    zero = functools.partial(TransLayer, dropout=0.0)
    for mod in (jug, jlayers, jumeml):
        mod.TransLayer = zero
    jug.BilinearFusion = jumeml.BilinearFusion = functools.partial(BilinearFusion,
                                                                   dropout_rate=0.0)
    init = flax.linen.Module.init  # compiled: op by op it takes ~20 s here

    def jit_init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, method=method, **kw))(rngs, *args)

    flax.linen.Module.init = jit_init

    cfg = _cfg(jax_cfg_default, task, root, out)
    cfg.TPU.MESH_SHAPE = (1,)
    trainer = jax_build_trainer(cfg)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(trainer.state["params"]).items()}
    np.savez(osp.join(out, "params.tmp.npz"), **flat)
    os.replace(osp.join(out, "params.tmp.npz"), osp.join(out, "params.npz"))
    evals = _record_eval_logits(trainer)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        metric = trainer.train()
    np.save(osp.join(out, "logits.npy"), np.concatenate(evals[-1]))
    with open(osp.join(out, "result.tmp.json"), "w") as f:
        json.dump({"metric": float(metric), "log": log.getvalue(), "evaluations": len(evals),
                   "steps": len(trainer.train_loader)}, f)
    os.replace(osp.join(out, "result.tmp.json"), osp.join(out, "result.json"))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """(tree, {task: (its JAX child, its output directory)}), both children
    started at once on one synthetic tree; ended after the file."""
    from imp_torch.data import synthetic

    root = str(tmp_path_factory.mktemp("tree"))
    synthetic.materialize(root, num_slides=SLIDES, bag_min=8, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=0)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    runs = {}
    try:
        for task in METRIC:
            out = str(tmp_path_factory.mktemp(f"jax_{task}"))
            child = subprocess.Popen([sys.executable, osp.abspath(__file__), task, root, out],
                                     cwd=REPO, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
            runs[task] = (child, out)
        yield root, runs
    finally:
        for child, _ in runs.values():
            if child.poll() is None:
                child.kill()
            child.communicate()


def _wait_for(path, child):
    deadline = time.monotonic() + CHILD_TIMEOUT
    while not osp.exists(path):
        if child.poll() is not None and not osp.exists(path):
            pytest.fail(f"the JAX run ended ({child.returncode}):\n{child.communicate()[0]}")
        if time.monotonic() > deadline:
            pytest.fail(f"no {path} after {CHILD_TIMEOUT} s")
        time.sleep(0.2)


def _epoch_means(out, steps_per_epoch):
    """{loss name: [its mean over epoch e's steps]} from the run's scalars."""
    by = {}
    with open(osp.join(out, "tensorboard", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            kind, _, name = rec["tag"].partition("/")
            if kind == "train" and name in LOSSES:
                by.setdefault(name, {}).setdefault(rec["step"] // steps_per_epoch, []).append(
                    rec["value"])
    return {n: [float(np.mean(e[k])) for k in sorted(e)] for n, e in by.items()}


def _curriculum(log):
    """[(epoch, gan, rr)] of the progress lines, and {epoch: CCA lines}."""
    flags = sorted(set(re.findall(r"epoch \[(\d+)/\d+\] batch .* gan=(\w+) rr=([\d.]+)", log)))
    cca = re.findall(r"epoch \[(\d+)/\d+\] CCA batch", log)
    return flags, {e: cca.count(e) for e in set(cca)}


def _train_port(task, root, out, params):
    """The port's MBTRAIN from the JAX run's initial parameters, dropout 0,
    one torch thread: (trainer, metric, log, eval logits)."""
    import torch

    from imp_torch.config import get_cfg_default
    from imp_torch.convert import umeml_gan_state_dict
    from imp_torch.engine import build_trainer
    from imp_torch.ops.attention import ExactSelfAttention, NystromAttention

    cfg = _cfg(get_cfg_default, task, root, out)
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    trainer.model.load_state_dict(umeml_gan_state_dict(params), strict=True)
    for m in trainer.model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    if cfg.MODEL.FUSION == "bilinear":
        trainer.model.mm.dropout_rate = 0.0
    evals = _record_eval_logits(trainer)
    log = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(log):
            metric = trainer.train()
    finally:
        torch.set_num_threads(threads)
    return trainer, metric, log.getvalue(), evals


@pytest.mark.parametrize("task", list(METRIC))
def test_whole_mbtrain_run_matches_jax(jax_runs, tmp_path, monkeypatch, task):
    for name in SLOW_IMPORTS:  # as in the JAX child
        monkeypatch.setitem(sys.modules, name, None)
    root, runs = jax_runs
    child, jax_out = runs[task]
    _wait_for(osp.join(jax_out, "params.npz"), child)
    params = dict(np.load(osp.join(jax_out, "params.npz")))
    port_out = str(tmp_path / "port")
    trainer, port_metric, port_log, port_evals = _train_port(task, root, port_out, params)
    _wait_for(osp.join(jax_out, "result.json"), child)
    with open(osp.join(jax_out, "result.json")) as f:
        jax_run = json.load(f)

    steps = len(trainer.train_loader)
    assert steps == jax_run["steps"] == -(-(SLIDES - SLIDES // 5) // BATCH)
    # the curriculum: plain, GAN, GAN; a CCA epoch after each of the first two
    flags, cca = _curriculum(port_log)
    assert flags == [("1", "False", "0.000"), ("2", "True", "0.000"), ("3", "True", "0.000")]
    assert cca == {"1": 1, "2": 1}
    assert _curriculum(jax_run["log"]) == (flags, cca)

    jax_means, port_means = _epoch_means(jax_out, steps), _epoch_means(port_out, steps)
    assert set(port_means) == set(jax_means) == set(LOSSES)
    assert len(port_means["loss"]) == EPOCHS and len(port_means["loss_gen"]) == EPOCHS - 1
    for name in LOSSES:
        np.testing.assert_allclose(port_means[name], jax_means[name], rtol=LOSS_RTOL,
                                   err_msg=name)

    # every evaluation (one per epoch, then the final test) on the same slides
    assert len(port_evals) == jax_run["evaluations"] == EPOCHS + 1
    want, got = np.load(osp.join(jax_out, "logits.npy")), np.concatenate(port_evals[-1])
    assert got.shape == want.shape and got.shape[0] == SLIDES // 5
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)

    assert f"* {METRIC[task]}:" in port_log and f"* {METRIC[task]}:" in jax_run["log"]
    assert port_metric == pytest.approx(jax_run["metric"], abs=1e-9)


if __name__ == "__main__":
    jax_side(*sys.argv[1:4])
