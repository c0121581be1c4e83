"""The other three tasks of the paper (Classification, Grading, Subtyping)
in the PyTorch port against ``imp_tpu`` on the CPU.

* the classification evaluators (numpy and scipy in the port, scikit-learn
  in JAX) on the same logits: every metric, the per-class accuracies and
  ``cmat.npy`` to 1e-12 (float64 on both sides), with ties in the scores, a
  class never predicted, a class absent from the labels (both sides give a
  ``nan`` AUC) and ``labels.max() + 1`` above the number of classes
  present; the per-class report against ``classification_report``; and the
  port's evaluators imported and run with scikit-learn, pandas and
  matplotlib blocked;
* ``compute_accuracy`` at top-1 and top-3, with ties;
* ``BilinearFusion`` on JAX-initialised weights carried by
  ``imp_torch.convert``, in eval and in train at dropout rate 0: 1e-5;
* UMEML with ``fusion="bilinear"`` at 3 classes (Grading) and 6
  (Classification), and UMEML_GAN likewise in
  ``tests/test_torch_tasks_umeml_gan.py`` (which takes its checks from
  here): the eval forward to 1e-5 and one MBTRAIN main step
  against a JAX step built as ``imp_tpu/engine/mbtrain.py`` builds it
  (loss to 1e-5, every gradient to 1e-4 of its largest value), on weights
  of a JAX init carried by ``imp_torch.convert``;
* one TransMIL and one ABMIL ``StandardTrainer`` step at Grading against
  the JAX trainer's ``train_step``: gradients to 1e-4;
* under ``TEST.FINAL_MODEL best_val`` the best checkpoint follows the val
  accuracy (the evaluator's first metric).

Dropout cannot share bits across the two frameworks, so every parity test
runs at rate 0 on both sides (the JAX modules through ``functools.partial``
bound into the names its models build, for the test only).  Hidden 64, 32
features, bags padded to 48, 60 genes in 6 groups, batch 3.
"""

import functools
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from sklearn.metrics import classification_report

import imp_tpu.engine.baselines as jbaselines
import imp_tpu.models.layers as jlayers
import imp_tpu.models.mil as jmil
import imp_tpu.models.umeml as jumeml
import imp_tpu.models.umeml_gan as jug
import imp_tpu.ops.attention as jattn
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine import build_trainer as jax_build_trainer
from imp_tpu.engine.mbtrain import DIS_KEYS, _merge, _take
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.evaluation import build_evaluator as jax_build_evaluator
from imp_tpu.evaluation.accuracy import compute_accuracy as jax_compute_accuracy
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.models.nets import ABMIL_NET as JaxABMIL
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_tpu.ops.blocks import BilinearFusion as JaxBilinearFusion
from imp_torch.config import get_cfg_default
from imp_torch.convert import _torch_key, mil_state_dict, umeml_gan_state_dict, umeml_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.engine.trainer import device_batch
from imp_torch.evaluation import build_evaluator, compute_accuracy
from imp_torch.evaluation.evaluators import per_class_prf
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention
from imp_torch.ops.blocks import BilinearFusion
from imp_torch.ops.pairing import cosine_similarity_matrix

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FEAT, BAG, GENES, BATCH, HIDDEN = 32, 48, 60, 3, 64
TOL, GRAD_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


# ---------------------------------------------------------------------------
# the classification evaluators
# ---------------------------------------------------------------------------


def _eval_case(name):
    """(logits, labels) of one evaluator case."""
    rng = np.random.default_rng(3)
    n, c = 40, 6
    labels = rng.integers(0, c, size=n)
    logits = rng.normal(size=(n, c))
    if name == "ties":  # scores on a coarse grid: many ties in every column
        logits = np.round(logits * 2) / 2
    elif name == "never_predicted":  # class 4 never wins the argmax
        logits[:, 4] -= 100.0
    elif name == "absent_label":  # class 2 absent from the labels: its AUC is nan
        labels[labels == 2] = 0
    elif name == "max_above_present":  # labels {1, 5}: 6 AUC columns over 2 classes
        labels = np.where(labels < 3, 1, 5)
    return logits.astype(np.float32), labels.astype(np.int64)


def _eval_cfg(get_default, out):
    cfg = get_default()
    cfg.TEST.PER_CLASS_RESULT = True
    cfg.TEST.COMPUTE_CMAT = True
    cfg.OUTPUT_DIR = out
    return cfg


def _run_evaluator(build, cfg, logits, labels):
    ev = build(cfg, lab2cname={c: f"class{c}" for c in range(6)})
    for s in range(0, len(labels), 7):  # batches of 7, the last one short
        ev.process(logits[s:s + 7], labels[s:s + 7])
    return ev.evaluate()


@pytest.mark.parametrize("name", ["plain", "ties", "never_predicted", "absent_label",
                                  "max_above_present"])
@pytest.mark.parametrize("evaluator", ["Classification", "Classification_UMEML"])
def test_classification_evaluator_matches_jax(tmp_path, capsys, name, evaluator):
    logits, labels = _eval_case(name)
    runs = {}
    for side, get_default, build in (("jax", jax_cfg_default, jax_build_evaluator),
                                     ("port", get_cfg_default, build_evaluator)):
        (tmp_path / side).mkdir()
        cfg = _eval_cfg(get_default, str(tmp_path / side))
        cfg.TEST.EVALUATOR = evaluator
        runs[side] = (_run_evaluator(build, cfg, logits, labels), capsys.readouterr().out)
    (want, want_log), (got, got_log) = runs["jax"], runs["port"]
    assert list(got) == list(want) == ["accuracy", "error_rate", "AUC", "macro_f1",
                                       "perclass_accuracy"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL, equal_nan=True,
                                   err_msg=k)
    assert np.isnan(got["AUC"]) == (name == "absent_label" or name == "max_above_present")
    # the stdout block tools/parse_test_res.py scrapes, and the per-class lines
    keep = ("* ", "=> ")
    assert [l for l in got_log.splitlines() if l.startswith(keep)] == \
        [l for l in want_log.splitlines() if l.startswith(keep)]
    np.testing.assert_allclose(np.load(tmp_path / "port" / "cmat.npy"),
                               np.load(tmp_path / "jax" / "cmat.npy"), rtol=0, atol=METRIC_TOL)


@pytest.mark.parametrize("name", ["plain", "never_predicted", "max_above_present"])
def test_per_class_report_matches_sklearn(name):
    logits, labels = _eval_case(name)
    pred = logits.argmax(axis=1)
    present = np.unique(labels)
    want = classification_report(labels, pred, labels=present, zero_division=1, output_dict=True)
    got = per_class_prf(labels, pred, present, zero_division=1.0)
    for i, c in enumerate(present):
        for key, col in (("precision", "precision"), ("recall", "recall"), ("f1-score", "f1"),
                         ("support", "support")):
            assert got[col][i] == pytest.approx(want[str(c)][key], abs=METRIC_TOL), (c, key)


def test_evaluators_need_no_sklearn_pandas_or_matplotlib(tmp_path):
    """Import the port's evaluation package and evaluate with those three
    blocked, in a fresh interpreter."""
    code = f"""
import sys
for name in ("sklearn", "pandas", "matplotlib"):
    sys.modules[name] = None
import numpy as np
from imp_torch.config import get_cfg_default
from imp_torch.evaluation import build_evaluator, compute_accuracy
cfg = get_cfg_default()
cfg.TEST.EVALUATOR = "Classification_UMEML"
cfg.TEST.COMPUTE_CMAT = True
cfg.OUTPUT_DIR = {str(tmp_path)!r}
ev = build_evaluator(cfg, lab2cname={{0: "a", 1: "b", 2: "c"}})
ev.process(np.eye(3)[[0, 1, 2, 1]], np.array([0, 1, 2, 2]))
res = ev.evaluate()
assert res["accuracy"] == 75.0, res
assert not any(m.split(".")[0] in ("sklearn", "pandas", "matplotlib")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr
    assert osp.exists(tmp_path / "cmat.npy")


def test_compute_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    output = np.round(rng.normal(size=(50, 6)) * 2) / 2  # ties in every row
    target = rng.integers(0, 6, size=50)
    want = jax_compute_accuracy(output.astype(np.float32), target, topks=(1, 3))
    got = compute_accuracy(torch.tensor(output, dtype=torch.float32), torch.tensor(target),
                           topks=(1, 3))
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(float(w), abs=1e-4)
    one = compute_accuracy(torch.tensor(output[0], dtype=torch.float32),
                           torch.tensor(target[:1]))[0]
    assert one.item() == float(jax_compute_accuracy(output[0].astype(np.float32),
                                                    target[:1])[0])


# ---------------------------------------------------------------------------
# BilinearFusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"skip": 1, "gate1": 0}],
                         ids=["gated", "skip_ungated1"])
def test_bilinear_fusion_matches_jax(kw):
    dims = dict(dim1=HIDDEN, dim2=HIDDEN, scale_dim1=8, scale_dim2=8, mmhid=HIDDEN)
    rng = np.random.default_rng(1)
    v1 = rng.normal(size=(5, HIDDEN)).astype(np.float32)
    v2 = rng.normal(size=(5, HIDDEN)).astype(np.float32)
    jmod = JaxBilinearFusion(**dims, **kw, dropout_rate=0.0)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(v1), jnp.asarray(v2))
    want = np.asarray(jmod.apply(params, jnp.asarray(v1), jnp.asarray(v2)))

    mod = BilinearFusion(**dims, **kw)
    state = {}
    for key, value in _flat(params).items():
        tkey, transpose = _torch_key(key)
        state[tkey] = torch.tensor(value.T if transpose else value)
    mod.load_state_dict(state, strict=True)
    assert mod.encoder1.in_features == (HIDDEN // 8 + 1) ** 2
    t1, t2 = torch.from_numpy(v1), torch.from_numpy(v2)
    with torch.no_grad():
        _close(mod(t1, t2), want, TOL, "eval")
        mod.dropout_rate = 0.0
        _close(mod(t1, t2, generator=torch.Generator().manual_seed(0)), want, TOL, "rate 0")
        mod.dropout_rate = 0.25  # with draws it differs, and only then
        assert not torch.allclose(mod(t1, t2, generator=torch.Generator().manual_seed(0)),
                                  torch.tensor(want))


# ---------------------------------------------------------------------------
# UMEML_GAN and UMEML with bilinear fusion under MBTRAIN
# ---------------------------------------------------------------------------

#: task -> (config directory, label of each batch row)
TASKS = {"Grading": [0, 2, 1], "Classification": [5, 0, 3]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("taskstree"))
    synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=BAG, feat_dim=FEAT,
                          num_genes=GENES, group_size=10, seed=0)
    return root


@pytest.fixture(scope="module")
def jax_dropout_zero():
    """The JAX TransLayers and BilinearFusion its models build at rate 0."""
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    for mod in (jug, jlayers, jumeml):
        mp.setattr(mod, "TransLayer", zero)
    fusion = functools.partial(JaxBilinearFusion, dropout_rate=0.0)
    mp.setattr(jug, "BilinearFusion", fusion)
    mp.setattr(jumeml, "BilinearFusion", fusion)
    yield
    mp.undo()


def _mb_cfg(get_default, task, model, root, out=""):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs", task, f"{model}.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TRAIN.BATCH_SIZE = cfg.DATALOADER.TEST.BATCH_SIZE = BATCH
    cfg.MODEL.DROPOUT = 0.0
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.TPU.PREFETCH = 0
    return cfg


def _batch(labels, seed):
    rng = np.random.default_rng(seed)
    lens = np.array([BAG, 29, 5])
    mask = np.arange(BAG)[None, :] < lens[:, None]
    return {
        "img": rng.normal(size=(BATCH, BAG, FEAT)).astype(np.float32) * mask[..., None],
        "img_mask": mask,
        "mol": rng.lognormal(size=(BATCH, GENES)).astype(np.float32),
        "label": np.array(labels, np.int32),
        "without_omic": np.array([0, 1, 0], np.float32),  # the main loss reaches the generator
        "insample_without_omic": (rng.random((BATCH, GENES)) < 0.2).astype(np.int32),
        "omic_means": rng.normal(size=(GENES,)).astype(np.float32),
    }


def _greedy_gap(sim, k=3):
    """The smallest lead of a greedy pick over the runner-up."""
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


def _jax_main_step(model, cfg, params, batch, gan):
    """Loss, outputs and gradients of one main step: UMEML_GAN's (encode
    vjp, then ``finish`` over the non-discriminator parameters, as
    ``mbtrain.py:357-466`` without the GAN phase) or UMEML's
    (``mbtrain.py:270-288``)."""
    task_loss = jax_task_loss(cfg)
    rng = jax.random.PRNGKey(3)
    if not gan:
        def loss_fn(p):
            out = model.apply(p, batch, train=True, rngs={"dropout": rng})
            return task_loss(out["logits"], batch) + out["modular_loss"], out

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        return loss, out, grads

    main_keys = tuple(k for k in params["params"] if k not in DIS_KEYS)

    @jax.jit
    def step(params, batch):
        enc, enc_vjp = jax.vjp(lambda p: model.apply(p, batch, train=True,
                                                     method=jug.UMEML_GAN.encode,
                                                     rngs={"dropout": rng}), params)

        def main_fn(sub, enc_in):
            out = model.apply(_merge(params, sub), enc_in, batch, train=True, replace_ratio=0.0,
                              rngs={"dropout": rng, "gan": rng}, method=jug.UMEML_GAN.finish)
            return task_loss(out["logits"], batch) + out["modular_loss"] + out["loss_kd"], out

        (loss, out), (g_sub, g_enc) = jax.value_and_grad(main_fn, argnums=(0, 1),
                                                         has_aux=True)(_take(params, main_keys), enc)
        (g_enc_params,) = enc_vjp(g_enc)
        return loss, out, jax.tree_util.tree_map(jnp.add, g_sub, _take(g_enc_params, main_keys))

    return step(params, batch)


@pytest.mark.parametrize("task", list(TASKS))
def test_bilinear_umeml_forward_and_main_step_match_jax(tree, tmp_path, jax_dropout_zero, task):
    check_bilinear_model(tree, tmp_path, task, "UMEML")


def check_bilinear_model(tree, tmp_path, task, model_name):
    """The eval forward and one MBTRAIN main step of ``model_name`` (UMEML
    or UMEML_GAN) with bilinear fusion at ``task`` against JAX."""
    gan = model_name == "UMEML_GAN"
    cfg = _mb_cfg(get_cfg_default, task, model_name, tree, str(tmp_path))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    model = trainer.model
    n_classes = {"Grading": 3, "Classification": 6}[task]
    assert trainer.num_classes == n_classes and model.num_classes == n_classes
    assert model.fusion == "bilinear" and model.mm.encoder1.in_features == (HIDDEN // 8 + 1) ** 2
    assert type(trainer.evaluator).__name__ == "Classification_UMEML"

    batch = _batch(TASKS[task], seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = _mb_cfg(jax_cfg_default, task, model_name, tree)
    if gan:
        jmodel = jax_build_model("umeml_gan", cfg=jcfg, num_classes=n_classes,
                                 gene_group_indexes=[list(g) for g in model.gene_group_indexes])
        init = {k: (v if k == "omic_means" else v[:1]) for k, v in jb.items()}

        def touch(module, b):  # the eval forward and the GAN losses create every parameter
            out = module(b, train=False)
            return module.gen_loss(out["h_path"], out["h_omic"])

        params = jax.jit(lambda r, b: jmodel.init(r, b, method=touch))(
            {"params": jax.random.PRNGKey(0)}, init)
        convert = umeml_gan_state_dict
    else:
        jmodel = jax_build_model("umeml", cfg=jcfg, num_classes=n_classes)
        params = jax.jit(functools.partial(jmodel.init, train=False))(
            {"params": jax.random.PRNGKey(0)}, jb)
        convert = umeml_state_dict
    assert "params/mm/encoder1/kernel" in _flat(params)
    model.load_state_dict(convert(_flat(params)), strict=True)
    for m in model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    model.mm.dropout_rate = 0.0

    want_loss, want, want_grads = _jax_main_step(jmodel, jcfg, params, jb, gan)

    # the eval forward, against the JAX train forward's outputs: at dropout 0
    # and replacement ratio 0 the two differ only by the modularity loss
    tb = device_batch(batch, "cpu")
    seen = []
    hook = model.bottleattn.register_forward_pre_hook(
        lambda _m, args: seen.append(cosine_similarity_matrix(args[0], args[1])))
    with torch.no_grad():
        got = model(tb)
    hook.remove()
    assert _greedy_gap(seen[0][:BATCH]) > 1e-4  # no near-tie in the greedy pairing
    keys = ("logits", "importance_path", "importance_omic") if gan else ("logits",)
    for key in keys:
        assert got[key].shape[-1] == (n_classes if key == "logits" else cfg.MODEL.UMEML.PROTOTYPES)
        _close(got[key], want[key], TOL, f"eval {key}")

    # one main step: the loss and every gradient the main optimizer receives
    names = [n for n, p in model.named_parameters() if any(p is q for q in trainer.main_params)]
    grads = {}
    step = trainer.main_opt.step
    trainer.main_opt.step = lambda g: (grads.update(zip(names, g)), step(g))
    loss = trainer.train_step(tb, train_gan=False, replace_ratio=0.0)["loss"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    want_grads = convert(_flat(_merge(jax.tree_util.tree_map(jnp.zeros_like, params),
                                      want_grads) if gan else want_grads))
    for k in names:
        g = torch.zeros_like(want_grads[k]) if grads[k] is None else grads[k]
        _close(g, want_grads[k], GRAD_TOL, f"gradient {k}")
    assert np.abs(want_grads["mm.encoder1.weight"].numpy()).max() > 0
    if gan:  # the missing-omics row reaches the generator
        assert np.abs(want_grads["gan_generator_p2o.fc1.weight"].numpy()).max() > 0


# ---------------------------------------------------------------------------
# TransMIL and ABMIL under StandardTrainer at Grading
# ---------------------------------------------------------------------------


def _mil_cfg(get_default, root, out, trainer):
    cfg = get_default()
    cfg.merge_from_file(osp.join(REPO, "configs/Grading", f"{trainer}.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = 36, FEAT
    cfg.DATALOADER.TRAIN.BATCH_SIZE = BATCH
    cfg.TRAINER.NAME = trainer
    cfg.TPU.ATTENTION = "flash"
    cfg.TPU.PREFETCH = 0
    return cfg


@pytest.mark.parametrize("name", ["TransMIL", "ABMIL"])
def test_one_standard_trainer_step_at_grading_matches_jax(tree, tmp_path, name):
    mp = pytest.MonkeyPatch()
    mp.setattr(jmil, "TransLayer", functools.partial(jattn.TransLayer, dropout=0.0))
    mp.setattr(jbaselines, "ABMIL_NET", functools.partial(JaxABMIL, dropout=0.0))
    try:
        jcfg = _mil_cfg(jax_cfg_default, tree, str(tmp_path / "jax"), name)
        jcfg.TPU.MESH_SHAPE = (1,)  # one device: no wrap-padded rows in the loss
        jtrainer = jax_build_trainer(jcfg)
        params = jax.tree_util.tree_map(np.asarray, jtrainer.params)
        batch = next(iter(jtrainer.train_loader))
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k in ("img", "img_mask", "label")}
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jtrainer.task_loss(
            jtrainer.model.apply(p, jb, train=True), jb)))(params)
    finally:
        mp.undo()
        jattn.set_default_attention_impl("nystrom")

    cfg = _mil_cfg(get_cfg_default, tree, str(tmp_path / "port"), name)
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.model.classifier.out_features == 3
    assert type(trainer.evaluator).__name__ == "Classification"
    trainer.model.load_state_dict(mil_state_dict(_flat(params)), strict=True)
    for m in trainer.model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    if name == "ABMIL":
        trainer.model.mil.dropout = 0.0
        trainer.model.mil.attention_net.rate = 0.0
    names = [n for n, _ in trainer.model.named_parameters()]
    seen = {}
    step = trainer.optimizer.step
    trainer.optimizer.step = lambda grads: (seen.update(zip(names, grads)), step(grads))
    loss = trainer.train_step(trainer._device_batch(batch))["loss"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    g_jax = mil_state_dict(_flat(jgrads))
    for k in names:
        np.testing.assert_allclose(seen[k].numpy(), g_jax[k].numpy(), rtol=GRAD_TOL, atol=1e-6,
                                   err_msg=f"gradient {k}")


def test_best_val_checkpoint_follows_accuracy(tree, tmp_path):
    """Under ``TEST.FINAL_MODEL best_val`` the best checkpoint is the epoch
    with the highest val accuracy, the evaluator's first metric, and the
    final test runs on it."""
    cfg = _mil_cfg(get_cfg_default, tree, str(tmp_path), "ABMIL")
    cfg.TEST.FINAL_MODEL = "best_val"
    cfg.OPTIM.MAX_EPOCH = 4
    cfg.OPTIM.LR = 2e-2  # large steps: the accuracy moves between epochs
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    seen = []
    test = trainer.test

    def record(split=None, **kw):
        result = test(split, **kw)
        seen.append((split, result, trainer.evaluator.evaluate()["accuracy"]))
        return result

    trainer.test = record
    final = trainer.train()
    val = [(r, acc) for split, r, acc in seen if split == "val"]
    assert len(val) == 4 and all(r == acc for r, acc in val)
    best_epoch = 1 + max(range(4), key=lambda i: (val[i][0], -i))  # the first best
    ckpt = torch.load(osp.join(cfg.OUTPUT_DIR, "model", "model-best.ckpt"), weights_only=True)
    assert ckpt["epoch"] == best_epoch and ckpt["val_result"] == val[best_epoch - 1][0]
    assert final == seen[-1][1] and seen[-1][0] is None
    assert final == val[best_epoch - 1][0]  # test == val in the 5-fold layout: the best model
