"""The port's trainers on a mesh of processes (``TPU.MESH_AXES
('data','seq')``) against the one-process step, on the CPU.

One local group of two gloo ranks (``imp_torch.parallel.launch.spawn``,
one CPU thread each, a 120 s wall limit after which every rank is killed
and the fixture fails) runs ``tests/test_torch_parallel_ranks.py::trainer_rank``:

* one step of TransMIL (``TPU.ATTENTION flash``) and of MBTRAIN
  (UMEML_GAN at hidden 32, Nyström TransLayers, with its GAN phase, so
  all four optimizers step, then one CCA update over two batches, its
  cca_loss over every data rank's rows) at the meshes ``(2, 1)`` (the batch of 4
  split over ``data``), ``(1, 2)`` gather and ``(1, 2)`` ring (the bag of
  64 = 8² tokens split over ``seq``), each from the same seed as the
  one-process step computed here: the losses, every gradient each
  optimizer steps on and the parameters after the step, to rtol 1e-5 /
  atol 1e-5 (dropout is 0 on both sides; the sharded modularity sums and
  the data-split batch mean reassociate, ~2e-6 at most here);
* one CLI epoch of TransMIL at ``(1, 2)`` ring through ``python -m
  imp_torch.tools.train``'s ``run``, in which rank 1 may not write a
  checkpoint (its ``save_checkpoint`` raises); the checkpoint rank 0 wrote
  loads strictly into the one-process model, whose eval logits equal the
  ring's;
* ``TRAINER.PREC bf16`` at ``(1, 2)`` (TransMIL gather and ring, MBTRAIN
  ring), TransMIL on ``('data', 'model')`` (1, 2) and HFB at (2, 1) (its
  BatchNorm over ``data``, on a tree of 1 000 genes), each against the
  one-process step (``ranks.EXTRA_STEPS``; the tests below say how);
* a Nyström attention on a batch of 3 wrap-padded to 4 over ``data`` 2,
  where sample 0 (and its copy on rank 1) holds the pseudo-inverse
  normaliser's max: output and parameter gradients against one process on
  the padded batch (the max's cotangent split over its two holders).

The references need no JAX: the one-process step is the port's own, held
against JAX by ``test_torch_mil.py`` and ``test_torch_train.py``.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.ops import attention as tattn
from imp_torch.ops.attention import NystromAttention
from imp_torch.parallel.launch import spawn

import test_torch_parallel_ranks as ranks

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
TRAINERS = ("TransMIL", "MBTRAIN")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic.materialize(root, num_slides=12, bag_min=20, bag_max=64, feat_dim=32,
                          num_genes=60, group_size=10, seed=0)
    out = str(tmp_path_factory.mktemp("out"))
    single = {name: ranks.one_step(name, ranks.trainer_cfg(
        root, osp.join(out, "single"), name, (1, 1), "gather", REPO)) for name in TRAINERS}
    hfb_root = str(tmp_path_factory.mktemp("hfb_tree"))  # HFB cuts 2 x 500 genes
    synthetic.materialize(hfb_root, num_slides=12, bag_min=20, bag_max=64, feat_dim=32,
                          num_genes=1000, group_size=100, seed=0)
    for name, _, mode, extra in ranks.EXTRA_STEPS:
        single[(name, extra)] = ranks.extra_step(root, hfb_root, osp.join(out, "single"), REPO,
                                                 name, (1, 1), mode, extra)
    single["HFB/float64"] = ranks.float64_grads(ranks.trainer_cfg(
        hfb_root, osp.join(out, "wide"), "HFB", (1, 1), "gather", REPO))
    odd = odd_batch_case()
    torch.save(odd, osp.join(out, "nystrom_odd_batch.pt"))
    got = spawn(ranks.trainer_rank, 2, (root, out, REPO, hfb_root), timeout=120)
    return root, out, single, got, odd


def odd_batch_case():
    """Inputs of ``ranks.nystrom_odd_batch``: a Nyström attention, a batch
    of 3 bags wrap-padded to 4 (rows 0, 1, 2, 0) whose sample 0 is scaled
    up so its landmark softmax is the peakiest, and an output cotangent."""
    rng = np.random.default_rng(3)
    kwargs = dict(dim=32, dim_head=8, heads=4, num_landmarks=16)
    torch.manual_seed(3)
    state = {k: v.clone() for k, v in NystromAttention(**kwargs).state_dict().items()}
    x = rng.standard_normal((3, 64, 32)).astype(np.float32)
    x[0] *= 4.0
    idx = np.arange(4) % 3  # pad_ragged_dim0's wrap
    w = rng.standard_normal((3, 64, 32)).astype(np.float32)
    return {"kwargs": kwargs, "state": state, "x": torch.from_numpy(x[idx]),
            "w": torch.from_numpy(w[idx])}


@pytest.mark.parametrize("name", TRAINERS)
@pytest.mark.parametrize("shape,mode", ranks.MESHES)
def test_step_on_a_mesh_matches_one_process(runs, name, shape, mode):
    _, _, single, got, _ = runs
    want_metrics, want_grads, want_state = single[name]
    for rank in (0, 1):
        metrics, grads, state = got[rank]["steps"][(name, shape, mode)]
        assert metrics.keys() == want_metrics.keys()
        for k, v in metrics.items():
            assert v == pytest.approx(want_metrics[k], rel=RTOL, abs=ATOL), k
        assert len(grads) == len(want_grads) == (1 if name == "TransMIL" else 5)
        for phase, (gs, ws) in enumerate(zip(grads, want_grads)):
            for i, (g, w) in enumerate(zip(gs, ws)):
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                               err_msg=f"phase {phase} grad {i}")
        for k, w in want_state.items():
            np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_ranks_hold_the_same_parameters_after_a_step(runs):
    _, _, _, got, _ = runs
    for key, res in got[0]["steps"].items():
        state0, state1 = res[2], got[1]["steps"][key][2]
        for k, v in state0.items():
            torch.testing.assert_close(state1[k], v, rtol=0, atol=0, msg=f"{key} {k}")


def test_ring_cli_epoch_writes_on_rank_0_and_reloads_into_one_process(runs):
    root, out, _, got, _ = runs
    model_dir = osp.join(out, "cli", "model")
    assert osp.isfile(osp.join(model_dir, "model.ckpt-1"))
    assert got[0]["cli_result"] == got[1]["cli_result"]  # val selection agrees
    cfg = ranks.trainer_cfg(root, osp.join(out, "reload"), "TransMIL", (1, 1), "gather", REPO)
    trainer = build_trainer(cfg, device="cpu")
    trainer.load_model(osp.join(out, "cli"))  # load_state_dict: strict
    batch = next(iter(trainer.test_loader))
    with torch.no_grad():
        logits = trainer.model(trainer._device_batch(batch))
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["logits"].numpy(), logits.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_nystrom_normaliser_over_a_wrap_padded_data_axis(runs, monkeypatch):
    *_, got, case = runs
    attn = NystromAttention(**case["kwargs"])
    attn.load_state_dict(case["state"], strict=True)
    seen = []
    real = tattn.norm_scalar
    monkeypatch.setattr(tattn, "norm_scalar", lambda x, axis: seen.append(x) or real(x, axis))
    out = attn(case["x"])
    names, params = zip(*attn.named_parameters())
    want = dict(zip(names, torch.autograd.grad((out * case["w"]).sum(), params)))
    # the case holds what it claims: the max column sum of the padded
    # batch's [B, H, m, m] matrices lies on sample 0 (rows 0 and 3)
    (x,) = seen
    col = x.abs().sum(dim=-2)
    holders = {int(i) // col[0].numel() for i in torch.nonzero(col.flatten() == col.max())}
    assert holders == {0, 3}
    np.testing.assert_allclose(torch.cat([got[r]["odd_batch"][0] for r in (0, 1)]).numpy(),
                               out.detach().numpy(), rtol=RTOL, atol=ATOL)
    for rank in (0, 1):
        grads = got[rank]["odd_batch"][1]
        for n in names:
            np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=n)


def _grads_states(got, want, what, tol, states=True):
    """Metrics, every gradient each optimizer stepped on, and (with
    ``states``) the state after the step, running statistics included, of
    two steps."""
    (metrics, grads, state), (want_metrics, want_grads, want_state) = got[:3], want[:3]
    assert metrics.keys() == want_metrics.keys()
    for k, v in metrics.items():
        tol(v, want_metrics[k], f"{what} {k}")
    assert len(grads) == len(want_grads)
    for phase, (gs, ws) in enumerate(zip(grads, want_grads)):
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert (g is None) == (w is None)
            if w is not None:
                tol(g, w, f"{what} phase {phase} grad {i}")
    assert state.keys() == want_state.keys()
    for k, w in want_state.items() if states else ():
        tol(state[k], w, f"{what} {k}")


def _exact(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("entry", [e for e in ranks.EXTRA_STEPS if e[3] != ranks.BF16],
                         ids=["model_axis", "hfb_data_2"])
def test_replicated_axis_and_hfb_batchnorm_match_one_process(runs, entry):
    """TransMIL on ``('data', 'model')`` (1, 2), whose ranks repeat the
    whole batch as JAX's trainer replicates over an axis it does not shard;
    HFB at (2, 1), its BatchNorm taking the global batch's moments over
    ``data``: the step, the running mean and variance and the eval logits
    of the stepped model against one process at the global batch, 1e-5."""
    _, _, single, got, _ = runs
    name, _, _, extra = entry
    want = single[(name, extra)]
    wide = single["HFB/float64"]
    for rank in (0, 1):
        res = got[rank]["steps"][entry]
        if name == "HFB":
            # float32 cannot resolve some of HFB's gradients to 1e-5 (its
            # BatchNorm normalises 2B = 8 rows; tests/test_torch_zoo.py): a
            # gradient that misses is held, with the one-process one, to
            # 1e-4 of the float64 gradient
            for i, (g, w, w64) in enumerate(zip(res[1][0], want[1][0], wide)):
                try:
                    _exact(g, w, f"rank {rank} grad {i}")
                except AssertionError:
                    for x, who in ((g, "mesh"), (w, "one process")):
                        np.testing.assert_allclose(x.numpy(), w64.numpy(), rtol=1e-4,
                                                   atol=1e-4, err_msg=f"{who} grad {i}")
            res = (res[0], want[1]) + tuple(res[2:])
        _grads_states(res, want, f"rank {rank}", _exact)
        _exact(res[3], want[3], f"rank {rank} eval logits")
    if name == "HFB":  # the statistics moved, and every rank holds the same
        state = got[0]["steps"][entry][2]
        moved = [k for k in state if k.endswith("running_mean")]
        assert moved and all(float(state[k].abs().max()) > 0 for k in moved)


def _bf16(got, want, what):
    """Within BF16_TOL = 2e-2 relative L2 of the one-rank bf16 value
    (``tests/test_torch_precision.py``'s gate)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= 2e-2, f"{what}: {err:.3g}"


@pytest.mark.parametrize("entry", [e for e in ranks.EXTRA_STEPS if e[3] == ranks.BF16],
                         ids=lambda e: f"{e[0]}-{e[2]}")
def test_bf16_step_under_sequence_parallelism(runs, entry):
    """``TRAINER.PREC bf16`` at ``(1, 2)``: TransMIL's loss and every
    gradient within 2e-2 relative L2 of the one-process bf16 step (not the
    parameters after it: Adam's first step is ±lr wherever a gradient entry
    is much larger than eps, so bf16 noise in a small entry flips it);
    MBTRAIN's ring step runs its four optimizers and CCA to finite results,
    its GAN and CCA losses within 2e-2 of one process (its gradients carry
    the bf16 distillation term and bf16's ulp of the encoder outputs, which
    move by several per cent between summation orders: the net-level bf16
    checks are in ``tests/test_torch_sequence_parallel.py``)."""
    _, _, single, got, _ = runs
    name, _, _, extra = entry
    want = single[(name, extra)]
    for rank in (0, 1):
        res = got[rank]["steps"][entry]
        if name == "TransMIL":
            _grads_states(res, want, f"rank {rank}", _bf16, states=False)
            continue
        metrics, _, state = res[:3]
        assert all(np.isfinite(v) for v in metrics.values())
        assert all(torch.isfinite(v).all() for v in state.values() if v.is_floating_point())
        for k in ("loss_gen", "loss_dis_p", "loss_dis_o", "cca_loss"):
            _bf16(metrics[k], want[0][k], k)
