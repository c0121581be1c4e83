"""Export from a trainer in the PyTorch port (``imp_torch.serving.export_trainer``)
on the CPU, without JAX: every registered trainer's program against the
rebuilt module, the registered operators K1 and K6 under
``torch.library.opcheck``, the refusal on a mesh of more than one rank, the
export CLI's trainer route from a checkpoint with ``--check``, and serving
in a fresh process that never imports the model code.

The JAX package's ``export_trainer`` is held against the port's in
``tests/test_torch_export_trainer_{jax,unimodal,fusion}.py``.  Small widths: bags padded to
36 × 32, 1 000 genes (MCAT, CMTA and HFB cut signatures of 200 and 500),
UMEML at hidden 64, CLIPOMIC's text tower at width 64.  The program and the
rebuilt module run the same ops: they agree to 1e-6 (bit for bit here)."""

import json
import os.path as osp
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imp_torch.config import get_cfg_default
from imp_torch.data import synthetic
from imp_torch.engine import TRAINER_REGISTRY, build_trainer
from imp_torch.engine.precision import amp_call
from imp_torch.ops.attention import token_conv_cpu
from imp_torch.ops.flash_attention import _mask_bias, flash_fwd_op
from imp_torch.ops.pinv import norm_scalar, pinv_fwd_op
from imp_torch.serving import example_eval_batch, export_trainer, load_model, rebuild_model
from imp_torch.tools import export_model as export_cli
from imp_torch.tools.train import run as train_run

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FEAT, BAG, GENES = 32, 36, 1000
TOL = 1e-6
#: each registered trainer with its config and the options that make it small
TRAINERS = {
    "MBTRAIN": ("UMEML_GAN", ["MODEL.HIDDEN_DIM", "64"]),
    "ABMIL": ("ABMIL", []),
    "TransMIL": ("TransMIL", []),
    "SNN": ("SNN", []),
    "SNNM": ("SNNM", []),
    "CLIPOMIC": ("CLIPOMIC", ["MODEL.BACKBONE.TEXT_WIDTH", "64", "MODEL.BACKBONE.TEXT_HEADS",
                              "4", "MODEL.BACKBONE.TEXT_LAYERS", "2",
                              "MODEL.BACKBONE.TEXT_VOCAB", "128",
                              "MODEL.BACKBONE.TEXT_CONTEXT", "16"]),
    "MCAT": ("MCAT", []),
    "CMTA": ("CMTA", []),
    "Porpoise": ("Porpoise", []),
    "ConCAT": ("ConCAT", []),
    "ADD": ("ADD", []),
    "HFB": ("HFB", []),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exporttree"))
    synthetic.materialize(root, num_slides=15, bag_min=8, bag_max=40, feat_dim=FEAT,
                          num_genes=GENES, group_size=30, seed=0)
    return root


def small_cfg(root, out, trainer, *opts):
    config, extra = TRAINERS[trainer]
    cfg = get_cfg_default()
    cfg.merge_from_file(osp.join(REPO, "configs", "Survival", f"{config}.yaml"))
    cfg.OUTPUT_DIR, cfg.SEED, cfg.VERBOSE = out, 1, False
    cfg.DATASET.ROOT, cfg.DATASET.FOLD = root, 1
    cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM = BAG, FEAT
    cfg.DATALOADER.TEST.BATCH_SIZE = 3
    cfg.TRAINER.NAME = trainer
    cfg.TPU.PREFETCH = 0
    cfg.merge_from_list(extra + list(opts))
    cfg.freeze()
    return cfg


def test_the_table_covers_every_registered_trainer():
    from imp_torch.engine import baselines, fusion_trainers, mbtrain  # noqa: F401

    assert sorted(TRAINER_REGISTRY.registered_names()) == sorted(TRAINERS)


def seeded_request(manifest, rng, n):
    """``n`` slides for ``predict_many``, other than the batch the program
    was traced on: ragged bags of 1 ... BAG + 9 patches (the longest
    truncated), random omics, omics withheld from about half of the slides
    and random in-sample masks; the other fields random at their dtype."""
    req = {}
    for key, spec in manifest["batch_keys"].items():
        shape, dtype = [n] + spec["shape"][1:], np.dtype(spec["dtype"])
        if key == "img":
            lengths = [1, BAG + 9, *rng.integers(2, BAG + 9, n - 2)]
            req[key] = [rng.normal(size=(m, FEAT)).astype(np.float32) for m in lengths]
        elif key == "without_omic" or dtype.kind != "f":
            req[key] = rng.integers(0, 2, shape).astype(dtype)
        elif key not in ("img_mask", "omic_means"):
            req[key] = rng.normal(size=shape).astype(dtype)
    return req


def padded(req, omic_means, batch_keys):
    """``req`` as the model takes it: the bags padded to BAG with a mask."""
    out = {k: torch.from_numpy(v) for k, v in req.items() if k != "img"}
    if "img" in req:
        img, mask = np.zeros((len(req["img"]), BAG, FEAT), np.float32), np.zeros(
            (len(req["img"]), BAG), bool)
        for i, bag in enumerate(req["img"]):
            img[i, :len(bag)], mask[i, :len(bag)] = bag[:BAG], True
        out["img"], out["img_mask"] = torch.from_numpy(img), torch.from_numpy(mask)
    if "omic_means" in batch_keys:
        out["omic_means"] = omic_means
    return out


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_every_trainer_serves_its_program(tree, tmp_path, trainer):
    """On the batch the program was traced on, and on a seeded ragged
    request of twice the exported batch: a program that baked a mask, the
    omics' absence or any batch-derived value into its graph fails the
    second."""
    cfg = small_cfg(tree, str(tmp_path / "out"), trainer)
    tr = build_trainer(cfg, device="cpu")
    manifest = export_trainer(tr, str(tmp_path / "art"))
    assert manifest["kind"] == ("mbtrain" if trainer == "MBTRAIN" else "generic")
    assert manifest["trainer"] == trainer and manifest["device"] == "cpu"
    assert osp.getsize(tmp_path / "art" / "model.pt2") > 0

    served = load_model(str(tmp_path / "art"), device="cpu")
    batch, _ = example_eval_batch(tr)
    got = served.predict({k: v.numpy() for k, v in batch.items()})
    assert list(got) == manifest["outputs"]
    model = rebuild_model(str(tmp_path / "art"), device="cpu")
    with torch.no_grad():
        want = amp_call(model, "forward", None, batch, train=False)
    want = want if isinstance(want, dict) else {"logits": want}
    for key, value in got.items():
        assert value.shape[0] == batch["img" if "img" in batch else "mol"].shape[0]
        np.testing.assert_allclose(value, want[key].numpy(), rtol=TOL, atol=TOL, err_msg=key)

    b = manifest["batch_size"]
    req = seeded_request(manifest, np.random.default_rng(7), 2 * b)
    got = served.predict_many(req)
    for start in (0, b):  # the model at the program's batch size, chunk by chunk
        chunk = padded({k: v[start:start + b] for k, v in req.items()},
                       batch.get("omic_means"), manifest["batch_keys"])
        with torch.no_grad():
            want = amp_call(model, "forward", None, chunk, train=False)
        want = want if isinstance(want, dict) else {"logits": want}
        for key, value in got.items():
            np.testing.assert_allclose(value[start:start + b], want[key].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f"{key}, slides {start}...")


def test_the_registered_operators_pass_opcheck():
    """``imp_torch::flash_fwd`` (fp32 and bf16 operands: O and lse come out
    fp32), ``imp_torch::pinv_fwd`` and the CPU token conv: schema, fake
    implementation, autograd registration and the AOT dispatch."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, n, 32, generator=g) for n in (9, 7, 7))
    bias = _mask_bias(torch.rand(2, 7, generator=g) > 0.3, 2, 7, "cpu")
    x = torch.softmax(torch.randn(3, 16, 16, generator=g), dim=-1)
    cases = [
        (flash_fwd_op, (q, k, v, bias)),
        (flash_fwd_op, (q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)),
        (pinv_fwd_op, (x, norm_scalar(x), 6)),
        (token_conv_cpu, (torch.randn(2, 8, 40, 8), torch.randn(8, 1, 33, 1), True)),
        (token_conv_cpu, (torch.randn(2, 8, 40, 8), torch.randn(8, 1, 33, 1), False)),
    ]
    for op, args in cases:
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, (op, result)
    o, lse = flash_fwd_op(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (2, 2, 9)


def test_export_refuses_a_mesh_of_more_than_one_rank(tree, tmp_path):
    tr = build_trainer(small_cfg(tree, str(tmp_path / "out"), "ABMIL"), device="cpu")
    tr.mesh = SimpleNamespace(size=2, shape={"data": 2, "seq": 1, "model": 1, "pipe": 1})
    with pytest.raises(ValueError, match="eval program of one device.*TPU.MESH_SHAPE"):
        export_trainer(tr, str(tmp_path / "art"))


def test_export_cli_from_a_checkpoint_with_check(tree, tmp_path, capsys, monkeypatch):
    """The CLI's trainer route on an ABMIL checkpoint after one epoch of the
    train CLI (JAX's ``test_export_cli_generic_trainer_with_checkpoint``):
    ``--check`` passes, and the artifact serves the trained weights."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "train")
    opts = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT), "OPTIM.MAX_EPOCH", "1",
            "DATALOADER.TEST.BATCH_SIZE", "4", "TPU.PREFETCH", "0"]
    common = ["--root", tree, "--seed", "1", "--trainer", "ABMIL", "--device", "cpu",
              "--config-file", osp.join(REPO, "configs/Survival/ABMIL.yaml")]
    train_run(common + ["--output-dir", out] + opts)
    capsys.readouterr()
    export_dir = str(tmp_path / "art")
    manifest = export_cli.run(common + ["--model-dir", out, "--export-dir", export_dir,
                                        "--check"] + opts)
    log = capsys.readouterr().out
    assert "check OK" in log and manifest["check_max_abs_diff"] <= export_cli.CHECK_TOL
    assert manifest["kind"] == "generic" and manifest["batch_size"] == 3  # the test fold
    served = load_model(export_dir, device="cpu")
    trained = torch.load(osp.join(out, "model", "model.ckpt-1"), weights_only=True)["model"]
    model = rebuild_model(export_dir, device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(value, trained[key]), key
    tr = build_trainer(small_cfg(tree, str(tmp_path / "fresh"), "ABMIL"), device="cpu")
    batch, _ = example_eval_batch(tr)
    tr.model.load_state_dict(trained)
    with torch.no_grad():
        want = tr.model(batch, train=False)
    got = served.predict({k: v.numpy() for k, v in batch.items()})["logits"]
    np.testing.assert_allclose(got, want.numpy(), rtol=TOL, atol=TOL)


def test_a_fresh_process_serves_without_the_model_code(tree, tmp_path):
    """``load_model`` + ``predict_many`` in a new interpreter: the program
    carries the forward; ``imp_torch.models`` is never imported.  Its
    outputs equal this process's."""
    cfg = small_cfg(tree, str(tmp_path / "out"), "TransMIL", "TPU.ATTENTION", "flash")
    manifest = export_trainer(build_trainer(cfg, device="cpu"), str(tmp_path / "art"))
    assert manifest["attention"] == "flash"
    rng = np.random.default_rng(3)
    bags = [rng.normal(size=(n, FEAT)).astype(np.float32).tolist() for n in (5, 36, 50, 1)]
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from imp_torch.serving import load_model\n"
        f"served = load_model({str(tmp_path / 'art')!r}, device='cpu')\n"
        "bags = [np.asarray(b, np.float32) for b in json.load(sys.stdin)]\n"
        "out = served.predict_many({'img': bags})\n"
        "assert not any(m.startswith('imp_torch.models') for m in sys.modules)\n"
        "print(json.dumps(out['logits'].tolist()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], input=json.dumps(bags), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.asarray(json.loads(res.stdout.strip().splitlines()[-1]), np.float32)
    want = load_model(str(tmp_path / "art"), device="cpu").predict_many(
        {"img": [np.asarray(b, np.float32) for b in bags]})["logits"]
    assert got.shape == (4, 4)
    np.testing.assert_array_equal(got, want)
