"""Serving of the PyTorch port (``imp_torch.serving``, ``imp_torch.tools``)
on the CPU: export, load, ``predict_many`` across chunks held against the
``imp_tpu`` eval forward on the same padded chunks, ``risk``, the HTTP 200 /
400 / 404 paths, the export CLI, and the configuration ``chip_smoke.py``
serves.

Small widths as in ``test_torch_umeml_gan.py`` (hidden 64, 6 prototypes,
60 genes, bags padded to 64, exported batch 4); weights from a JAX init.
Tolerance 1e-5 (float32 on both sides, different summation orders)."""

import importlib.util
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.models import build_model as jax_build_model
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.models import build_model
from imp_torch.serving import (
    export_model,
    load_model,
    make_http_server,
    mbtrain_batch_template,
    rebuild_model,
    survival_risk,
)
from imp_torch.tools import export_model as export_cli

REPO = Path(__file__).resolve().parents[1]
HIDDEN, N_PROTO, GENES, FEAT, BAG, BATCH = 64, 6, 60, 32, 64, 4
GROUPS = [list(range(i * 10, (i + 1) * 10)) for i in range(N_PROTO)]
TOL = 1e-5
LENGTHS = (64, 1, 30, 80, 17, 64, 5, 33, 12, 50)  # 80 > BAG: truncated


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(get_default, attention="auto"):
    cfg = get_default()
    cfg.MODEL.NAME = "umeml_gan"
    cfg.TRAINER.NAME = "MBTRAIN"
    cfg.TASK.NAME = "Survival"
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.MODEL.UMEML.PROTOTYPES = N_PROTO
    cfg.MODEL.FUSION = "concat"
    cfg.DATASET.PATH.DIM = FEAT
    cfg.DATASET.BAG_PAD = BAG
    cfg.DATASET.OMIC.DIM = GENES
    cfg.TPU.ATTENTION = attention
    return cfg


def _slides(lengths, seed=5):
    rng = np.random.default_rng(seed)
    without = np.zeros(len(lengths), np.float32)
    without[1] = 1.0
    return {
        "img": [rng.normal(size=(n, FEAT)).astype(np.float32) for n in lengths],
        "mol": rng.lognormal(size=(len(lengths), GENES)).astype(np.float32),
        "without_omic": without,
    }


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A nystrom (default attention) artifact with JAX-initialised weights."""
    jmodel = jax_build_model("umeml_gan", cfg=_cfg(jax_cfg_default), num_classes=4,
                             gene_group_indexes=GROUPS)
    template = mbtrain_batch_template(_cfg(get_cfg_default), BATCH, GENES)
    init_batch = {k: (v if k == "omic_means" else v[:1]) for k, v in template.items()}

    def init_eval_and_gan(module, batch):  # every submodule, no train-mode trace
        out = module(batch, train=False)
        return module.gen_loss(out["h_path"], out["h_omic"])

    rngs = {n: jax.random.key(i, impl="rbg") for i, n in enumerate(("params", "dropout", "gan"))}
    params = jax.jit(lambda r, b: jmodel.init(r, b, method=init_eval_and_gan))(rngs, init_batch)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}

    cfg = _cfg(get_cfg_default)
    model = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS,
                        device="cpu")
    model.load_state_dict(umeml_gan_state_dict(flat), strict=True)
    omic_means = np.random.default_rng(1).lognormal(size=GENES).astype(np.float32)
    out = str(tmp_path_factory.mktemp("artifact"))
    manifest = export_model(model, cfg, template, out, omic_means)
    return out, manifest, jmodel, params, omic_means


def _padded_chunk(slides, s, e, omic_means, batch=BATCH):
    """The host batch ServingModel builds for slides[s:e]: bags padded to
    BAG with a mask, rows wrap-padded to the batch, zero ablation masks."""
    idx = np.arange(batch) % (e - s) + s
    img = np.zeros((batch, BAG, FEAT), np.float32)
    mask = np.zeros((batch, BAG), bool)
    for row, i in enumerate(idx):
        t = min(len(slides["img"][i]), BAG)
        img[row, :t] = slides["img"][i][:t]
        mask[row, :t] = True
    return {
        "img": img, "img_mask": mask, "mol": slides["mol"][idx],
        "without_omic": slides["without_omic"][idx],
        "insample_without_omic": np.zeros((batch, GENES), np.int32),
        "omic_means": omic_means,
    }


def test_roundtrip_predict_many_matches_jax_per_chunk(exported):
    out_dir, manifest, jmodel, params, omic_means = exported
    assert manifest["attention"] == "nystrom" and manifest["batch_size"] == BATCH
    assert manifest["gene_group_indexes"] == GROUPS and manifest["bag_pad"] == BAG
    served = load_model(out_dir, device="cpu")
    slides = _slides(LENGTHS)
    got = served.predict_many(slides)
    assert got["logits"].shape == (len(LENGTHS), 4)
    assert got["importance_path"].shape == (len(LENGTHS), N_PROTO)

    # the Nyström normaliser spans the whole batch, so each chunk is held
    # against JAX on exactly the padded chunk the server built
    apply = jax.jit(lambda p, b: jmodel.apply(p, b, train=False))
    for s in range(0, len(LENGTHS), BATCH):
        e = min(s + BATCH, len(LENGTHS))
        want = apply(params, {k: jnp.asarray(v) for k, v in
                              _padded_chunk(slides, s, e, omic_means).items()})
        for key in ("logits", "importance_path", "importance_omic"):
            np.testing.assert_allclose(got[key][s:e], np.asarray(want[key])[: e - s],
                                       rtol=TOL, atol=TOL, err_msg=f"{key} chunk {s}")
    np.testing.assert_allclose(served.predict_risk(slides), survival_risk(got["logits"]),
                               rtol=1e-6)


def test_predict_rejects_malformed_batches(exported):
    served = load_model(exported[0], device="cpu")
    slides = _slides(LENGTHS)
    with pytest.raises(ValueError, match="per-sample input 'mol' has length 9"):
        served.predict_many(dict(slides, mol=slides["mol"][:9]))
    with pytest.raises(ValueError, match="exceeds the exported batch size"):
        served.predict(slides)
    with pytest.raises(ValueError, match="trailing dims"):
        served.predict({"img": slides["img"][:2], "mol": slides["mol"][:2, :10]})


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_paths(exported):
    server = make_http_server(exported[0], port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        assert r.status == 200 and health["attention"] == "nystrom"
        assert health["batch_size"] == BATCH and health["device"] == "cpu"

        slides = _slides(LENGTHS[:5], seed=9)  # 5 > batch 4: two chunks
        status, resp = _post(base + "/predict", {
            "batch": {"img": [b.tolist() for b in slides["img"]],
                      "mol": slides["mol"].tolist(),
                      "without_omic": slides["without_omic"].tolist()},
            "risk": True,
        })
        assert status == 200 and resp["batch_size"] == 5
        want = server.serving_model.predict_many(slides)["logits"]
        np.testing.assert_allclose(np.asarray(resp["outputs"]["logits"]), want,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(np.asarray(resp["risk"]), survival_risk(want), rtol=1e-6)

        status, resp = _post(base + "/predict", {"batch": {"img": [[[0.0] * 3]],
                                                           "mol": [[0.0] * 7]}})
        assert status == 400 and "Error" in resp["error"]
        assert _post(base + "/predict", {"batch": {}})[0] == 400
        assert _post(base + "/nope", {"batch": {}})[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_flash_artifact_and_export_cli(tmp_path):
    """The CLI exports a seeded flash artifact from the flagship YAML (shrunk
    by overrides); what it serves equals the model's own forward, and
    re-exporting its weights with --params gives the same logits."""
    shrink = ["DATASET.BAG_PAD", str(BAG), "DATASET.PATH.DIM", str(FEAT),
              "DATASET.OMIC.DIM", str(GENES), "MODEL.HIDDEN_DIM", str(HIDDEN)]
    args = export_cli.parser().parse_args(
        ["--export-dir", str(tmp_path / "a"), "--config-file",
         str(REPO / "configs/Survival/UMEML_GAN.yaml"), "--random-init", "--seed", "3",
         "--attention", "flash", "--batch-size", "2", "--device", "cpu", *shrink])
    manifest = export_cli.main(args)
    assert manifest["attention"] == "flash" and manifest["batch_size"] == 2
    served = load_model(str(tmp_path / "a"), device="cpu")
    model = rebuild_model(str(tmp_path / "a"), device="cpu")
    assert model.attention == "flash"
    slides = _slides((40, 64, 3))
    got = served.predict_many(slides)["logits"]
    chunk = _padded_chunk(slides, 0, 2, served._aux["omic_means"], batch=2)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in chunk.items()})["logits"]
    np.testing.assert_allclose(got[:2], want.numpy(), rtol=TOL, atol=TOL)

    torch.save(model.state_dict(), tmp_path / "w.pt")
    args = export_cli.parser().parse_args(
        ["--export-dir", str(tmp_path / "b"), "--config-file",
         str(REPO / "configs/Survival/UMEML_GAN.yaml"), "--params", str(tmp_path / "w.pt"),
         "--attention", "flash", "--batch-size", "2", "--device", "cpu", *shrink])
    export_cli.main(args)
    again = load_model(str(tmp_path / "b"), device="cpu").predict_many(slides)["logits"]
    np.testing.assert_array_equal(again, got)


def test_chip_smoke_serves_the_flagship_yaml():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = get_cfg_default()
    want.merge_from_file(str(REPO / "configs/Survival/UMEML_GAN.yaml"))
    assert smoke.flagship_cfg("auto").to_dict() == want.to_dict()
    flash = smoke.flagship_cfg("flash").to_dict()
    assert flash.pop("TPU")["ATTENTION"] == "flash"
    assert {k: v for k, v in want.to_dict().items() if k != "TPU"} == flash
    throughput = get_cfg_default()
    throughput.merge_from_file(str(REPO / "configs/Survival/UMEML_GAN_THROUGHPUT.yaml"))
    assert smoke.SERVE_BATCH == throughput.DATALOADER.TEST.BATCH_SIZE
