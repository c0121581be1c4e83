"""PLIP prototypes in the PyTorch port (``imp_torch.tools.extract_prototypes``
and ``MODEL.UMEML.PROTO_INIT=plip``) against ``imp_tpu`` on the CPU.

* the linear autoencoder (512 -> 256 -> 512, MSE, Adam at 1e-4, batch 8)
  over 3 epochs of 33 seeded embeddings from the JAX tool's own init (its
  ``train_autoencoder`` at 0 epochs), the same batch order: every parameter
  to rtol 1e-5 / atol 1e-6 (float32, another summation order), and the
  per-category mean codes likewise;
* the CLI on ``prompts/prompt.json`` (6 categories, 33 prompts) writes
  ``[1, 6, 256]`` float32 prototypes;
* ``PROTO_INIT=plip`` loads the cached ``.npy`` into UMEML_GAN's
  prototypes in both packages, from ``OUTPUT_DIR`` or else
  ``DATASET.ROOT``, exactly; without a cache both warn and draw the uniform
  init; a cache of another shape is refused; UMEML, whose JAX factory
  reads no ``PROTO_INIT``, keeps its uniform prototypes.
"""

import importlib.util
import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.models import build_model as jax_build_model
from imp_torch.config import get_cfg_default
from imp_torch.models import build_model
from imp_torch.tools import extract_prototypes

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PROMPTS = osp.join(REPO, "prompts", "prompt.json")
HIDDEN, N_PROTO = 64, 6
GROUPS = [list(range(i * 10, (i + 1) * 10)) for i in range(N_PROTO)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_prototypes", osp.join(REPO, "tools", "extract_prototypes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _embeddings(seed=0):
    with open(PROMPTS) as f:
        counts = [len(v) for v in json.load(f).values()]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(sum(counts), 512)).astype(np.float32), counts


def test_autoencoder_matches_jax_from_its_init():
    tool = _jax_tool()
    emb, counts = _embeddings()
    init = jax.tree_util.tree_map(np.asarray, tool.train_autoencoder(emb, num_epochs=0))
    want = tool.train_autoencoder(emb, num_epochs=3)
    got = extract_prototypes.train_autoencoder(emb, num_epochs=3, params=init, device="cpu")
    for k in ("enc_w", "enc_b", "dec_w", "dec_b"):
        assert not np.array_equal(np.asarray(want[k]), init[k]), k  # it trained
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the prototypes: each category's mean code, as the JAX tool's main forms them
    z = emb @ np.asarray(want["enc_w"]) + np.asarray(want["enc_b"])
    starts = np.cumsum([0, *counts])
    np.testing.assert_allclose(
        extract_prototypes.category_prototypes(emb, counts, got)[0],
        np.stack([z[a:b].mean(0) for a, b in zip(starts[:-1], starts[1:])]), rtol=1e-5, atol=1e-6)


def test_cli_writes_one_prototype_per_category(tmp_path):
    emb, counts = _embeddings(1)
    np.save(tmp_path / "emb.npy", emb)
    out = str(tmp_path / "prototypes_plip.npy")
    protos = extract_prototypes.main(["--prompts", PROMPTS, "--embeddings",
                                      str(tmp_path / "emb.npy"), "--out", out, "--device", "cpu"])
    saved = np.load(out)
    assert saved.shape == (1, len(counts), 256) and saved.dtype == np.float32
    assert np.array_equal(saved, protos) and np.isfinite(saved).all()
    np.save(tmp_path / "short.npy", emb[:-1])
    with pytest.raises(SystemExit, match="32 embedding rows for 33 prompts"):
        extract_prototypes.main(["--prompts", PROMPTS, "--embeddings",
                                 str(tmp_path / "short.npy"), "--out", out, "--device", "cpu"])


def _cfg(get_default, tmp_path, name="umeml_gan"):
    cfg = get_default()
    cfg.MODEL.NAME, cfg.MODEL.HIDDEN_DIM, cfg.MODEL.FUSION = name, HIDDEN, "concat"
    cfg.MODEL.UMEML.PROTOTYPES, cfg.MODEL.UMEML.PROTO_INIT = N_PROTO, "plip"
    cfg.DATASET.PATH.DIM = 32
    cfg.OUTPUT_DIR, cfg.DATASET.ROOT = str(tmp_path / "out"), str(tmp_path / "root")
    return cfg


def _jax_prototypes(cfg):
    model = jax_build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS)
    variables = model.init(jax.random.PRNGKey(0), method=lambda m: m.p_proto)
    return np.asarray(variables["params"]["p_proto"])


def _port_prototypes(cfg, name="umeml_gan"):
    kwargs = {"gene_group_indexes": GROUPS} if name == "umeml_gan" else {"omic_dim": 60}
    model = build_model(name, cfg=cfg, num_classes=4, device="cpu", **kwargs)
    return model.p_proto.detach().numpy()


@pytest.mark.parametrize("where", ["OUTPUT_DIR", "DATASET.ROOT"])
def test_plip_init_loads_the_cache_in_both_packages(tmp_path, where):
    arr = np.random.default_rng(2).normal(size=(1, N_PROTO, HIDDEN)).astype(np.float32)
    for d in ("out", "root"):
        (tmp_path / d).mkdir()
    np.save(tmp_path / ("out" if where == "OUTPUT_DIR" else "root") / "prototypes_plip.npy", arr)
    assert np.array_equal(_jax_prototypes(_cfg(jax_cfg_default, tmp_path)), arr)
    assert np.array_equal(_port_prototypes(_cfg(get_cfg_default, tmp_path)), arr)
    # UMEML's factory reads no PROTO_INIT (as in JAX): its prototypes stay uniform
    umeml = _port_prototypes(_cfg(get_cfg_default, tmp_path, "umeml"), "umeml")
    assert not np.array_equal(umeml, arr) and np.abs(umeml).max() <= 1.0 / N_PROTO


def test_plip_init_without_a_cache_warns_and_draws_uniform(tmp_path):
    with pytest.warns(UserWarning, match="no cached prototypes"):
        _jax_prototypes(_cfg(jax_cfg_default, tmp_path))
    with pytest.warns(UserWarning, match="no cached prototypes"):
        got = _port_prototypes(_cfg(get_cfg_default, tmp_path))
    cfg = _cfg(get_cfg_default, tmp_path)
    cfg.MODEL.UMEML.PROTO_INIT = "uniform"
    assert np.array_equal(got, _port_prototypes(cfg))  # the same draw as the default init


def test_plip_cache_of_another_shape_is_refused(tmp_path):
    (tmp_path / "out").mkdir()
    np.save(tmp_path / "out" / "prototypes_plip.npy", np.zeros((1, N_PROTO, 32), np.float32))
    with pytest.raises(ValueError, match=r"\(1, 6, 32\)"):
        _port_prototypes(_cfg(get_cfg_default, tmp_path))
    with pytest.raises(AssertionError):
        _jax_prototypes(_cfg(jax_cfg_default, tmp_path))
