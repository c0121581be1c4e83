"""More of the UMEML_GAN family in the PyTorch port against ``imp_tpu`` on
the CPU (sizes, weights and helpers of ``tests/test_torch_umeml_variants.py``):

* ``bag_dtype=torch.bfloat16`` (JAX's ``BAG_DTYPE``): the train forward's
  outputs and the gradients of a scalar of them within 2e-2 (relative L2)
  of JAX's ``BAG_DTYPE=bfloat16`` run, or no farther from JAX's float32 run
  than twice JAX's own bf16 distance;
* ``MODEL.INIT_WEIGHTS``: a partial load across a head-width change
  against JAX's ``load_pretrained_params`` merge, and a trainer built from
  another's checkpoint gives its eval logits bit for bit;
* ``umeml_gan_plot``: the bottleneck's pre-pairing similarity grids equal
  JAX's sown ``similarity``, and MBTRAIN writes ``plots/sim_<patient>.png``
  and the importance PNGs where matplotlib is installed.
"""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from imp_tpu.utils.checkpoint import load_pretrained_params as jax_load_pretrained
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.engine.trainer import device_batch
from imp_torch.models import build_model
from imp_torch.models.layers import sow_similarity
from imp_torch.utils.checkpoint import load_pretrained_params, save_checkpoint

import test_torch_train as T
from test_torch_precision import check_bf16
from test_torch_umeml_variants import (
    OUT_KEYS, TOL, _jax_init, _jax_model, _jax_train, _port_model, _port_train,
    jax_flags, jax_zero_dropout, one_torch_thread,
)

__all__ = ["jax_zero_dropout", "one_torch_thread"]  # fixtures of this file


def test_bag_only_bf16_matches_jax(jax_zero_dropout):
    model = _jax_model()
    params = _jax_init(model)
    with jax_flags(BAG_DTYPE=jnp.bfloat16):
        want16, g16 = _jax_train(model, params)
    want32, g32 = _jax_train(model, params)
    port = _port_model(umeml_gan_state_dict(T._flat(params)), bag_dtype=torch.bfloat16)
    seen = {}
    hook = port.proto_g_blocks[0].register_forward_pre_hook(  # returns None: inputs pass
        lambda _m, args: seen.update(bag=args[0]))
    got, got_g = _port_train(port)
    hook.remove()
    assert seen["bag"].dtype == torch.bfloat16  # the bag activations
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert got["h_path"].dtype == np.float32
    for k in OUT_KEYS:
        check_bf16(k, got[k], want16[k], want32[k], computed_in_bf16=k == "logits")
    for k, g in got_g.items():
        check_bf16(f"gradient {k}", g, g16[k], g32[k])


def test_init_weights_partial_load_matches_jax_merge(tmp_path):
    """A 4-class checkpoint into a 6-class model: every tensor but the
    head's widths loads; the classifier and the explainers keep the fresh
    init (JAX's shape-checked, non-strict merge)."""
    src = _jax_init(_jax_model(4))
    fresh = _jax_init(_jax_model(6))
    path = tmp_path / "jax.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"params": jax.tree_util.tree_map(
        np.asarray, src["params"])}))
    merged = jax_load_pretrained(str(path), jax.tree_util.tree_map(np.asarray, fresh))

    port_dir = str(tmp_path / "port")
    save_checkpoint({"model": umeml_gan_state_dict(T._flat(src)), "epoch": 1}, port_dir, 1)
    model = build_model("umeml_gan", cfg=T._cfg(get_cfg_default), num_classes=6,
                        gene_group_indexes=T.GROUPS, device="cpu")
    model.load_state_dict(umeml_gan_state_dict(T._flat(fresh)), strict=True)
    load_pretrained_params(port_dir, model)  # the directory with its pointer
    want = umeml_gan_state_dict(T._flat(merged))
    got = model.state_dict()
    kept = [k for k in want if not torch.equal(want[k], umeml_gan_state_dict(T._flat(src)).get(
        k, torch.empty(0)))]
    assert sorted(kept) == ["classifier.bias", "classifier.weight", "explainer_omic.weight",
                            "explainer_path.weight"]
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _tree(tmp_path):
    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=8, bag_max=T.BAG, feat_dim=T.FEAT,
                          num_genes=T.GENES, group_size=10, seed=0)
    return root


def test_init_weights_through_the_trainer_gives_the_same_eval_logits(tmp_path):
    root = _tree(tmp_path)
    cfg = T._cfg(get_cfg_default, root, str(tmp_path / "a"))
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.freeze()
    first = build_trainer(cfg, device="cpu")
    first.train()
    cfg2 = cfg.clone()
    cfg2.defrost()
    cfg2.OUTPUT_DIR = str(tmp_path / "b")
    cfg2.MODEL.INIT_WEIGHTS = osp.join(cfg.OUTPUT_DIR, "model")
    cfg2.SEED = 7  # another fresh init: every parameter must come from the file
    cfg2.freeze()
    second = build_trainer(cfg2, device="cpu")
    batch = next(iter(first.test_loader))
    with torch.no_grad():
        a = first.model(first._device_batch(batch))["logits"]
        b = second.model(second._device_batch(batch))["logits"]
    assert torch.equal(a, b)


def test_plot_variant_grids_match_jax_and_pngs_are_written(jax_zero_dropout, tmp_path):
    model = _jax_model()
    params = _jax_init(model)
    batch = T._batch()
    _, inter = model.apply(params, T._jnp(batch), train=False, mutable=["intermediates"])
    sims = [v for path, v in jax.tree_util.tree_leaves_with_path(inter)
            if any(getattr(k, "key", None) == "similarity" for k in path)]
    want = np.asarray(sims[0])[: T.BATCH]  # the plain pass of the fused head
    port = _port_model(umeml_gan_state_dict(T._flat(params)))
    with torch.no_grad(), sow_similarity(port.bottleattn) as sown:
        port(device_batch(batch, "cpu"))
    assert len(sown) == 1 and sown[0].shape == (2 * T.BATCH, 7, 7)
    np.testing.assert_allclose(sown[0][: T.BATCH].numpy(), want, rtol=TOL, atol=TOL)
    assert port.bottleattn.sown is None  # recording ends with the block

    pytest.importorskip("matplotlib")
    root = _tree(tmp_path)
    cfg = T._cfg(get_cfg_default, root, str(tmp_path / "out"))
    cfg.MODEL.NAME = "umeml_gan_plot"
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.is_gan
    trainer.train()
    grids = trainer.similarity_grids(next(iter(trainer.test_loader)))
    assert grids.shape[1:] == (7, 7) and torch.isfinite(grids).all()
    plots = os.listdir(osp.join(cfg.OUTPUT_DIR, "plots"))
    pids = {pid for b in trainer.test_loader for pid in b["patient_id"]}
    assert {f"sim_{pid}.png" for pid in pids} <= set(plots)
    assert osp.isfile(osp.join(cfg.OUTPUT_DIR, "train_path.png"))
