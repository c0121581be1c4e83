"""Tensor parallelism of the port's CLIP towers (``imp_torch/parallel/tensor.py``)
against ``imp_tpu/parallel/tensor.py`` on the CPU.

A tiny ViT (32 px, patch 16, width 64, 2 layers, 4 heads, as
``tests/test_tensor_parallel.py``) and a tiny text tower (width 32, 4 heads,
2 layers, context 12) from a JAX init, carried over by
``imp_torch.convert.clip_state_dict``.  One local group of four gloo ranks
(``imp_torch.parallel.launch.spawn``, one CPU thread each, a 60 s wall
limit after which every rank is killed and the fixture fails) runs
``tests/test_torch_parallel_ranks.py::tower_rank`` at (dp, tp) = (1, 2)
(two meshes of two ranks), (2, 2) and (1, 4); the parent holds each
result against JAX's ``make_tp_encode``/``make_tp_encode_text`` on its
8-device CPU mesh and against JAX's single-device tower, at JAX's own
2e-5.  Also: the port's splits equal JAX's leaf by leaf, bit for bit; a
split run at tp = 1 gives the unsplit port tower's features; heads that
tp does not divide raise JAX's error; a rank holds 1/tp of the block
weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh as JaxMesh

import imp_tpu.parallel.tensor as JT
from imp_tpu.models.clip import TextTransformer as JaxText
from imp_tpu.models.clip import VisionTransformer as JaxViT
from imp_torch.convert import clip_state_dict
from imp_torch.models.clip import TextTransformer, VisionTransformer
from imp_torch.parallel import make_mesh
from imp_torch.parallel.collectives import Axis
from imp_torch.parallel.launch import spawn
from imp_torch.parallel.mesh import Mesh
from imp_torch.parallel.tensor import (make_tp_encode, make_tp_encode_text, put_tp_params,
                                       split_text_params_tp, split_vision_params_tp)

import test_torch_parallel_ranks as ranks

TOL = 2e-5  # JAX's own tolerance for its tp towers
VIT = dict(input_resolution=32, patch_size=16, width=64, layers=2, heads=4, output_dim=32)
TXT = dict(context_length=12, vocab_size=64, width=32, heads=4, layers=2, embed_dim=16)
MESHES = ((1, 2), (2, 2), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _jax_mesh(dp, tp):
    return JaxMesh(np.asarray(jax.devices()[: dp * tp]).reshape(dp, tp), ("data", "model"))


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """JAX's towers, their parameters, inputs and JAX's outputs (single
    device and at every tp mesh), and the ranks' results."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 64, size=(4, 12)).astype(np.int32)
    jvit, jtxt = JaxViT(**VIT), JaxText(**TXT)
    vparams = jax.jit(jvit.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    tparams = jax.jit(jtxt.init)(jax.random.PRNGKey(1), jnp.asarray(tokens[:1]))
    want = {"vit": np.asarray(jax.jit(jvit.apply)(vparams, images)),
            "text": np.asarray(jax.jit(jtxt.apply)(tparams, tokens))}
    for dp, tp in MESHES:
        mesh = _jax_mesh(dp, tp)
        split = JT.put_tp_params(JT.split_vision_params_tp(vparams, tp), mesh)
        want[("vit", dp, tp)] = np.asarray(JT.make_tp_encode(jvit, mesh)(split, images))
        split = JT.put_tp_params(JT.split_text_params_tp(tparams, tp), mesh)
        want[("text", dp, tp)] = np.asarray(JT.make_tp_encode_text(jtxt, mesh)(split, tokens))
    case = {"vit_kwargs": VIT, "txt_kwargs": TXT, "images": torch.from_numpy(images),
            "tokens": torch.from_numpy(tokens).long(), "tp": MESHES,
            "vit_state": clip_state_dict(_flat(vparams)),
            "txt_state": clip_state_dict(_flat(tparams))}
    path = str(tmp_path_factory.mktemp("tp") / "case.pt")
    torch.save(case, path)
    got = spawn(ranks.tower_rank, 4, (path,), timeout=60)
    return case, (vparams, tparams), want, got


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("tower", ["vit", "text"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_tp_tower_matches_jax_tp_and_single_device(towers, tower, dp, tp):
    _, _, want, got = towers
    for rank in range(4):  # every rank holds the whole batch's features
        out = got[rank][(tower, dp, tp)]
        assert out.shape == want[tower].shape
        _close(out, want[(tower, dp, tp)], f"rank {rank} vs JAX tp")
        _close(out, want[tower], f"rank {rank} vs JAX single device")


@pytest.mark.parametrize("tower", ["vit", "text"])
@pytest.mark.parametrize("tp", [2, 4])
def test_splits_equal_jax_bit_for_bit(towers, tower, tp):
    case, (vparams, tparams), _, _ = towers
    state, jparams = ((case["vit_state"], vparams) if tower == "vit"
                      else (case["txt_state"], tparams))
    ours = split_vision_params_tp(state, tp)
    theirs = JT.split_vision_params_tp(jparams, tp)
    assert set(ours["shard"]) == {k.replace("_", ".") for k in theirs["shard"]}
    for key, leaves in theirs["shard"].items():
        for leaf, value in leaves.items():
            got = ours["shard"][key.replace("_", ".")][leaf].numpy()
            assert got.shape == value.shape and np.array_equal(got, value), (key, leaf)
    # the replicated side: every entry outside the shards, under the port's names
    rep = _flat(theirs["rep"])
    blocks = {k.split("/")[0] for k in rep if k.startswith("resblocks_")}
    for key in blocks:
        name = key.replace("_", ".")
        assert np.array_equal(ours["rep"][name + ".out_bias"].numpy(), rep[key + "/out_bias"])
        assert np.array_equal(ours["rep"][name + ".proj_bias"].numpy(), rep[key + "/proj_bias"])
        for ln in ("ln_1", "ln_2"):
            assert np.array_equal(ours["rep"][f"{name}.{ln}.weight"].numpy(),
                                  rep[f"{key}/{ln}/scale"])
            assert np.array_equal(ours["rep"][f"{name}.{ln}.bias"].numpy(),
                                  rep[f"{key}/{ln}/bias"])
    # outside the blocks: the port's own entries, as many as JAX's leaves
    outside = {k: v for k, v in state.items() if not k.startswith("resblocks.")}
    assert len(outside) == len([k for k in rep if not k.startswith("resblocks_")])
    assert set(ours["rep"]) == set(outside) | {
        f"{k.replace('_', '.')}.{leaf}" for k in blocks
        for leaf in ("out_bias", "proj_bias", "ln_1.weight", "ln_1.bias", "ln_2.weight",
                     "ln_2.bias")}
    for k, v in outside.items():
        assert torch.equal(ours["rep"][k], v), k


def test_a_rank_holds_one_tpth_of_the_block_weights(towers):
    case, _, _, got = towers
    split = ("attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
             "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight")
    whole = sum(v.numel() * v.element_size() for k, v in case["vit_state"].items()
                if k.endswith(split))
    for dp, tp in MESHES:
        for rank in range(4):
            assert got[rank][("vit_bytes", dp, tp)] * tp == whole


@pytest.mark.parametrize("tower", ["vit", "text"])
def test_a_split_run_at_tp_1_gives_the_unsplit_tower(towers, tower):
    case, _, _, _ = towers
    mesh = make_mesh(("data", "model"), (1, 1), "cpu")
    if tower == "vit":
        module, state, x = VisionTransformer(**VIT), case["vit_state"], case["images"]
        encode = make_tp_encode(module, mesh)
        params = put_tp_params(split_vision_params_tp(state, 1), mesh)
    else:
        module, state, x = TextTransformer(**TXT), case["txt_state"], case["tokens"]
        encode = make_tp_encode_text(module, mesh)
        params = put_tp_params(split_text_params_tp(state, 1), mesh)
    module.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = module(x)
    torch.testing.assert_close(encode(params, x), want, rtol=1e-5, atol=1e-6)


def test_heads_not_divisible_by_tp_raise():
    vit = VisionTransformer(input_resolution=32, patch_size=16, width=60, layers=1, heads=3,
                            output_dim=16)
    split = split_vision_params_tp(vit.state_dict(), 2)  # 60 columns split, 3 heads do not
    model = Axis("model", 2, 0, None, [0, 1])
    mesh = Mesh({"data": 1, "seq": 1, "model": 2, "pipe": 1}, Axis("data"), Axis("seq"), model,
                Axis("pipe"), Axis("world", 2, 0, None, [0, 1]), torch.device("cpu"))
    params = {"rep": split["rep"], "shard": {k: {n: v[0] for n, v in blk.items()}
                                             for k, blk in split["shard"].items()}}
    with pytest.raises(ValueError, match="3 attention heads not divisible by model-axis size 2"):
        make_tp_encode(vit, mesh)(params, torch.zeros(2, 32, 32, 3))
