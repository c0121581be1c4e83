"""Pipeline parallelism of the port's ViT tower (``imp_torch/parallel/pipeline.py``)
against ``imp_tpu/parallel/pipeline.py`` on the CPU.

The tiny ViT of ``tests/test_pipeline_parallel.py`` (32 px, patch 16, width
64, 4 heads) at 4 layers, from a JAX init carried over by
``imp_torch.convert.clip_state_dict``.  One local group of four gloo ranks
(``imp_torch.parallel.launch.spawn``, one CPU thread each, a 60 s wall
limit after which every rank is killed and the fixture fails) runs
``tests/test_torch_parallel_ranks.py::tower_rank`` at (dp, pp, mb) =
(1, 2, 2) (two meshes of two ranks), (1, 4, 4) and (2, 2, 2); the parent
holds each result against JAX's ``make_pp_encode`` on its 8-device CPU
mesh and against JAX's single-device tower, at JAX's 2e-5.  Also: the
port's split equals JAX's leaf by leaf, bit for bit; a split run at pp = 1
gives the unsplit port tower's features exactly (the same block code);
3 layers at pp = 2 raise JAX's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh as JaxMesh

import imp_tpu.parallel.pipeline as JP
from imp_tpu.models.clip import VisionTransformer as JaxViT
from imp_torch.convert import _torch_key, clip_state_dict
from imp_torch.models.clip import VisionTransformer
from imp_torch.parallel import make_mesh
from imp_torch.parallel.launch import spawn
from imp_torch.parallel.pipeline import make_pp_encode, put_pp_params, split_vision_params_pp

import test_torch_parallel_ranks as ranks

TOL = 2e-5  # JAX's own tolerance for its pp tower
VIT = dict(input_resolution=32, patch_size=16, width=64, layers=4, heads=4, output_dim=32)
MESHES = ((1, 2, 2), (1, 4, 4), (2, 2, 2))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    jvit = JaxViT(**VIT)
    params = jax.jit(jvit.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    want = {"single": np.asarray(jax.jit(jvit.apply)(params, images))}
    for dp, pp, mb in MESHES:
        mesh = JaxMesh(np.asarray(jax.devices()[: dp * pp]).reshape(dp, pp), ("data", "pipe"))
        split = JP.put_pp_params(JP.split_vision_params_pp(params, pp), mesh)
        want[(dp, pp, mb)] = np.asarray(JP.make_pp_encode(jvit, mesh, mb)(split, images))
    case = {"vit_kwargs": VIT, "txt_kwargs": dict(width=8, heads=2, layers=1, vocab_size=8,
                                                  context_length=4, embed_dim=4),
            "images": torch.from_numpy(images), "pp": MESHES,
            "vit_state": clip_state_dict(_flat(params))}
    path = str(tmp_path_factory.mktemp("pp") / "case.pt")
    torch.save(case, path)
    got = spawn(ranks.tower_rank, 4, (path,), timeout=60)
    return case, params, want, got


@pytest.mark.parametrize("dp,pp,mb", MESHES)
def test_pp_tower_matches_jax_pp_and_single_device(tower, dp, pp, mb):
    _, _, want, got = tower
    for rank in range(4):  # every stage holds the whole batch's features
        out = got[rank][("pp", dp, pp, mb)]
        assert out.shape == want["single"].shape
        for ref, what in ((want[(dp, pp, mb)], "JAX pp"), (want["single"], "JAX single device")):
            np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {rank} vs {what}")


@pytest.mark.parametrize("pp", [2, 4])
def test_split_equals_jax_bit_for_bit(tower, pp):
    case, params, _, _ = tower
    ours = split_vision_params_pp(case["vit_state"], pp)
    theirs = JP.split_vision_params_pp(params, pp)
    stages = _flat(theirs["stages"])
    assert len(stages) == len(ours["stages"])
    for key, value in stages.items():
        name, transpose = _torch_key("params/" + key)
        got = ours["stages"][name]
        if transpose:  # a Dense kernel: the port keeps its transpose
            got = got.transpose(-1, -2)
        assert got.shape == value.shape and np.array_equal(got.numpy(), value), key
    outside = {k: v for k, v in case["vit_state"].items() if not k.startswith("resblocks.")}
    assert set(ours["rep"]) == set(outside)
    assert len(outside) == len(_flat(theirs["rep"]))
    for k, v in outside.items():
        assert torch.equal(ours["rep"][k], v), k


def test_a_split_run_at_pp_1_gives_the_unsplit_tower(tower):
    case, _, _, _ = tower
    module = VisionTransformer(**VIT)
    module.load_state_dict(case["vit_state"], strict=True)
    mesh = make_mesh(("data", "pipe"), (1, 1), "cpu")
    got = make_pp_encode(module, mesh, 2)(put_pp_params(split_vision_params_pp(
        case["vit_state"], 1), mesh), case["images"])
    with torch.no_grad():
        assert torch.equal(got, module(case["images"]))


def test_layers_not_divisible_by_pp_raise():
    vit = VisionTransformer(**dict(VIT, layers=3))
    with pytest.raises(ValueError, match="3 blocks not divisible into 2 pipeline stages"):
        split_vision_params_pp(vit.state_dict(), 2)
