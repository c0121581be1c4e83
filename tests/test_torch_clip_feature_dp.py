"""The port's parallel feature-extraction tools on the CPU:
``imp_torch.tools.clip_feature_dp`` (the counterpart of
``tools/clip_feature_dp.py``) and ``imp_torch.tools.clip_feature --tp/--pp``.

PNG slides as in ``tests/test_clip_feature_dp.py`` (5, 2 and one single
patch) on a tiny ViT-B/32 stand-in (32 px, patch 16, width 128: 2 heads, 2 layers);
skipped where PIL or h5py is absent.  One local group of two gloo ranks
(``imp_torch.parallel.launch.spawn``, one CPU thread each, a 60 s wall
limit) runs ``tests/test_torch_parallel_ranks.py::tools_rank``: the dp tool
at a global batch of 3 (rounded up to 4, so the last batch carries padding
rows), run twice (the resume), then the serial tool's CLI at ``--tp 2`` and
at ``--pp 2``.  Each slide's features equal the one-process serial tool's
within 1e-6 (JAX's dp test checks shapes only); the single-patch slide is
skipped, the padding rows are stripped, no ``.tmp`` is left, and rank 0
alone wrote.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from imp_torch.models import clip
from imp_torch.parallel.launch import spawn
from imp_torch.tools import clip_feature

import test_torch_parallel_ranks as ranks

TINY = dict(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=16, context_length=8, vocab_size=100, transformer_width=16,
            transformer_heads=2, transformer_layers=1)
SLIDES = {"s0": 5, "s1": 2, "single": 1}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    pytest.importorskip("PIL")
    pytest.importorskip("h5py")
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for slide, n in SLIDES.items():
        d = root / "tcga_x" / "images" / "train" / slide
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)).save(
                d / f"{i}_{i}.png")
    out = tmp_path_factory.mktemp("feat")
    got = spawn(ranks.tools_rank, 2, (TINY, str(root), str(out)), timeout=60)
    assert got == [0, 1]
    # the serial tool in this process: the reference features
    mp = pytest.MonkeyPatch()
    mp.setitem(clip.CLIP_CONFIGS, "ViT-B/32", TINY)
    try:
        clip_feature.main(["--src", str(root / "tcga_x" / "images" / "train"), "--dst",
                           str(out / "serial"), "--random-weights", "--batch-size", "2",
                           "--key", "clip_feature", "--device", "cpu"])
    finally:
        mp.undo()
    return out


def _read(path):
    import h5py

    with h5py.File(path) as f:
        return f["clip_feature"][()]


@pytest.mark.parametrize("tool", ["dp", "tp", "pp"])
def test_parallel_tool_features_equal_the_serial_tool(extracted, tool):
    base = extracted / "dp" / "clip_vit_b32" / "tcga_x" if tool == "dp" else extracted / tool
    for slide, n in SLIDES.items():
        if tool == "dp" and n <= 1:  # the reference skips single-patch slides
            assert not (base / f"{slide}.h5").exists()
            continue
        got = _read(base / f"{slide}.h5")
        assert got.shape == (n, 16)  # padding rows stripped
        np.testing.assert_allclose(got, _read(extracted / "serial" / f"{slide}.h5"), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{tool} {slide}")
    assert not [f for f in os.listdir(base) if f.endswith(".tmp")]


def test_dp_tool_writes_the_reference_tree_once(extracted):
    base = extracted / "dp" / "clip_vit_b32" / "tcga_x"
    assert sorted(os.listdir(base)) == ["s0.h5", "s1.h5"]
    assert osp.isdir(extracted / "dp" / "clip_vit_b32")
