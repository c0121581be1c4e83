"""The CLIP towers of the PyTorch port (``imp_torch.models.clip``), their
weight conversions, the tokenizer and the feature-extraction tool, against
``imp_tpu`` on the CPU.

Weights come from a JAX ``init`` (through ``imp_torch.convert.clip_state_dict``)
or from one random OpenAI-layout ``state_dict`` read by both packages'
``convert_torch_clip_state``; inputs come from a numpy seed.  Small sizes:

* the ViT at patch 8, resolution 32, width 64, 2 layers, 4 heads;
* the text tower at width 64, 2 layers, 4 heads, context 16, vocabulary
  100, with the EOT token at another position in each row, and its blocks
  with and without the causal mask;
* ``ModifiedResNet`` at layers (1, 1, 1, 1), width 16, resolution 64, with
  random ``batch_stats``, and ``AttentionPool2d`` alone.

Tolerances: the towers' outputs to rtol 1e-5 / atol 1e-5 (float32 on both
sides, another summation order; observed ~1e-6); the conversions exactly
(both are copies and transposes), and a checkpoint file loads as a state
dict or as a TorchScript archive.  The tokenizer runs on a synthetic
gzipped merges file: ``encode``, ``decode`` and ``tokenize`` (truncation
at the context length included) give the same ids and text as JAX's.
``imp_torch.tools.clip_feature``: ``preprocess`` and ``device_normalize``
against ``tools/clip_feature.py``'s (exactly; 1e-6), the encode loop with a
padded last batch, and the CLI end to end on a tiny tower.
"""

import gzip
import importlib.util
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import imp_tpu.models.clip as J
from imp_tpu.models import tokenizer as jtok
from imp_torch.convert import (_torch_key, clip_state_dict, convert_torch_clip_state,
                               load_torch_checkpoint)
from imp_torch.models import clip as P
from imp_torch.models import tokenizer as ptok
from imp_torch.tools import clip_feature

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = 1e-5
#: a small CLIP in both packages' config tables (the JAX package's own
#: parity test adds one the same way)
TEST_CFG = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=8, context_length=16, vocab_size=100,
    transformer_width=64, transformer_heads=4, transformer_layers=2,
)
RN_TEST_CFG = dict(TEST_CFG, embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1),
                   vision_width=16, vision_patch_size=None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def test_configs(monkeypatch):
    for table in (J.CLIP_CONFIGS, P.CLIP_CONFIGS):
        monkeypatch.setitem(table, "test", TEST_CFG)
        monkeypatch.setitem(table, "test-rn", RN_TEST_CFG)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _port(module, variables):
    module.load_state_dict(clip_state_dict(_flat(variables)), strict=True)
    return module.eval()


def _load(module, variables):
    """A JAX block's variables into a port block, by the converter's key rule."""
    state = {}
    for key, value in _flat(variables).items():
        tkey, transpose = _torch_key(key)
        state[tkey] = torch.from_numpy(np.array(value.T if transpose else value))
    module.load_state_dict(state, strict=True)
    return module


def _random_batch_stats(variables, rng):
    """JAX variables with random running means and variances."""
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    stats = {k: (0.1 * rng.normal(size=v.shape) if k[-1] == "mean"
                 else rng.uniform(0.5, 2.0, size=v.shape)).astype(np.float32)
             for k, v in flatten_dict(variables["batch_stats"]).items()}
    return {**variables, "batch_stats": unflatten_dict(stats)}


def test_available_models_are_the_jax_packages():
    assert P.available_models() == J.available_models()
    assert P.CLIP_CONFIGS == J.CLIP_CONFIGS


def test_vit_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    jv = J.VisionTransformer(input_resolution=32, patch_size=8, width=64, layers=2, heads=4,
                             output_dim=32)
    variables = jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.asarray(img))
    want = jax.jit(jv.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = _port(P.VisionTransformer(32, 8, 64, 2, 4, 32), variables)(torch.from_numpy(img))
    _close(got, want)


def test_text_tower_pools_at_each_rows_eot_as_jax_does():
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 90, size=(4, 16))
    tokens[np.arange(4), [5, 15, 9, 2]] = 99  # EOT = the highest id, at 4 positions
    jt = J.TextTransformer(context_length=16, vocab_size=100, width=64, heads=4, layers=2,
                           embed_dim=32)
    variables = jt.init(jax.random.PRNGKey(1), jnp.asarray(tokens, jnp.int32))
    want = jt.apply(variables, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = _port(P.TextTransformer(16, 100, 64, 4, 2, 32), variables)(torch.from_numpy(tokens))
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_with_and_without_the_causal_mask(causal):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    jb = J.ResidualAttentionBlock(64, 4, causal_mask=causal)
    variables = jb.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jb.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _load(P.ResidualAttentionBlock(64, 4, causal=causal), variables)(torch.from_numpy(x))
    _close(got, want)
    # the causal mask changes every row but the last
    other = J.ResidualAttentionBlock(64, 4, causal_mask=not causal).apply(variables, jnp.asarray(x))
    assert np.abs(np.asarray(other) - np.asarray(want))[:, :-1].max() > 1e-3


def test_modified_resnet_with_batch_stats_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jr = J.ModifiedResNet(layers=(1, 1, 1, 1), output_dim=32, heads=8, input_resolution=64,
                          width=16)
    variables = _random_batch_stats(jax.jit(jr.init)(jax.random.PRNGKey(3), jnp.asarray(img)), rng)
    want = jax.jit(jr.apply)(variables, jnp.asarray(img))
    port = _port(P.ModifiedResNet((1, 1, 1, 1), 32, 8, 64, 16), variables)
    assert torch.equal(port.layer2[0].bn1.running_var,
                       torch.from_numpy(variables["batch_stats"]["layer2_0"]["bn1"]["var"]))
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    _close(got, want)


def test_attention_pool_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 3, 64)).astype(np.float32)
    jp = J.AttentionPool2d(embed_dim=64, num_heads=4, output_dim=24)
    variables = jp.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = jp.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        _close(_load(P.AttentionPool2d(9, 64, 4, 24), variables)(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# the OpenAI state_dict, read by both packages
# ---------------------------------------------------------------------------


def _block_state(rng, prefix, w):
    r = lambda *s: torch.from_numpy(0.05 * rng.normal(size=s).astype(np.float32))  # noqa: E731
    return {
        prefix + "ln_1.weight": 1 + r(w), prefix + "ln_1.bias": r(w),
        prefix + "attn.in_proj_weight": r(3 * w, w), prefix + "attn.in_proj_bias": r(3 * w),
        prefix + "attn.out_proj.weight": r(w, w), prefix + "attn.out_proj.bias": r(w),
        prefix + "ln_2.weight": 1 + r(w), prefix + "ln_2.bias": r(w),
        prefix + "mlp.c_fc.weight": r(4 * w, w), prefix + "mlp.c_fc.bias": r(4 * w),
        prefix + "mlp.c_proj.weight": r(w, 4 * w), prefix + "mlp.c_proj.bias": r(w),
    }


def openai_state(rng, vision: str):
    """A random OpenAI CLIP ``state_dict`` at TEST_CFG's text widths with a
    ViT (``vision="vit"``) or a ModifiedResNet (``"rn"``) image tower, the
    names and layouts of ``clip/model.py`` (``logit_scale`` included, which
    neither converter reads).  The ResNet's names are the port's own with
    the OpenAI ``visual.`` prefix and ``downsample.0`` / ``downsample.1``;
    the JAX converter, which reads OpenAI names on its own, is the check."""
    r = lambda *s: torch.from_numpy(0.05 * rng.normal(size=s).astype(np.float32))  # noqa: E731
    c = TEST_CFG
    tw = c["transformer_width"]
    state = {"logit_scale": torch.tensor(4.6), "token_embedding.weight": r(c["vocab_size"], tw),
             "positional_embedding": r(c["context_length"], tw),
             "text_projection": r(tw, c["embed_dim"]), "ln_final.weight": 1 + r(tw),
             "ln_final.bias": r(tw)}
    for i in range(c["transformer_layers"]):
        state.update(_block_state(rng, f"transformer.resblocks.{i}.", tw))
    if vision == "vit":
        w, p = c["vision_width"], c["vision_patch_size"]
        grid = c["image_resolution"] // p
        state.update({"visual.conv1.weight": r(w, 3, p, p), "visual.class_embedding": r(w),
                      "visual.positional_embedding": r(grid * grid + 1, w),
                      "visual.proj": r(w, c["embed_dim"]), "visual.ln_pre.weight": 1 + r(w),
                      "visual.ln_pre.bias": r(w), "visual.ln_post.weight": 1 + r(w),
                      "visual.ln_post.bias": r(w)})
        for i in range(c["vision_layers"]):
            state.update(_block_state(rng, f"visual.transformer.resblocks.{i}.", w))
        return state
    tower = P.build_vision_tower("test-rn")
    for key, value in tower.state_dict().items():
        name = "visual." + key.replace("downsample_conv.", "downsample.0.").replace(
            "downsample_bn.", "downsample.1.")
        if key.endswith("running_var"):
            var = rng.uniform(0.5, 2.0, size=value.shape).astype(np.float32)
            state[name] = torch.from_numpy(var)
            state[name.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        else:
            state[name] = r(*value.shape)
    return state


@pytest.mark.parametrize("vision", ["vit", "rn"])
def test_openai_state_converts_as_jax_does(test_configs, vision):
    name = "test" if vision == "vit" else "test-rn"
    state = openai_state(np.random.default_rng(5), vision)
    vis, txt = convert_torch_clip_state(state, name)
    jvis, jtxt = J.convert_torch_clip_state(state, name)
    for got, want in ((vis, clip_state_dict(_flat(jvis))), (txt, clip_state_dict(_flat(jtxt)))):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # the converted towers compute what the JAX towers compute on the same weights
    rng = np.random.default_rng(6)
    res = P.CLIP_CONFIGS[name]["image_resolution"]
    img = rng.normal(size=(2, res, res, 3)).astype(np.float32)
    tower = P.build_vision_tower(name)
    tower.load_state_dict(vis, strict=True)
    text = P.build_text_tower(name)
    text.load_state_dict(txt, strict=True)
    tokens = rng.integers(1, 90, size=(2, 16))
    tokens[:, -3] = 99
    with torch.no_grad():
        _close(tower.eval()(torch.from_numpy(img)),
               jax.jit(J.build_vision_tower(name).apply)(jvis, jnp.asarray(img)))
        _close(text(torch.from_numpy(tokens)),
               J.build_text_tower(name).apply(jtxt, jnp.asarray(tokens, jnp.int32)))


def test_checkpoints_load_as_state_dicts_or_torchscript_archives(tmp_path):
    """A saved state dict loads with ``weights_only``; an OpenAI-style
    TorchScript archive, which ``torch.load`` refuses so, through
    ``torch.jit.load``."""
    state = {"token_embedding.weight": torch.ones(4, 2)}
    torch.save(state, tmp_path / "state.pt")
    assert torch.equal(load_torch_checkpoint(str(tmp_path / "state.pt"))["token_embedding.weight"],
                       state["token_embedding.weight"])
    scripted = torch.jit.script(torch.nn.Linear(3, 2))
    scripted.save(str(tmp_path / "archive.pt"))
    got = load_torch_checkpoint(str(tmp_path / "archive.pt"))
    assert set(got) == {"weight", "bias"} and torch.equal(got["weight"], scripted.weight)


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

MERGES = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>", "e r", "o n", "o f</w>",
          "t i", "ti ss", "s s", "u e</w>", "c e", "l l</w>", "m i", "c r", "o g", "ra ph</w>",
          "r a", "p h</w>", "h e</w>", "t u", "tu m", "o r</w>"]


@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "bpe_synthetic.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "\n".join(MERGES) + "\n")
    return str(path)


TEXTS = ["a high-power H&amp;E micrograph of tumor cells.", "The tissue and   the cells",
         "it's 42 mitoses per 10 HPF!", "necrotic   stroma, inflammatory infiltrate",
         "café ñ ü — unicode bytes"]


def test_tokenizer_matches_jax(merges_file):
    port, ref = ptok.SimpleTokenizer(merges_file), jtok.SimpleTokenizer(merges_file)
    assert port.encoder == ref.encoder and port.bpe_ranks == ref.bpe_ranks
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text) and len(ids) > 0
        assert port.decode(ids) == ref.decode(ids)
    for context in (77, 8):  # 8 truncates the longer texts, EOT kept last
        got = ptok.tokenize(TEXTS, port, context_length=context)
        want = jtok.tokenize(TEXTS, ref, context_length=context)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[:, -1] == port.encoder[ptok.EOT]).sum() >= 3
    with pytest.raises(RuntimeError, match="too long"):
        ptok.tokenize(TEXTS[0], port, context_length=8, truncate=False)


# ---------------------------------------------------------------------------
# the feature-extraction tool
# ---------------------------------------------------------------------------


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_clip_feature",
                                                  osp.join(REPO, "tools", "clip_feature.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _patches(root, counts, rng):
    from PIL import Image

    for s, n in enumerate(counts):
        os.makedirs(osp.join(root, f"slide{s}"))
        for i in range(n):
            h, w = rng.integers(20, 48, size=2)
            arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(osp.join(root, f"slide{s}", f"p{i:02d}.png"))


def test_preprocess_and_normalize_match_the_jax_tool(tmp_path):
    tool = _jax_tool()
    _patches(str(tmp_path), [3], np.random.default_rng(7))
    for i in range(3):
        path = str(tmp_path / "slide0" / f"p{i:02d}.png")
        for as_uint8 in (True, False):
            got = clip_feature.preprocess(path, 32, as_uint8)
            want = tool.preprocess(path, 32, as_uint8)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    x = np.random.default_rng(8).integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    _close(clip_feature.device_normalize(torch.from_numpy(x), torch.float32),
           tool.device_normalize(jnp.asarray(x), jnp.float32), 1e-6)


def test_encode_slide_pads_the_last_batch_and_keeps_the_order():
    seen = []

    def encode(x):  # a batch's per-patch pixel sums
        seen.append(x.shape[0])
        return x.reshape(x.shape[0], -1).float().sum(1, keepdim=True)

    rng = np.random.default_rng(9)
    patches = rng.integers(0, 256, size=(7, 4, 4, 3), dtype=np.uint8)
    feats = clip_feature.encode_slide(encode, lambda i: patches[i], list(range(7)), 3, 4, "cpu")
    assert seen == [3, 3, 3] and feats.shape == (7, 1)
    np.testing.assert_array_equal(feats[:, 0], patches.reshape(7, -1).sum(1).astype(np.float32))

    def broken(i):
        if i == 4:
            raise OSError("unreadable patch")
        return patches[i]

    with pytest.raises(OSError, match="unreadable"):
        clip_feature.encode_slide(encode, broken, list(range(7)), 3, 4, "cpu")


def test_cli_writes_each_slide_once_and_matches_the_tower(test_configs, tmp_path, capsys):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    _patches(src, [5, 3], np.random.default_rng(10))
    argv = ["--src", src, "--dst", dst, "--model", "test", "--random-weights",
            "--batch-size", "2", "--key", "feat", "--device", "cpu"]
    clip_feature.main(argv)
    import h5py

    tower, encode = clip_feature.build_encoder("test", "cpu")
    for s, n in enumerate([5, 3]):
        sdir = osp.join(src, f"slide{s}")
        imgs = np.stack([clip_feature.preprocess(osp.join(sdir, f"p{i:02d}.png"), 32, True)
                         for i in range(n)])
        with h5py.File(osp.join(dst, f"slide{s}.h5")) as f:
            got = f["feat"][()]
        np.testing.assert_allclose(got, encode(torch.from_numpy(imgs)).numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert sorted(os.listdir(dst)) == ["slide0.h5", "slide1.h5"]  # no .tmp left behind
    capsys.readouterr()
    clip_feature.main(argv)
    assert capsys.readouterr().out.count("(exists)") == 2
    with pytest.raises(SystemExit, match="does not divide 1 devices"):  # one process
        clip_feature.main(argv + ["--tp", "2"])
    # --prec bf16: the same tower in bf16 stays within a cosine of 0.99
    _, encode16 = clip_feature.build_encoder("test", "cpu", prec="bf16")
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    cos = torch.nn.functional.cosine_similarity(encode16(x), encode(x), dim=1)
    assert encode16(x).dtype == torch.float32 and cos.min() > 0.99
