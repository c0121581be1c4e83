"""UMEML_GAN of the PyTorch port against ``imp_tpu`` on the CPU.

Weights come from a JAX ``init`` and reach the port through
``imp_torch.convert.umeml_gan_state_dict``; inputs come from a numpy seed.
Small widths: hidden 64 (d_head 8, 32 landmarks), 6 prototypes, 60 genes in
6 groups, bags of <= 128 tokens with ragged masks, batch 3, with a
``without_omic`` row and ``insample_without_omic`` entries.

Tolerance 1e-5 on logits and importances under both attention paths: both
sides run float32 with different summation orders (measured ~1e-7).  The
greedy pairing is discrete, so the test first asserts that every greedy
step's best pair leads the runner-up by more than 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.ops.attention as jatt
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.models import build_model as jax_build_model
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_gan_state_dict
from imp_torch.models import build_model, resolve_attention
from imp_torch.models.umeml_gan import UMEML_GAN
from imp_torch.ops.pairing import cosine_similarity_matrix


HIDDEN, N_PROTO, GENES, FEAT, BATCH, BAG = 64, 6, 60, 32, 3, 128
GROUPS = [list(range(i * 10, (i + 1) * 10)) for i in range(N_PROTO)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(get_default, attention):
    cfg = get_default()
    cfg.MODEL.NAME = "umeml_gan"
    cfg.MODEL.HIDDEN_DIM = HIDDEN
    cfg.MODEL.UMEML.PROTOTYPES = N_PROTO
    cfg.MODEL.FUSION = "concat"
    cfg.DATASET.PATH.DIM = FEAT
    cfg.TPU.ATTENTION = attention
    return cfg


def _batch(seed=4):  # a seed whose greedy pairs lead by > 4e-4 (asserted below)
    rng = np.random.default_rng(seed)
    lens = np.array([BAG, 77, 5])
    mask = np.arange(BAG)[None, :] < lens[:, None]
    img = rng.normal(size=(BATCH, BAG, FEAT)).astype(np.float32) * mask[..., None]
    return {
        "img": img,
        "img_mask": mask,
        "mol": rng.lognormal(size=(BATCH, GENES)).astype(np.float32),
        "without_omic": np.array([0, 1, 0], np.float32),
        "insample_without_omic": (rng.random((BATCH, GENES)) < 0.2).astype(np.int32),
        "omic_means": rng.normal(size=(GENES,)).astype(np.float32),
    }


def _init_eval_and_gan(module, batch):
    """Touch every submodule: the eval forward, then the GAN loss (both
    generators, both discriminators) — the full tree ``init_all`` makes,
    without tracing the train-mode modularity loss."""
    out = module(batch, train=False)
    return module.gen_loss(out["h_path"], out["h_omic"])


@pytest.fixture(scope="module")
def flax_params():
    model = jax_build_model("umeml_gan", cfg=_cfg(jax_cfg_default, "auto"),
                            num_classes=4, gene_group_indexes=GROUPS)
    init_batch = {k: (v if k == "omic_means" else v[:1]) for k, v in _batch().items()}
    # rbg keys: the same flax init, at a fraction of threefry's compile time
    rngs = {n: jax.random.key(i, impl="rbg")
            for i, n in enumerate(("params", "dropout", "gan"))}
    params = jax.jit(lambda r, b: model.init(r, b, method=_init_eval_and_gan))(rngs, init_batch)
    return params, {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _jax_eval(params, attention, batch):
    jatt.set_default_attention_impl(attention)  # process-global on the JAX side
    try:
        model = jax_build_model("umeml_gan", cfg=_cfg(jax_cfg_default, attention),
                                num_classes=4, gene_group_indexes=GROUPS)
        out = jax.jit(lambda p, b: model.apply(p, b, train=False))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}
        )
    finally:
        jatt.set_default_attention_impl("nystrom")
    return {k: np.asarray(v) for k, v in out.items()}


def _greedy_gaps(sim: torch.Tensor, k: int) -> float:
    """Smallest lead of a greedy step's best pair over the runner-up."""
    s = sim.clone()
    b, p, o = s.shape
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


@pytest.mark.parametrize("attention", ["nystrom", "flash"])
def test_eval_forward_matches_jax(flax_params, attention):
    params, flat = flax_params
    batch = _batch()
    want = _jax_eval(params, attention, batch)

    model = build_model("umeml_gan", cfg=_cfg(get_cfg_default, attention), num_classes=4,
                        gene_group_indexes=GROUPS, device="cpu")
    assert model.attention == attention
    model.load_state_dict(umeml_gan_state_dict(flat), strict=True)
    seen = {}

    def keep_similarity(_module, args):  # returns None: the inputs pass unchanged
        seen["sim"] = cosine_similarity_matrix(args[0], args[1])

    hook = model.bottleattn.register_forward_pre_hook(keep_similarity)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    hook.remove()
    assert _greedy_gaps(seen["sim"], 3) > 1e-4

    for key in ("logits", "logits_first_pass", "importance_path", "importance_omic",
                "loss_kd", "h_path", "h_omic"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)
    assert got["logits"].shape == (BATCH, 4)
    assert got["importance_path"].shape == (BATCH, N_PROTO)


def test_state_dict_refuses_missing_extra_and_misshapen_keys(flax_params):
    _, flat = flax_params
    sd = umeml_gan_state_dict(flat)
    assert len(sd) == len(flat)
    missing = dict(flat)
    del missing["params/bottleattn/encoders_1/attn/attn/res_conv"]
    with pytest.raises(KeyError, match="lacks the port's parameters"):
        umeml_gan_state_dict(missing)
    extra = dict(flat, **{"params/bottleattn/extra/kernel": np.zeros((4, 4), np.float32)})
    with pytest.raises(KeyError, match="no counterpart"):
        umeml_gan_state_dict(extra)
    bad = dict(flat, **{"params/classifier/kernel": np.zeros((4, HIDDEN), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        umeml_gan_state_dict(bad)


def test_unported_options_raise():
    """The three JAX module globals of the UMEML family now build (their
    numerics: tests/test_torch_umeml_variants.py); unknown options still
    raise."""
    kw = dict(num_classes=4, gene_group_indexes=GROUPS, feat_dim=FEAT, hidden=HIDDEN)
    for opt in ({"head_fused": False}, {"stacked_pairs": True},
                {"bag_dtype": torch.bfloat16}):
        model = UMEML_GAN(**kw, **opt)
        for name, value in opt.items():
            assert getattr(model, name) == value
    stacked = UMEML_GAN(**kw, stacked_pairs=True)
    assert stacked.pair_decoder.layer.attn.to_qkv.weight.shape == (2, 3 * HIDDEN, HIDDEN)
    assert not hasattr(stacked, "path_decoder") and not hasattr(stacked, "explainer_omic")
    # bilinear fusion is ported (tests/test_torch_tasks*.py); others are unknown
    assert hasattr(UMEML_GAN(**kw, fusion="bilinear"), "mm")
    with pytest.raises(ValueError, match="Unknown fusion"):
        UMEML_GAN(**kw, fusion="sum")
    with pytest.raises(ValueError, match="TPU.ATTENTION"):
        resolve_attention("dense")
    assert resolve_attention("auto") == "nystrom"
    model = UMEML_GAN(**kw)
    # training is ported; it needs an explicit generator for its randomness
    with pytest.raises(ValueError, match="torch.Generator"):
        model.encode({}, train=True)


def test_seeded_init_is_reproducible_and_leaves_global_rng_alone():
    cfg = _cfg(get_cfg_default, "auto")
    state = torch.random.get_rng_state()
    a = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS,
                    device="cpu", generator=torch.Generator().manual_seed(7))
    b = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS,
                    device="cpu", generator=torch.Generator().manual_seed(7))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    # GroupedLinear pad rows start at zero (a 9-gene group in a 10-wide grid)
    c = UMEML_GAN(4, [list(range(9))] + GROUPS[1:], FEAT, hidden=HIDDEN)
    c.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(c.omic_net.kernel[0, 9]) == 0


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without a card the default device fails."""
    cfg = _cfg(get_cfg_default, "auto")
    if torch.cuda.is_available():
        model = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=GROUPS)
