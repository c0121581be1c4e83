"""The baseline zoo of the PyTorch port (MCAT, CMTA, Porpoise and its
ConCAT / ADD / low-rank fusions, HFB, SNN, SNN_M) against ``imp_tpu`` on
the CPU.

Weights come from a JAX ``init`` and reach the port through
``imp_torch.convert.zoo_state_dict`` (HFB's ``batch_stats`` too); inputs
come from a numpy seed.  Small sizes: 32 features, bags padded to 36 (a
6 × 6 grid) with ragged masks at batch 3, and 1 000 genes, which the nets
fix (five 200-gene signatures, HFB's 2 × 500).

* each new block (``AlphaDropout``'s a and b, ``SNN_Block``,
  ``Reg_Block``, ``Attn_Net``, ``LRBilinearFusion``, ``Transformer_P``
  masked, ``Transformer_G``, ``MultiheadAttention`` with its weight
  dropout at rate 0, ``TorchTransformerEncoderLayer``, ``SigNetworks``) to
  1e-5;
* a statistical check of the port's alpha dropout: SELU-normalised input
  keeps its mean and variance;
* all eight nets in eval and in train mode: the logits (CMTA's four cls
  tokens too) to 1e-4 and every parameter gradient to 1e-4 of the larger
  of 1 and its largest value, CMTA under Nyström and
  under flash's plain path; HFB's train forward normalises by the batch
  and moves its running statistics as flax does (1e-6).

Dropout cannot share bits across the two frameworks: a fixture makes it
the identity on both sides for the test only (flax's ``nn.Dropout`` and the
JAX ``AlphaDropout``, whose rates the JAX modules hard-code; the port's
``dropout`` and ``alpha_dropout``).  Nothing in ``imp_tpu`` changes.
"""

import copy
import functools
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.fusion as jfusion
import imp_tpu.ops.attention as jattn
import imp_tpu.ops.blocks as jblocks
from imp_tpu.engine.fusion_trainers import FusionNet as JaxFusionNet
from imp_tpu.models.nets import SNN_NET as JaxSNN
from imp_tpu.models.nets import SNNM_NET as JaxSNNM
from imp_torch.convert import _torch_key, zoo_state_dict
from imp_torch.engine.fusion_trainers import FusionNet
from imp_torch.models import fusion
from imp_torch.models.nets import SNN_NET, SNNM_NET
from imp_torch.ops import blocks
from imp_torch.ops.attention import MultiheadAttention, dropout as port_dropout

FEAT, BAG, BATCH, GENES = 32, 36, 3, 1000
LENGTHS = (36, 20, 5)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class _Identity(flax.linen.Module):
    """flax's ``nn.Dropout`` (and the JAX ``AlphaDropout``) at rate 0."""

    rate: float = 0.0
    deterministic: object = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_dropout():
    """Dropout is the identity on both sides while the test runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _Identity)
    mp.setattr(jblocks, "AlphaDropout", _Identity)
    drops = (port_dropout, blocks.alpha_dropout)
    for name, mod in list(sys.modules.items()):
        for attr in ("dropout", "alpha_dropout"):
            if name.startswith("imp_torch") and getattr(mod, attr, None) in drops:
                mp.setattr(mod, attr, lambda x, rate, generator: x)
    yield
    mp.undo()


@pytest.fixture
def jax_attention():
    mp = pytest.MonkeyPatch()
    yield lambda impl: mp.setattr(jattn, "_DEFAULT_ATTENTION_IMPL", impl)
    mp.undo()


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _load(module, variables):
    """Load a JAX block's variables into a port block by ``_torch_key``."""
    state = {}
    for k, v in _flat(variables).items():
        key, transpose = _torch_key(k)
        state[key] = _t(v.T if transpose else v)
    module.load_state_dict(state, strict=True)
    return module


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _rel(got, want) -> float:
    """max |got - want| over the larger of 1 and the largest |want| (the
    Nyström pseudo-inverse amplifies float32 rounding in small entries)."""
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1.0))


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    mask = np.arange(BAG)[None, :] < np.array(LENGTHS)[:, None]
    return {
        "img": rng.normal(size=(BATCH, BAG, FEAT)).astype(np.float32) * mask[..., None],
        "img_mask": mask,
        "mol": rng.lognormal(size=(BATCH, GENES)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_alpha_dropout_keeps_selu_moments_and_uses_jax_constants():
    rate = 0.25
    x = torch.randn(400_000, generator=torch.Generator().manual_seed(0))
    y = blocks.alpha_dropout(x, rate, torch.Generator().manual_seed(1))
    assert abs(y.mean().item()) < 1e-2 and abs(y.var().item() - 1.0) < 1e-2
    assert torch.equal(blocks.alpha_dropout(x, rate, None), x)
    # a and b: on a constant input the kept values are a·c + b and the
    # dropped a·ALPHA_P + b; JAX's module gives the same two values
    c = np.full((64, 64), 0.7, np.float32)
    jvals = np.unique(np.asarray(jblocks.AlphaDropout(rate).apply(
        {}, jnp.asarray(c), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})))
    pvals = np.unique(blocks.alpha_dropout(_t(c), rate, torch.Generator().manual_seed(0)).numpy())
    assert len(jvals) == len(pvals) == 2
    np.testing.assert_allclose(pvals, jvals, rtol=1e-6)
    assert blocks.ALPHA_P == -1.7580993408473766


def _block_cases():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    v1, v2 = (rng.normal(size=(3, 24)).astype(np.float32) for _ in range(2))
    bag = rng.normal(size=(2, 10, 64)).astype(np.float32)
    valid = np.arange(10)[None, :] < np.array([10, 4])[:, None]
    toks = rng.normal(size=(2, 5, 64)).astype(np.float32)
    omic = rng.normal(size=(3, 30)).astype(np.float32)
    return {
        "snn_block": (jblocks.SNN_Block(8), blocks.SNN_Block(16, 8), (x,)),
        "reg_block": (jblocks.Reg_Block(8), blocks.Reg_Block(16, 8), (x,)),
        "attn_net": (jblocks.Attn_Net(D=8, dropout=True, n_classes=2),
                     blocks.Attn_Net(16, D=8, dropout=True, n_classes=2), (x,)),
        "lrb": (jblocks.LRBilinearFusion(dim1=24, dim2=24, scale_dim1=4, scale_dim2=2, rank=5,
                                         output_dim=3),
                blocks.LRBilinearFusion(dim1=24, dim2=24, scale_dim1=4, scale_dim2=2, rank=5,
                                        output_dim=3), (v1, v2)),
        "transformer_p": (jblocks.Transformer_P(64), blocks.Transformer_P(64), (bag, valid)),
        "transformer_g": (jblocks.Transformer_G(64), blocks.Transformer_G(64), (toks,)),
        "mha": (jattn.MultiheadAttention(embed_dim=64, num_heads=8, dropout=0.3),
                MultiheadAttention(64, 8, dropout=0.3), (toks, bag, bag, valid)),
        "encoder_layer": (jfusion.TorchTransformerEncoderLayer(d_model=64, nhead=8,
                                                               dim_feedforward=32),
                          fusion.TorchTransformerEncoderLayer(64, 8, 32), (toks,)),
        "sig_networks": (jfusion.SigNetworks(omic_sizes=(10, 20), hidden=(16, 8)),
                         fusion.SigNetworks((10, 20), (16, 8)), (omic,)),
    }


@pytest.mark.parametrize("name", list(_block_cases()))
def test_block_matches_jax(name, no_dropout):
    jmod, mod, args = _block_cases()[name]
    jargs = [jnp.asarray(a) for a in args]
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(1), *jargs)
    _load(mod, variables)
    targs = [torch.from_numpy(a) for a in args]
    rng = {"dropout": jax.random.PRNGKey(2)}
    wants = jax.jit(lambda v, *a: [jmod.apply(v, *a, deterministic=d, rngs=rng)
                                   for d in (True, False)])(variables, *jargs)
    for train, want in zip((False, True), wants):
        got = mod(*targs, generator=torch.Generator().manual_seed(0) if train else None)
        for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
            _close(g, w, what=f"{name} train={train}")


def test_flax_batch_norm_statistics():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6)).astype(np.float32) * 3 + 1
    jbn = flax.linen.BatchNorm(use_running_average=False)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, state = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = _load(fusion.BatchNorm(6), variables)
    _close(bn(_t(x), train=True), want)
    _close(bn.running_mean, state["batch_stats"]["mean"], 1e-6)
    _close(bn.running_var, state["batch_stats"]["var"], 1e-6)
    # BatchNorm1d takes the unbiased variance into its running statistics
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 + 0.01 * x.var(0), rtol=1e-6)
    jeval = flax.linen.BatchNorm(use_running_average=True)
    _close(bn(_t(x)), jeval.apply({**variables, **state}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the eight nets
# ---------------------------------------------------------------------------


def _nets(name):
    """(JAX net, port net) at FEAT features, 4 survival bins."""
    if name == "snn":
        return JaxSNN(num_classes=4, num_mol=GENES), SNN_NET(4, GENES)
    if name == "snnm":
        return JaxSNNM(num_classes=4), SNNM_NET(4)
    kind, _, variant = name.partition("_")
    if kind == "mcat":
        jm, m = jfusion.MCAT(path_input_dim=FEAT), fusion.MCAT(path_input_dim=FEAT)
    elif kind == "cmta":
        jm = jfusion.CMTA(path_input_dim=FEAT)
        m = fusion.CMTA(path_input_dim=FEAT, attention=variant)
    elif kind == "hfb":
        jm, m = jfusion.HFB(path_input_dim=FEAT), fusion.HFB(path_input_dim=FEAT)
    else:
        jm = jfusion.Porpoise(fusion=variant, omic_input_dim=GENES, path_input_dim=FEAT)
        m = fusion.Porpoise(fusion=variant, omic_input_dim=GENES, path_input_dim=FEAT)
    return JaxFusionNet(fusion_module=jm, num_classes=4), FusionNet(m, 4)


CLS_KEYS = ("cls_token_pathomics_encoder", "cls_token_pathomics_decoder",
            "cls_token_genomics_encoder", "cls_token_genomics_decoder")


def _port_run(net, batch, train, w, wc, dtype=torch.float32):
    """The port's outputs (a dict) and parameter gradients of
    sum(logits·w) (+ sum(cls·wc) for each CMTA cls token) in ``dtype``."""
    b = {k: torch.from_numpy(v).to(dtype) if v.dtype != bool else torch.from_numpy(v)
         for k, v in batch.items()}
    out = net(b, train=train, generator=torch.Generator().manual_seed(0) if train else None)
    out = out if isinstance(out, dict) else {"logits": out}
    loss = (out["logits"] * _t(w).to(dtype)).sum()
    for k in CLS_KEYS:
        if k in out:
            loss = loss + (out[k] * _t(wc).to(dtype)).sum()
    names, ps = zip(*net.named_parameters())
    return out, dict(zip(names, torch.autograd.grad(loss, ps)))


def check_net(name: str) -> None:
    """One net in eval and in train mode against JAX: the logits and CMTA's
    cls tokens to 1e-4, every parameter gradient to 1e-4 of the larger of 1
    and its largest value; a gradient that misses is held instead, with the
    JAX one, to 1e-4 of the port's float64 gradient (float32 cannot resolve
    some of HFB's training gradients, behind its batch statistics over 2B
    rows, to 1e-4); HFB's running statistics to 1e-6."""
    jnet, net = _nets(name)
    batch = _inputs()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(functools.partial(jnet.init, train=True))(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}, jb)
    params = {"params": variables["params"]}
    state = {k: v for k, v in variables.items() if k != "params"}
    w = np.random.default_rng(5).normal(size=(BATCH, 4)).astype(np.float32)
    wc = np.random.default_rng(6).normal(size=(BATCH, 256)).astype(np.float32)

    def jloss(p, train):
        mutable = list(state) if train and state else False
        out = jnet.apply({**p, **state}, jb, train=train,
                         rngs={"dropout": jax.random.PRNGKey(7)}, mutable=mutable)
        out, new_state = out if mutable else (out, state)
        out = out if isinstance(out, dict) else {"logits": out}
        loss = jnp.sum(out["logits"] * w)
        for k in CLS_KEYS:
            if k in out:
                loss = loss + jnp.sum(out[k] * wc)
        return loss, (out, new_state)

    grad = jax.value_and_grad(jloss, has_aux=True)
    # both modes in one program: one compile per net
    jax_runs = jax.jit(lambda p: (grad(p, False), grad(p, True)))(params)
    sd = zoo_state_dict(_flat(variables))
    for train, ((_, (want, new_state)), jgrads) in zip((False, True), jax_runs):
        net.load_state_dict(sd, strict=True)
        out, got = _port_run(net, batch, train, w, wc)
        for k, v in want.items():
            if k == "logits" or k in CLS_KEYS:
                _close(out[k], v, TOL, f"{k} train={train}")
        want_grads = zoo_state_dict(_flat({**jgrads, **state}))
        missed = [k for k, g in got.items() if _rel(g, want_grads[k]) > TOL]
        if missed:
            net64 = copy.deepcopy(net).double()
            net64.load_state_dict(sd, strict=True)
            exact = _port_run(net64, batch, train, w, wc, torch.float64)[1]
            for k in missed:
                for side, g in (("port", got[k]), ("jax", want_grads[k])):
                    err = _rel(g.double(), exact[k].numpy())
                    assert err <= TOL, (k, side, err, train)
        if name == "hfb":  # the running statistics moved (train) or stayed (eval) as in flax
            moved = zoo_state_dict(_flat({**params, **new_state}))
            for k in ("fusion_module.norm.running_mean", "fusion_module.norm.running_var"):
                np.testing.assert_allclose(net.state_dict()[k].numpy(), moved[k].numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=k)
            assert train != torch.equal(net.state_dict()["fusion_module.norm.running_var"],
                                        torch.ones(384))


@pytest.mark.parametrize("name", ["mcat", "porpoise_bilinear", "porpoise_lrb", "porpoise_concat",
                                  "porpoise_add", "snn", "snnm"])
def test_net_outputs_and_gradients_match_jax(name, no_dropout):
    check_net(name)
