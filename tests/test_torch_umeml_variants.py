"""The UMEML_GAN variants of the PyTorch port against ``imp_tpu`` on the CPU:
the JAX module globals ``HEAD_FUSED`` and ``STACKED_PAIRS`` (the port's
constructor arguments ``head_fused`` and ``stacked_pairs``).

The JAX flags are set on the module (``importlib``, not the package
attribute) inside ``try``/``finally``, as ``tests/test_umeml_gan_parity.py``
does.  Weights come from a JAX init through ``imp_torch.convert``; the
sizes, batch and dropout-0 setting are those of ``tests/test_torch_train.py``
(hidden 64, 6 prototypes, 60 genes, bags of <= 64 tokens, batch 3).

* ``head_fused=False`` and ``stacked_pairs=True``: the train forward's
  outputs and the gradients of a scalar of them (logits, the
  self-distillation and the modularity loss) to 1e-5 of JAX's; the stacked
  model also equals the twin model at the same weights (``stack_twins``),
  Nyström and flash;
* ``bag_dtype``, ``MODEL.INIT_WEIGHTS`` and ``umeml_gan_plot`` are in
  ``tests/test_torch_umeml_variants_io.py`` (the helpers are this file's).

A gradient that misses 1e-5 (a sum over the bag's tokens, which float32
resolves to ~1e-5 in either framework) must lie no farther from the port's
float64 replay than twice JAX's.
"""

import contextlib
import functools
import importlib

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imp_tpu.models.layers as jlayers
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_torch.config import get_cfg_default
from imp_torch.convert import stack_twins, umeml_gan_state_dict
from imp_torch.engine.trainer import device_batch
from imp_torch.models import build_model
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention

import test_torch_train as T

jug = importlib.import_module("imp_tpu.models.umeml_gan")
TOL = 1e-5
OUT_KEYS = ("logits", "logits_first_pass", "loss_kd", "modular_loss", "importance_path",
            "importance_omic", "h_path", "h_omic")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class _ZeroDropoutTransLayer(JaxTransLayer):
    dropout: float = 0.0


@pytest.fixture(scope="module")
def jax_zero_dropout():
    """The JAX TransLayers at dropout 0, the stacked twins' included (their
    ``nn.vmap`` is built at import from the class itself)."""
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jug, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    mp.setattr(jug, "_StackedTransLayer", flax.linen.vmap(
        _ZeroDropoutTransLayer, in_axes=(0, None, None), out_axes=0,
        variable_axes={"params": 0}, split_rngs={"params": True, "dropout": True}))
    yield
    mp.undo()


@contextlib.contextmanager
def jax_flags(**flags):
    """The JAX module globals (and the TransLayer default) while inside."""
    jattn = importlib.import_module("imp_tpu.ops.attention")
    impl = flags.pop("attention", "nystrom")
    saved = {k: getattr(jug, k) for k in flags}
    try:
        for k, v in flags.items():
            setattr(jug, k, v)
        jattn.set_default_attention_impl(impl)
        yield
    finally:
        for k, v in saved.items():
            setattr(jug, k, v)
        jattn.set_default_attention_impl("nystrom")


def _jax_model(num_classes=4):
    return jax_build_model("umeml_gan", cfg=T._cfg(jax_cfg_default), num_classes=num_classes,
                           gene_group_indexes=T.GROUPS)


def _jax_init(model):
    init_batch = {k: (v if k == "omic_means" else v[:1]) for k, v in T._batch().items()}
    rngs = {n: jax.random.key(i, impl="rbg") for i, n in enumerate(("params", "dropout", "gan"))}
    return jax.jit(lambda r, b: model.init(r, b, method=T._init_eval_and_gan))(
        rngs, T._jnp(init_batch))


W = np.random.default_rng(11).normal(size=(T.BATCH, 4)).astype(np.float32)


def _jax_train(model, params):
    """The train forward's outputs and the gradients of sum(logits·W) +
    loss_kd + modular_loss, at replace ratio 0 (no draw)."""
    rngs = {"dropout": jax.random.key(5, impl="rbg"), "gan": jax.random.key(6, impl="rbg")}

    def fn(p):
        out = model.apply(p, T._jnp(T._batch()), train=True, replace_ratio=0.0, rngs=rngs)
        return (jnp.sum(out["logits"].astype(jnp.float32) * W) + out["loss_kd"]
                + out["modular_loss"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    return ({k: np.asarray(out[k], np.float32) for k in OUT_KEYS},
            {k: v.numpy() for k, v in umeml_gan_state_dict(T._flat(grads)).items()})


def _port_model(state, attention="nystrom", **variant):
    cfg = T._cfg(get_cfg_default)
    cfg.TPU.ATTENTION = attention
    model = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=T.GROUPS,
                        device="cpu", **variant)
    model.load_state_dict(state, strict=True)
    for m in model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
    return model


def _port_train(model, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    db = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in device_batch(T._batch(), "cpu").items()}
    out = model(db, train=True, replace_ratio=0.0, generator=g)
    loss = ((out["logits"] * torch.from_numpy(W).to(out["logits"].dtype)).sum()
            + out["loss_kd"] + out["modular_loss"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)  # the GAN's are unused
    return ({k: out[k].detach().float().numpy() for k in OUT_KEYS},
            {n: np.zeros(p.shape, np.float32) if g is None else g.float().numpy()
             for n, p, g in zip(names, params, grads)})


def _err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _close(got, want, tol, what):
    assert _err(got, want) <= tol, f"{what}: {_err(got, want):.3g} > {tol}"


def _close_grads(model, got_g, want_g):
    """Every gradient to 1e-5 of JAX's; one that float32 cannot resolve
    that closely (a sum over the bag's tokens, ~1e-5 in either framework)
    no farther from the port's float64 replay than twice JAX's."""
    assert set(got_g) == set(want_g)
    g64 = None
    for k, g in got_g.items():
        if _err(g, want_g[k]) <= TOL:
            continue
        if g64 is None:
            g64 = _port_train(copy.deepcopy(model).double(), torch.float64)[1]
        ours, theirs = _err(g, g64[k]), _err(want_g[k], g64[k])
        print(f"gradient {k}: {_err(g, want_g[k]):.3g} from JAX; from float64 "
              f"{ours:.3g} (JAX {theirs:.3g})")
        assert ours <= 2 * theirs, k


@pytest.mark.parametrize("attention", ["nystrom", "flash"])
def test_two_sequential_head_passes_match_jax(jax_zero_dropout, attention):
    model = _jax_model()
    params = _jax_init(model)
    with jax_flags(HEAD_FUSED=False, attention=attention):
        want, want_g = _jax_train(model, params)
    port = _port_model(umeml_gan_state_dict(T._flat(params)), attention, head_fused=False)
    got, got_g = _port_train(port)
    for k in OUT_KEYS:
        _close(got[k], want[k], TOL, k)
    _close_grads(port, got_g, want_g)
    if attention == "flash":  # rows are independent: the fused pass over 2B rows
        fused, _ = _port_train(_port_model(umeml_gan_state_dict(T._flat(params)), attention))
        for k in OUT_KEYS:  # (a Nyström normaliser is global over the rows)
            _close(fused[k], got[k], TOL, f"fused {k}")


def test_stacked_twins_match_jax_and_the_twin_layout(jax_zero_dropout):
    with jax_flags(STACKED_PAIRS=True):
        model = _jax_model()
        params = _jax_init(model)
        want, want_g = _jax_train(model, params)
    flat = T._flat(params)
    assert "params/pair_decoder/attn/to_qkv/kernel" in flat
    state = umeml_gan_state_dict(flat)  # the stacked layout of convert.py
    assert state["pair_decoder.layer.attn.to_qkv.weight"].shape == (2, 3 * T.HIDDEN, T.HIDDEN)
    port = _port_model(state, stacked_pairs=True)
    got, got_g = _port_train(port)
    for k in OUT_KEYS:
        _close(got[k], want[k], TOL, k)
    _close_grads(port, got_g, want_g)


@pytest.mark.parametrize("attention", ["nystrom", "flash"])
def test_stacked_model_equals_the_twin_model_at_the_same_weights(jax_zero_dropout, attention):
    """Each twin keeps its own Nyström normaliser (the global max of its own
    landmark softmax): folding the twins into the batch would share one."""
    twin_state = umeml_gan_state_dict(T._flat(_jax_init(_jax_model())))
    twin, twin_g = _port_train(_port_model(twin_state, attention))
    stacked_model = _port_model(stack_twins(twin_state), attention, stacked_pairs=True)
    stacked, stacked_g = _port_train(stacked_model)
    for k in OUT_KEYS:
        _close(stacked[k], twin[k], TOL, k)
    for k, g in twin_g.items():
        for pair, (first, second) in (("pair_decoder", ("path_decoder", "omic_decoder")),
                                      ("pair_norm", ("layer_norm_p", "layer_norm_o")),
                                      ("pair_explainer", ("explainer_path", "explainer_omic"))):
            top, _, rest = k.partition(".")
            if top in (first, second):
                k_stacked, i = f"{pair}.layer.{rest}", (first, second).index(top)
                _close(stacked_g[k_stacked][i], g, TOL, f"gradient {k}")
                break
        else:
            _close(stacked_g[k], g, TOL, f"gradient {k}")
