"""Sequence parallelism of the PyTorch port (``imp_torch/parallel/``)
against the JAX package's single-device functions, on the CPU.

One local group of four gloo ranks (``imp_torch.parallel.launch.spawn``,
one CPU thread each, a 120 s wall limit after which every rank is killed
and the fixture fails) is spawned once for the file; it runs every check at
sp = 2 (ranks 0-1 and 2-3) and sp = 4 (all four) in
``tests/test_torch_parallel_ranks.py::sequence_rank``, and rank 0's results are
held here against JAX references computed in this process (no JAX
``shard_map`` runs: JAX's own ``test_sequence_parallel.py`` holds its sp
path to single-device).  One square bag of 144 tokens (a 12 × 12 grid:
6 rows a rank at sp 2, 3 at sp 4) serves both sizes, so the JAX references
are compiled once; ragged masks, batch 2.

* the sp and ring modularity pair: values and both prototype sets'
  gradients;
* ``cross_attention_tokens_sp``: output and the gradients of q, k and v;
* ``self_attention_tokens_sp`` and ``ring_self_attention`` (the second
  slide's last half has no valid key: whole key bands without one, under
  the global row statistics): output and gradients;
* a TransMIL ``TransLayer`` (``ExactSelfAttention`` inside) in the gather
  and ring layouts (the ring threading the cls token), and ``PPEG`` in
  the ring layout: outputs and parameter gradients;
* TransMIL (exact attention on both sides) and UMEML_GAN (hidden 32,
  train forward at dropout 0) in both layouts: logits, loss and every
  parameter gradient.

Tolerances are JAX's own for its sp tests: rtol 1e-4 / atol 1e-5, and
2e-4 / 2e-5 where a TransLayer's attention is inside.  A TransLayer
gradient that misses JAX's is held, with JAX's, to the port's one-rank
float64 gradient instead (float32 cannot resolve some of these sums to
the tolerance in every summation order: the residual conv's weight
gradient at sp 4 misses by 4e-5 on one of 264 entries).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.layers as jlayers
import imp_tpu.models.umeml_gan as jug
import imp_tpu.ops.attention as jattn
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.models.nets import TransMIL_NET as JaxTransMIL
from imp_tpu.ops.blocks import PPEG as JaxPPEG
from imp_tpu.ops.flash_attention import flash_attention as jax_flash
from imp_tpu.ops.modularity import compute_modularity_pair as jax_modularity_pair
from imp_torch.convert import mil_state_dict, umeml_gan_state_dict
from imp_torch.parallel.launch import spawn

import test_torch_parallel_ranks as ranks

FEAT, B, P, D = 32, 2, 6, 32
GENES = 60
GROUPS = [list(range(i * 10, (i + 1) * 10)) for i in range(P)]
SIDE = 12  # bag = 144 = 12²: 6 grid rows a rank at sp 2, 3 at sp 4
RTOL, ATOL = 1e-4, 1e-5
LAYER_RTOL, LAYER_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask(rng, n, lengths):
    return np.arange(n)[None, :] < np.asarray(lengths)[:, None]


def _jax_umeml_cfg():
    cfg = jax_cfg_default()
    cfg.MODEL.NAME, cfg.MODEL.HIDDEN_DIM = "umeml_gan", D
    cfg.MODEL.UMEML.PROTOTYPES, cfg.MODEL.FUSION, cfg.MODEL.DROPOUT = P, "concat", 0.0
    cfg.DATASET.PATH.DIM = FEAT
    return cfg


def _references() -> tuple:
    """(inputs for the ranks, JAX references): one bag serves sp 2 and 4."""
    n = SIDE * SIDE
    rng = np.random.default_rng(12)
    f32 = np.float32
    valid = _mask(rng, n, [n, n - SIDE * 3 - 5])
    case = {"feat": FEAT, "side": SIDE, "groups": GROUPS}
    want = {}

    x = rng.normal(size=(B, n, D)).astype(f32)
    c1 = rng.normal(size=(B, P, D)).astype(f32)
    c2 = rng.normal(size=(B, P + 1, D)).astype(f32)
    pq, xv, pw = (rng.normal(size=s_).astype(f32) for s_ in ((B, P, D), (B, n, D), (B, P, D)))
    h, dh = 2, 32
    q, k, v_, do = (rng.normal(size=(B, h, n, dh)).astype(f32) for _ in range(4))
    kmask = valid.copy()
    kmask[1, n // 2:] = False  # the last half of slide 1: one band at sp 2, two at sp 4
    case.update(x=_t(x), valid=_t(valid), c1=_t(c1), c2=_t(c2), pq=_t(pq), xv=_t(xv),
                pw=_t(pw), q=_t(q), k=_t(k), v=_t(v_), do=_t(do), kmask=_t(kmask))

    def ops(c1, c2, pq, x, xv, q, k, v_, valid, kmask, pw, do):
        modular = jax.value_and_grad(
            lambda a, b_: jax_modularity_pair((a, b_), x, valid), argnums=(0, 1))

        def cross(q_, k_, v2):
            out, _, _ = jattn.dense_attention(q_[:, None], k_[:, None], v2[:, None], valid,
                                              scale=D**-0.5)
            return jnp.sum(out[:, 0] * pw), out[:, 0]

        def selfattn(q_, k_, v2):
            o = jax_flash(q_, k_, v2, mask=kmask, scale=dh**-0.5)
            return jnp.sum(o * do), o

        grad3 = functools.partial(jax.value_and_grad, argnums=(0, 1, 2), has_aux=True)
        return modular(c1, c2), grad3(cross)(pq, x, xv), grad3(selfattn)(q, k, v_)

    (mv, mg), ((_, co), cg), ((_, so), sg) = jax.jit(ops)(c1, c2, pq, x, xv, q, k, v_, valid,
                                                          kmask, pw, do)
    want.update(modularity=[mv, *mg], cross=[co, *cg], self=[so, *sg])

    # TransMIL: its layer1 and PPEG on [cls; grid] tokens, and the whole net
    jattn.set_default_attention_impl("flash")
    try:
        jnet = JaxTransMIL(num_classes=4, path_input_dim=FEAT)
        img = (rng.normal(size=(B, n, FEAT)) * valid[..., None]).astype(f32)
        jb = {"img": jnp.asarray(img), "img_mask": jnp.asarray(valid)}
        params = jax.jit(jnet.init)(jax.random.PRNGKey(3), jb)
        tokens = rng.normal(size=(B, n + 1, 512)).astype(f32)
        tmask = np.concatenate([np.ones((B, 1), bool), valid], axis=1)
        tw = rng.normal(size=(B, n + 1, 512)).astype(f32)
        lw = rng.normal(size=(B, 4)).astype(f32)
        case.update(transmil_sd=mil_state_dict(_flat(params)), tokens=_t(tokens),
                    tmask=_t(tmask), tw=_t(tw), img=_t(img), img_mask=_t(valid), lw=_t(lw))
        layer, ppeg = jattn.TransLayer(dim=512), JaxPPEG(dim=512)

        # arrays go in as arguments: closed over, XLA folds them as constants
        def nets(p, tokens, tmask, tw, lw, jb):
            def layer_loss(p):
                y = layer.apply({"params": p["params"]["mil"]["layer1"]}, tokens, mask=tmask)
                return jnp.sum(y * tw), y

            def ppeg_loss(p, t):
                y = ppeg.apply({"params": p["params"]["mil"]["pos_layer"]}, t, SIDE, SIDE)
                return jnp.sum(y[:, 1:] * tw[:, 1:]), y[:, 1:]

            def net_loss(p):
                logits = jnet.apply(p, jb)
                return jnp.sum(logits * lw), logits

            return (jax.value_and_grad(layer_loss, has_aux=True)(p),
                    jax.value_and_grad(ppeg_loss, argnums=(0, 1), has_aux=True)(p, tokens),
                    jax.value_and_grad(net_loss, has_aux=True)(p))

        ((_, y), g), ((_, py), (pg, pt)), ((loss, logits), ng) = jax.jit(nets)(
            params, tokens, tmask, tw, lw, jb)
        want["translayer"] = [y, mil_state_dict(_flat(g))]
        want["ppeg"] = [py, pt[:, 1:], mil_state_dict(_flat(pg))]
        want["transmil"] = [logits, loss, mil_state_dict(_flat(ng))]
    finally:
        jattn.set_default_attention_impl("nystrom")

    # UMEML_GAN's train forward (its TransLayers at dropout 0)
    mp = pytest.MonkeyPatch()
    zero = functools.partial(jattn.TransLayer, dropout=0.0)
    mp.setattr(jug, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    try:
        model = jax_build_model("umeml_gan", cfg=_jax_umeml_cfg(), num_classes=4,
                                gene_group_indexes=GROUPS)
        ub = {
            "img": (rng.normal(size=(B, n, FEAT)) * valid[..., None]).astype(f32),
            "img_mask": valid,
            "mol": rng.lognormal(size=(B, GENES)).astype(f32),
            "without_omic": np.array([0, 1], f32),
            "insample_without_omic": (rng.random((B, GENES)) < 0.2).astype(np.int32),
            "omic_means": rng.normal(size=(GENES,)).astype(f32),
        }
        jub = {k_: jnp.asarray(v) for k_, v in ub.items()}
        init_batch = {k_: (v if k_ == "omic_means" else v[:1]) for k_, v in jub.items()}
        rngs = {nm: jax.random.key(i, impl="rbg") for i, nm in
                enumerate(("params", "dropout", "gan"))}

        def touch(module, batch):
            out = module(batch, train=False)
            return module.gen_loss(out["h_path"], out["h_omic"])

        uparams = jax.jit(lambda r, b_: model.init(r, b_, method=touch))(rngs, init_batch)
        uw = rng.normal(size=(B, 4)).astype(f32)
        drngs = {"dropout": jax.random.key(5, impl="rbg"), "gan": jax.random.key(6, impl="rbg")}

        def uloss(p, batch, uw):
            out = model.apply(p, batch, train=True, replace_ratio=0.0, rngs=drngs)
            loss = out["modular_loss"] + out["loss_kd"] + jnp.sum(out["logits"] * uw)
            return loss, out

        (loss, out), g = jax.jit(jax.value_and_grad(uloss, has_aux=True))(uparams, jub, uw)
        want["umeml_gan"] = [out["logits"], out["modular_loss"], loss,
                             umeml_gan_state_dict(_flat(g))]
        case.update(umeml_sd=umeml_gan_state_dict(_flat(uparams)), uw=_t(uw),
                    ubatch={k_: _t(v) for k_, v in ub.items()})
    finally:
        mp.undo()
    return case, want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    case, want = _references()
    path = str(tmp_path_factory.mktemp("sp") / "case.pt")
    torch.save(case, path)
    return spawn(ranks.sequence_rank, 4, (path,), timeout=120), want


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


SPS = list(ranks.SP_SIZES)


def test_all_ranks_agree_on_replicated_results(results):
    """Every rank of a group computes the same replicated values."""
    got, _ = results
    for r, res in enumerate(got):
        sp2_lead = 0 if r < 2 else 2
        for sp, lead in ((2, sp2_lead), (4, 0)):
            for key in ("modularity/gather", "modularity/ring", "transmil/ring"):
                torch.testing.assert_close(res[sp][key][0], got[lead][sp][key][0], rtol=0, atol=0)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_modularity_pair_matches_single_device(results, sp, mode):
    got, want = results
    v, g1, g2 = got[0][sp][f"modularity/{mode}"]
    wv, wg1, wg2 = want["modularity"]
    _close(v, wv, RTOL, ATOL, "value")
    _close(g1, wg1, RTOL, ATOL, "d c1")
    _close(g2, wg2, RTOL, ATOL, "d c2")


@pytest.mark.parametrize("sp", SPS)
def test_cross_attention_tokens_sp_matches_single_device(results, sp):
    got, want = results
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[0][sp]["cross"], want["cross"]):
        _close(g, w, RTOL, ATOL, name)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_self_attention_matches_single_device(results, sp, mode):
    got, want = results
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[0][sp][f"self/{mode}"],
                          want["self"]):
        _close(g, w, RTOL, ATOL, name)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_translayer_matches_single_device(results, sp, mode):
    got, want = results
    y, grads = got[0][sp][f"translayer/{mode}"]
    wide = got[0][sp]["translayer/float64"]
    wy, wgrads = want["translayer"]
    _close(y, wy, LAYER_RTOL, LAYER_ATOL, "out")
    assert grads
    for k, g in grads.items():
        w = wgrads["mil.layer1." + k]
        try:
            _close(g, w, LAYER_RTOL, LAYER_ATOL, k)
        except AssertionError:
            # a sum float32 cannot resolve to the tolerance (the residual
            # conv's weight gradient sums the whole bag in another order):
            # both sides must then hold the float64 gradient
            _close(g, wide[k].numpy(), LAYER_RTOL, LAYER_ATOL, k + " vs float64")
            _close(w, wide[k].numpy(), LAYER_RTOL, LAYER_ATOL, k + " (JAX) vs float64")


@pytest.mark.parametrize("sp", SPS)
def test_ppeg_ring_layout_matches_single_device(results, sp):
    got, want = results
    y, gx, grads = got[0][sp]["ppeg/ring"]
    wy, wgx, wgrads = want["ppeg"]
    _close(y, wy, RTOL, ATOL, "out")
    _close(gx, wgx, RTOL, ATOL, "d tokens")
    for k, g in grads.items():
        _close(g, wgrads["mil.pos_layer." + k], RTOL, ATOL, k)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_transmil_matches_single_device(results, sp, mode):
    got, want = results
    logits, loss, grads = got[0][sp][f"transmil/{mode}"]
    wlogits, wloss, wgrads = want["transmil"]
    _close(logits, wlogits, LAYER_RTOL, LAYER_ATOL, "logits")
    _close(loss, wloss, LAYER_RTOL, LAYER_ATOL, "loss")
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        _close(g, wgrads[k], LAYER_RTOL, LAYER_ATOL, k)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_umeml_gan_matches_single_device(results, sp, mode):
    got, want = results
    logits, modular, loss, grads = got[0][sp][f"umeml_gan/{mode}"]
    wlogits, wmodular, wloss, wgrads = want["umeml_gan"]
    _close(logits, wlogits, LAYER_RTOL, LAYER_ATOL, "logits")
    _close(modular, wmodular, RTOL, ATOL, "modular_loss")
    assert abs(float(modular)) > 1e-3  # the loss is really there
    _close(loss, wloss, LAYER_RTOL, LAYER_ATOL, "loss")
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        _close(g, wgrads[k], LAYER_RTOL, LAYER_ATOL, k)
