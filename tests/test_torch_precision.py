"""``TRAINER.PREC`` bf16 in the PyTorch port against ``imp_tpu`` on the CPU.

One training step under the bf16 policy, the port's trainer against the JAX
trainer's own step body (``compute_dtype_of``/``cast_floats`` and MBTRAIN's
``_amp_apply``): the weights of a JAX init carried by ``imp_torch.convert``,
the batch from a seeded synthetic tree, dropout at rate 0 on both sides.
bf16 rounds at other places in XLA and in eager PyTorch, so the loss, the
logits and every gradient are held to 2e-2 in relative L2 of JAX's bf16
step; a gradient outside that passes only if its distance from JAX's
float32 step is at most twice JAX's own bf16 distance from it (the test
prints that ratio: :func:`check_bf16`, shared with
``test_torch_precision_{gan,nets,fusion}.py``).  The logits must also lie
at least a quarter of JAX's own bf16 distance from JAX's float32 logits, so
a port that stayed float32 fails.  Here:

* the policy's mapping of ``TRAINER.PREC`` (fp16 and amp are bf16);
* UMEML under MBTRAIN (the non-GAN step), Nyström, at ``amp``;
* the flash plain versions on bf16 operands against JAX's off-TPU path
  (``dense_attention`` on bf16 inputs), and :class:`FlashAttention`'s
  delta, formed from the float32 O.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.models.layers as jlayers
import imp_tpu.models.umeml as jumeml
import imp_tpu.ops.flash_attention as jflash
from imp_tpu.config import get_cfg_default as jax_cfg_default
from imp_tpu.engine.trainer import cast_floats as jcast
from imp_tpu.engine.trainer import compute_dtype_of as jax_compute_dtype_of
from imp_tpu.engine.trainer import make_task_loss as jax_task_loss
from imp_tpu.models import build_model as jax_build_model
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_torch.config import get_cfg_default
from imp_torch.convert import umeml_state_dict
from imp_torch.data import synthetic
from imp_torch.engine import build_trainer
from imp_torch.engine.precision import compute_dtype_of
from imp_torch.ops import flash_attention as fa
from imp_torch.ops.attention import NystromAttention

import test_torch_umeml as U

BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_bf16(name, got, want_bf16, want_fp32, computed_in_bf16=False):
    """``got`` within 2e-2 (relative L2) of JAX's bf16 value, or no farther
    from JAX's float32 value than twice JAX's own bf16 distance from it.
    With ``computed_in_bf16`` (the logits), ``got`` must also lie at least a
    quarter of JAX's bf16 distance away from JAX's float32 value: a port
    that ignored the policy and stayed float32 would sit next to it."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got)
    ours, theirs = _rel(got, want_fp32), _rel(want_bf16, want_fp32)
    if computed_in_bf16:
        assert theirs > 0 and ours >= 0.25 * theirs, (
            f"{name}: {ours:.3g} from JAX fp32, JAX bf16 {theirs:.3g} from it: "
            "not computed in bf16")
    if _rel(got, want_bf16) <= BF16_TOL:
        return
    print(f"{name}: {_rel(got, want_bf16):.3g} from JAX bf16; distance from JAX fp32 "
          f"{ours:.3g}, ratio to JAX bf16's {ours / max(theirs, 1e-30):.3g}")
    assert ours <= 2 * theirs, name


def _port_grads(trainer, opts, names):
    """Wrap each optimizer's step to keep the gradients it receives."""
    seen = {}
    for phase, opt in opts.items():
        def record(grads, opt=opt, step=opt.step, phase=phase):
            seen[phase] = {names[id(p)]: torch.zeros_like(p) if g is None else g.detach().clone()
                           for p, g in zip(opt.params, grads)}
            step(grads)

        opt.step = record
    return seen


def _record_logits(trainer):
    seen = {}
    task_loss = trainer.task_loss

    def record(logits, db):
        seen["logits"] = logits.detach()
        return task_loss(logits, db)

    trainer.task_loss = record
    return seen



def test_policy_maps_every_prec_to_bf16():
    cfg, jcfg = get_cfg_default(), jax_cfg_default()
    for prec in ("fp32", "bf16", "fp16", "amp"):
        cfg.TRAINER.PREC = jcfg.TRAINER.PREC = prec
        want = jax_compute_dtype_of(jcfg)
        assert compute_dtype_of(cfg) == (None if want is None else torch.bfloat16)
    cfg.TRAINER.PREC = "int8"
    with pytest.raises(ValueError, match="TRAINER.PREC"):
        compute_dtype_of(cfg)


# ---------------------------------------------------------------------------
# UMEML: the non-GAN step under MBTRAIN
# ---------------------------------------------------------------------------


def test_one_umeml_step_under_bf16_matches_jax(tmp_path):
    root = str(tmp_path / "tree")
    synthetic.materialize(root, num_slides=12, bag_min=5, bag_max=U.BAG, feat_dim=U.FEAT,
                          num_genes=U.GENES, group_size=10, seed=0)
    cfg = U._cfg(get_cfg_default, root, str(tmp_path / "out"))
    cfg.MODEL.HIDDEN_DIM = 64
    cfg.TRAINER.PREC = "amp"
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    batch = next(iter(trainer.train_loader))
    db = trainer._device_batch(batch)
    jb = {k: jnp.asarray(v.numpy()) for k, v in db.items()}
    jcfg = U._cfg(jax_cfg_default, root, "")
    jcfg.MODEL.HIDDEN_DIM = 64
    mp = pytest.MonkeyPatch()
    zero = functools.partial(JaxTransLayer, dropout=0.0)
    mp.setattr(jumeml, "TransLayer", zero)
    mp.setattr(jlayers, "TransLayer", zero)
    try:
        model = jax_build_model("umeml", cfg=jcfg, num_classes=4)
        params = jax.jit(functools.partial(model.init, train=False))(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jb)
        task_loss = jax_task_loss(jcfg)

        def grads_at(cd):
            def loss_fn(p):  # mbtrain.py:270-288 with _amp_apply
                out = model.apply(jcast(p, cd), jcast(jb, cd), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(3)})
                out = jcast(out, jnp.float32) if cd else out
                return task_loss(out["logits"], jb) + out["modular_loss"], out["logits"]

            return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

        want = {cd: grads_at(cd) for cd in (jnp.bfloat16, None)}
    finally:
        mp.undo()

    trainer.model.load_state_dict(umeml_state_dict(_flat(params)), strict=True)
    for m in trainer.model.modules():
        if isinstance(m, NystromAttention):
            m.dropout = 0.0
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    seen = _port_grads(trainer, {"main": trainer.main_opt}, names)
    logits = _record_logits(trainer)
    got = trainer.train_step(db)
    ((l16, lg16), g16), ((l32, lg32), g32) = want[jnp.bfloat16], want[None]
    check_bf16("loss", got["loss"], l16, l32)
    check_bf16("logits", logits["logits"], lg16, lg32, computed_in_bf16=True)
    w16, w32 = umeml_state_dict(_flat(g16)), umeml_state_dict(_flat(g32))
    assert set(seen["main"]) == set(w16)
    for k, g in seen["main"].items():
        check_bf16(f"gradient {k}", g, w16[k].numpy(), w32[k].numpy())


# ---------------------------------------------------------------------------
# flash attention on bf16 operands
# ---------------------------------------------------------------------------


def _bf16_qkv(b=2, h=4, n=40, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(n)[None, :] < np.array([n, 23])[:, None]
    to16 = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    return to16(q), to16(k), to16(v), torch.from_numpy(mask)


def test_flash_plain_versions_on_bf16_operands_match_jax_dense():
    """The port's flash attention on bf16 q, k, v (its plain versions here)
    against JAX's off-TPU ``flash_attention`` (``dense_attention`` on bf16
    inputs): O in bf16 and the bf16 gradients within 2e-2; the kernels'
    float32 contract: the plain versions return float32 O, lse and
    gradients on widened operands."""
    q, k, v, mask = _bf16_qkv()
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, mask=jnp.asarray(mask.numpy()))
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    assert jo.dtype == jnp.bfloat16
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qq, kk, vv, mask=mask)
    assert o.dtype == torch.bfloat16
    (o.float() * torch.from_numpy(w)).sum().backward()
    assert _rel(o.float().detach(), np.asarray(jo, np.float32)) <= BF16_TOL
    for name, t, want in zip("qkv", (qq, kk, vv), jg):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad.float(), np.asarray(want, np.float32)) <= BF16_TOL, name
    # the plain versions of K1-K3: float32 out, the arithmetic of widened operands
    bias = torch.where(mask, 0.0, fa.NEG_INF)
    o16, lse16 = fa.flash_attention_fwd(q, k, v, bias)
    o32, lse32 = fa.flash_attention_fwd(q.float(), k.float(), v.float(), bias)
    assert o16.dtype == lse16.dtype == torch.float32
    assert torch.equal(o16, o32) and torch.equal(lse16, lse32)
    do = torch.from_numpy(w)
    delta = (do * o32).sum(-1)
    for a, b in zip(fa.flash_attention_bwd(q, k, v, bias, do, lse32, delta),
                    fa.flash_attention_bwd(q.float(), k.float(), v.float(), bias, do, lse32,
                                           delta)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_flash_function_forms_delta_from_the_float32_output(monkeypatch):
    """Under bf16 :class:`FlashAttention` returns O rounded to bf16 but
    forms delta = rowsum(dO ⊙ O) from the float32 O the kernel wrote, as
    JAX's custom VJP does; dO reaches the backward in float32."""
    q, k, v, mask = _bf16_qkv(seed=2)
    seen = {}
    bwd = fa.flash_attention_bwd

    def spy(q, k, v, bias, do, lse, delta):
        seen.update(do=do, delta=delta)
        return bwd(q, k, v, bias, do, lse, delta)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qq, kk, vv, mask=mask)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(4)).bfloat16()
    o.backward(do)
    bias = torch.where(mask, 0.0, fa.NEG_INF)
    scale = q.shape[-1] ** -0.5
    o32, _ = fa.flash_attention_reference(q * scale, k, v, bias)
    assert seen["do"].dtype == torch.float32 and torch.equal(seen["do"], do.float())
    assert torch.equal(seen["delta"], (do.float() * o32).sum(-1))
    assert not torch.equal(seen["delta"], (do.float() * o32.bfloat16().float()).sum(-1))
    # what a CUDA call takes: q, k, v all fp32 or all bf16, the rest fp32
    with pytest.raises(TypeError, match="q's dtype"):
        fa._check_kernel_operands((("q", q), ("k", k.float()), ("v", v)), ())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_kernel_operands((("q", q.half()), ("k", k.half()), ("v", v.half())), ())
    with pytest.raises(TypeError, match="do must be float32"):
        fa._check_kernel_operands((("q", q), ("k", k), ("v", v)), (("do", do),))
