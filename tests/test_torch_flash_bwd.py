"""The flash-attention backward of the PyTorch port against ``imp_tpu`` on the
CPU, where the port's K2/K3 wrapper is its plain version and the JAX
flash attention takes its dense fallback.

* the plain backward (``flash_attention_bwd_reference``) against
  ``imp_tpu``'s ``flash_attention_partial_bwd`` with the same lse and delta
  supplied: the same math, so 1e-5 relative to the largest entry (an entry
  near 0 is a sum of terms of size ~1 and keeps their rounding), and so
  are the per-kernel plain versions of K2 (dq) and K3 (dk, dv);
* ``torch.autograd.grad`` through the port's ``flash_attention`` (the
  ``FlashAttention`` autograd.Function) against ``jax.grad`` of ``imp_tpu``'s
  ``flash_attention``: dq, dk, dv to rtol 2e-4 / atol 2e-5, the tolerance of
  ``tests/test_flash_attention.py`` (exp(s - lse) against autodiff of a
  softmax: the same gradient, other roundings);
* the TransLayer under ``impl="flash"``: every parameter gradient and the
  input gradient against JAX's TransLayer (dropout 0) to 1e-4;
* a model of the Hopper kernels' numerics (every tile product in 3xTF32,
  operands cut to TF32 by integer bit operations) against the JAX backward:
  within 1e-5 (~1e-6 measured at d 64, 384 keys, one slide masked past key
  250), while one TF32 pass per product misses the 1e-4 gate (~6-8e-4);
  and one of the bf16 entries' pass schedule (Q·Kᵀ one bf16 pass, a
  product with one bf16 operand two TF32 passes, Pᵀ·dO 3xTF32) on bf16
  q, k, v: within 1e-5, while dropping the small pass of any one two-pass
  product misses 1e-4.

Masks keep a valid key in every row (60 and 96 of 96): a fully masked row
follows each side's own contract (see ``imp_torch/ops/flash_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.ops.flash_attention as jflash
from imp_tpu.ops.attention import TransLayer as JaxTransLayer
from imp_torch import kernels
from imp_torch.convert import _torch_key
from imp_torch.ops.attention import TransLayer
from imp_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq_reference,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

B, H, NQ, NK = 2, 4, 64, 96
VALID = (60, 96)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _inputs(d, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, NQ, d)).astype(np.float32) * d**-0.5
    k, v = (rng.normal(size=(B, H, NK, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, H, NQ, d)).astype(np.float32)
    mask = np.arange(NK)[None, :] < np.array(VALID)[:, None]
    return q, k, v, do, mask


@pytest.mark.parametrize("d", [32, 64])
def test_plain_backward_matches_jax_partial_bwd(d):
    q, k, v, do, mask = _inputs(d)
    bias = _t(np.where(mask, 0.0, NEG_INF))
    o, lse = flash_attention_reference(_t(q), _t(k), _t(v), bias)
    delta = (_t(do) * o).sum(-1)
    want = jflash.flash_attention_partial_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(do),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()))
    before = kernels.launches()
    got = flash_attention_bwd(_t(q), _t(k), _t(v), bias, _t(do), lse, delta)
    assert kernels.launches() == before  # on the CPU the wrapper is the plain version
    ref = flash_attention_bwd_reference(_t(q), _t(k), _t(v), bias, _t(do), lse, delta)
    for name, g, r, w in zip(("dq", "dk", "dv"), got, ref, want):
        assert torch.equal(g, r), name
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("d", [32, 64])
def test_per_kernel_plain_versions_match_jax_partial_bwd(d):
    """K2's plain version gives dq, K3's gives (dk, dv), each as the pair's."""
    q, k, v, do, mask = _inputs(d, seed=6)
    bias = _t(np.where(mask, 0.0, NEG_INF))
    _, lse = flash_attention_reference(_t(q), _t(k), _t(v), bias)
    delta = _t(np.random.default_rng(7).normal(size=(B, H, NQ)))
    args = (_t(q), _t(k), _t(v), bias, _t(do), lse, delta)
    want = jflash.flash_attention_partial_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(do),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()))
    got = (flash_attention_bwd_dq_reference(*args), *flash_attention_bwd_dkv_reference(*args))
    for name, g, r, w in zip(("dq", "dk", "dv"), got, flash_attention_bwd_reference(*args), want):
        assert torch.equal(g, r), name
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("d", [32, 64])
def test_autograd_gradients_match_jax_grad(d):
    q, k, v, do, mask = _inputs(d, seed=4)
    scale = d**-0.5

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, mask=jnp.asarray(mask), scale=scale) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, mask=torch.from_numpy(mask), scale=scale)
    got = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=name)
    # no grad: the forward alone, the same values
    with torch.no_grad():
        again = flash_attention(tq, tk, tv, mask=torch.from_numpy(mask), scale=scale)
    assert torch.equal(again, out.detach()) and not again.requires_grad


@pytest.mark.parametrize("masked", [False, True])
def test_translayer_flash_gradients_match_jax(masked):
    dim, n, b = 64, 21, 3
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    w = rng.normal(size=(b, n, dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, 13, 1])[:, None] if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jlayer = JaxTransLayer(dim=dim, dropout=0.0, impl="flash")
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jmask)

    def jloss(params, x):
        return jnp.sum(jlayer.apply(params, x, mask=jmask) * w)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(variables, jnp.asarray(x))

    layer = TransLayer(dim, impl="flash", dropout=0.0)
    sd = {}
    for key, value in flatten_dict(variables).items():
        tkey, transpose = _torch_key("/".join(key))
        arr = np.asarray(value, np.float32)
        sd[tkey] = torch.tensor(arr.T if transpose else arr)
    layer.load_state_dict(sd, strict=True)
    tx = _t(x).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    loss = (layer(tx, mask=tmask) * _t(w)).sum()
    names, params = zip(*layer.named_parameters())
    got = torch.autograd.grad(loss, (tx,) + params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-5)
    for key, value in flatten_dict(want_p).items():
        tkey, transpose = _torch_key("/".join(key))
        g = got[1 + names.index(tkey)].numpy()
        np.testing.assert_allclose(g.T if transpose else g, np.asarray(value), rtol=1e-4,
                                   atol=1e-5, err_msg=tkey)


def _tf32(x, nearest=True):
    """``x`` (float32) cut to TF32's 10 mantissa bits by integer bit
    operations: rounded to nearest, ties away from zero (what
    ``cvt.rna.tf32.f32`` gives), or truncated (what the tensor core reads of
    an fp32 operand)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the flash backward kernels form every tile product: each
    operand split into big = tf32(x) and small = x - big (truncated by the
    tensor core), and big.small + small.big + big.big summed in fp32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab, nearest=False), _tf32(b - bb, nearest=False)
    return ab @ b_s + a_s @ bb + ab @ bb


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_split_model_of_the_backward(passes):
    """The numerics the Hopper K2/K3 rest on, modelled on the CPU: the math
    of ``_bwd_p_ds`` and the three gradient products with every product in
    3xTF32 stays within 1e-5 of the JAX backward (norm-wise), while one TF32
    pass per product does not stay within the kernels' 1e-4 gate.  This
    documents the choice of route; it calls no code of the port, so it
    guards no kernel: the kernels' precision is held by the 1e-4 card gates
    (``chip_smoke.py`` and ``test_flash_bwd_kernels_match_plain_on_card``)."""
    b, h, n, d = 2, 4, 384, 64
    rng = np.random.default_rng(8)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32) * d**-0.5
    k, v, do = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(n)[None, :] < np.array([n, 250])[:, None]
    bias = _t(np.where(mask, 0.0, NEG_INF))
    o, lse = flash_attention_reference(_t(q), _t(k), _t(v), bias)
    delta = (_t(do) * o).sum(-1)
    want = jflash.flash_attention_partial_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(do),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()))
    mm = _mm_3xtf32 if passes == 3 else _mm_1xtf32
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    p = torch.exp(mm(tq, tk.transpose(-1, -2)) + bias[:, None, None, :] - lse[..., None])
    ds = p * (mm(tdo, tv.transpose(-1, -2)) - delta[..., None])
    got = (mm(ds, tk), mm(ds.transpose(-1, -2), tq), mm(p.transpose(-1, -2), tdo))
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        errs[name] = np.abs(g.numpy() - w).max() / np.abs(w).max()
    if passes == 3:
        assert max(errs.values()) <= 1e-5, errs
    else:
        assert min(errs.values()) > 1e-4, errs


def test_tf32_split_of_bf16_operands_has_zero_low_parts():
    """K1's bf16 entry widens q, k, v to fp32 and runs the fp32 entry's
    3xTF32 products.  A bf16 value (8 significant bits) is exact in TF32
    (11), so its split is big = x, small = 0: the two correction passes
    add exact zeros and the three-pass product equals one TF32 pass bit for
    bit, on the products of the backward's model above.  K2's and K3's bf16
    entries use that for speed: the products with one bf16 operand drop
    the zero pass (two passes), Q·Kᵀ is one bf16 pass
    (:func:`test_bf16_pass_model_of_the_backward`); K1's is the next."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64)).astype(np.float32)).bfloat16().float()
    big = _tf32(x)
    assert torch.equal(big, x)
    assert torch.count_nonzero(_tf32(x - big, nearest=False)) == 0
    q, k = (torch.from_numpy(rng.normal(size=(2, 4, 96, 64)).astype(np.float32))
            .bfloat16().float() for _ in range(2))
    three, one = _mm_3xtf32(q, k.transpose(-1, -2)), _mm_1xtf32(q, k.transpose(-1, -2))
    assert torch.equal(three, one)
    # an fp32 operand has a nonzero low part: there the passes differ
    xf = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    assert torch.count_nonzero(xf - _tf32(xf)) > 0


def _mm_2xtf32(a, b):
    """a @ b as K2/K3's bf16 entries form a product of an fp32 operand ``a``
    and a bf16 one ``b`` (exact in TF32): a's big and small halves (the
    small one truncated by the tensor core) times b, summed in fp32."""
    ab = _tf32(a)
    return _tf32(a - ab, nearest=False) @ b + ab @ b


def _mm_big_only(a, b):
    """_mm_2xtf32 without the small pass: one TF32 pass of ``a``."""
    return _tf32(a) @ b


#: the products of K2/K3's bf16 entries with one bf16 operand (the fp32
#: operand first), each in two TF32 passes
TWO_PASS_PRODUCTS = ("dO·Vᵀ", "dS·K", "dSᵀ·Q")


def _bf16_inputs(d, seed=10):
    """bf16 q (scaled in fp32, then rounded), k, v as float32 tensors of their
    exact values, fp32 dO, the mask of slide 1 past key 250, and the row
    statistics of the plain forward."""
    b, h, n = 2, 4, 384
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)
                                * scale).bfloat16().float()
               for scale in (d**-0.5, 1.0, 1.0))
    do = _t(rng.normal(size=(b, h, n, d)))
    mask = np.arange(n)[None, :] < np.array([n, 250])[:, None]
    bias = _t(np.where(mask, 0.0, NEG_INF))
    o, lse = flash_attention_reference(q, k, v, bias)
    return q, k, v, mask, bias, do, lse, (do * o).sum(-1)


def _bf16_pass_model(q, k, v, bias, do, lse, delta, drop=None):
    """K2/K3's bf16 entries' arithmetic: S = Q·Kᵀ as exact products of bf16
    values summed in fp32 (one bf16 pass), the products with one bf16
    operand by :func:`_mm_2xtf32` (``drop``: that one by
    :func:`_mm_big_only`), Pᵀ·dO in 3xTF32.  Returns (dq, dk, dv)."""
    mm = {name: _mm_big_only if name == drop else _mm_2xtf32 for name in TWO_PASS_PRODUCTS}
    p = torch.exp(q @ k.transpose(-1, -2) + bias[:, None, None, :] - lse[..., None])
    ds = p * (mm["dO·Vᵀ"](do, v.transpose(-1, -2)) - delta[..., None])
    return (mm["dS·K"](ds, k), mm["dSᵀ·Q"](ds.transpose(-1, -2), q),
            _mm_3xtf32(p.transpose(-1, -2), do))


def _errs_vs_jax(got, q, k, v, mask, do, lse, delta):
    """Norm-wise relative distance of each of (dq, dk, dv) from imp_tpu's
    flash_attention_partial_bwd at mxu_precision fp32 on bf16 q, k, v."""
    jq, jk, jv = (jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    want = jflash.flash_attention_partial_bwd(
        jq, jk, jv, jnp.asarray(mask), jnp.asarray(do.numpy()), jnp.asarray(lse.numpy()),
        jnp.asarray(delta.numpy()), mxu_precision="fp32")
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        errs[name] = np.abs(g.numpy() - w).max() / np.abs(w).max()
    return errs


@pytest.mark.parametrize("d", [32, 64])
def test_bf16_pass_model_of_the_backward(d):
    """The numerics of K2/K3's bf16 entries modelled on the CPU
    (:func:`_bf16_pass_model`: Q·Kᵀ in one bf16 pass, dO·Vᵀ, dS·K and
    dSᵀ·Q in two TF32 passes, Pᵀ·dO in 3xTF32) stay within 1e-5 of the JAX
    backward on the same bf16 q, k, v (norm-wise; 384 keys, slide 1 masked
    past key 250).  Like the 3xTF32 model above, it documents the route and
    guards no kernel: the kernels are held by the card gates."""
    q, k, v, mask, bias, do, lse, delta = _bf16_inputs(d)
    errs = _errs_vs_jax(_bf16_pass_model(q, k, v, bias, do, lse, delta),
                        q, k, v, mask, do, lse, delta)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("product", TWO_PASS_PRODUCTS)
def test_bf16_pass_model_needs_both_passes(product):
    """Dropping the fp32 operand's small pass in any one of the two-pass
    products of :func:`_bf16_pass_model` leaves a gradient past the
    kernels' 1e-4 gate: both passes are needed."""
    q, k, v, mask, bias, do, lse, delta = _bf16_inputs(64)
    errs = _errs_vs_jax(_bf16_pass_model(q, k, v, bias, do, lse, delta, drop=product),
                        q, k, v, mask, do, lse, delta)
    assert max(errs.values()) > 1e-4, errs


def _flash_fwd_model(q, k, v, bias, mm, tile=64):
    """K1's algorithm on the CPU: key tiles of ``tile`` swept with an online
    softmax, both products by ``mm``, each tile's part of O added to O in
    fp32 (o * alpha + part), fully masked tiles skipped in slides that have
    a valid key, and keys past Nk zero with bias -inf (what the kernel's
    cp.async zero-fill and its explicit bias give).  Returns (O, lse, the
    tiles swept per slide)."""
    b, h, n, _ = q.shape
    nk = k.shape[2]
    nt = -(-nk // tile)
    pad = nt * tile - nk
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    bias = torch.cat([bias, torch.full((b, pad), float("-inf"))], dim=1)
    valid = bias > -1e29
    any_key = valid.any(dim=1)
    m = torch.full((b, h, n), float("-inf"))
    l = torch.zeros(b, h, n)
    o = torch.zeros_like(q)
    swept = torch.zeros(b, dtype=torch.int64)
    for t in range(nt):
        keys = slice(t * tile, (t + 1) * tile)
        live = valid[:, keys].any(dim=1) | ~any_key
        s = mm(q, k[:, :, keys].transpose(-1, -2)) + bias[:, None, None, keys]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[..., None] + mm(p, v[:, :, keys])
        sel = live[:, None, None]
        m, l = torch.where(sel, m_new, m), torch.where(sel, l_new, l)
        o = torch.where(sel[..., None], o_new, o)
        swept += live
    return o / l[..., None], m + torch.log(l), swept


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_split_model_of_the_forward(passes):
    """The numerics and masking of the Hopper K1 modelled on the CPU
    (:func:`_flash_fwd_model`): with every product in 3xTF32, O on every
    slide and lse on slides with a valid key stay within 1e-5 of JAX's
    ``flash_attention`` (absolute, as K1's card gate measures), while one
    TF32 pass per product does not stay within that 1e-4 gate.  Slide 0 alternates valid and
    masked 64-key tiles, with one valid key alone in the masked, ragged
    last tile (keys 192..199 of 200); slide 1 has no valid key (the mean of
    V over its 200 true keys).  Like the backward's model, this documents
    the route and rehearses the skip and edge semantics; the kernel itself
    is held by the 1e-4 card gates (``chip_smoke.py`` and
    ``test_flash_kernel_matches_plain_on_card``)."""
    b, h, n, d = 2, 4, 200, 64
    rng = np.random.default_rng(12)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32) * d**-0.5
    k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(2))
    mask = np.zeros((b, n), dtype=bool)
    mask[0] = (np.arange(n) // 64) % 2 == 0
    mask[0, 197] = True
    bias = _t(np.where(mask, 0.0, NEG_INF))
    want_o = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale=1.0))
    _, want_lse = jflash.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    want_lse = np.asarray(want_lse)[:1]  # lse only where the slide has a valid key
    mm = _mm_3xtf32 if passes == 3 else _mm_1xtf32
    o, lse, swept = _flash_fwd_model(_t(q), _t(k), _t(v), bias, mm)
    assert swept.tolist() == [3, 4]  # tile 1 of slide 0 skipped; slide 1 sweeps all
    errs = {"o": np.abs(o.numpy() - want_o).max(),
            "lse": np.abs(lse[:1].numpy() - want_lse).max()}
    if passes == 3:
        assert max(errs.values()) <= 1e-5, errs
    else:
        assert min(errs.values()) > 1e-4, errs
