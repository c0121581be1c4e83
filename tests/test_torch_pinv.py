"""The fused Newton-Schulz pseudo-inverse of the PyTorch port (K6/K7's plain
versions, the autograd Function, the fused mode of ``moore_penrose_pinv``
and the Nyström layers that run it) against ``imp_tpu`` on the CPU.

The JAX side runs the TPU kernel bodies themselves: ``_fwd_call`` and
``_bwd_call`` of ``imp_tpu/ops/pinv_kernel.py`` go through Pallas in
interpret mode, by patching ``jax.experimental.pallas.pallas_call`` to pass
``interpret=True`` inside each test (nothing in ``imp_tpu`` changes).
Inputs are softmax rows of seeded scores, conditioned like a Nyström
``attn2``.

Tolerances: float32 on both sides with other summation orders.  The
iteration amplifies gradients into the thousands, so every gradient is
held to 1e-4 of the largest reference value (``_close``); forward values,
~1e-2 at most, to 1e-5 of theirs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import imp_tpu.ops.attention as jattn
import imp_tpu.ops.pinv_kernel as jpk
from imp_torch import kernels
from imp_torch.convert import _torch_key
import imp_torch.ops.attention as tattn
from imp_torch.ops.attention import NystromAttention, TransLayer, moore_penrose_pinv
from imp_torch.ops.pinv import (
    PinvNewtonSchulz,
    norm_scalar,
    pinv_bwd_reference,
    pinv_fwd_reference,
    pinv_newton_schulz,
)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def interpret(monkeypatch):
    """Pallas calls run in interpret mode for the test (JAX on the CPU)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _attn_like(g, m, seed=0):
    s = np.random.default_rng(seed).normal(size=(g, m, m)).astype(np.float32)
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _untied(g, m, seed):
    """Softmax rows, each scaled by its own factor 1 + k/1000: one row sum
    is the largest by far more than rounding, so both frameworks pick the
    same maximum (a softmax's row sums all round near 1, and which of them
    tie is up to the summation order)."""
    scale = 1.0 + 1e-3 * np.random.default_rng(seed).permutation(g * m).reshape(g, m, 1)
    return (_attn_like(g, m, seed) * scale).astype(np.float32)


def _tied(g, m):
    """Circulant matrices whose every row and column sums to the same value
    exactly (entries are multiples of 1/1024): the normaliser's two maxima
    each tie over all g·m of them."""
    v = ((np.arange(m) * 37) % 7 + 1).astype(np.float32) / 1024.0
    idx = (np.arange(m)[None, :] - np.arange(m)[:, None]) % m
    return np.stack([v[(idx + b) % m] for b in range(g)]).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


SHAPES = [(2, 128), (4, 128), (2, 256)]


@pytest.mark.parametrize("g,m", SHAPES)
def test_plain_k6_matches_the_tpu_kernel_body_and_the_chain(g, m, interpret):
    x = _attn_like(g, m)
    c = jpk._norm_scalar(jnp.asarray(x))
    want = jpk._fwd_call(jnp.asarray(x), c, 6)
    got = pinv_fwd_reference(torch.from_numpy(x), torch.tensor(float(c)))
    _close(got, want, FWD_TOL, "vs _fwd_call")
    _close(got, jattn.moore_penrose_pinv(jnp.asarray(x)), FWD_TOL, "vs the JAX chain")


@pytest.mark.parametrize("g,m", SHAPES)
def test_plain_k7_matches_the_tpu_kernel_body(g, m, interpret):
    x = _attn_like(g, m, seed=1)
    g_out = np.random.default_rng(2).normal(size=(g, m, m)).astype(np.float32)
    c = jpk._norm_scalar(jnp.asarray(x))
    want_dx, want_dcp = jpk._bwd_call(jnp.asarray(x), c, jnp.asarray(g_out), 6)
    dx, dcp = pinv_bwd_reference(torch.from_numpy(x), torch.tensor(float(c)),
                                 torch.from_numpy(g_out))
    assert np.abs(np.asarray(want_dx)).max() > 100  # the amplified regime
    _close(dx, want_dx, GRAD_TOL, "dx")
    _close(dcp, np.asarray(want_dcp)[:, 0], GRAD_TOL, "dcp")


@pytest.mark.parametrize("tied", [False, True])
def test_fused_mode_gradient_matches_jax(tied, interpret):
    """``moore_penrose_pinv(mode="fused")`` through the autograd Function
    (the normaliser's max differentiated by torch, outside it) against
    ``jax.grad`` of the Pallas ``pinv_newton_schulz`` and of the JAX chain;
    with exact ties in both maxima, whose gradient both frameworks split
    evenly."""
    g, m = 2, 128
    x = _tied(g, m) if tied else _untied(g, m, seed=3)
    w = np.random.default_rng(4).normal(size=(g, m, m)).astype(np.float32)
    if tied:
        sums = np.abs(x).sum(axis=-1), np.abs(x).sum(axis=-2)
        assert all((s == s.max()).all() for s in sums)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want_kernel = jax.jit(jax.grad(lambda a: jnp.sum(jpk.pinv_newton_schulz(a) * jw)))(jx)
    want_chain = jax.jit(jax.grad(lambda a: jnp.sum(jattn.moore_penrose_pinv(a) * jw)))(jx)

    tx = torch.from_numpy(x).requires_grad_()
    z = moore_penrose_pinv(tx, 6, mode="fused")
    (got,) = torch.autograd.grad((z * torch.from_numpy(w)).sum(), tx)
    _close(z.detach(), jpk.pinv_newton_schulz(jx), FWD_TOL, "forward")
    _close(got, want_kernel, GRAD_TOL, "vs the Pallas kernel's custom VJP")
    _close(got, want_chain, GRAD_TOL, "vs jax.grad of the chain")
    if not tied:  # the normaliser's own path is in it: without it the gradient differs
        c = norm_scalar(torch.from_numpy(x))
        no_c = torch.autograd.grad((PinvNewtonSchulz.apply(tx, c, 6) * torch.from_numpy(w)).sum(),
                                   tx)[0]
        assert (np.abs(no_c.numpy() - np.asarray(want_chain)).max()
                > 10 * GRAD_TOL * np.abs(want_chain).max())
    # under no_grad the Function gives the same values
    with torch.no_grad():
        again = pinv_newton_schulz(torch.from_numpy(x))
    assert torch.equal(again, z.detach())


def test_fused_mode_gate(monkeypatch):
    """Only square, m % 128 == 0, m <= 512 inputs take the Function; others
    take the chain (which, as in JAX, has no non-square case).  CPU tensors
    run the plain versions and launch nothing."""
    calls = []
    real = tattn.pinv_newton_schulz
    monkeypatch.setattr(tattn, "pinv_newton_schulz",
                        lambda x, iters, batch_axis: calls.append(tuple(x.shape))
                        or real(x, iters, batch_axis))
    before = kernels.launches()
    for m in (64, 640):
        x = torch.from_numpy(_attn_like(2, m))
        assert torch.equal(moore_penrose_pinv(x, 6, mode="fused"), moore_penrose_pinv(x, 6))
    with pytest.raises(RuntimeError):
        moore_penrose_pinv(torch.from_numpy(_attn_like(2, 128))[:, :, :96], 6, mode="fused")
    assert calls == []
    x = torch.from_numpy(_attn_like(3, 256).reshape(1, 3, 256, 256))
    moore_penrose_pinv(x, 6, mode="fused")
    assert calls == [(1, 3, 256, 256)] and kernels.launches() == before
    with pytest.raises(ValueError, match="pinv mode"):
        moore_penrose_pinv(x, 6, mode="pallas")
    with pytest.raises(ValueError, match="pinv_mode"):
        TransLayer(256, pinv_mode="xla")


def _load(module, variables):
    sd = {}
    for key, value in flatten_dict(variables).items():
        tkey, transpose = _torch_key("/".join(key))
        arr = np.asarray(value, np.float32)
        sd[tkey] = torch.tensor(arr.T if transpose else arr)
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("layer,n,masked", [
    ("nystrom", 7, False),  # 7 tokens pad to the 128 landmarks: the l == 1 branch
    ("nystrom", 200, True),  # 256 padded tokens, 2 per landmark, a ragged mask
    ("translayer", 13, False),
    ("translayer", 200, True),
])
def test_nystrom_layers_in_fused_mode_match_jax(layer, n, masked, monkeypatch):
    """NystromAttention and TransLayer at dim 256 (128 landmarks, 8 heads of
    32) with the fused pseudo-inverse against JAX's Nyström layers (their
    chain on the CPU) on JAX-initialised weights: output, input gradient and
    every parameter gradient."""
    dim, b = 256, 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    w = rng.normal(size=(b, n, dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, n // 2 + 3])[:, None] if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    if layer == "nystrom":
        jmod = jattn.NystromAttention(dim=dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2)
        tmod = NystromAttention(dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2,
                                pinv_mode="fused")
    else:
        jmod = jattn.TransLayer(dim=dim, dropout=0.0, impl="nystrom")
        tmod = TransLayer(dim, dropout=0.0, pinv_mode="fused")
    variables = jax.jit(lambda xx: jmod.init(jax.random.PRNGKey(0), xx, mask=jmask))(jnp.asarray(x))

    def jloss(params, xx):
        out = jmod.apply(params, xx, mask=jmask)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want_out), (want_p, want_x) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(variables, jnp.asarray(x))
    _load(tmod, variables)
    calls = []
    real = tattn.pinv_newton_schulz
    monkeypatch.setattr(tattn, "pinv_newton_schulz",
                        lambda a, iters, batch_axis: calls.append(tuple(a.shape))
                        or real(a, iters, batch_axis))
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx, mask=None if mask is None else torch.from_numpy(mask))
    assert calls == [(b, 8, dim // 2, dim // 2)]  # one [B, H, m, m] pinv, fused
    names, params = zip(*tmod.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tx,) + params)
    _close(out.detach(), want_out, FWD_TOL, "output")
    _close(got[0], want_x, GRAD_TOL, "input gradient")
    for key, value in flatten_dict(want_p).items():
        tkey, transpose = _torch_key("/".join(key))
        g = got[1 + names.index(tkey)].numpy()
        _close(g.T if transpose else g, value, GRAD_TOL, tkey)


def _tf32(x, nearest=True):
    """``x`` (float32) cut to TF32's 10 mantissa bits by integer bit
    operations: rounded to nearest, ties away from zero (the kernels' split),
    or truncated (what the tensor core reads of an fp32 operand)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _slice_products(passes):
    """a @ b as K6/K7 form every band product: 16-deep k-slices, each
    slice's part formed apart (3xTF32, big.small + small.big + big.big with
    big = tf32(x) and small = x - big truncated; or one TF32 pass) and added
    to the sum in fp32."""
    def mm(a, b):
        out = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for k0 in range(0, a.shape[-1], 16):
            sa, sb = a[..., k0:k0 + 16], b[..., k0:k0 + 16, :]
            ab, bb = _tf32(sa), _tf32(sb)
            part = ab @ bb
            if passes == 3:
                part = ab @ _tf32(sb - bb, nearest=False) + _tf32(sa - ab, nearest=False) @ bb + part
            out = out + part
        return out
    return mm


def _route_model(x, c, g_out, mm, iters=6):
    """K6's and K7's chains in the kernels' order, every product by ``mm``:
    (z, dx, dcp)."""
    eye = torch.eye(x.shape[-1])

    def step(z):
        y = mm(x, z)
        t1 = 7.0 * eye - y
        t3 = 15.0 * eye - mm(y, t1)
        m_ = 13.0 * eye - mm(y, t3)
        return 0.25 * mm(z, m_), (y, t1, t3, m_)

    xt = x.transpose(-1, -2)
    zs = [xt / c]
    for _ in range(iters):
        zs.append(step(zs[-1])[0])
    z = zs.pop()
    dz, dx = g_out, torch.zeros_like(x)
    for zi in reversed(zs):
        _, (y, t1, t3, m_) = step(zi)
        yt = y.transpose(-1, -2)
        dzi = 0.25 * mm(dz, m_.transpose(-1, -2))
        dm = 0.25 * mm(zi.transpose(-1, -2), dz)
        dy = -mm(dm, t3.transpose(-1, -2))
        dt2 = mm(yt, dm)
        dy = dy + mm(dt2, t1.transpose(-1, -2))
        dt1 = mm(yt, dt2)
        dy = dy - dt1
        dx = dx + mm(dy, zi.transpose(-1, -2))
        dz = dzi + mm(xt, dy)
    return z, dx + dz.transpose(-1, -2) / c, -(xt * dz).sum(dim=(-1, -2)) / (c * c)


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_split_model_of_the_kernels(passes, interpret):
    """The numerics the Hopper K6/K7 rest on, modelled on the CPU: the
    forward chain and its hand-written reverse with every product in 16-deep
    slices of 3xTF32, added in fp32, stay within 1e-5 of the TPU kernel
    bodies (norm-wise), while one TF32 pass per product does not stay within
    the kernels' 1e-4 gate.  This documents the choice of route; it calls no
    code of the port, so it guards no kernel: the kernels' precision is held
    by the 1e-4 card gates (``chip_smoke.py`` and
    ``test_pinv_kernels_match_plain_on_card``)."""
    g, m = 2, 128
    x = _attn_like(g, m, seed=3)
    g_out = np.random.default_rng(4).normal(size=(g, m, m)).astype(np.float32)
    c = jpk._norm_scalar(jnp.asarray(x))
    want_z = np.asarray(jpk._fwd_call(jnp.asarray(x), c, 6))
    want_dx, want_dcp = (np.asarray(w) for w in jpk._bwd_call(jnp.asarray(x), c, jnp.asarray(g_out), 6))
    z, dx, dcp = _route_model(torch.from_numpy(x), torch.tensor(float(c)), torch.from_numpy(g_out),
                              _slice_products(passes))
    errs = {name: np.abs(got.numpy() - w).max() / np.abs(w).max()
            for name, got, w in (("z", z, want_z), ("dx", dx, want_dx), ("dcp", dcp, want_dcp[:, 0]))}
    if passes == 3:
        assert max(errs.values()) <= 1e-5, errs
    else:
        assert max(errs.values()) > 1e-4, errs
