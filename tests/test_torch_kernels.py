"""The port's Hopper kernels and the package rules — tests that need no JAX,
so they also run on the card's machine:

    python -m pytest tests/test_torch_kernels.py -q        # CPU: card tests skip
    python -m pytest tests/test_torch_kernels.py -q -m gpu # on a CUDA host

On a CPU tensor a kernel wrapper is its plain version; the ``gpu`` tests
hold the kernel against that plain version on the card (fp32, different
summation order: 1e-4)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imp_torch import kernels
from imp_torch.ops import modularity as M
from imp_torch.ops import pinv
from imp_torch.ops.attention import moore_penrose_pinv
from imp_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    flash_bwd_layout,
    flash_fwd_layout,
)

from chip_smoke import bf16_float64_gate, key_valid

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _qkv(b, h, nq, nk, d, seed=7, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g, device=device) for n in (nq, nk, nk))
    return q * d**-0.5, k, v


def test_flash_reference_lse_and_masked_row():
    q, k, v = _qkv(2, 2, 5, 9, 32)
    valid = torch.tensor([[True] * 6 + [False] * 3, [False] * 9])
    bias = torch.where(valid, 0.0, NEG_INF)
    o, lse = flash_attention_reference(q, k, v, bias)
    s = q @ k.transpose(-1, -2)
    np.testing.assert_allclose(lse[0].numpy(), torch.logsumexp(s[0, :, :, :6], -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    # a row with no valid key stays finite: the mean of V, lse ~ -1e30
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o[1].numpy(), v[1].mean(dim=1, keepdim=True).expand(2, 5, 32).numpy(),
                               rtol=1e-6, atol=1e-6)
    # on CPU tensors the wrapper IS the plain version
    o2, lse2 = flash_attention_fwd(q, k, v, bias)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_wrapper_rejects_bad_input():
    q = torch.zeros(1, 2, 3, 32)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_fwd(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16),
                            torch.zeros(1, 4))
    with pytest.raises(ValueError, match="bias"):
        flash_attention_fwd(q, q, q, torch.zeros(1, 4))
    meta = torch.zeros(1, 2, 3, 32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention_fwd(meta, meta, meta, torch.zeros(1, 3, device="meta"))
    # every kernel has a launch count; nothing was built at import
    assert set(kernels.launches()) == set(kernels.KERNELS)
    assert all((REPO / "imp_torch" / "csrc" / src).is_file()
               for src, _ in kernels.KERNELS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,lengths", [
    (32, 1000, (1000, 731, 0)),
    (64, 1000, (1000, 731, 0)),
    (64, 1000, ("tiles", 0)),  # no prefix: skipped tiles, a lone key; a slide with none
    (32, 7, None),  # a serving shape: one ragged tile, no mask
    (64, 130, (130, 67)),  # N not a multiple of the tile
])
def test_flash_kernel_matches_plain_on_card(d, n, lengths):
    """K1 against its plain version on the card: O on every slide and lse
    on slides with a valid key within 1e-4 (fp32, other summation order),
    one launch per call.  Every N here has a ragged last key tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    b, h = (8, 8) if lengths is None else (len(lengths), 8)
    q, k, v = _qkv(b, h, n, n, d, device="cuda")
    if lengths is None:
        bias = torch.zeros(b, n, device="cuda")
    else:
        tile = flash_fwd_layout(d)["tile"] if "tiles" in lengths else None
        valid = torch.stack([key_valid(n, spec, "cuda", tile) for spec in lengths])
        bias = torch.where(valid, 0.0, NEG_INF)
    has_key = (bias == 0).any(dim=1)
    before = kernels.launches()["flash_fwd"]
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        assert kernels.launches()["flash_fwd"] == before + 1
        o_ref, lse_ref = flash_attention_reference(q, k, v, bias)
    assert (o - o_ref).abs().max().item() < 1e-4
    assert (lse[has_key] - lse_ref[has_key]).abs().max().item() < 1e-4
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # a CUDA tensor never falls back: what the kernel does not take raises
    with pytest.raises(TypeError, match="float32"):
        flash_attention_fwd(q.double(), k.double(), v.double(), bias.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, bias)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh``: editing
    the header that K1 and K2/K3 include names new libraries for both, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (REPO / "imp_torch" / "csrc").iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "tf32x3.cuh").is_file()
    monkeypatch.setattr(kernels, "CSRC", csrc)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    before = {name: kernels.library_path(name) for name in names}
    assert before["flash_bwd_dq"] == before["flash_bwd_dkv"]  # one source, one build
    assert kernels.library_path("flash_fwd") == before["flash_fwd"]  # deterministic
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: kernels.library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)
    assert all(after[name].parent == kernels.BUILD_DIR for name in names)


def _bwd_inputs(b, h, n, d, lengths, device="cpu"):
    """q, k, v, bias, dO and the row statistics of K1's forward; a slide's
    keys are a valid prefix or, for ``"tiles"``, chip_smoke's mask of
    alternate key tiles at the kernels' own tile."""
    q, k, v = _qkv(b, h, n, n, d, seed=9, device=device)
    tile = flash_bwd_layout(d)["tile"] if "tiles" in lengths else None
    valid = torch.stack([key_valid(n, spec, device, tile) for spec in lengths])
    bias = torch.where(valid, 0.0, NEG_INF)
    g = torch.Generator(device=device).manual_seed(10)
    do = torch.randn(b, h, n, d, generator=g, device=device)
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, bias)
    return q, k, v, bias, do, lse, (do * o).sum(-1)


def test_flash_bwd_wrapper_is_the_plain_version_on_cpu_and_rejects_bad_input():
    args = _bwd_inputs(2, 2, 9, 32, (9, 4))
    before = kernels.launches()
    for a, b in zip(flash_attention_bwd(*args), flash_attention_bwd_reference(*args)):
        assert torch.equal(a, b)
    # the autograd Function on CPU tensors: K1's and K2/K3's plain versions
    q, k, v = (t.clone().requires_grad_() for t in args[:3])
    flash_attention(q, k, v, mask=args[3] == 0, scale=1.0).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    assert kernels.launches() == before
    q, k, v, bias, do, lse, delta = args
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, bias, do, lse[:, :, :3], delta)
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_bwd(q, k, v, bias, do[:, :1], lse, delta)


@pytest.mark.gpu
@pytest.mark.parametrize("d,lengths", [(32, (1000, 731, 0)), (64, (1000, 731, 1)),
                                       (64, ("tiles", 401))])
def test_flash_bwd_kernels_match_plain_on_card(d, lengths):
    """K2 and K3 against their plain version on the card (1e-4 relative,
    fp32, other summation order), with a fully masked slide at d = 32
    (both follow exp(s - lse): P = 1 on every key), a mask that is no
    prefix (skipped and zero-filled key tiles beside a lone valid key), and
    the autograd Function launching K1 then K2 and K3 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    args = _bwd_inputs(len(lengths), 8, 1000, d, lengths, device="cuda")
    before = kernels.launches()
    got = flash_attention_bwd(*args)
    ref = flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all() and _rel(a, b) < 1e-4
    # a masked key of a slide with a valid key gets P = 0: dk = dv = 0 exactly
    masked = (args[3] < 0) & (args[3] == 0).any(dim=1, keepdim=True)
    for a in got[1:]:
        assert (a.transpose(1, 2)[masked] == 0).all()
    q, k, v = (t.clone().requires_grad_() for t in args[:3])
    before = kernels.launches()
    out = flash_attention(q, k, v, mask=args[3] == 0, scale=1.0)
    grads = torch.autograd.grad((out * args[4]).sum(), (q, k, v))
    torch.cuda.synchronize()
    after = kernels.launches()
    assert all(after[n] == before[n] + 1 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    for a, b in zip(grads, ref):
        assert _rel(a, b) < 1e-4
    # a CUDA tensor never falls back: what the kernels do not take raises
    with pytest.raises(TypeError, match="float32"):
        flash_attention_bwd(*(t.double() for t in args))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(*(t[..., :16].contiguous() if t.dim() == 4 else t for t in args))


def _bf16_args(d, lengths, device):
    """_bwd_inputs with q, k, v rounded to bf16 (q scaled, as
    ``flash_attention`` scales it in bf16) and the row statistics of their
    float32 copies."""
    q, k, v, bias, do, _, _ = _bwd_inputs(len(lengths), 8, 1000, d, lengths, device=device)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    with torch.no_grad():
        o, lse = flash_attention_reference(q, k, v, bias)
    return q, k, v, bias, do, lse, (do * o).sum(-1)


def test_bf16_operands_take_the_widened_plain_versions_on_cpu():
    """On CPU tensors the bf16 entries' wrappers are the plain versions on
    widened operands: the fp32 wrappers' bits on ``.float()`` copies, fp32
    outputs, no launch; a mix of dtypes raises before any kernel is asked."""
    args = _bf16_args(32, (1000, 731), "cpu")
    wide = tuple(t.float() for t in args[:3]) + args[3:]
    before = kernels.launches()
    for a, b in zip(flash_attention_fwd(*args[:4]), flash_attention_fwd(*wide[:4])):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for a, b in zip(flash_attention_bwd(*args), flash_attention_bwd(*wide)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert kernels.launches() == before
    assert {"flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"} <= set(kernels.KERNELS)


@pytest.mark.gpu
@pytest.mark.parametrize("d,lengths", [(32, (1000, 731, 0)), (64, (1000, 731, 1)),
                                       (64, ("tiles", 401))])
def test_flash_bf16_entries_give_the_f32_entries_bits_on_card(d, lengths):
    """K1-K3's bf16 entries on the card, each launched once and counted
    apart, with fp32 outputs.  K1's widens q, k, v exactly as it stages
    them, so O and lse are the fp32 entry's bits on ``.float()`` copies.
    K2's and K3's keep q, k, v in bf16 and run Q·Kᵀ in one bf16 pass, which
    sums in another order, so dq, dk and dv are held instead (a) within
    1e-4 of the plain versions, (b) to the same bits on a second launch and
    (c) no farther from a float64 replay of the plain version than twice the
    fp32 entries on the ``.float()`` copies.  A bf16 tensor never goes to an
    fp32 entry: a mix of dtypes raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    args = _bf16_args(d, lengths, "cuda")
    wide = tuple(t.float() for t in args[:3]) + args[3:]
    before = kernels.launches()
    with torch.no_grad():
        o, lse = flash_attention_fwd(*args[:4])
        grads = flash_attention_bwd(*args)
        torch.cuda.synchronize()
        after = kernels.launches()
        again = flash_attention_bwd(*args)
        o_w, lse_w = flash_attention_fwd(*wide[:4])
        grads_w = flash_attention_bwd(*wide)
        exact = flash_attention_bwd_reference(*(t.double() for t in args))
        torch.cuda.synchronize()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {
        "flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1, "flash_bwd_dkv_bf16": 1}
    assert torch.equal(o, o_w) and torch.equal(lse, lse_w)
    o_ref, _ = flash_attention_reference(*args[:4])
    assert (o - o_ref).abs().max().item() < 1e-4
    for a, b, r in zip(grads, again, flash_attention_bwd_reference(*args)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert _rel(a, r) < 1e-4
    gate = bf16_float64_gate(grads, grads_w, exact, ("dq", "dk", "dv"))
    assert gate["ok"], gate
    with pytest.raises(TypeError, match="q's dtype"):
        flash_attention_fwd(args[0], wide[1], args[2], args[3])


def _bag(b, n, d, lengths, p_counts, seed=11, device="cpu"):
    """A normalised masked bag and its clipped assignments, as _prepare makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, n, d, generator=g, device=device)
    valid = torch.arange(n, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    cs = [torch.randn(b, p, d, generator=g, device=device) for p in p_counts]
    return M._prepare(cs, x, valid)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("p_counts", [(6, 7), (3, 5), (4,)])
def test_modularity_kernels_match_plain_on_card(p_counts):
    """K4 and K5 against their plain versions on the card: degrees, the
    per-set scalars and dC to 1e-4 relative (fp32, different summation
    order), at lengths that are no multiple of the 64-row tile (1000 and
    731: 16 and 12 valid tiles, an even and an odd half sweep), a fully
    masked slide and a one-token slide; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    norm_x, cs = _bag(4, 1000, 256, (1000, 731, 0, 1), p_counts, device="cuda")
    before = kernels.launches()
    deg = M.deg_cuda(norm_x)
    deg_ref = M.degree_reference(norm_x)
    assert _rel(deg, deg_ref) < 1e-4
    e = deg_ref.sum(dim=1).clamp_min(1e-12)
    s1, q, dcs = M.combined_cuda(norm_x, cs, deg_ref, (1.0 / e).contiguous(), 0.1)
    s1_ref, q_ref, dcs_ref = M.combined_reference(norm_x, cs, deg_ref, 1.0 / e, 0.1)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["modularity_deg"] == before["modularity_deg"] + 1
    assert after["modularity_combined"] == before["modularity_combined"] + 1
    assert _rel(s1, s1_ref) < 1e-4 and _rel(q, q_ref) < 1e-4
    for dc, dc_ref in zip(dcs, dcs_ref):
        assert _rel(dc, dc_ref) < 1e-4
    # the fully masked slide and the one-token slide (no pair) are exactly zero
    for i in (2, 3):
        assert deg[i].abs().max().item() == 0.0
        assert all(dc[i].abs().max().item() == 0.0 for dc in dcs)
    # no atomics: a second launch on the same input gives the same bits
    again = M.combined_cuda(norm_x, cs, deg_ref, (1.0 / e).contiguous(), 0.1)
    assert torch.equal(M.deg_cuda(norm_x), deg)
    assert torch.equal(again[0], s1) and torch.equal(again[1], q)
    assert all(torch.equal(a, b) for a, b in zip(again[2], dcs))
    # a CUDA tensor never falls back: what the kernel does not take raises
    with pytest.raises(TypeError, match="float32"):
        M.deg_cuda(norm_x.double())
    with pytest.raises(ValueError, match="1 or 2 prototype sets"):
        M.combined_cuda(norm_x, cs * 3, deg_ref, 1.0 / e, 0.1)
    with pytest.raises(ValueError, match="1..8"):
        M.combined_cuda(norm_x, [torch.zeros(3, 9, 1000, device="cuda")], deg_ref, 1.0 / e, 0.1)


def test_modularity_wrappers_are_the_plain_versions_on_cpu():
    norm_x, cs = _bag(2, 40, 16, (40, 13), (6, 7))
    before = kernels.launches()
    deg = M.deg_cuda(norm_x)
    assert torch.equal(deg, M.degree_reference(norm_x))
    inv_e = 1.0 / deg.sum(dim=1)
    for a, b in zip(M.combined_cuda(norm_x, cs, deg, inv_e, 0.1)[:2],
                    M.combined_reference(norm_x, cs, deg, inv_e, 0.1)[:2]):
        assert torch.equal(a, b)
    assert kernels.launches() == before  # the plain versions launch nothing


def _attn_like(g, m, seed=13, device="cpu"):
    """Softmax rows of seeded scores: conditioned like a Nyström attn2."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.softmax(torch.randn(g, m, m, generator=gen, device=device), dim=-1)


def _chain_grad(x, g_out):
    xg = x.clone().requires_grad_()
    return torch.autograd.grad((moore_penrose_pinv(xg, 6, mode="chain") * g_out).sum(), xg)[0]


def test_pinv_wrappers_are_the_plain_versions_on_cpu_and_reject_bad_input():
    x = _attn_like(2, 128)
    c = pinv.norm_scalar(x)
    g_out = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(3))
    before = kernels.launches()
    assert torch.equal(pinv.pinv_fwd(x, c), pinv.pinv_fwd_reference(x, c))
    for a, b in zip(pinv.pinv_bwd(x, c, g_out), pinv.pinv_bwd_reference(x, c, g_out)):
        assert torch.equal(a, b)
    assert kernels.launches() == before  # the plain versions launch nothing
    with pytest.raises(ValueError, match=r"\[g, m, m\]"):
        pinv.pinv_fwd(x[:, :64], c)
    with pytest.raises(ValueError, match="one value"):
        pinv.pinv_fwd(x, torch.ones(2))
    with pytest.raises(ValueError, match="g_out"):
        pinv.pinv_bwd(x, c, g_out[:1])


def _near_duplicate_rows(g, m, seed=17, device="cpu"):
    """Softmax rows in pairs whose scores differ by 1e-3: x is close to rank
    m / 2, far worse conditioned than :func:`_attn_like`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.randn(g, m, m, generator=gen, device=device)
    s[:, 1::2] = s[:, 0::2] + 1e-3 * torch.randn(g, m // 2, m, generator=gen, device=device)
    return torch.softmax(s, dim=-1)


_PINV_INPUTS = {"attn_like": _attn_like, "near_duplicate_rows": _near_duplicate_rows}


@pytest.mark.gpu
@pytest.mark.parametrize("g,m,inputs", [
    (16, 128, "attn_like"), (64, 128, "attn_like"), (1, 256, "attn_like"),
    (5, 256, "attn_like"), (8, 256, "attn_like"), (3, 384, "attn_like"), (2, 512, "attn_like"),
    (16, 128, "near_duplicate_rows"), (8, 256, "near_duplicate_rows")])
def test_pinv_kernels_match_plain_on_card(g, m, inputs):
    """K6 and K7 against their plain versions on the card (1e-4 relative to
    the largest reference value: fp32, other summation order; the backward
    reaches ~1e3), a second launch of each against the first (bit for bit:
    no atomics), and the autograd Function, through ``moore_penrose_pinv``
    in the fused mode, against autograd through the chain.  (1, 256) is a
    single cluster, (5, 256) an odd count of them;
    ``near_duplicate_rows`` is the ill-conditioned input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true fp32
    x = _PINV_INPUTS[inputs](g, m, device="cuda")
    c = pinv.norm_scalar(x)
    g_out = torch.randn(g, m, m, generator=torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
    before = kernels.launches()
    z = pinv.pinv_fwd(x, c)
    dx, dcp = pinv.pinv_bwd(x, c, g_out)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["pinv_fwd"] == before["pinv_fwd"] + 1
    assert after["pinv_bwd"] == before["pinv_bwd"] + 1
    dx_ref, dcp_ref = pinv.pinv_bwd_reference(x, c, g_out)
    for got, want in ((z, pinv.pinv_fwd_reference(x, c)), (dx, dx_ref), (dcp, dcp_ref)):
        assert torch.isfinite(got).all() and _rel(got, want) < 1e-4
    assert torch.equal(pinv.pinv_fwd(x, c), z)
    dx2, dcp2 = pinv.pinv_bwd(x, c, g_out)
    assert torch.equal(dx2, dx) and torch.equal(dcp2, dcp)
    xg = x.clone().requires_grad_()
    before = kernels.launches()
    grad = torch.autograd.grad((moore_penrose_pinv(xg, 6, mode="fused") * g_out).sum(), xg)[0]
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["pinv_fwd"] == before["pinv_fwd"] + 1
    assert after["pinv_bwd"] == before["pinv_bwd"] + 1
    assert _rel(grad, _chain_grad(x, g_out)) < 1e-4
    # a CUDA tensor never falls back: what the kernels do not take raises
    with pytest.raises(TypeError, match="float32"):
        pinv.pinv_fwd(x.double(), c.double())
    with pytest.raises(ValueError, match="contiguous"):
        pinv.pinv_fwd(x.transpose(1, 2), c)


@pytest.mark.gpu
def test_pinv_fused_gradient_with_a_tied_normaliser_matches_the_chain_on_card():
    """The normaliser's column-sum maximum ties exactly (two equal columns
    in each of two equal matrices): the fused mode's gradient (K6/K7, and
    torch's max outside them splitting dc over the ties) matches autograd
    through the chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    one = _attn_like(1, 128, device="cuda")
    one[..., 0] += 0.5
    one[..., 1] = one[..., 0]
    x = torch.cat([one, one])
    colsums = x.abs().sum(dim=-2)
    assert int((colsums == colsums.max()).sum()) == 4
    g_out = torch.randn(2, 128, 128, generator=torch.Generator(device="cuda").manual_seed(6),
                        device="cuda")
    xg = x.clone().requires_grad_()
    before = kernels.launches()
    grad = torch.autograd.grad((moore_penrose_pinv(xg, 6, mode="fused") * g_out).sum(), xg)[0]
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["pinv_fwd"] == before["pinv_fwd"] + 1
    assert after["pinv_bwd"] == before["pinv_bwd"] + 1
    assert torch.isfinite(grad).all() and _rel(grad, _chain_grad(x, g_out)) < 1e-4


@pytest.mark.gpu
def test_pinv_gate_runs_the_chain_on_card():
    """The fused mode takes the kernels only where JAX takes its kernel
    (square, m % 128 == 0, m <= 512); elsewhere it is the chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    before = kernels.launches()
    for x in (_attn_like(4, 64, device="cuda"), _attn_like(2, 640, device="cuda")):
        got = moore_penrose_pinv(x, 6, mode="fused")
        assert torch.equal(got, moore_penrose_pinv(x, 6, mode="chain"))
    # a non-square input goes to the chain, which (as in JAX) has no such case
    with pytest.raises(RuntimeError):
        moore_penrose_pinv(_attn_like(2, 128, device="cuda")[:, :, :96], 6, mode="fused")
    assert kernels.launches() == before
    with pytest.raises(ValueError, match="m = 64"):
        pinv.pinv_fwd(_attn_like(2, 64, device="cuda"), torch.ones((), device="cuda"))


# ---------------------------------------------------------------------------
# package rules: no JAX anywhere in the port or its smoke script
# ---------------------------------------------------------------------------

#: ``bench`` and ``clip_feature`` are the JAX package's root bench and the
#: module its tools import from ``tools/``: the port has its own of each
_FORBIDDEN = ("jax", "flax", "optax", "triton", "imp_tpu", "bench", "clip_feature")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "imp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in _FORBIDDEN
    ]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'triton', 'imp_tpu', 'yaml', 'pandas', 'h5py'):\n"
        "    sys.modules[m] = None\n"
        "import imp_torch, imp_torch.kernels, imp_torch.convert, imp_torch.serving\n"
        "import imp_torch.models, imp_torch.tools.export_model, imp_torch.tools.serve\n"
        "import imp_torch.engine.mbtrain, imp_torch.tools.train, imp_torch.data\n"
        "import imp_torch.evaluation, imp_torch.native, imp_torch.ops.modularity\n"
        "import imp_torch.engine.baselines, imp_torch.models.nets, imp_torch.ops.blocks\n"
        "import imp_torch.ops.pinv, imp_torch.models.umeml, imp_torch.losses\n"
        "import imp_torch.data.labeling, imp_torch.data.xlsx, imp_torch.ops.extras\n"
        "import imp_torch.tools.kfold, imp_torch.tools.label_gen\n"
        "import imp_torch.tools.generate_test_labels\n"
        "import imp_torch.utils.profiling, imp_torch.tools.bench, imp_torch.tools.ab_step\n"
        "import imp_torch.tools.bench_anatomy, imp_torch.tools.bench_flash\n"
        "import imp_torch.tools.bench_pinv, imp_torch.tools.bench_vit\n"
        "from imp_torch.config import get_cfg_default\n"
        "cfg = get_cfg_default(); cfg.TPU.ATTENTION = 'flash'; cfg.freeze()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
