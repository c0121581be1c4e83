"""The port's modularity passes (``imp_torch.ops.modularity``) against the JAX
package on the CPU.

The port's plain passes — what its kernel wrappers K4/K5 run on a CPU tensor
— are held against JAX's ``_scan_passes`` and its Pallas kernels run in
interpret mode (``_pallas_passes(..., interpret=True)``), both with the
JAX block size cut to 16 as ``tests/test_ops.py`` does, so the small bags
span several tiles.  Inputs come from a numpy seed: slides masked to 18, 50
and 0 of 50 tokens, two prototype sets (P = 3 and 5, and the model's 6 and
7).  Then ``compute_modularity_pair``'s value and gradient against
``jax.value_and_grad``, and the pair against the sum of single calls.

Tolerance rtol 1e-4, atol 1e-6: float32 on both sides with different
summation orders (the same bound the JAX package holds its two backends to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imp_tpu.ops import modularity as JM
from imp_torch.ops import modularity as M

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file (the suite runs many workers on a
    small host); the worker's own setting comes back after the file."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def jax_block16():
    saved = JM._BLOCK
    JM._BLOCK = 16
    yield
    JM._BLOCK = saved


def _inputs(p_counts, seed=10, b=3, n=50, d=16, lengths=(18, 50, 0)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    cs = [rng.normal(size=(b, p, d)).astype(np.float32) for p in p_counts]
    valid = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return x, cs, valid


def _jax_prepared(x, cs, valid):
    nx = JM._l2_normalize(jnp.asarray(x), axis=2) * jnp.asarray(valid)[..., None]
    Cs = []
    for c in cs:
        c = jnp.asarray(c)
        nc = c / jnp.maximum(jnp.linalg.norm(c, axis=1, keepdims=True), 1e-12)
        Cs.append(jax.nn.relu(jnp.einsum("bnd,bpd->bpn", nx, nc)))
    return nx, Cs


@pytest.mark.parametrize("backend", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("p_counts", [(3, 5), (6, 7)])
def test_plain_passes_match_jax(jax_block16, backend, p_counts):
    x, cs, valid = _inputs(p_counts)
    nx, Cs = _jax_prepared(x, cs, valid)
    if backend == "scan":
        want_t, want_d = JM._scan_passes(nx, Cs, 0.1)
    else:
        want_t, want_d = JM._pallas_passes(nx, Cs, 0.1, interpret=True)

    norm_x, tCs = M._prepare([torch.from_numpy(c) for c in cs], torch.from_numpy(x),
                             torch.from_numpy(valid))
    np.testing.assert_allclose(norm_x.numpy(), np.asarray(nx), rtol=RTOL, atol=ATOL)
    for tc, jc in zip(tCs, Cs):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    got_t, got_d = M.modularity_passes_reference(norm_x, tCs, 0.1)
    for gt, wt in zip(got_t, want_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=RTOL, atol=ATOL)
    for gd, wd in zip(got_d, want_d):
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)
    # the fully masked slide gives exactly zero, as the padded reference does
    assert float(got_t[0][2]) == 0.0 and float(got_d[1][2].abs().max()) == 0.0
    # on CPU tensors the wrappers are the plain versions
    via_wrappers_t, via_wrappers_d = M.modularity_passes(norm_x, tCs, 0.1)
    for a, b in zip(via_wrappers_t + via_wrappers_d, got_t + got_d):
        assert torch.equal(a, b)


def test_valid_lengths_and_degrees_match_jax():
    x, _, valid = _inputs((3,))
    valid[1, 30:40] = False  # a masked run inside a slide keeps its length
    nx = JM._l2_normalize(jnp.asarray(x), axis=2) * jnp.asarray(valid)[..., None]
    norm_x = M._l2_normalize(torch.from_numpy(x), dim=2) * torch.from_numpy(valid)[..., None]
    np.testing.assert_array_equal(M._valid_lengths(norm_x).numpy(),
                                  np.asarray(JM._valid_lengths(nx)))
    assert M._valid_lengths(norm_x).dtype == torch.int32
    np.testing.assert_allclose(M.degree_reference(norm_x).numpy(),
                               np.asarray(JM._deg_xla(nx)), rtol=RTOL, atol=1e-5)


def test_pair_value_and_gradient_match_jax():
    x, cs, valid = _inputs((6, 7), seed=11, b=2, n=40, d=16, lengths=(23, 40))

    def jax_pair(c1, c2):
        return JM.compute_modularity_pair((c1, c2), jnp.asarray(x), valid=jnp.asarray(valid))

    want, want_g = jax.value_and_grad(jax_pair, argnums=(0, 1))(*map(jnp.asarray, cs))

    tc = [torch.from_numpy(c).requires_grad_() for c in cs]
    tx = torch.from_numpy(x).requires_grad_()
    got = M.compute_modularity_pair(tc, tx, valid=torch.from_numpy(valid))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=RTOL, abs=ATOL)
    for t, w in zip(tc, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert tx.grad is None  # the bag gets no gradient (JAX's stop_gradient)


def test_pair_matches_two_single_calls():
    x, cs, valid = _inputs((6, 7), seed=9, b=2, n=30, d=16, lengths=(21, 30))
    tx, tv = torch.from_numpy(x), torch.from_numpy(valid)
    pair_c = [torch.from_numpy(c).requires_grad_() for c in cs]
    single_c = [torch.from_numpy(c).requires_grad_() for c in cs]
    vp = M.compute_modularity_pair(pair_c, tx, valid=tv)
    vs = sum(M.compute_modularity(c, tx, valid=tv) for c in single_c)
    vp.backward()
    vs.backward()
    assert vp.item() == pytest.approx(vs.item(), rel=1e-5)
    for a, b in zip(pair_c, single_c):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=RTOL, atol=ATOL)
    # and the single call against JAX's
    want = JM.compute_modularity(jnp.asarray(cs[0]), jnp.asarray(x), valid=jnp.asarray(valid))
    got = M.compute_modularity(torch.from_numpy(cs[0]), tx, valid=tv)
    assert got.item() == pytest.approx(float(want), rel=RTOL, abs=ATOL)


def test_backward_scales_the_saved_residual_without_rerunning(monkeypatch):
    x, cs, valid = _inputs((3,), seed=12, b=2, n=20, d=8, lengths=(20, 11))
    norm_x, Cs = M._prepare([torch.from_numpy(cs[0])], torch.from_numpy(x),
                            torch.from_numpy(valid))
    C = Cs[0].detach().requires_grad_()
    (trace,) = M.ModularityTraces.apply(0.1, norm_x, C)
    _, (dc,) = M.modularity_passes_reference(norm_x, [C.detach()], 0.1)
    calls = []
    monkeypatch.setattr(M, "modularity_passes", lambda *a: calls.append(a))
    gt = torch.tensor([2.0, -3.0])
    trace.backward(gt)
    assert not calls
    torch.testing.assert_close(C.grad, gt[:, None, None] * dc)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    meta = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        M.deg_cuda(meta, torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        M.combined_cuda(meta, [torch.zeros(1, 2, 4, device="meta")],
                        torch.zeros(1, 4, device="meta"), torch.zeros(1, device="meta"), 0.1,
                        torch.zeros(1, dtype=torch.int32, device="meta"))
