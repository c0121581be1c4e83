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

Last, a CPU model of the Hopper K4/K5 route (``imp_torch/csrc/modularity.cu``):
the cyclic half sweep of the upper triangle at a 16-row tile, the row side
of each tile plus the transposed column side, the column partials added in
the kernels' fixed order, and every x̂x̂ᵀ product in 3xTF32, held to 1e-5
(norm-wise) against both JAX backends.
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


# ---------------------------------------------------------------------------
# a CPU model of the Hopper route of K4/K5
# ---------------------------------------------------------------------------

MODEL_TILE = 16


def _tf32(x, nearest=True):
    """``x`` (float32) cut to TF32's 10 mantissa bits by integer bit
    operations: rounded to nearest, ties away from zero (the kernels' split),
    or truncated (what the tensor core reads of an fp32 operand)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernels form x̂_I x̂_Jᵀ: big = tf32(x), small = x - big
    (truncated by the tensor core), big.small + small.big + big.big."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab, nearest=False), _tf32(b - bb, nearest=False)
    return ab @ b_s + a_s @ bb + ab @ bb


def _half_sweep(nvb):
    """The column tiles each row tile I sweeps, d = 0 (its diagonal) first:
    J = (I + d) mod nvb up to ``last_step`` of ``modularity.cu``."""
    return [[(i + d) % nvb for d in range((nvb - 1) // 2 + (nvb % 2 == 0 and i < nvb // 2) + 1)]
            for i in range(nvb)]


def _swept(x, sweep, tile, step):
    """Run ``step(I, J, d, a)`` over the sweep on A = relu(x̂_I x̂_Jᵀ) in
    3xTF32 (zero diagonal on J = I); returns {(I, d): column partial}."""
    cols = {}
    for i, js in enumerate(sweep):
        xi = x[i * tile:(i + 1) * tile]
        for d, j in enumerate(js):
            a = torch.relu(_mm_3xtf32(xi, x[j * tile:(j + 1) * tile].T))
            if d == 0:
                a.fill_diagonal_(0.0)
            col = step(i, j, d, a)
            if d:
                cols[i, d] = col
    return cols


def _add_columns(rows, cols, sweep, scale=1.0):
    """Row side plus, per column tile T, its partials in the order of d."""
    nvb = len(sweep)
    out = rows.clone()
    for t in range(nvb):
        for d in range(1, nvb):
            i = (t - d) % nvb
            if d < len(sweep[i]):
                out[..., t, :] = out[..., t, :] + scale * cols[i, d]
    return out


def _modularity_model(norm_x, Cs, temp, tile=MODEL_TILE):
    """K4 then K5 as ``modularity.cu`` computes them: (traces, dCs, deg)."""
    b, n, _ = norm_x.shape
    nb = -(-n // tile)
    pad = nb * tile - n
    xs = torch.nn.functional.pad(norm_x, (0, 0, 0, pad))
    cps = [torch.nn.functional.pad(C, (0, pad)) for C in Cs]
    lens = M._valid_lengths(norm_x).tolist()
    deg = torch.zeros(b, nb, tile)
    for s in range(b):
        sweep = _half_sweep(-(-lens[s] // tile))
        rows = torch.zeros(nb, tile)

        def deg_step(i, j, d, a):
            rows[i] += a.sum(dim=1)
            return a.sum(dim=0)

        cols = _swept(xs[s], sweep, tile, deg_step)
        deg[s, :len(sweep)] = _add_columns(rows, cols, sweep)[:len(sweep)]
    deg = deg.reshape(b, -1)
    e = deg.sum(dim=1).clamp_min(1e-12)
    inv_e, inv_temp = 1.0 / e, 1.0 / temp
    s1 = torch.zeros(len(Cs), b)
    q = torch.zeros(len(Cs), b)
    dcs = [torch.zeros(C.shape[0], C.shape[1], nb, tile) for C in Cs]
    for s in range(b):
        sweep = _half_sweep(-(-lens[s] // tile))
        rows = [torch.zeros(C.shape[1], nb, tile) for C in Cs]
        tiles = lambda v, i: v[..., i * tile:(i + 1) * tile]  # noqa: E731

        def combined_step(i, j, d, a):
            dd = tiles(deg[s], i)[:, None] * tiles(deg[s], j)[None, :]
            amdd = (a - dd * inv_e[s]) * inv_e[s]
            sym = 2.0 if d else 1.0
            col = []
            for k, cp in enumerate(cps):
                ci, cj = tiles(cp[s], i), tiles(cp[s], j)
                best, bp = ci[0][:, None] * cj[0][None, :], torch.zeros(tile, tile, dtype=torch.int64)
                for p in range(1, cp.shape[1]):
                    term = ci[p][:, None] * cj[p][None, :]
                    take = term > best
                    best, bp = torch.where(take, term, best), torch.where(take, p, bp)
                delta = torch.tanh(best * inv_temp)
                s1[k, s] += sym * (a * delta).sum()
                q[k, s] += sym * (delta * dd).sum()
                w = amdd * ((1.0 - delta * delta) * inv_temp)
                for p in range(cp.shape[1]):
                    m = w * (bp == p)
                    rows[k][p, i] += m @ cj[p]
                col.append(torch.stack([(w * (bp == p)).T @ ci[p] for p in range(cp.shape[1])]))
            return col

        cols = _swept(xs[s], sweep, tile, combined_step)
        for k in range(len(Cs)):
            per_set = {key: v[k] for key, v in cols.items()}
            dcs[k][s][:, :len(sweep)] = _add_columns(2.0 * rows[k], per_set, sweep, 2.0)[:, :len(sweep)]
    dcs = [dc.reshape(dc.shape[0], dc.shape[1], -1)[..., :n] for dc in dcs]
    return tuple((s1[k] - q[k] / e) / e for k in range(len(Cs))), dcs, deg[:, :n]


def test_half_sweep_covers_each_tile_pair_once():
    """The kernels' cyclic half sweep: every unordered pair of valid tiles
    once, the diagonal tile first, and every CTA within one tile of the
    others."""
    for nvb in range(1, 14):
        sweep = _half_sweep(nvb)
        pairs = [tuple(sorted((i, j))) for i, js in enumerate(sweep) for j in js]
        assert sorted(pairs) == [(i, j) for i in range(nvb) for j in range(i, nvb)]
        assert all(js[0] == i for i, js in enumerate(sweep))
        assert max(map(len, sweep)) - min(map(len, sweep)) <= 1


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("backend", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("lengths", [(50, 37, 0), (50, 1, 0)], ids=["ragged", "one_token"])
@pytest.mark.parametrize("p_counts", [(6, 7), (3, 5), (4,)])
def test_hopper_route_model_matches_jax(jax_block16, backend, lengths, p_counts):
    """The Hopper route modelled on the CPU (:func:`_modularity_model`):
    degrees, traces and dC within 1e-5 of JAX. N = 50 is no multiple of the
    16-row tile; the slides sweep 4 (even) and 3 (odd) or 1 valid tiles, and
    none. Like the flash models, this calls no kernel: the kernels are held
    by the 1e-4 card gates (``chip_smoke.py``,
    ``test_modularity_kernels_match_plain_on_card``)."""
    x, cs, valid = _inputs(p_counts, seed=13, lengths=lengths)
    nx, Cs = _jax_prepared(x, cs, valid)
    if backend == "scan":
        want_t, want_d = JM._scan_passes(nx, Cs, 0.1)
    else:
        want_t, want_d = JM._pallas_passes(nx, Cs, 0.1, interpret=True)
    norm_x, tCs = M._prepare([torch.from_numpy(c) for c in cs], torch.from_numpy(x),
                             torch.from_numpy(valid))
    got_t, got_d, deg = _modularity_model(norm_x, tCs, 0.1)
    errs = {"deg": _rel(deg, JM._deg_xla(nx))}
    errs.update({f"trace{k}": _rel(g, w) for k, (g, w) in enumerate(zip(got_t, want_t))})
    errs.update({f"dC{k}": _rel(g, w) for k, (g, w) in enumerate(zip(got_d, want_d))})
    assert max(errs.values()) <= 1e-5, errs
    # slides with no pair give exactly zero
    for s in (i for i, m in enumerate(lengths) if m <= 1):
        assert float(deg[s].abs().max()) == 0.0
        assert all(float(d[s].abs().max()) == 0.0 for d in got_d)
