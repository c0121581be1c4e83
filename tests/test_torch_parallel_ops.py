"""The chunk forms of flash attention that ring attention runs, in one
process on the CPU, against ``imp_tpu/ops/flash_attention.py``'s
``flash_attention_partial`` and ``flash_attention_partial_bwd`` (their
off-TPU branches) and its ``flash_attention``.

Keys split into 4 chunks; slide 1's last chunk has no valid key (on the
card, K1–K3 run the same contract: ``chip_smoke.py``'s
``kernel_flash_partial``).

* the partial forward: O and lse of every chunk with a valid key to
  1e-5; a row with no valid key in its chunk gets lse = -1e30 (JAX's
  value; the port's O there is the chunk's mean V, JAX's CPU branch the
  sum, and the merge weighs either by exactly 0);
* the partial backward with the global lse and delta, chunk by chunk, to
  1e-5;
* the logsumexp merge of the 4 chunks (``ring_hop_forward``) and the
  per-chunk backward (``ring_hop_backward``: dq summed, dk and dv
  concatenated) against JAX ``flash_attention`` and its ``jax.grad``, to
  1e-5;
* the hazard: a chunk with no valid key under a finite global lse gives
  P = 0, so its dk, dv and dq part are exactly 0;
* ``ring_self_attention`` on an axis of one rank equals flash attention,
  forward and backward; ``mxu_precision="bf16"`` is refused;
* one process is a 1 x 1 mesh whose batch layout keeps every row and
  token; what JAX refuses on a mesh (batch statistics under sp, ``--tp``
  on a world it does not divide) raises here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imp_tpu.ops.flash_attention import flash_attention as jax_flash
from imp_tpu.ops.flash_attention import flash_attention_partial as jax_partial
from imp_tpu.ops.flash_attention import flash_attention_partial_bwd as jax_partial_bwd
from imp_torch.ops import flash_attention as fa
from imp_torch.parallel import LOCAL
from imp_torch.parallel import sequence as S

B, H, N, CHUNKS = 2, 2, 96, 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, N, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, N), bool)
    mask[0, rng.random(N) < 0.3] = False  # ragged
    mask[1, (CHUNKS - 1) * N // CHUNKS:] = False  # slide 1's last chunk: no valid key
    return q * d**-0.5, k, v, do, mask


def _chunks(a, axis):
    return np.split(a, CHUNKS, axis=axis)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", params=[32, 64], ids=lambda d: f"d{d}")
def case(request):
    d = request.param
    q, k, v, do, mask = _inputs(d)
    # JAX: the whole attention (q unscaled by flash_attention's own scale=1)
    # and its gradient
    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, mask=jnp.asarray(mask), scale=1.0)
        return jnp.sum(o * do), o

    (_, o), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) + np.where(mask, 0.0, -1e30)[:, None, None, :]
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    delta = (do * np.asarray(o)).sum(-1)
    return dict(d=d, q=q, k=k, v=v, do=do, mask=mask, o=np.asarray(o),
                grads=[np.asarray(g) for g in grads], lse=lse.astype(np.float32),
                delta=delta.astype(np.float32))


def test_partial_forward_matches_jax(case):
    q = case["q"]
    for c, (k, v, m) in enumerate(zip(_chunks(case["k"], 2), _chunks(case["v"], 2),
                                      _chunks(case["mask"], 1))):
        jo, jl = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m))
        o, lse = fa.flash_attention_partial(_t(q), _t(k), _t(v), _t(m))
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=TOL, atol=TOL,
                                   err_msg=f"lse chunk {c}")
        has_key = m.any(axis=1)
        np.testing.assert_allclose(o.numpy()[has_key], np.asarray(jo)[has_key], rtol=TOL,
                                   atol=TOL, err_msg=f"O chunk {c}")
        if not has_key.all():  # the kernel's contract: the chunk's mean V
            np.testing.assert_allclose(o.numpy()[~has_key],
                                       np.broadcast_to(v[~has_key].mean(axis=2, keepdims=True),
                                                       o.numpy()[~has_key].shape),
                                       rtol=TOL, atol=TOL)
            assert np.all(lse.numpy()[~has_key] == np.float32(-1e30))


def test_partial_backward_with_global_statistics_matches_jax(case):
    q, do, lse, delta = case["q"], case["do"], case["lse"], case["delta"]
    for c, (k, v, m) in enumerate(zip(_chunks(case["k"], 2), _chunks(case["v"], 2),
                                      _chunks(case["mask"], 1))):
        want = jax_partial_bwd(*(jnp.asarray(a) for a in (q, k, v, m, do, lse, delta)))
        got = fa.flash_attention_partial_bwd(*(_t(a) for a in (q, k, v, m, do, lse, delta)))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} chunk {c}")


def test_merge_of_four_chunks_matches_jax_attention_and_gradient(case):
    q = _t(case["q"])
    o = torch.zeros(q.shape)
    lse = torch.full(q.shape[:3], float("-inf"))
    chunks = list(zip(_chunks(case["k"], 2), _chunks(case["v"], 2), _chunks(case["mask"], 1)))
    for k, v, m in chunks:
        o, lse = S.ring_hop_forward(q, _t(k), _t(v), _t(m), o, lse)
    np.testing.assert_allclose(o.numpy(), case["o"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), case["lse"], rtol=TOL, atol=TOL)
    do = _t(case["do"])
    delta = (do * o).sum(-1)
    dq = torch.zeros(q.shape)
    dks, dvs = [], []
    for k, v, m in chunks:
        dq_t, dk, dv = S.ring_hop_backward(q, _t(k), _t(v), _t(m), do, lse, delta)
        dq, dks, dvs = dq + dq_t, dks + [dk], dvs + [dv]
    for name, g, w in zip(("dq", "dk", "dv"), (dq, torch.cat(dks, 2), torch.cat(dvs, 2)),
                          case["grads"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


def test_chunk_without_a_valid_key_gives_exactly_zero_under_a_global_lse(case):
    q, do, lse, delta = (_t(case[n]) for n in ("q", "do", "lse", "delta"))
    k, v, m = (_chunks(case[n], a)[-1] for n, a in (("k", 2), ("v", 2), ("mask", 1)))
    assert not m[1].any() and np.isfinite(case["lse"][1]).all()
    bias = torch.where(_t(m), 0.0, fa.NEG_INF)
    p, ds = fa._bwd_p_ds(q, _t(k), _t(v), bias, do, lse, delta)
    assert torch.count_nonzero(p[1]) == 0 and torch.count_nonzero(ds[1]) == 0
    dq, dk, dv = fa.flash_attention_partial_bwd(q, _t(k), _t(v), _t(m), do, lse, delta)
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert torch.count_nonzero(g[1]) == 0, name  # exactly 0, not merely small
    assert torch.count_nonzero(dk[0]) > 0  # slide 0's chunk has keys: a real gradient


def test_ring_self_attention_on_one_rank_is_flash_attention(case):
    d = case["d"]
    q, k, v = (_t(case[n] * (d**0.5 if n == "q" else 1.0)).requires_grad_() for n in "qkv")
    mask, do = _t(case["mask"]), _t(case["do"])
    o = S.ring_self_attention(q, k, v, mask, axis=LOCAL)
    got = torch.autograd.grad((o * do).sum(), (q, k, v))
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o2 = fa.flash_attention(q2, k2, v2, mask)
    want = torch.autograd.grad((o2 * do).sum(), (q2, k2, v2))
    torch.testing.assert_close(o, o2, rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_only_fp32_products_are_ported(case):
    q, k, v, m = (_t(case[n]) for n in ("q", "k", "v", "mask"))
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_attention_partial(q, k, v, m, mxu_precision="bf16")
    with pytest.raises(ValueError, match="fp32"):
        S.ring_self_attention(q, k, v, m, axis=LOCAL, mxu_precision="bf16")


def test_one_process_is_the_world_of_one():
    """Without a process group the mesh is 1 x 1, every collective the
    identity, and a batch keeps all its rows and tokens."""
    from imp_torch.engine.trainer import REPLICATED_KEYS, SEQ_SHARDED_KEYS, pad_ragged_dim0
    from imp_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(("data", "seq"), (-1, 1), "cpu")
    assert mesh.shape == {"data": 1, "seq": 1, "model": 1, "pipe": 1} and mesh.size == 1
    batch = {"img": np.ones((3, 8, 2), np.float32), "omic_means": np.zeros(5, np.float32)}
    out = shard_batch(pad_ragged_dim0(batch, mesh.data.size), mesh, SEQ_SHARDED_KEYS,
                      REPLICATED_KEYS)
    assert out["img"].shape == (3, 8, 2) and out["omic_means"].shape == (5,)
    padded = pad_ragged_dim0(batch, 2)  # wrap-pad, as JAX pads for its data axis
    assert padded["img"].shape[0] == 4 and padded["omic_means"].shape == (5,)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(("data", "seq"), (1, 2))


def test_unported_parallel_options_raise_the_a8_deferral():
    """ROADMAP item 8 is done: what still raises is what JAX refuses too.
    An axis outside ``(data, seq, model, pipe)``; ``--tp`` on a world it
    does not divide (JAX's ``SystemExit``); a net with batch statistics
    under sequence parallelism (JAX's assertion in ``imp_tpu/engine/
    trainer.py``); ``mxu_precision="bf16"`` has its own test above."""
    from types import SimpleNamespace

    from imp_torch.engine.trainer import TrainerBase
    from imp_torch.parallel import make_mesh
    from imp_torch.tools import clip_feature

    with pytest.raises(ValueError, match="'tensor' not in"):
        make_mesh(("data", "tensor"), (1, 1))
    with pytest.raises(SystemExit, match="--tp 2 does not divide 1 devices"):
        clip_feature.main(["--src", "x", "--dst", "y", "--random-weights", "--tp", "2",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        clip_feature.main(["--src", "x", "--dst", "y", "--tp", "2", "--pp", "2"])
    on_mesh = SimpleNamespace(mesh=SimpleNamespace(size=2), sp_axis=object(),
                              cdtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mutable collections"):
        TrainerBase.check_mesh(on_mesh, torch.nn.BatchNorm1d(2))
