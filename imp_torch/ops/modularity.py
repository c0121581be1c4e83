"""Graph-modularity clustering loss — the PyTorch counterpart of
``imp_tpu/ops/modularity.py`` (reference ``medmm/modeling/ops/utils.py:178-227``).

The O(N²) reductions over a slide's bag run in two streaming passes:

1. the *degree* pass, deg_i = Σ_{j≠i} relu(x̂_i·x̂_j) over the L2-normalised,
   masked bag: :func:`deg_cuda`, the wrapper of the Hopper kernel K4
   (``imp_torch/csrc/modularity.cu``, replacing the Pallas
   ``_deg_kernel``);
2. the *combined value-and-gradient* pass for K prototype sets sharing the
   bag (the model's ``p_proto`` and ``h_omic``): the per-set scalars s1 and
   q and the prototype cotangent dC: :func:`combined_cuda`, the wrapper of
   K5 (replacing ``_combined_kernel``).

Both kernels sweep the upper triangle of 64 × 64 tiles once and add the
column side of each off-diagonal tile through a workspace of partials,
which the wrapper allocates (:func:`modularity_layout` gives its size) and a
second launch adds in a fixed order: two calls on the same input give the
same bits.  Each wrapper launches its kernels on a CUDA tensor (or raises)
and runs its plain version, :func:`degree_reference` /
:func:`combined_reference`, on a CPU tensor.
:func:`modularity_passes_reference` chains the two plain versions — a
transcription of the JAX ``_scan_passes`` — and :func:`modularity_passes`
chains the wrappers.

:class:`ModularityTraces` is the ``torch.autograd.Function`` of the JAX
``custom_vjp``: its forward returns the traces and saves dC, its backward
is the scale ``gt * dC`` and reruns nothing.  The bag gets no gradient, as
JAX's ``stop_gradient`` gives none.

The reference's prototype normalisation ``F.normalize(c.T, dim=1)`` — each
feature column normalised over the *prototype* axis — is kept (``_prepare``):
it is part of the trained objective.  Masked tokens are zero rows, so they
add nothing and the padded bag gives the loss of the unpadded one.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

_BLOCK = 512  # row block of the plain passes
P_MAX = 8  # prototypes per set the kernel takes (the JAX _P_PAD)


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _valid_lengths(norm_x: torch.Tensor) -> torch.Tensor:
    """Per-slide count covering every non-zero row (masked rows are zero):
    int32 [B]."""
    row = norm_x.abs().sum(dim=2) > 0  # [B, N]
    n = norm_x.shape[1]
    last = n - row.flip(1).to(torch.int32).argmax(dim=1)
    return torch.where(row.any(dim=1), last, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def adjacency(x_rows: torch.Tensor, x_cols: torch.Tensor, r0: int = 0, c0: int = 0) -> torch.Tensor:
    """relu(x̂_I x̂_Jᵀ) for rows starting at global index ``r0`` and columns
    at ``c0``, with a zero diagonal: [B, R, C]."""
    a = torch.relu(x_rows @ x_cols.transpose(1, 2))
    ridx = torch.arange(r0, r0 + x_rows.shape[1], device=a.device)
    cidx = torch.arange(c0, c0 + x_cols.shape[1], device=a.device)
    return a * (ridx[:, None] != cidx[None, :])


def block_degrees(x_rows: torch.Tensor, x_cols: torch.Tensor, r0: int = 0, c0: int = 0) -> torch.Tensor:
    """Each row's degree over the columns ``x_cols`` (global indices as in
    :func:`adjacency`), swept in row blocks: [B, R]."""
    return torch.cat([adjacency(x_rows[:, i:i + _BLOCK], x_cols, r0 + i, c0).sum(dim=2)
                      for i in range(0, x_rows.shape[1], _BLOCK)], dim=1)


def combined_sweep(x_rows, x_cols, deg_rows, deg_cols, inv_e, c_rows, c_cols, temp: float,
                   r0: int = 0, c0: int = 0):
    """The combined pass of the rows ``x_rows`` against the columns
    ``x_cols`` (global indices as in :func:`adjacency`), swept in row
    blocks: per prototype set the partial s1 and q [B] and the rows' dC
    [B, P, R] (the JAX ``main_step`` body)."""
    b, nr = x_rows.shape[:2]
    inv_temp = 1.0 / temp
    ie = inv_e[:, None, None]
    s1 = [x_rows.new_zeros(b) for _ in c_rows]
    q = [x_rows.new_zeros(b) for _ in c_rows]
    dcs = [torch.zeros_like(C) for C in c_rows]
    for i in range(0, nr, _BLOCK):
        j = min(i + _BLOCK, nr)
        a = adjacency(x_rows[:, i:j], x_cols, r0 + i, c0)
        dd = deg_rows[:, i:j, None] * deg_cols[:, None, :]
        a_m_dd = (a - dd * ie) * ie
        for k, (cr, cc) in enumerate(zip(c_rows, c_cols)):
            # running max over prototypes of C[p,I] C[p,J]; the first max wins
            best = cr[:, 0, i:j, None] * cc[:, 0, None, :]
            best_p = torch.zeros_like(best, dtype=torch.int64)
            for p in range(1, cr.shape[1]):
                term = cr[:, p, i:j, None] * cc[:, p, None, :]
                take = term > best
                best = torch.where(take, term, best)
                best_p = torch.where(take, p, best_p)
            delta = torch.tanh(best * inv_temp)
            s1[k] = s1[k] + (a * delta).sum(dim=(1, 2))
            q[k] = q[k] + (delta * dd).sum(dim=(1, 2))
            w = a_m_dd * ((1.0 - delta * delta) * inv_temp)
            for p in range(cr.shape[1]):
                dcs[k][:, p, i:j] = 2.0 * ((w * (best_p == p)) @ cc[:, p, :, None])[..., 0]
    return s1, q, dcs


def degree_reference(norm_x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: deg [B, N]."""
    return block_degrees(norm_x, norm_x)


def combined_reference(
    norm_x: torch.Tensor,
    Cs: Sequence[torch.Tensor],
    deg: torch.Tensor,
    inv_e: torch.Tensor,
    temp: float,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Plain version of K5: (s1 [K, B], q [K, B], dC per set [B, P, N])."""
    s1, q, dcs = combined_sweep(norm_x, norm_x, deg, deg, inv_e, Cs, Cs, temp)
    return torch.stack(s1), torch.stack(q), dcs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _cuda_args(norm_x: torch.Tensor, lengths: Optional[torch.Tensor]):
    if norm_x.device.type != "cuda":
        raise ValueError(f"the modularity passes run on cuda or cpu, not {norm_x.device}")
    if norm_x.dim() != 3:
        raise ValueError("norm_x must be [B, N, D]")
    b, n, d = norm_x.shape
    _check_cuda("norm_x", norm_x, (b, n, d))
    if d % 4:
        raise ValueError(f"feature width {d} must be a multiple of 4 (float4 loads)")
    if lengths is None:
        lengths = _valid_lengths(norm_x)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) or lengths.device != norm_x.device:
        raise ValueError("lengths must be int32 [B] on the bag's device")
    return b, n, d, lengths.contiguous()


def modularity_layout(n: int, d: int, k: int = 1) -> dict:
    """K4/K5's launch layout for a bag of ``n`` rows of width ``d`` and ``k``
    prototype sets, as ``modularity.cu`` sets it: ``tile``, the rows a CTA
    owns and the columns of each swept tile; ``slots``, the column-side
    partials per slide (each one vector of ``tile`` floats per output
    vector: 1 for K4, P0 + P1 for K5); and each kernel's dynamic shared
    memory in bytes.  Builds the kernels' library at first use."""
    from ..kernels import load

    out = [ctypes.c_int() for _ in range(4)]
    err = load("modularity_deg").imp_modularity_layout(n, d, k, *map(ctypes.byref, out))
    if err:
        raise ValueError(f"modularity has no layout for n = {n}, d = {d}, k = {k}: cudaError {err}")
    tile, slots, deg_smem, combined_smem = (v.value for v in out)
    return {"tile": tile, "slots": slots, "modularity_deg": deg_smem,
            "modularity_combined": combined_smem}


def _workspace(b: int, n: int, d: int, k: int, vectors: int, device) -> torch.Tensor:
    """The column-side partials of one launch: [B, slots, vectors, tile]."""
    lay = modularity_layout(n, d, k)
    return torch.empty((b, lay["slots"], vectors, lay["tile"]), dtype=torch.float32, device=device)


def deg_cuda(norm_x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Degrees [B, N] by kernel K4 on CUDA, by the plain version on CPU.
    ``lengths`` (int32 [B]) bounds each slide's non-zero rows; computed from
    the bag when not given."""
    if norm_x.device.type == "cpu":
        return degree_reference(norm_x)
    b, n, d, lengths = _cuda_args(norm_x, lengths)
    from ..kernels import count_launch, load

    lib = load("modularity_deg")
    deg = torch.empty((b, n), dtype=torch.float32, device=norm_x.device)
    work = _workspace(b, n, d, 1, 1, norm_x.device)
    stream = torch.cuda.current_stream(norm_x.device).cuda_stream
    err = lib.imp_modularity_deg_f32(
        norm_x.data_ptr(), lengths.data_ptr(), deg.data_ptr(), work.data_ptr(), b, n, d,
        ctypes.c_void_p(stream),
    )
    if err:
        raise RuntimeError(f"modularity_deg launch failed: cudaError {err}")
    count_launch("modularity_deg")
    return deg


def combined_cuda(
    norm_x: torch.Tensor,
    Cs: Sequence[torch.Tensor],
    deg: torch.Tensor,
    inv_e: torch.Tensor,
    temp: float,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(s1 [K, B], q [K, B], dC per set) by kernel K5 on CUDA, by the plain
    version on CPU.  K is 1 or 2, each set has at most 8 prototypes."""
    if norm_x.device.type == "cpu":
        return combined_reference(norm_x, Cs, deg, inv_e, temp)
    b, n, d, lengths = _cuda_args(norm_x, lengths)
    k = len(Cs)
    if k not in (1, 2):
        raise ValueError(f"the combined kernel takes 1 or 2 prototype sets, got {k}")
    ps = [C.shape[1] for C in Cs]
    if any(not 1 <= p <= P_MAX for p in ps):
        raise ValueError(f"prototype counts {ps} must lie in 1..{P_MAX}")
    for i, C in enumerate(Cs):
        _check_cuda(f"C[{i}]", C, (b, ps[i], n))
    _check_cuda("deg", deg, (b, n))
    _check_cuda("inv_e", inv_e, (b,))
    from ..kernels import count_launch, load

    lib = load("modularity_combined")
    n_tiles = -(-n // 64)
    s1_part = torch.empty((k, b, n_tiles), dtype=torch.float32, device=norm_x.device)
    q_part = torch.empty_like(s1_part)
    dcs = [torch.empty_like(C) for C in Cs]
    c1, dc1 = (Cs[1], dcs[1]) if k == 2 else (Cs[0], dcs[0])
    work = _workspace(b, n, d, k, sum(ps), norm_x.device)
    stream = torch.cuda.current_stream(norm_x.device).cuda_stream
    err = lib.imp_modularity_combined_f32(
        norm_x.data_ptr(), lengths.data_ptr(), Cs[0].data_ptr(), c1.data_ptr(),
        deg.data_ptr(), inv_e.data_ptr(), s1_part.data_ptr(), q_part.data_ptr(),
        dcs[0].data_ptr(), dc1.data_ptr(), work.data_ptr(), b, n, d, k, ps[0], ps[-1],
        ctypes.c_float(1.0 / temp), ctypes.c_void_p(stream),
    )
    if err:
        raise RuntimeError(f"modularity_combined launch failed: cudaError {err}")
    count_launch("modularity_combined")
    return s1_part.sum(dim=2), q_part.sum(dim=2), dcs


# ---------------------------------------------------------------------------
# the two passes and the custom gradient
# ---------------------------------------------------------------------------


def _traces(s1, q, e):
    return tuple((s1[k] - q[k] / e) / e for k in range(s1.shape[0]))


def modularity_passes(norm_x, Cs, temp):
    """(traces, dCs) through the kernel wrappers: K4, then K5."""
    lengths = _valid_lengths(norm_x) if norm_x.device.type == "cuda" else None
    deg = deg_cuda(norm_x, lengths)
    e = deg.sum(dim=1).clamp_min(1e-12)
    s1, q, dcs = combined_cuda(norm_x, Cs, deg, (1.0 / e).contiguous(), temp, lengths)
    return _traces(s1, q, e), tuple(dcs)


def modularity_passes_reference(norm_x, Cs, temp):
    """(traces, dCs) through the plain versions (the JAX ``_scan_passes``)."""
    deg = degree_reference(norm_x)
    e = deg.sum(dim=1).clamp_min(1e-12)
    s1, q, dcs = combined_reference(norm_x, Cs, deg, 1.0 / e, temp)
    return _traces(s1, q, e), tuple(dcs)


class ModularityTraces(torch.autograd.Function):
    """trace_b((W/e)·δ_k) per prototype set k, sharing the adjacency work.

    Inputs: ``temp``, the normalised masked bag ``norm_x`` [B, N, D] (no
    gradient) and the assignments C_k [B, P_k, N].  Returns K traces [B]."""

    @staticmethod
    def forward(ctx, temp, norm_x, *Cs):
        traces, dcs = modularity_passes(norm_x, [C.contiguous() for C in Cs], temp)
        ctx.save_for_backward(*dcs)
        return traces

    @staticmethod
    def backward(ctx, *gts):
        dcs = ctx.saved_tensors
        return (None, None) + tuple(gt[:, None, None] * dc for gt, dc in zip(gts, dcs))


def _prepare(c_list, x, valid):
    x = x.detach()
    # normalisation and assignment in fp32 (numerics-sensitive, O(ND))
    norm_x = _l2_normalize(x.float(), dim=2)
    if valid is not None:
        norm_x = norm_x * valid[..., None].to(norm_x.dtype)
    # C[b,p,n] = relu(Σ_d x̂[b,n,d] · c[b,p,d] / ||c[b,:,d]||): the reference's
    # per-feature normalisation over the prototype axis
    Cs = []
    for c in c_list:
        norm_c = _l2_normalize(c.float(), dim=1)
        Cs.append(torch.relu(torch.einsum("bnd,bpd->bpn", norm_x, norm_c)))
    return norm_x.contiguous(), Cs


def compute_modularity(
    c: torch.Tensor,  # [B, P, D] prototypes / cluster tokens
    x: torch.Tensor,  # [B, N, D] bag tokens
    valid: Optional[torch.Tensor] = None,  # [B, N] bool
    temp: float = 0.1,
) -> torch.Tensor:
    """Batched modularity score: ``mean_b(-trace_b) * 100``."""
    norm_x, Cs = _prepare((c,), x, valid)
    (trace,) = ModularityTraces.apply(float(temp), norm_x, *Cs)
    return -trace.mean() * 100.0


def compute_modularity_pair(
    c_list: Sequence[torch.Tensor],  # K x [B, P_k, D]
    x: torch.Tensor,  # [B, N, D] shared bag
    valid: Optional[torch.Tensor] = None,
    temp: float = 0.1,
) -> torch.Tensor:
    """Sum of :func:`compute_modularity` over prototype sets sharing one bag;
    the degree pass and the adjacency products run once for all sets."""
    norm_x, Cs = _prepare(tuple(c_list), x, valid)
    traces = ModularityTraces.apply(float(temp), norm_x, *Cs)
    return sum(-t.mean() * 100.0 for t in traces)
