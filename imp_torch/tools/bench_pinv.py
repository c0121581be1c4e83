"""Validate and time the fused Newton-Schulz pseudo-inverse (K6 forward, K7
backward) against the chain of products; the counterpart of the JAX
package's ``tools/bench_pinv.py``.

    python -m imp_torch.tools.bench_pinv [--g 16] [--m 128] [--iters 6]
        [--timing-iters 30] [--check] [--device cuda]

The inputs are softmax rows, g matrices of m x m (the Nyström layers'
``attn2``), drawn from a ``torch.Generator`` at seed 0.  The fused path is
:func:`imp_torch.ops.pinv.pinv_newton_schulz`, the chain
:func:`imp_torch.ops.attention.moore_penrose_pinv` with ``mode="chain"``.
``--check`` holds the forward (relative error below 2e-4) and the gradient
of ``sum(pinv(x) · cot)`` (below 2e-3) of the fused path against the
chain's, as the JAX tool does, prints ``‖A Z A − A‖`` of the fused result
and the launches of K6 and K7 per forward and per backward; it raises
where a bound is missed.  Each path is then timed (CUDA events on a card), forward
alone and forward + backward.

``imp_torch.tools.pinv_ab`` differs: it times versions of the kernel
sources (``csrc/pinv.cu`` copies) against each other; this tool times the
checkout's kernels against the chain of products.  On ``--device cpu`` the
fused path runs the kernels' plain versions and the times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

FWD_TOL, GRAD_TOL = 2e-4, 2e-3


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def inputs(g: int, m: int, device):
    """Softmax rows ``[g, m, m]`` and a cotangent of the same shape."""
    gen = torch.Generator().manual_seed(0)
    x = torch.softmax(torch.randn(g, m, m, generator=gen), dim=-1).to(device)
    cot = torch.randn(g, m, m, generator=gen).to(device)
    return x, cot


def paths(iters: int):
    from imp_torch.ops.attention import moore_penrose_pinv
    from imp_torch.ops.pinv import pinv_newton_schulz

    return {"fused": lambda x: pinv_newton_schulz(x, iters),
            "chain": lambda x: moore_penrose_pinv(x, iters, "chain")}


def check(x, cot, iters: int) -> Dict:
    """The fused path's forward and gradient against the chain's, the
    reconstruction error and K6/K7's launches; raises past the bounds."""
    from imp_torch import kernels

    fns = paths(iters)
    z, grads, launched = {}, {}, {}
    for name, fn in fns.items():
        leaf = x.clone().requires_grad_()
        kernels.reset_launches()
        z[name] = fn(leaf)
        fwd = kernels.launches()
        kernels.reset_launches()
        (grads[name],) = torch.autograd.grad((z[name] * cot).sum(), leaf)
        bwd = kernels.launches()
        launched[name] = {"per_forward": {k: fwd[k] for k in ("pinv_fwd", "pinv_bwd")},
                          "per_backward": {k: bwd[k] for k in ("pinv_fwd", "pinv_bwd")}}
    zf, zc = z["fused"].detach(), z["chain"].detach()
    err_f, err_g = _rel(zf, zc), _rel(grads["fused"], grads["chain"])
    recon = float((x @ zf @ x - x).abs().max())
    print(f"fwd  max-rel-err vs chain: {err_f:.3e} (|z|max {float(zc.abs().max()):.3e})")
    gmax = float(grads["chain"].abs().max())
    print(f"grad max-rel-err vs chain: {err_g:.3e} (|g|max {gmax:.3e})")
    print(f"||A Z A - A||_max: {recon:.3e}")
    print(f"launches fused {launched['fused']}, chain {launched['chain']}", flush=True)
    if not err_f < FWD_TOL:
        raise AssertionError(f"forward mismatch: {err_f}")
    if not err_g < GRAD_TOL:
        raise AssertionError(f"gradient mismatch: {err_g}")
    print("CHECK OK", flush=True)
    return {"fwd_rel_err": err_f, "grad_rel_err": err_g, "aza_minus_a_max": recon,
            "launches": launched}


def main(argv: Optional[list] = None) -> Dict:
    from imp_torch.tools.bench import card_of, check_device
    from imp_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--timing-iters", type=int, default=30)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the chain in full fp32, as the models run it

    x, cot = inputs(args.g, args.m, device)
    result = {"g": args.g, "m": args.m, "iters": args.iters, "card": card_of(device),
              "device": str(device)}
    if args.check:
        result["check"] = check(x, cot, args.iters)

    result["ms"] = {}
    for name, fn in paths(args.iters).items():
        leaf = x.clone().requires_grad_()

        def fwd(fn=fn):
            with torch.no_grad():
                fn(x)

        def fwd_bwd(fn=fn):
            torch.autograd.grad((fn(leaf) * cot).sum(), leaf)

        for tag, f in (("fwd", fwd), ("fwd+bwd", fwd_bwd)):
            ms = profiling.call_ms(f, args.timing_iters, device, warmup=6)
            result["ms"][f"{name} {tag}"] = ms
            print(f"{name:5s} {tag:7s}: {ms:.3f} ms/call  (g={args.g}, m={args.m})", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
