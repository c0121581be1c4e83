"""Flash-attention kernel micro-benchmark at the TransLayer envelope
(10 240-token bags, d_head 32, 8 heads, batch 2); the counterpart of the
JAX package's ``tools/bench_flash.py``.

    python -m imp_torch.tools.bench_flash [--n 10240] [--d 32] [--heads 8]
        [--batch 2] [--iters 10] [--valid-frac 1.0] [--precisions bf16,fp32]
        [--check] [--device cuda]

Times K1 (the flash forward) through
:func:`imp_torch.ops.flash_attention.flash_attention` by CUDA events and
prints its TFLOP/s over the valid keys (4·b·h·n·n_valid·d) and the
kernels' launches per timed call.  ``--check``
first holds the forward and, through autograd (K2 and K3), dq, dk and dv
against :func:`imp_torch.ops.attention.dense_attention` on the same
inputs and the same ``sum(out · cos out)`` loss, and prints the launches
of each kernel per forward and per backward.  Use a small ``--n`` there:
the dense reference holds the n x n scores.

Two differences from the JAX tool:

* ``--block-q``/``--block-k`` have no counterpart: the kernels pick their
  own tiles (``flash_fwd_layout``/``flash_bwd_layout``).
* ``bf16`` means q, k and v in bfloat16 on K1-K3's bf16 entries
  (``TRAINER.PREC bf16``); the JAX tool's ``mxu_precision="bf16"`` (fp32
  operands, bf16 products) raises in the port.

On ``--device cpu`` the wrappers run their plain versions and the time is
the CPU's (host clock).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _entry(name: str, prec: str) -> str:
    return f"{name}_bf16" if prec == "bf16" else name


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / (want.abs().max() + 1e-9))


def inputs(b: int, h: int, n: int, d: int, valid_frac: float, device):
    """q, k, v from ``default_rng(0)`` (as the JAX tool draws them) and the
    key mask of the first ``n·valid_frac`` keys of every slide."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(device)
               for _ in range(3))
    n_valid = int(n * valid_frac)
    mask = (torch.arange(n, device=device) < n_valid)[None, :].repeat(b, 1)
    return q, k, v, mask, n_valid


def check(q, k, v, mask, precisions) -> Dict:
    """Per precision: the forward's and dq/dk/dv's max relative errors
    against the dense attention in fp32, and the launches of K1-K3 (or
    their bf16 entries) in one forward and in one backward."""
    from imp_torch import kernels
    from imp_torch.ops.attention import dense_attention
    from imp_torch.ops.flash_attention import flash_attention

    d = q.shape[-1]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want, _, _ = dense_attention(leaves[0] * d**-0.5, leaves[1], leaves[2], key_valid=mask,
                                 scale=1.0)
    want_g = torch.autograd.grad((want * torch.cos(want)).sum(), leaves)
    out = {}
    for prec in precisions:
        dtype = torch.bfloat16 if prec == "bf16" else torch.float32
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        kernels.reset_launches()
        got = flash_attention(*leaves, mask=mask).float()
        fwd = kernels.launches()
        kernels.reset_launches()
        got_g = torch.autograd.grad((got * torch.cos(got)).sum(), leaves)
        bwd = kernels.launches()
        errs = [_rel(a, b) for a, b in zip(got_g, want_g)]
        out[prec] = {"fwd_rel_err": _rel(got.detach(), want.detach()),
                     "dq_rel_err": errs[0], "dk_rel_err": errs[1], "dv_rel_err": errs[2],
                     "launches_per_forward": {n: fwd[_entry(n, prec)] for n in FLASH_KERNELS},
                     "launches_per_backward": {n: bwd[_entry(n, prec)] for n in FLASH_KERNELS}}
        print(f"check {prec}: fwd max rel err vs dense = {out[prec]['fwd_rel_err']:.2e}; "
              f"dq/dk/dv rel err = " + "/".join(f"{e:.2e}" for e in errs), flush=True)
        print(f"check {prec}: launches per forward {out[prec]['launches_per_forward']}, "
              f"per backward {out[prec]['launches_per_backward']}", flush=True)
    return out


def main(argv: Optional[list] = None) -> Dict:
    from imp_torch import kernels
    from imp_torch.ops.flash_attention import flash_attention
    from imp_torch.tools.bench import card_of, check_device
    from imp_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10240)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--valid-frac", type=float, default=1.0,
                    help="fraction of keys unmasked (ragged-bag skipping)")
    ap.add_argument("--precisions", default="bf16,fp32")
    ap.add_argument("--check", action="store_true",
                    help="compare against the dense attention (use small --n)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the dense reference in full fp32

    b, h, n, d = args.batch, args.heads, args.n, args.d
    precisions = args.precisions.split(",")
    q, k, v, mask, n_valid = inputs(b, h, n, d, args.valid_frac, device)
    flops = 4 * b * h * n * n_valid * d  # 2 products over the valid keys
    result = {"n": n, "d": d, "heads": h, "batch": b, "valid_frac": args.valid_frac,
              "flops": flops, "card": card_of(device), "device": str(device)}
    if args.check:
        result["check"] = check(q, k, v, mask, precisions)

    result["timed"] = {}
    with torch.no_grad():
        for prec in precisions:
            dtype = torch.bfloat16 if prec == "bf16" else torch.float32
            qp, kp, vp = q.to(dtype), k.to(dtype), v.to(dtype)

            calls = [0]

            def fwd():
                flash_attention(qp, kp, vp, mask=mask)
                calls[0] += 1

            kernels.reset_launches()
            ms = profiling.call_ms(fwd, args.iters, device)
            counted = kernels.launches()
            tflops = flops / (ms / 1e3) / 1e12
            result["timed"][prec] = {
                "ms": ms, "tflops": tflops,
                "launches_per_call": {n: counted[_entry(n, prec)] / calls[0]
                                      for n in FLASH_KERNELS}}
            print(f"{prec}: {ms:8.3f} ms  {tflops:6.2f} TFLOP/s  "
                  f"(n={n}, d={d}, h={h}, b={b}, valid={args.valid_frac:.0%})", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
