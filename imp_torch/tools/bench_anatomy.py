"""Step-cost anatomy of the canonical UMEML_GAN train step (batch 2, bags
of 10 000 x 512, hidden 256); the counterpart of the JAX package's
``tools/bench_anatomy.py``.

    python -m imp_torch.tools.bench_anatomy [--prec fp32|bf16] [--iters 30]
        [--batch-size 2] [--only SUBSTR,...] [--device cuda]

Times each piece of the step alone, under the JAX tool's section names:
the full step (:func:`imp_torch.tools.bench.build_step`), the encode
forward and forward + backward, the main forward and forward + backward,
the modularity pair (K4 and K5 on the card) at the bench shape, the GAN
phase (three gradients and Adam updates), the head's forward + backward,
the main optimizer update alone and the bf16 casts of the parameters and
the batch.  Every section runs on the model, batch and GAN phase of
``build_step``.  Each reports its synchronised host ms per call (5
untimed calls, then ``--iters`` timed), the kernels those calls launched
per call and, on a card, its device-busy ms per call from a traced window
(:func:`imp_torch.utils.profiling.device_busy_ms`, the harness of
``chip_smoke.py``: primer kernels, retraces of a window that lost
records); the last line, ``JSON: {...}``, holds them per section and the
retraces of the run's traced windows.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import torch

from imp_torch.tools.bench import REPLACE_RATIO, bench_optim, build_step, card_of

SECTIONS = (
    "full_train_step", "encode_fwd", "encode_fwd_bwd", "main_fwd_only", "main_fwd_bwd",
    "modularity_pair_fwd_bwd", "gan_phase(3 grads+updates)", "head_fwd_bwd",
    "main_optimizer_update", "cast_params_and_batch_to_bf16",
)
BURN_IN, TRACED_CALLS = 5, 3


def _grad_sum(loss, params) -> torch.Tensor:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return sum(g.sum() for g in grads if g is not None)


def sections(state, batch, prec: str, step, device) -> Dict[str, Callable[[], torch.Tensor]]:
    """{section name: fn()} over ``build_step``'s model and batch; each
    ``fn`` returns a tensor that depends on all of its work."""
    from imp_torch.config import get_cfg_default
    from imp_torch.engine.precision import amp_call, cast_floats
    from imp_torch.ops.modularity import compute_modularity_pair
    from imp_torch.optim import build_optimizer

    model = state["model"]
    cdtype = torch.bfloat16 if prec == "bf16" else None
    g = torch.Generator(device=device).manual_seed(0)
    params = list(model.parameters())
    main = state["opt_state"].params
    b, n = batch["img_mask"].shape
    hidden = model.hidden

    def enc():
        return step.encode(state, batch, g)

    def full():
        return step(state, batch, g, REPLACE_RATIO)

    @torch.no_grad()
    def encode_fwd():
        return enc()["h_path"].sum()

    def encode_fwd_bwd():
        out = enc()
        return _grad_sum(out["h_path"].sum() + out["h_omic"].sum(), params)

    def forward():
        out = enc()
        return amp_call(model, "finish", cdtype, out, batch, train=True,
                        replace_ratio=REPLACE_RATIO, generator=g)

    @torch.no_grad()
    def main_fwd_only():
        out = forward()
        return out["logits"].sum() + out["modular_loss"]

    def main_fwd_bwd():
        out = forward()
        return _grad_sum(out["logits"].sum() + out["modular_loss"] + out["loss_kd"], main)

    gm = torch.Generator(device=device).manual_seed(1)
    hb = torch.randn(b, n, hidden, generator=gm, device=device).requires_grad_()
    pp = torch.randn(b, 6, hidden, generator=gm, device=device).requires_grad_()
    ho = torch.randn(b, 7, hidden, generator=gm, device=device).requires_grad_()

    def modularity_pair_fwd_bwd():
        v = compute_modularity_pair((pp, ho), hb, valid=batch["img_mask"])
        return v + _grad_sum(v, (pp, ho, hb))

    with torch.no_grad():
        enc0 = enc()
    h_path0, h_omic0 = enc0["h_path"], enc0["h_omic"]

    def gan_phase():  # the step's own, on the state's three GAN optimizers
        return step.gan_phase(state, enc0)

    def head_fwd_bwd():
        out = amp_call(model, "head", cdtype, h_path0, h_omic0, train=True, generator=g)
        return _grad_sum(out["logits"].sum() + out["loss_kd"], params)

    copies = [p.detach().clone() for p in main]
    ones = [torch.ones_like(p) for p in copies]
    opt = build_optimizer(bench_optim(get_cfg_default().OPTIM), copies, updates_per_epoch=100)

    def main_optimizer_update():
        opt.step(ones)
        return copies[0].sum()

    @torch.no_grad()
    def cast_params_and_batch_to_bf16():
        p2 = cast_floats(params, torch.bfloat16)
        b2 = cast_floats(batch, torch.bfloat16)
        return sum(x.float().sum() for x in p2) + b2["img"].float().sum()

    fns = (full, encode_fwd, encode_fwd_bwd, main_fwd_only, main_fwd_bwd,
           modularity_pair_fwd_bwd, gan_phase, head_fwd_bwd, main_optimizer_update,
           cast_params_and_batch_to_bf16)
    return dict(zip(SECTIONS, fns))


def run(batch_size=2, prec="fp32", iters=30, only=(), device="cuda", **shape) -> Dict:
    """{section: {"host_ms", "device_busy_ms", "finite",
    "launches_per_call"}} of every section whose name holds one of
    ``only`` (all when empty); the launches are those of the section's
    untimed and timed calls, per call, of each kernel it launched.
    ``shape`` reaches ``build_step`` (``bag_pad``, ``feat_dim``,
    ``hidden``...)."""
    from imp_torch import kernels
    from imp_torch.utils import profiling

    device = torch.device(device)
    step, state, batch = build_step(batch_size=batch_size, prec=prec, device=device, **shape)
    fns = sections(state, batch, prec, step, device)
    results = {}
    for name, fn in fns.items():
        if only and not any(pat in name for pat in only):
            continue
        out, calls = [None], [0]

        def call(fn=fn):
            out[0] = fn()
            calls[0] += 1

        kernels.reset_launches()
        ms = profiling.host_ms(call, iters, device, warmup=BURN_IN)
        launched = {k: v / calls[0] for k, v in kernels.launches().items() if v}
        busy = (profiling.device_busy_ms(call, TRACED_CALLS) if device.type == "cuda"
                else None)
        results[name] = {"host_ms": ms, "device_busy_ms": busy,
                         "finite": bool(torch.isfinite(out[0]).all()),
                         "launches_per_call": launched}
        print(f"{name:34s} {ms:9.3f} ms  device busy "
              f"{'not measured' if busy is None else f'{busy:.3f} ms'}  launches {launched}",
              flush=True)
    return results


def main(argv: Optional[list] = None) -> Dict:
    from imp_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prec", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated substrings; time only matching sections")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sessions = len(profiling.TRACE_SESSIONS), len(profiling.TRACE_SHORT)
    results = run(args.batch_size, args.prec, args.iters,
                  [s for s in args.only.split(",") if s], args.device)
    windows = profiling.TRACE_SESSIONS[sessions[0]:]
    row = {"sections": results, "batch": args.batch_size, "prec": args.prec,
           "iters": args.iters, "card": card_of(args.device),
           "traced_windows": len(windows),
           "retraced": sum(1 for _, seen in windows if not seen),
           "retraced_for_lost_launches": len(profiling.TRACE_SHORT) - sessions[1]}
    print("\nJSON:", json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
