"""Interleaved in-process A/B of full-train-step variants on one card; the
counterpart of the JAX package's ``tools/ab_step.py``.

    python -m imp_torch.tools.ab_step --knob head_fused   # head_fused True vs False
    python -m imp_torch.tools.ab_step --knob pinv         # K6/K7 (fused) vs the chain
    python -m imp_torch.tools.ab_step --knob none         # two identical arms (noise floor)

The step is :func:`imp_torch.tools.bench.build_step`.  The knobs are
arguments of the model builder here, not module globals: ``head_fused``
(A True, B False), ``pinv`` (A ``pinv_mode="fused"``, B ``"chain"``),
``stacked`` (``stacked_pairs`` True / False), ``bagbf16`` (``bag_dtype``
bfloat16 / None), ``prec`` (the whole step in bf16 / fp32) and ``none``.
Each arm gets its own step, state and batch; after one step and a burn-in
of 6 rounds, the arms alternate A B A B for ``--slots`` slots of
``--iters`` steps each, every slot synchronised at both ends, and slot 0
is dropped.  The last line is one JSON object: each arm's median and best
ms per step, its slots, and the kernels it launched per timed step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, Optional

import torch

from imp_torch.tools.bench import REPLACE_RATIO, STEP_KERNELS, build_step, card_of

KNOBS = ("head_fused", "pinv", "stacked", "prec", "bagbf16", "none")


def arm_kwargs(knob: str, arm: str) -> Dict:
    """The ``build_step`` arguments of ``arm`` ("A" or "B") of ``knob``."""
    on = arm == "A"
    if knob == "head_fused":
        return {"head_fused": on}
    if knob == "pinv":
        return {"pinv_mode": "fused" if on else "chain"}
    if knob == "stacked":
        return {"stacked_pairs": on}
    if knob == "bagbf16":  # bag activations only; params, losses, pinv, modularity fp32
        return {"bag_dtype": torch.bfloat16 if on else None}
    if knob == "prec":
        return {"prec": "bf16" if on else "fp32"}
    if knob == "none":
        return {}
    raise ValueError(f"knob {knob!r} not in {KNOBS}")


def main(argv: Optional[list] = None) -> Dict:
    from imp_torch import kernels
    from imp_torch.utils.profiling import synchronize

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--knob", default="head_fused", choices=KNOBS)
    ap.add_argument("--slots", type=int, default=4, help="timed slots PER ARM")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    print(f"knob={args.knob}  A=on/fused  B=off/chain  device={device}", flush=True)
    arms = {}
    for arm in ("A", "B"):
        kw = arm_kwargs(args.knob, arm)
        step, state, batch = build_step(batch_size=args.batch_size, device=device, **kw)
        g = torch.Generator(device=device).manual_seed(ord(arm))
        step(state, batch, g, REPLACE_RATIO)  # first call: kernel loads, allocator
        arms[arm] = (step, state, batch, g)
    synchronize(device)

    def run(arm, n):
        step, state, batch, g = arms[arm]
        for _ in range(n):
            loss = step(state, batch, g, REPLACE_RATIO)
        return loss

    for _ in range(6):  # burn-in of both arms
        for arm in arms:
            run(arm, 1)
    synchronize(device)

    slots = {"A": [], "B": []}
    counted = {"A": dict.fromkeys(STEP_KERNELS, 0), "B": dict.fromkeys(STEP_KERNELS, 0)}
    for s in range(args.slots):
        for arm in ("A", "B"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            run(arm, args.iters)
            synchronize(device)
            dt = (time.perf_counter() - t0) / args.iters * 1e3
            launched = kernels.launches()
            for k in STEP_KERNELS:
                counted[arm][k] += launched[k]
            slots[arm].append(dt)
            print(f"slot {s} arm {arm}: {dt:.2f} ms/step", flush=True)

    result = {"knob": args.knob, "batch": args.batch_size, "iters": args.iters,
              "card": card_of(device), "device": str(device), "arms": {}}
    for arm in ("A", "B"):
        r = slots[arm][1:] if len(slots[arm]) > 1 else slots[arm]
        print(f"arm {arm}: best {min(r):.2f}  median {statistics.median(r):.2f} "
              f" all(after slot0) {['%.2f' % x for x in r]}", flush=True)
        kw = arm_kwargs(args.knob, arm)
        result["arms"][arm] = {
            "variant": {k: str(v) for k, v in kw.items()},
            "median_ms": statistics.median(r), "best_ms": min(r), "slots_ms": slots[arm],
            "launches_per_step": {k: n / (args.slots * args.iters)
                                  for k, n in counted[arm].items()},
        }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
