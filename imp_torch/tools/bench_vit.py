"""Patch-encode throughput of the CLIP vision towers, stage by stage; the
counterpart of the JAX package's ``tools/bench_vit.py``.

    python -m imp_torch.tools.bench_vit [--model ViT-B/16] [--prec fp32|bf16]
        [--batch-size 256] [--iters 10] [--stage device|h2d|pipeline|all]
        [--device cuda]

Three stages separate the candidate bottlenecks of feature extraction:

1. ``device``   — the tower alone: weights and a uint8 batch resident on
   the card, ``--iters`` encodes, synchronised at both ends;
2. ``h2d``      — each batch uploaded from host memory (uint8 NHWC) before
   its encode;
3. ``pipeline`` — the extraction loop itself:
   :func:`imp_torch.tools.clip_feature.encode_slide` (a producer thread
   filling pinned batches into a queue, ``IN_FLIGHT`` batches encoded
   ahead of the one read back) over ``2 · --iters`` batches of synthetic
   patches.

Each prints patches/s and TFLOP/s against :func:`vit_flops_per_image`,
the JAX tool's analytic count.  The tower is
:func:`imp_torch.tools.clip_feature.build_encoder` (weights from seed 0);
its products are ``torch.matmul`` and run no kernel of ``csrc/``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch


def vit_flops_per_image(name: str) -> float:
    """Analytic forward FLOPs (multiply-adds x 2) of the vision tower, as
    the JAX tool counts them."""
    from imp_torch.models.clip import CLIP_CONFIGS

    c = CLIP_CONFIGS[name]
    w, layers = c["vision_width"], c["vision_layers"]
    if not isinstance(layers, int):  # ResNet towers: not supported here
        raise SystemExit("bench_vit supports ViT towers only")
    res, patch = c["image_resolution"], c["vision_patch_size"]
    n = (res // patch) ** 2 + 1
    per_layer = (
        4 * n * w * w * 2  # qkv + out proj
        + 2 * n * n * w * 2  # scores + weighted sum
        + 8 * n * w * w * 2  # mlp
    )
    conv = n * (patch * patch * 3) * w * 2
    proj = w * c["embed_dim"] * 2
    return float(layers * per_layer + conv + proj)


def main(argv: Optional[list] = None) -> Dict:
    from imp_torch.models.clip import CLIP_CONFIGS
    from imp_torch.tools.bench import card_of, check_device
    from imp_torch.tools.clip_feature import build_encoder, encode_slide
    from imp_torch.utils.profiling import host_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--prec", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stage", default="all", choices=["device", "h2d", "pipeline", "all"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    _, encode = build_encoder(args.model, device, args.prec,
                              generator=torch.Generator().manual_seed(0))
    size = CLIP_CONFIGS[args.model]["image_resolution"]
    bs = args.batch_size
    flops = vit_flops_per_image(args.model) * bs
    host_u8 = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (bs, size, size, 3), dtype=np.uint8))
    result = {"model": args.model, "prec": args.prec, "batch": bs, "iters": args.iters,
              "flops_per_image": flops / bs, "card": card_of(device), "device": str(device),
              "stages": {}}

    def report(stage, dt_per_batch):
        pps, tf = bs / dt_per_batch, flops / dt_per_batch / 1e12
        result["stages"][stage] = {"patches_per_s": pps, "tflops": tf,
                                   "ms_per_batch": dt_per_batch * 1e3}
        print(f"{stage:10s} {args.model} {args.prec} bs={bs}: {pps:,.0f} patches/s  "
              f"{tf:.1f} TFLOP/s ({dt_per_batch * 1e3:.2f} ms/batch)", flush=True)

    if args.stage in ("device", "all"):
        dev_u8 = host_u8.to(device)
        report("device", host_ms(lambda: encode(dev_u8), args.iters, device, warmup=4) / 1e3)

    if args.stage in ("h2d", "all"):
        report("h2d", host_ms(lambda: encode(host_u8.to(device)), args.iters, device) / 1e3)

    if args.stage in ("pipeline", "all"):
        items = list(range(2 * args.iters * bs))
        patches = host_u8.numpy()

        def loop():
            feats = encode_slide(encode, lambda i: patches[i % bs], items, bs, size, device)
            if feats.shape[0] != len(items):
                raise RuntimeError(f"{feats.shape[0]} features for {len(items)} patches")

        report("pipeline", host_ms(loop, 1, device, warmup=0) / 1e3 / (2 * args.iters))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
