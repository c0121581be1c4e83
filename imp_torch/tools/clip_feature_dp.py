"""Data-parallel WSI patch -> CLIP feature extraction for the PyTorch port —
the counterpart of ``tools/clip_feature_dp.py``.

    torchrun --standalone --nproc-per-node N -m imp_torch.tools.clip_feature_dp \\
        --root DATA_ROOT --dataset tcga_glioma --output-dir FEATURES \\
        --model clip_vit_b16 (--checkpoint ViT-B-16.pt | --random-weights) \\
        [--batch-size 512] [--prec fp32|bf16] [--device cuda|cpu]

Every rank reads the same global batches of a slide's patches (the global
``--batch-size``, rounded up to a multiple of the rank count) and encodes
its part on its own card with the whole tower
(:func:`imp_torch.tools.clip_feature.build_encoder`); the features are
gathered over the ``data`` axis and rank 0 writes them.  It keeps the JAX
tool's CLI contract: the short model flags (:data:`MODEL_FLAGS`), the tree
``{output_dir}/{model}/{dataset}``, one ``.h5`` per slide under ``--key``
(written through ``.h5.tmp``, :func:`~imp_torch.tools.clip_feature.write_features`),
skip-if-exists resume, slides of at most one patch skipped, the padding
rows of the last batch stripped.  Without ``torchrun`` it runs on one card.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Optional, Sequence

from .clip_feature import IMG_EXTS, build_encoder, encode_slide, preprocess, write_features

# short flag -> canonical CLIP name (the reference's clip_feature_dp.py)
MODEL_FLAGS = {
    "clip_vit_b32": "ViT-B/32",
    "clip_vit_b16": "ViT-B/16",
    "clip_vit_l14": "ViT-L/14",
    "clip_vit_l14@336px": "ViT-L/14@336px",
    "clip_r50": "RN50",
    "clip_r101": "RN101",
    "clip_r50x4": "RN50x4",
    "clip_r50x16": "RN50x16",
    "clip_r50x64": "RN50x64",
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    import torch.distributed as dist

    from ..parallel import maybe_initialize_distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model", default="clip_vit_b32", choices=sorted(MODEL_FLAGS))
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--batch-size", type=int, default=512,
                    help="GLOBAL batch (split across the ranks; rounded up to a multiple of "
                    "the rank count)")
    ap.add_argument("--prec", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--key", default="clip_feature")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.checkpoint or args.random_weights):
        raise SystemExit("Provide --checkpoint or --random-weights")
    owns_group = not dist.is_initialized()
    device = maybe_initialize_distributed(args.device)  # torchrun's ranks, else one
    try:
        _extract(args, device)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _extract(args, device) -> None:
    from ..models.clip import CLIP_CONFIGS
    from ..parallel import barrier, is_primary, make_mesh
    from ..parallel.tensor import data_parallel

    name = MODEL_FLAGS[args.model]
    size = CLIP_CONFIGS[name]["image_resolution"]
    mesh = make_mesh(("data",), (-1,), device)
    _, encode_part = build_encoder(name, device, args.prec, args.checkpoint)
    encode = data_parallel(mesh, encode_part)
    n = mesh.data.size
    bs = -(-args.batch_size // n) * n

    output_dir = osp.join(args.output_dir, args.model, args.dataset)
    os.makedirs(output_dir, exist_ok=True)
    root = osp.join(args.root, args.dataset, "images", "train")
    # splitext, so that slide ids with dots resume; .h5 only, so that the
    # .h5.tmp of an interrupted run does not mark its slide done
    done = {osp.splitext(f)[0] for f in os.listdir(output_dir) if f.endswith(".h5")}
    slides = sorted(d for d in os.listdir(root)
                    if osp.isdir(osp.join(root, d)) and d not in done)
    barrier()  # every rank listed the slides before rank 0 writes any
    print(f"{name} on {n} rank(s), global batch {bs}, {len(slides)} slides to encode")

    total_patches, t_start = 0, time.perf_counter()
    for slide in slides:
        sdir = osp.join(root, slide)
        patches = sorted(f for f in os.listdir(sdir) if f.lower().endswith(IMG_EXTS))
        if len(patches) <= 1:  # the reference skips single-patch slides
            continue
        feats = encode_slide(encode, lambda p: preprocess(osp.join(sdir, p), size, as_uint8=True),
                             patches, bs, size, device)
        if is_primary():
            write_features(osp.join(output_dir, f"{slide}.h5"), args.key, feats)
        total_patches += len(patches)
        rate = total_patches / (time.perf_counter() - t_start)
        print(f"{slide}: {len(patches)} patches  ({rate:.1f} patches/s)")
    barrier()


if __name__ == "__main__":
    main()
