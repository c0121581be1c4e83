"""Whole-slide patch -> CLIP feature extraction for the PyTorch port — the
counterpart of ``tools/clip_feature.py``.

    python -m imp_torch.tools.clip_feature --src PATCH_ROOT --dst FEATURE_DIR \\
        --checkpoint ViT-B-16.pt --model ViT-B/16 [--batch-size 32] \\
        [--prec fp32|bf16] [--device cuda|cpu]

Each slide's patches (one directory of images per slide) stream through the
image tower in static batches on the card: a host thread decodes and
resizes the next batches into pinned uint8 buffers (a queue of 4), the
normalisation runs on the card, and two batches stay in flight, their
features copied back asynchronously and read one batch late.  A slide's
features go to ``FEATURE_DIR/<slide>.h5`` under ``--key``, through a
``.h5.tmp`` file renamed into place; a slide whose ``.h5`` exists is
skipped.  ``--random-weights`` runs without a checkpoint.  ``--prec bf16``
casts the float32 weights and the activations to bf16.  In fp32 the
products run in full float32 (TF32 off, as ``models.build_module`` sets).
``--tp``/``--pp`` > 1 (tensor and pipeline parallel towers) are not ported.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..errors import deferred

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
QUEUE_DEPTH = 4  # decoded batches waiting for the card
IN_FLIGHT = 2  # batches encoded ahead of the one read back


def preprocess(path: str, size: int, as_uint8: bool = False) -> np.ndarray:
    """resize(shorter=size, bicubic) -> center crop -> normalize (the
    reference's ``clip.load()`` preprocess).  With ``as_uint8`` the host
    emits raw uint8 pixels and :func:`device_normalize` does the rest on
    the card (a quarter of the bytes to copy)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    if as_uint8:
        return np.asarray(img, np.uint8)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def device_normalize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> the normalised image in ``dtype``, on
    ``x``'s device."""
    mean = torch.as_tensor(CLIP_MEAN, dtype=dtype, device=x.device)
    std = torch.as_tensor(CLIP_STD, dtype=dtype, device=x.device)
    return (x.to(dtype) / torch.tensor(255.0, dtype=dtype, device=x.device) - mean) / std


def load_checkpoint_params(path: str, model_name: str):
    """The vision tower's port ``state_dict`` from an OpenAI CLIP checkpoint
    (a saved state dict, or the TorchScript archive OpenAI ships)."""
    from ..convert import convert_torch_clip_state, load_torch_checkpoint

    vision, _ = convert_torch_clip_state(load_torch_checkpoint(path), name=model_name)
    return vision


def build_encoder(model_name: str, device="cuda", prec: str = "fp32", checkpoint: str = "",
                  generator: Optional[torch.Generator] = None):
    """(tower, encode): the image tower of ``model_name`` on ``device`` with
    the weights of ``checkpoint``, else drawn from ``generator`` (seed 0),
    cast to bf16 under ``prec="bf16"``; ``encode(x_u8)`` maps a uint8
    ``[B, H, W, 3]`` batch on the device to float32 features."""
    from ..models import build_module
    from ..models.clip import build_vision_tower

    model = build_module(lambda: build_vision_tower(model_name), device, generator)
    if checkpoint:
        model.load_state_dict(load_checkpoint_params(checkpoint, model_name), strict=True)
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    model = model.to(dtype)

    @torch.no_grad()
    def encode(x_u8: torch.Tensor) -> torch.Tensor:
        return model(device_normalize(x_u8, dtype)).float()

    return model, encode


def encode_slide(encode: Callable[[torch.Tensor], torch.Tensor],
                 load: Callable[[object], np.ndarray], items: Sequence, batch_size: int,
                 size: int, device="cuda") -> np.ndarray:
    """The features of one slide, ``[len(items), D]`` float32: ``load(item)``
    gives a uint8 ``[size, size, 3]`` patch.  A host thread fills static
    batches (the last one padded with zeros) into pinned buffers; the card
    encodes with :data:`IN_FLIGHT` batches ahead of the one read back, each
    batch's features cut to its patches."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    batches: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
    stop = threading.Event()

    def producer():
        try:
            for s in range(0, len(items), batch_size):
                if stop.is_set():
                    return
                chunk = items[s : s + batch_size]
                arr = np.zeros((batch_size, size, size, 3), np.uint8)
                for i, item in enumerate(chunk):
                    arr[i] = load(item)
                x = torch.from_numpy(arr)
                batches.put((x.pin_memory() if cuda else x, len(chunk)))
        except Exception as e:  # handed to the consumer, which raises it
            batches.put(e)
            return
        batches.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    feats, inflight = [], []

    def read_back():
        host, done, _ = inflight.pop(0)
        if done is not None:
            done.synchronize()
        feats.append(host.numpy())

    try:
        while True:
            item = batches.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            x, n = item
            out = encode(x.to(device, non_blocking=cuda))[:n]
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda)
            host.copy_(out, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            inflight.append((host, done, x))  # x stays alive until its copy is done
            if len(inflight) > IN_FLIGHT:
                read_back()
        while inflight:
            read_back()
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                batches.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
    return np.concatenate(feats, axis=0)


def write_features(out_path: str, key: str, feats: np.ndarray) -> None:
    """``feats`` under ``key`` in ``out_path``, written to ``out_path.tmp``
    and renamed into place, so that an interrupted run leaves no partial
    ``.h5`` that a rerun would skip."""
    import h5py

    with h5py.File(out_path + ".tmp", "w") as f:
        f.create_dataset(key, data=feats)
    os.replace(out_path + ".tmp", out_path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..models.clip import CLIP_CONFIGS

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="root dir of per-slide patch dirs")
    ap.add_argument("--dst", required=True, help="output h5 dir")
    ap.add_argument("--model", default="ViT-B/32")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--prec", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--key", default="clip_vit_b32_feature")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel size (not ported)")
    ap.add_argument("--pp", type=int, default=1, help="pipeline-parallel size (not ported)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tp > 1 or args.pp > 1:
        raise deferred("--tp/--pp (the tensor and pipeline parallel CLIP towers)", 8)
    if not (args.checkpoint or args.random_weights):
        raise SystemExit("Provide --checkpoint or --random-weights")

    size = CLIP_CONFIGS[args.model]["image_resolution"]
    _, encode = build_encoder(args.model, args.device, args.prec, args.checkpoint)
    os.makedirs(args.dst, exist_ok=True)
    slides = sorted(d for d in os.listdir(args.src) if osp.isdir(osp.join(args.src, d)))
    total_patches, t_start = 0, time.perf_counter()
    for slide in slides:
        out_path = osp.join(args.dst, slide + ".h5")
        if osp.exists(out_path):
            print(f"skip {slide} (exists)")
            continue
        sdir = osp.join(args.src, slide)
        patches = sorted(f for f in os.listdir(sdir) if f.lower().endswith(IMG_EXTS))
        if not patches:
            continue
        feats = encode_slide(encode, lambda p: preprocess(osp.join(sdir, p), size, as_uint8=True),
                             patches, args.batch_size, size, args.device)
        write_features(out_path, args.key, feats)
        total_patches += len(patches)
        rate = total_patches / (time.perf_counter() - t_start)
        print(f"{slide}: {len(patches)} patches -> {out_path}  ({rate:.1f} patches/s)")


if __name__ == "__main__":
    main()
