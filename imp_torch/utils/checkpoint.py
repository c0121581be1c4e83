"""Checkpoint IO with the reference's best/last/pointer semantics — the
counterpart of ``imp_tpu/utils/checkpoint.py`` (reference
``medmm/utils/torchtools.py:27-157``): a directory holding
``model.ckpt-<epoch>`` files, a ``checkpoint`` pointer file naming the
latest, and ``model-best.ckpt`` when val improves.

A checkpoint is one ``torch.save`` file of the trainer's state: the model's
state dict, every optimizer state, the epoch and the best val result.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Optional, Tuple

import torch

from .logger import mkdir_if_missing


def _write(state: Any, fpath: str) -> None:
    tmp = fpath + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, fpath)  # a reader sees the old file or the new one


def save_checkpoint(
    state: Any, directory: str, epoch: int, is_best: bool = False, model_name: str = ""
) -> str:
    mkdir_if_missing(directory)
    if not model_name:
        model_name = f"model.ckpt-{epoch}"
    fpath = osp.join(directory, model_name)
    _write(state, fpath)
    with open(osp.join(directory, "checkpoint"), "w") as f:
        f.write(osp.basename(fpath))
    if is_best and osp.basename(fpath) != "model-best.ckpt":
        _write(state, osp.join(directory, "model-best.ckpt"))
    print(f'Checkpoint saved to "{fpath}"')
    return fpath


def load_checkpoint(fpath: str, map_location=None) -> Any:
    if not osp.exists(fpath):
        raise FileNotFoundError(f'File is not found at "{fpath}"')
    return torch.load(fpath, map_location=map_location, weights_only=True)


def resume_from_checkpoint(directory: str, map_location=None) -> Tuple[Optional[Any], int]:
    """Resume from the ``checkpoint`` pointer file: (state, epoch), or
    (None, 0) when nothing is found (train from scratch)."""
    pointer = osp.join(directory, "checkpoint")
    if not osp.exists(pointer):
        print("No checkpoint found, train from scratch")
        return None, 0
    with open(pointer) as f:
        name = f.read().strip()
    fpath = osp.join(directory, name)
    state = load_checkpoint(fpath, map_location)
    epoch = int(state["epoch"]) if isinstance(state, dict) and "epoch" in state else 0
    print(f'Loaded checkpoint from "{fpath}" (resume at epoch {epoch})')
    return state, epoch


def best_checkpoint_path(directory: str) -> Optional[str]:
    best = osp.join(directory, "model-best.ckpt")
    return best if osp.exists(best) else None


def load_pretrained_params(fpath: str, model) -> None:
    """Initialise ``model``'s parameters from a saved checkpoint (reference
    ``load_pretrained_weights``, ``torchtools.py:267``; the JAX package's
    ``load_pretrained_params``): a partial, non-strict load.  ``fpath`` is a
    checkpoint file of :func:`save_checkpoint` or a directory holding a
    ``checkpoint`` pointer.  A parameter takes the checkpoint's tensor of
    the same name and shape, in its own dtype; one whose name is missing or
    whose shape differs (another head width) keeps its fresh init.  Buffers
    are not loaded, as the JAX package merges ``params`` only."""
    if osp.isdir(fpath) and osp.exists(osp.join(fpath, "checkpoint")):
        with open(osp.join(fpath, "checkpoint")) as f:
            fpath = osp.join(fpath, f.read().strip())
    state = load_checkpoint(fpath, map_location="cpu")
    loaded = state.get("model", state) if isinstance(state, dict) else None
    if not isinstance(loaded, dict):
        raise ValueError(f"No model parameters found in checkpoint {fpath}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            got = loaded.get(name)
            if got is not None and tuple(got.shape) == tuple(p.shape):
                p.copy_(got)
    print(f"Initialized weights from {fpath} (non-strict)")
