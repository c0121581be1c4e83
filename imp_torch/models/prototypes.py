"""Pathology prototypes from PLIP text embeddings — the PyTorch counterpart
of ``imp_tpu/models/prototypes.py``.

``MODEL.UMEML.PROTO_INIT=plip`` fills UMEML_GAN's prototypes from the cached
``prototypes_plip.npy`` that ``python -m imp_torch.tools.extract_prototypes``
writes (the reference retrains its autoencoder at every model
construction, ``extract_prototype_with_plip_train.py:35-112``, and then
overwrites the result with the uniform init, ``umeml_gan.py:315``: the
default here stays uniform).  The file is looked for in ``OUTPUT_DIR``,
then in ``DATASET.ROOT``; where neither holds it, the prototypes are drawn
uniform with a warning, as in the JAX package.
"""

from __future__ import annotations

import os.path as osp
import warnings
from typing import Callable

import numpy as np
import torch

from .layers import proto_init_

PROTO_CACHE = "prototypes_plip.npy"


def plip_prototype_init(cfg, n_proto: int, hidden: int
                        ) -> Callable[[torch.Tensor, torch.Generator], None]:
    """An in-place init of a ``[1, n_proto, hidden]`` prototype tensor: the
    cached PLIP prototypes, else the uniform draw from ``generator``."""
    cache = osp.join(cfg.OUTPUT_DIR, PROTO_CACHE)
    alt = osp.join(osp.abspath(osp.expanduser(cfg.DATASET.ROOT)), PROTO_CACHE)

    @torch.no_grad()
    def init(t: torch.Tensor, generator: torch.Generator) -> None:
        for path in (cache, alt):
            if osp.isfile(path):
                arr = np.load(path)
                if arr.shape != (1, n_proto, hidden):
                    raise ValueError(f"{path}: prototypes of shape {arr.shape}, the model "
                                     f"takes {(1, n_proto, hidden)}")
                t.copy_(torch.from_numpy(arr))
                return
        warnings.warn(
            "PROTO_INIT=plip requested but no cached prototypes found "
            f"({cache} / {alt}); falling back to uniform init"
        )
        proto_init_(t, n_proto, generator)

    return init
