"""Carry weights from the JAX package's flax trees to the port.

:func:`umeml_gan_state_dict` (UMEML_GAN), :func:`umeml_state_dict` (UMEML)
and :func:`mil_state_dict` (``TransMIL_NET``, ``ABMIL_NET``) take a flax
param tree flattened to ``"params/path_net/kernel"``-style keys with numpy
values (flatten it with flax on the JAX side: this package needs no flax)
and return the port's ``state_dict``:

* every ``TorchLinear`` kernel (flax ``[in, out]``) is transposed into an
  ``nn.Linear`` weight (``[out, in]``);
* ``LayerNorm`` ``scale`` becomes ``weight``; flax's auto-named
  ``LayerNorm_0`` inside a TransLayer is the port's ``norm``;
* list members ``name_i`` become ``name.i`` (``nn.ModuleList``);
* a tree with ``mm/encoder1`` is a model with bilinear fusion, whose
  ``mm/linear_*`` and ``mm/encoder*`` become ``mm.*`` by the rules above;
* UMEML_GAN's ``GroupedLinear`` (``omic_net``), the packed MHA ``in_proj_weight``
  (``[e, 3e]`` in both), ``res_conv``, ``p_proto``, the encoder tokens and
  ``bottle_tokens`` carry over as they are, and so do TransMIL's
  ``cls_token``, its PPEG convs (``pos_layer/proj{,1,2}_{kernel,bias}``) and
  its final ``mil/LayerNorm_0`` (the port's ``mil.norm``).

Any key left over or missing in either direction, or a shape that does not
fit, raises: the expected keys come from a model built (on the meta device)
at the widths the tree itself implies.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LIST_MEMBER = re.compile(r"^(proto_g_blocks|omic_encoder|encoders)_(\d+)$")


def _torch_key(flax_key: str, grouped_omic: bool = True):
    """(torch key, transpose?) for one flattened flax key; ``grouped_omic``:
    ``omic_net`` is UMEML_GAN's GroupedLinear, whose kernel is kept as it is
    (UMEML's is a TorchLinear)."""
    parts = flax_key.split("/")
    if parts[0] != "params" or len(parts) < 2:
        raise KeyError(f"not a flax param key: {flax_key!r}")
    parts = parts[1:]
    out = []
    for p in parts[:-1]:
        m = _LIST_MEMBER.match(p)
        if m:
            out += [m.group(1), m.group(2)]
        elif p == "LayerNorm_0":
            out.append("norm")
        else:
            out.append(p)
    leaf = parts[-1]
    transpose = False
    if leaf == "kernel" and not (grouped_omic and parts[:-1] == ["omic_net"]):
        leaf, transpose = "weight", True
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(out + [leaf]), transpose


def _shape(flat: Dict[str, np.ndarray], key: str):
    if key not in flat:
        raise KeyError(f"flax tree lacks {key!r}")
    return np.shape(flat[key])


def _fusion(flat: Dict[str, np.ndarray]) -> str:
    return "bilinear" if "params/mm/encoder1/kernel" in flat else "concat"


def _expected(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Size]:
    """Key -> shape of the port's UMEML_GAN at the widths ``flat`` implies
    (hidden and prototypes from ``p_proto``, registers from
    ``bottle_tokens``, classes from ``classifier``, feature width from
    ``path_net``, widest gene group from ``omic_net``, the fusion from
    ``mm``)."""
    from .models.umeml_gan import UMEML_GAN

    def shape(key):
        return _shape(flat, key)

    _, n_proto, hidden = shape("params/p_proto")
    gmax = shape("params/omic_net/kernel")[1]
    with torch.device("meta"):
        model = UMEML_GAN(
            num_classes=shape("params/classifier/bias")[0],
            gene_group_indexes=[list(range(gmax))] * n_proto,
            feat_dim=shape("params/path_net/kernel")[0],
            hidden=hidden,
            n_proto=n_proto,
            n_reg=shape("params/bottleattn/bottle_tokens")[1],
            fusion=_fusion(flat),
        )
    return {k: v.shape for k, v in model.state_dict().items()}


def _mil_expected(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Size]:
    """Key -> shape of the port's TransMIL_NET (the tree has
    ``mil/cls_token``) or ABMIL_NET, with the classes from ``classifier``,
    the feature width from the first Linear and ABMIL's size from ``rho``."""
    from .models.nets import ABMIL_NET, TransMIL_NET

    num_classes = _shape(flat, "params/classifier/bias")[0]
    with torch.device("meta"):
        if "params/mil/cls_token" in flat:
            model = TransMIL_NET(num_classes, _shape(flat, "params/mil/_fc1/kernel")[0])
        else:
            size = {256: "small", 384: "big"}[_shape(flat, "params/mil/rho/bias")[0]]
            model = ABMIL_NET(num_classes, _shape(flat, "params/mil/fc/kernel")[0], size)
    return {k: v.shape for k, v in model.state_dict().items()}


def _umeml_expected(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Size]:
    """Key -> shape of the port's UMEML at the widths ``flat`` implies (the
    gene count from ``omic_net``, the rest as for UMEML_GAN)."""
    from .models.umeml import UMEML

    _, n_proto, hidden = _shape(flat, "params/p_proto")
    with torch.device("meta"):
        model = UMEML(
            num_classes=_shape(flat, "params/classifier/bias")[0],
            feat_dim=_shape(flat, "params/path_net/kernel")[0],
            omic_dim=_shape(flat, "params/omic_net/kernel")[0],
            hidden=hidden,
            n_proto=n_proto,
            n_reg=_shape(flat, "params/bottleattn/bottle_tokens")[1],
            fusion=_fusion(flat),
        )
    return {k: v.shape for k, v in model.state_dict().items()}


def umeml_gan_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _expected(flat))


def umeml_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _umeml_expected(flat), grouped_omic=False)


def mil_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _mil_expected(flat))


def _state_dict(flat: Dict[str, np.ndarray], expected: Dict[str, torch.Size],
                grouped_omic: bool = True) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        tkey, transpose = _torch_key(key, grouped_omic)
        if tkey not in expected:
            raise KeyError(f"flax key {key!r} -> {tkey!r} has no counterpart in the port")
        arr = np.asarray(value, dtype=np.float32)
        t = torch.tensor(arr.T if transpose else arr)  # a copy, contiguous
        if t.shape != expected[tkey]:
            raise ValueError(
                f"{key!r} -> {tkey!r}: shape {tuple(t.shape)} != {tuple(expected[tkey])}"
            )
        out[tkey] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks the port's parameters {missing}")
    return out
