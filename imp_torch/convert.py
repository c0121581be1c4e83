"""Carry weights from the JAX package's flax trees to the port.

:func:`umeml_gan_state_dict` (UMEML_GAN), :func:`umeml_state_dict` (UMEML),
:func:`mil_state_dict` (``TransMIL_NET``, ``ABMIL_NET``),
:func:`zoo_state_dict` (``FusionNet`` over MCAT, CMTA, Porpoise or HFB,
``SNN_NET``, ``SNNM_NET``, ``CLIPOMIC_NET``) and :func:`clip_state_dict`
(the CLIP towers) take a flax variable tree flattened to
``"params/path_net/kernel"``-style keys with numpy values (flatten it with
flax on the JAX side: this package needs no flax) and return the port's
``state_dict``:

* every ``TorchLinear`` kernel (flax ``[in, out]``) is transposed into an
  ``nn.Linear`` weight (``[out, in]``);
* ``LayerNorm`` ``scale`` becomes ``weight``; flax's auto-named
  ``LayerNorm_0`` inside a TransLayer is the port's ``norm``;
* list members ``name_i`` become ``name.i`` (``nn.ModuleList``: also
  the CLIP towers' ``resblocks_i`` and ``layer1_0`` …);
* a 4-D conv ``kernel`` (flax HWIO) becomes an OIHW ``weight`` (the
  ModifiedResNet's convolutions; the ViT's ``conv1_kernel`` stays HWIO);
* a tree with ``mm/encoder1`` is a model with bilinear fusion, whose
  ``mm/linear_*`` and ``mm/encoder*`` become ``mm.*`` by the rules above;
* the zoo's auto-named Linears: ``TorchLinear_0`` (SNN/Reg blocks,
  ``Attn_Net``) is the port's ``fc``, ``Attn_Net``'s ``TorchLinear_1`` its
  ``score``, ``MaxLinear_0`` (SNN blocks with ``init_max_weights``) ``fc``;
  HFB's ``batch_stats`` ``norm/mean`` and ``norm/var`` become the buffers
  ``norm.running_mean`` and ``norm.running_var``;
* UMEML_GAN's ``GroupedLinear`` (``omic_net``), the packed MHA ``in_proj_weight``
  (``[e, 3e]`` in both), ``res_conv``, ``p_proto``, the encoder tokens and
  ``bottle_tokens`` carry over as they are, and so do TransMIL's
  ``cls_token``, its PPEG convs (``pos_layer/proj{,1,2}_{kernel,bias}``) and
  its final ``mil/LayerNorm_0`` (the port's ``mil.norm``), and the CLIP
  towers' packed ``in_proj_weight`` (``[d, 3d]``), embeddings and
  projections.

:func:`convert_torch_clip_state` reads an OpenAI CLIP ``state_dict``
instead (the layout of ``clip/model.py``), into the same port towers.

Any key left over or missing in either direction, or a shape that does not
fit, raises: the expected keys come from a model built (on the meta device)
at the widths the tree itself implies.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np
import torch

_LIST_MEMBER = re.compile(r"^(proto_g_blocks|omic_encoder|encoders|resblocks|layer[1-4])_(\d+)$")
_AUTO_NAMED = {"LayerNorm_0": "norm", "TorchLinear_0": "fc", "TorchLinear_1": "score",
               "MaxLinear_0": "fc"}
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _torch_key(flax_key: str, grouped_omic: bool = True):
    """(torch key, transpose?) for one flattened flax key; ``grouped_omic``:
    ``omic_net`` is UMEML_GAN's GroupedLinear, whose kernel is kept as it is
    (UMEML's is a TorchLinear)."""
    parts = flax_key.split("/")
    if parts[0] not in ("params", "batch_stats") or len(parts) < 2:
        raise KeyError(f"not a flax variable key: {flax_key!r}")
    collection, parts = parts[0], parts[1:]
    out = []
    for p in parts[:-1]:
        m = _LIST_MEMBER.match(p)
        if m:
            out += [m.group(1), m.group(2)]
        else:
            out.append(_AUTO_NAMED.get(p, p))
    leaf = parts[-1]
    transpose = False
    if collection == "batch_stats":
        leaf = _BATCH_STATS[leaf]
    elif leaf == "kernel" and not (grouped_omic and parts[:-1] == ["omic_net"]):
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


def _zoo_expected(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Size]:
    """Key -> shape (parameters and buffers) of the port's zoo net at the
    widths ``flat`` implies: a ``fusion_module`` subtree is a ``FusionNet``
    whose module is told by its first layer's name (MCAT ``wsi_net``, CMTA
    ``pathomics_fc_0``, Porpoise ``fc_h``, HFB ``encoder_gene``), the
    fusion by ``mm``'s keys, the sizes by layer widths; a
    ``genomic_backbone`` is CLIPOMIC's (the head count changes no shape:
    one stands in); otherwise the ``backbone`` is SNN_M's (it has
    ``attention_net``) or SNN's."""
    from .engine.fusion_trainers import FusionNet
    from .models import fusion as F
    from .models.clipomic import CLIPOMIC_NET
    from .models.nets import SNN_NET, SNNM_NET

    def shape(key):
        return _shape(flat, "params/" + key)

    def has(prefix):
        return any(k.startswith("params/" + prefix) for k in flat)

    def mm_fusion(module):
        if has(f"{module}/mm/encoder1"):
            return "bilinear"
        if has(f"{module}/mm/h1_factor"):
            return "lrb"
        return "concat" if has(f"{module}/mm_fc1") else "add"

    num_classes = shape("classifier/bias")[0]
    size = {256: "small", 1024: "big"}
    with torch.device("meta"):
        if has("fusion_module/"):
            fm = "fusion_module"
            if has(f"{fm}/wsi_net"):
                sig = f"{fm}/sig_networks/sig{{}}_fc0/TorchLinear_0"
                module = F.MCAT(
                    fusion=mm_fusion(fm), path_input_dim=shape(f"{fm}/wsi_net/kernel")[0],
                    omic_sizes=tuple(shape(sig.format(i) + "/kernel")[0] for i in range(5)),
                    model_size_wsi={256: "small", 512: "big"}[shape(f"{fm}/wsi_net/bias")[0]],
                    model_size_omic=size[shape(sig.format(0) + "/bias")[0]])
            elif has(f"{fm}/pathomics_fc_0"):
                module = F.CMTA(
                    fusion=mm_fusion(fm), path_input_dim=shape(f"{fm}/pathomics_fc_0/kernel")[0],
                    omic_sizes=tuple(shape(f"{fm}/genomics_fc/sig{i}_fc0/TorchLinear_0/kernel")[0]
                                     for i in range(5)),
                    model_size={256: "small", 512: "large"}[shape(f"{fm}/pathomics_fc_0/bias")[0]])
            elif has(f"{fm}/fc_h"):
                module = F.Porpoise(
                    fusion=mm_fusion(fm),
                    omic_input_dim=shape(f"{fm}/fc_omic_0/TorchLinear_0/kernel")[0],
                    path_input_dim=shape(f"{fm}/fc_h/kernel")[0],
                    model_size_wsi={256: "small", 384: "big"}[shape(f"{fm}/rho_h/bias")[0]],
                    model_size_omic=size[shape(f"{fm}/fc_omic_0/TorchLinear_0/bias")[0]])
            else:
                module = F.HFB(path_input_dim=shape(f"{fm}/encoder_path/enc1/kernel")[0])
            model = FusionNet(module, num_classes)
        elif has("genomic_backbone/omic_fc"):
            bb = "genomic_backbone"
            len_mol, width = shape(f"{bb}/omic_fc/TorchLinear_0/kernel")
            model = CLIPOMIC_NET(
                num_classes, len_mol=len_mol, width=width, heads=1,
                layers=_count(flat, f"params/{bb}/resblocks_{{}}"),
                vocab_size=shape(f"{bb}/token_embedding")[0],
                context_length=shape(f"{bb}/positional_embedding")[0],
                model_size_omic={256: "small", 384: "big"}[shape(f"{bb}/rho/bias")[0]])
        elif has("backbone/attention_net"):
            first = shape("backbone/fc_omic_0/MaxLinear_0/kernel")
            model = SNNM_NET(num_classes, first[0],
                             model_size_omic={256: "small", 1: "big"}[first[1]])
        else:
            first = shape("backbone/fc_omic_0/MaxLinear_0/kernel")
            model = SNN_NET(num_classes, first[0], model_size_omic=size[first[1]])
    return {k: v.shape for k, v in model.state_dict().items()}


def _count(flat: Dict[str, np.ndarray], pattern: str) -> int:
    """How many list members ``pattern.format(i)`` (i = 0, 1, ...) ``flat``
    holds a key under."""
    n = 0
    while any(k.startswith(pattern.format(n) + "/") for k in flat):
        n += 1
    return n


def _clip_expected(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Size]:
    """Key -> shape (parameters and buffers) of the port's CLIP tower at the
    widths ``flat`` implies: a ViT (``conv1_kernel``), a ModifiedResNet
    (``layer1_0``) or a text tower (``token_embedding``).  The head count
    changes no shape (one head stands in)."""
    from .models import clip

    def shape(key):
        return _shape(flat, "params/" + key)

    with torch.device("meta"):
        if "params/conv1_kernel" in flat:
            patch, _, _, width = shape("conv1_kernel")
            grid = math.isqrt(shape("positional_embedding")[0] - 1)
            model = clip.VisionTransformer(grid * patch, patch, width,
                                           _count(flat, "params/resblocks_{}"), 1,
                                           shape("proj")[1])
        elif "params/layer1_0/conv1/kernel" in flat:
            spacial = shape("attnpool/positional_embedding")[0] - 1
            model = clip.ModifiedResNet(
                [_count(flat, f"params/layer{s}_{{}}") for s in (1, 2, 3, 4)],
                shape("attnpool/c_proj/kernel")[1], 1, math.isqrt(spacial) * 32,
                shape("conv3/kernel")[3])
        else:
            vocab, width = shape("token_embedding")
            model = clip.TextTransformer(shape("positional_embedding")[0], vocab, width, 1,
                                         _count(flat, "params/resblocks_{}"),
                                         shape("text_projection")[1])
    return {k: v.shape for k, v in model.state_dict().items()}


def clip_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The state dict of a port CLIP tower (ViT, ModifiedResNet with its
    ``batch_stats``, or the text tower) from its flattened flax variables."""
    return _state_dict(flat, _clip_expected(flat))


def _openai_block(state, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    """One residual attention block of an OpenAI ``state_dict`` under the
    port's names; the packed ``in_proj_weight`` turns ``[3d, d]`` ->
    ``[d, 3d]``."""
    for key in [k for k in state if k.startswith(src)]:
        value = state[key]
        out[dst + key[len(src):]] = value.T if key.endswith("attn.in_proj_weight") else value


def convert_torch_clip_state(state, name: str = "ViT-B/32"
                             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """An OpenAI CLIP ``state_dict`` (tensors or numpy arrays) as the
    ``state_dict`` of the port's vision tower and of its text tower,
    float32 (the counterpart of the JAX package's
    ``convert_torch_clip_state``).  The vision side is empty where the state
    has no ``visual.conv1.weight``, the text side where it has no
    ``token_embedding.weight``; the vision layer count is the config's
    (``name``), the text layer count is read from the state (a shrunken
    tower loads as it is).  ModifiedResNet running statistics become the
    port's BatchNorm buffers (``num_batches_tracked`` has no counterpart)."""
    from .models.clip import CLIP_CONFIGS

    state = {k: v.detach().to("cpu", torch.float32) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v, np.float32))
             for k, v in state.items() if not k.endswith("num_batches_tracked")}
    c = CLIP_CONFIGS[name]
    vis: Dict[str, torch.Tensor] = {}
    if "visual.layer1.0.conv1.weight" in state:  # ModifiedResNet family
        for key, value in state.items():
            if key.startswith("visual."):
                key = key[len("visual."):].replace("downsample.0.", "downsample_conv.")
                vis[key.replace("downsample.1.", "downsample_bn.")] = value
    elif "visual.conv1.weight" in state:
        vis["conv1_kernel"] = state["visual.conv1.weight"].permute(2, 3, 1, 0)  # OIHW -> HWIO
        for key in ("class_embedding", "positional_embedding", "proj", "ln_pre.weight",
                    "ln_pre.bias", "ln_post.weight", "ln_post.bias"):
            vis[key] = state["visual." + key]
        for i in range(c["vision_layers"]):
            _openai_block(state, f"visual.transformer.resblocks.{i}.", f"resblocks.{i}.", vis)
    txt: Dict[str, torch.Tensor] = {}
    if "token_embedding.weight" in state:
        txt["token_embedding"] = state["token_embedding.weight"]
        for key in ("positional_embedding", "text_projection", "ln_final.weight",
                    "ln_final.bias"):
            txt[key] = state[key]
        n_layers = 0
        while f"transformer.resblocks.{n_layers}.ln_1.weight" in state:
            n_layers += 1
        for i in range(n_layers or c["transformer_layers"]):
            _openai_block(state, f"transformer.resblocks.{i}.", f"resblocks.{i}.", txt)
    return ({k: v.contiguous() for k, v in vis.items()},
            {k: v.contiguous() for k, v in txt.items()})


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a torch checkpoint file: a saved state dict,
    or an OpenAI TorchScript archive (``ViT-B-16.pt``), which
    ``torch.load`` refuses with ``weights_only`` and ``torch.jit.load``
    reads."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except RuntimeError:  # a TorchScript archive
        state = torch.jit.load(path, map_location="cpu")
    return state.state_dict() if hasattr(state, "state_dict") else state


def umeml_gan_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _expected(flat))


def umeml_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _umeml_expected(flat), grouped_omic=False)


def mil_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return _state_dict(flat, _mil_expected(flat))


def zoo_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The state dict of a zoo net from its flattened ``params`` (and HFB's
    ``batch_stats``)."""
    return _state_dict(flat, _zoo_expected(flat))


def _state_dict(flat: Dict[str, np.ndarray], expected: Dict[str, torch.Size],
                grouped_omic: bool = True) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        tkey, transpose = _torch_key(key, grouped_omic)
        if tkey not in expected:
            raise KeyError(f"flax key {key!r} -> {tkey!r} has no counterpart in the port")
        arr = np.asarray(value, dtype=np.float32)
        if transpose:  # Dense [in, out] -> [out, in]; Conv HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        t = torch.tensor(arr)  # a copy, contiguous
        if t.shape != expected[tkey]:
            raise ValueError(
                f"{key!r} -> {tkey!r}: shape {tuple(t.shape)} != {tuple(expected[tkey])}"
            )
        out[tkey] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks the port's parameters {missing}")
    return out
