"""Tensor (model) parallelism for the CLIP/PLIP towers — the torch
counterpart of ``imp_tpu/parallel/tensor.py``.

Megatron-style over the ``model`` axis of a process mesh, composed with the
``data`` axis:

* **attention**: the packed qkv projection is split head-wise (each rank
  owns ``heads/tp`` heads end to end), the output projection is split by
  rows, and one all-reduce over ``model`` reassembles the residual branch;
* **MLP**: ``c_fc`` split by columns, ``c_proj`` by rows, one all-reduce;
* everything token-local (patchify, embeddings, LayerNorms, ``ln_post`` and
  ``proj``, the text tower's embeddings and ``ln_final``) and both residual
  biases stay replicated, added once after the sum.

Two all-reduces per block; each rank holds 1/tp of the block weights
(:func:`put_tp_params` keeps this rank's shard only).  The towers are
frozen feature extractors, so nothing here takes a gradient: the
collectives are the plain ones of :mod:`imp_torch.parallel.collectives`.
The products and the softmax are plain PyTorch, as the JAX towers run no
Pallas kernel.

:func:`split_vision_params_tp` splits the port's ``state_dict`` (the one
:func:`imp_torch.convert.clip_state_dict` makes from JAX's parameters) into
JAX's layout: ``{"rep": {name: tensor}, "shard": {"resblocks.i": {leaf:
[tp, ...]}}}``, each shard leaf bit-identical to JAX's (the port keeps
``in_proj_weight`` ``[d, 3d]`` as flax does; a ``Dense`` weight is the
transpose of flax's kernel, so it is transposed back before the split).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..models.clip import _attend, _heads, patchify, quick_gelu
from .collectives import Axis, _all_reduce, _gather
from .mesh import Mesh

BLOCKS = "resblocks."
EPS = 1e-5  # the towers' LayerNorm epsilon


def _chunk(t: torch.Tensor, tp: int, dim: int) -> torch.Tensor:
    """``[tp, ...]``: ``t`` cut into tp equal chunks along ``dim``."""
    return torch.stack(torch.chunk(t, tp, dim=dim), dim=0).contiguous()


def split_blocks(state: Dict[str, torch.Tensor]):
    """(the entries outside the residual blocks, {block index: {name within
    the block: tensor}}) of a tower's ``state_dict``."""
    rep, blocks = {}, {}
    for name, t in state.items():
        if name.startswith(BLOCKS):
            i, rest = name[len(BLOCKS):].split(".", 1)
            blocks.setdefault(int(i), {})[rest] = t
        else:
            rep[name] = t
    return rep, [blocks[i] for i in sorted(blocks)]


def split_vision_params_tp(state: Dict[str, torch.Tensor], tp: int) -> Dict:
    """The ``tp``-way split of a ViT tower's ``state_dict``: ``{"rep":
    replicated entries (the block LayerNorms and the two residual biases as
    ``resblocks.i.out_bias`` / ``resblocks.i.proj_bias``), "shard": {
    "resblocks.i": {wq, wk, wv, bq, bk, bv, wo, wfc, bfc, wproj}}}``, each
    shard leaf ``[tp, ...]``: q, k and v in head-major column chunks (chunk
    j holds heads ``[j·h/tp, (j+1)·h/tp)``), ``wo`` and ``wproj`` in row
    chunks, ``wfc`` in column chunks, as ``x @ W``."""
    rep, blocks = split_blocks(state)
    shard = {}
    for i, blk in enumerate(blocks):
        key = f"{BLOCKS}{i}"
        w, b = blk["attn.in_proj_weight"], blk["attn.in_proj_bias"]  # [d, 3d], [3d]
        d = w.shape[0]
        for ln in ("ln_1", "ln_2"):
            for leaf in ("weight", "bias"):
                rep[f"{key}.{ln}.{leaf}"] = blk[f"{ln}.{leaf}"]
        rep[f"{key}.out_bias"] = blk["attn.out_proj.bias"]
        rep[f"{key}.proj_bias"] = blk["mlp.c_proj.bias"]
        shard[key] = {
            "wq": _chunk(w[:, :d], tp, 1), "wk": _chunk(w[:, d:2 * d], tp, 1),
            "wv": _chunk(w[:, 2 * d:], tp, 1),
            "bq": _chunk(b[:d], tp, 0), "bk": _chunk(b[d:2 * d], tp, 0),
            "bv": _chunk(b[2 * d:], tp, 0),
            "wo": _chunk(blk["attn.out_proj.weight"].t(), tp, 0),  # [d, d] rows
            "wfc": _chunk(blk["mlp.c_fc.weight"].t(), tp, 1),  # [d, 4d] columns
            "bfc": _chunk(blk["mlp.c_fc.bias"], tp, 0),
            "wproj": _chunk(blk["mlp.c_proj.weight"].t(), tp, 0),  # [4d, d] rows
        }
    return {"rep": rep, "shard": shard}


def split_text_params_tp(state: Dict[str, torch.Tensor], tp: int) -> Dict:
    """The text tower's split: the same residual blocks, other ends."""
    return split_vision_params_tp(state, tp)


def put_tp_params(tp_params: Dict, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> Dict:
    """A split on this rank's device: the replicated entries whole, of each
    shard leaf only this rank's chunk along ``model`` (so a rank holds 1/tp
    of the block weights); floating tensors cast to ``dtype`` if given."""
    axis = mesh.model

    def put(t):
        t = t.to(mesh.device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    if any(v.shape[0] != axis.size for blk in tp_params["shard"].values() for v in blk.values()):
        raise ValueError(f"the split's shard count differs from the model axis ({axis.size})")
    return {"rep": {k: put(v) for k, v in tp_params["rep"].items()},
            "shard": {key: {k: put(v[axis.index]) for k, v in blk.items()}
                      for key, blk in tp_params["shard"].items()}}


def _ln(x, rep, name):
    return F.layer_norm(x, x.shape[-1:], rep[name + ".weight"], rep[name + ".bias"], EPS)


def _block_tp(x, rep, key, shard, heads_local: int, axis: Axis, causal: bool = False):
    """One pre-LN residual block with this rank's heads and columns; two
    all-reduces over ``axis`` reassemble the residual branches, and the
    replicated biases are added after them."""
    b, n, _ = x.shape
    y = _ln(x, rep, key + ".ln_1")
    q = torch.matmul(y, shard["wq"]) + shard["bq"]  # [b, n, d/tp]
    k = torch.matmul(y, shard["wk"]) + shard["bk"]
    v = torch.matmul(y, shard["wv"]) + shard["bv"]
    out = _attend(_heads(q, heads_local), _heads(k, heads_local), _heads(v, heads_local), causal)
    out = torch.matmul(out.transpose(1, 2).reshape(b, n, -1), shard["wo"])
    x = x + _all_reduce(axis, out) + rep[key + ".out_bias"]  # row-split out proj
    z = _ln(x, rep, key + ".ln_2")
    h = quick_gelu(torch.matmul(z, shard["wfc"]) + shard["bfc"])  # [b, n, 4d/tp]
    return x + _all_reduce(axis, torch.matmul(h, shard["wproj"])) + rep[key + ".proj_bias"]


def local_heads(heads: int, axis: Axis) -> int:
    """The heads of one rank of ``axis``; JAX's error where they do not
    divide."""
    if heads % axis.size:
        raise ValueError(f"{heads} attention heads not divisible by model-axis size {axis.size}")
    return heads // axis.size


def vit_embed(vit, rep: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The replicated stage boundary of a ViT: patchify, class token,
    positional embedding and ``ln_pre`` (``VisionTransformer.forward``'s
    first half) with the parameters in ``rep``."""
    x = patchify(x, rep["conv1_kernel"], vit.grid)
    cls = rep["class_embedding"].expand(x.shape[0], 1, -1)
    return _ln(torch.cat([cls, x], dim=1) + rep["positional_embedding"], rep, "ln_pre")


def vit_pool(rep: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``ln_post`` on the class token, then ``proj``."""
    return torch.matmul(_ln(x[:, 0, :], rep, "ln_post"), rep["proj"])


def _vit_forward_tp(vit, params: Dict, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's ViT forward (``VisionTransformer.forward``) with the
    block weights split over ``axis``."""
    heads_local = local_heads(vit.heads, axis)
    rep = params["rep"]
    x = vit_embed(vit, rep, x)
    for key in sorted(params["shard"], key=lambda k: int(k[len(BLOCKS):])):
        x = _block_tp(x, rep, key, params["shard"][key], heads_local, axis)
    return vit_pool(rep, x)


def _text_forward_tp(txt, params: Dict, tokens: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's text-tower forward (``TextTransformer.forward``) with the
    causal blocks split over ``axis``."""
    heads_local = local_heads(txt.heads, axis)
    rep = params["rep"]
    x = rep["token_embedding"][tokens] + rep["positional_embedding"][: tokens.shape[1]]
    for key in sorted(params["shard"], key=lambda k: int(k[len(BLOCKS):])):
        x = _block_tp(x, rep, key, params["shard"][key], heads_local, axis, causal=True)
    x = _ln(x, rep, "ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return torch.matmul(pooled, rep["text_projection"])


def data_parallel(mesh: Mesh, body: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(batch) -> out`` over the global batch: this rank's part of dim 0
    along ``data`` through ``body``, the parts gathered back in rank order
    on every rank (JAX's ``in_specs``/``out_specs`` ``P("data")``)."""

    def fn(batch: torch.Tensor) -> torch.Tensor:
        if batch.shape[0] % mesh.data.size:
            raise ValueError(f"batch {batch.shape[0]} not divisible by data-axis size "
                             f"{mesh.data.size}")
        per = batch.shape[0] // mesh.data.size
        out = body(batch[mesh.data.index * per:(mesh.data.index + 1) * per])
        return _gather(mesh.data, out, 0)

    return fn


def make_tp_encode(vit, mesh: Mesh, pre: Optional[Callable] = None):
    """``fn(tp_params, images) -> features`` with the batch split over
    ``data`` and the blocks over ``model``: ``vit`` is the port's
    ``VisionTransformer`` of the split (its configuration is read, not its
    weights), ``tp_params`` comes from :func:`put_tp_params`, ``pre`` is an
    elementwise image preprocess applied to this rank's part (the uint8
    ``device_normalize`` of ``imp_torch.tools.clip_feature``).  Runs
    without gradient."""

    @torch.no_grad()
    def fn(tp_params: Dict, images: torch.Tensor) -> torch.Tensor:
        def body(x):
            return _vit_forward_tp(vit, tp_params, pre(x) if pre is not None else x, mesh.model)

        return data_parallel(mesh, body)(images)

    return fn


def make_tp_encode_text(txt, mesh: Mesh):
    """``fn(tp_params, tokens) -> embeddings``: the text-tower counterpart
    of :func:`make_tp_encode`."""

    @torch.no_grad()
    def fn(tp_params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        return data_parallel(mesh, lambda t: _text_forward_tp(txt, tp_params, t, mesh.model))(
            tokens)

    return fn
