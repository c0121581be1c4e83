"""Rank bodies of the port's multi-process CPU tests
(``tests/test_torch_sequence_parallel.py`` and
``tests/test_torch_parallel_trainers.py``).

They run in processes that :func:`imp_torch.parallel.launch.spawn` starts
(gloo, one CPU thread each), so this module imports neither JAX nor the
JAX package: the test files compute the JAX references in the parent,
save them beside the inputs, and compare what the ranks return.  It holds
no test of its own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from imp_torch.config import get_cfg_default
from imp_torch.models.nets import TransMIL_NET
from imp_torch.models.umeml_gan import UMEML_GAN
from imp_torch.ops.attention import ExactSelfAttention, NystromAttention, set_batch_axis
from imp_torch.parallel import sequence as S
from imp_torch.parallel.collectives import LOCAL, Axis, _all_reduce, _gather

SP_SIZES = (2, 4)
UMEML = dict(num_classes=4, hidden=32, n_proto=6, dropout_rate=0.0)


def umeml_kwargs(feat: int, groups) -> dict:
    """UMEML_GAN's constructor arguments at the tests' widths, the rest from
    the port's config defaults (as the JAX builder reads them)."""
    u = get_cfg_default().MODEL.UMEML
    return dict(UMEML, gene_group_indexes=groups, feat_dim=feat, n_reg=u.REGISTERS,
                lambda_cyc=float(u.LAMBDA_CYC), topk=u.TOPK, kd_t=float(u.KD_T))


def seq_axes(world: int):
    """{sp: this rank's Axis} for every sp of :data:`SP_SIZES` that divides
    the world: consecutive ranks form one group (every rank creates every
    group, in one order)."""
    rank = dist.get_rank()
    out = {}
    for sp in SP_SIZES:
        for start in range(0, world, sp):
            ranks = list(range(start, start + sp))
            group = dist.new_group(ranks)
            if rank in ranks:
                out[sp] = Axis("seq", sp, rank - start, group, ranks)
    return out


def band(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n)


def _zero_dropout(model):
    """Every dropout rate of ``model`` that no cfg key sets to 0 (the
    attention's, HFB's gated pools and factorised pooling)."""
    for m in model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
        for rate in ("rate", "fac_drop"):
            if isinstance(getattr(m, rate, None), float):
                setattr(m, rate, 0.0)
    return model


def _param_grads(model, loss, ax):
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return {n: _all_reduce(ax, g if g is not None else torch.zeros_like(p))
            for n, p, g in zip(names, ps, grads)}


def _modularity(case, ax):
    out = {}
    x, valid = band(case["x"], ax, 1), band(case["valid"], ax, 1)
    for mode, fn in (("gather", S.compute_modularity_pair_sp),
                     ("ring", S.compute_modularity_pair_ring)):
        c1, c2 = (case[k].clone().requires_grad_() for k in ("c1", "c2"))
        v = fn((c1, c2), x, valid, axis=ax)
        g1, g2 = torch.autograd.grad(v / ax.size, (c1, c2))
        out[f"modularity/{mode}"] = [v.detach(), _all_reduce(ax, g1), _all_reduce(ax, g2)]
    return out


def _cross(case, ax):
    q, k, v = (case[n].clone().requires_grad_() for n in ("pq", "x", "xv"))
    o = S.cross_attention_tokens_sp(q, band(k, ax, 1), band(v, ax, 1),
                                    band(case["valid"], ax, 1), axis=ax)
    grads = torch.autograd.grad((o * case["pw"]).sum() / ax.size, (q, k, v))
    return {"cross": [o.detach()] + [_all_reduce(ax, g) for g in grads]}


def _self_attention(case, ax):
    out = {}
    for mode, fn in (("gather", S.self_attention_tokens_sp), ("ring", S.ring_self_attention)):
        q, k, v = (case[n].clone().requires_grad_() for n in ("q", "k", "v"))
        o = fn(band(q, ax, 2), band(k, ax, 2), band(v, ax, 2), band(case["kmask"], ax, 1),
               axis=ax)
        grads = torch.autograd.grad((o * band(case["do"], ax, 2)).sum(), (q, k, v))
        # each rank's loss term is its own band's: the gradients sum
        out[f"self/{mode}"] = [_gather(ax, o.detach(), 2)] + [_all_reduce(ax, g) for g in grads]
    return out


def _translayer_ppeg(case, ax):
    """layer1 of a TransMIL (gather and ring layouts) and its PPEG (ring)
    on [cls; grid] tokens, held against the JAX single-device layer."""
    out = {}
    x_full, mask_full = case["tokens"], case["tmask"]
    w = case["tw"]
    for mode in ("gather", "ring"):
        net = TransMIL_NET(4, case["feat"], attention="flash", seq=ax, sp_mode=mode)
        net.load_state_dict(case["transmil_sd"], strict=True)
        layer = net.mil.layer1
        x = x_full.clone().requires_grad_()
        if mode == "gather":
            y = layer(x, mask=mask_full)
            loss = (y * w).sum() / ax.size
            y_full = y.detach()
        else:
            yb, yc = layer(band(x[:, 1:], ax, 1), mask=band(mask_full[:, 1:], ax, 1),
                           cls=x[:, :1])
            loss = (yb * band(w[:, 1:], ax, 1)).sum() + (yc * w[:, :1]).sum() / ax.size
            y_full = torch.cat([yc.detach(), _gather(ax, yb.detach(), 1)], dim=1)
        grads = _param_grads(layer, loss, ax)
        names, ps = zip(*layer.named_parameters())
        out[f"translayer/{mode}"] = [y_full, {n: grads[n] for n in names}]
    # the arbiter of a gradient float32 cannot resolve: the one-rank layer in float64
    ref = TransMIL_NET(4, case["feat"], attention="flash")
    ref.load_state_dict(case["transmil_sd"], strict=True)
    layer = ref.mil.layer1.double()
    names, ps = zip(*layer.named_parameters())
    y = layer(x_full.double(), mask=mask_full)
    out["translayer/float64"] = dict(zip(names, torch.autograd.grad((y * w.double()).sum(), ps)))
    # PPEG, ring layout: this rank's band of grid rows, no cls
    net = TransMIL_NET(4, case["feat"], attention="flash", seq=ax, sp_mode="ring")
    net.load_state_dict(case["transmil_sd"], strict=True)
    ppeg = net.mil.pos_layer
    grid = x_full[:, 1:].clone().requires_grad_()
    side = case["side"]
    y = ppeg(band(grid, ax, 1), side, side)
    loss = (y * band(w[:, 1:], ax, 1)).sum()
    names, ps = zip(*ppeg.named_parameters())
    gx, *gp = torch.autograd.grad(loss, (grid,) + ps)
    out["ppeg/ring"] = [_gather(ax, y.detach(), 1), _all_reduce(ax, gx),
                        {n: _all_reduce(ax, g) for n, g in zip(names, gp)}]
    return out


def _transmil(case, ax):
    out = {}
    for mode in ("gather", "ring"):
        net = TransMIL_NET(4, case["feat"], attention="flash", seq=ax, sp_mode=mode)
        net.load_state_dict(case["transmil_sd"], strict=True)
        batch = {"img": band(case["img"], ax, 1), "img_mask": band(case["img_mask"], ax, 1)}
        logits = net(batch)
        loss = (logits * case["lw"]).sum()
        out[f"transmil/{mode}"] = [logits.detach(), loss.detach(),
                                   _param_grads(net, loss / ax.size, ax)]
    return out


def _umeml_gan(case, ax):
    out = {}
    for mode in ("gather", "ring"):
        model = UMEML_GAN(**umeml_kwargs(case["feat"], case["groups"]), seq=ax, sp_mode=mode)
        model.load_state_dict(case["umeml_sd"], strict=True)
        _zero_dropout(model)
        batch = dict(case["ubatch"])
        batch["img"], batch["img_mask"] = band(batch["img"], ax, 1), band(batch["img_mask"], ax, 1)
        g = torch.Generator().manual_seed(0)
        res = model(batch, train=True, replace_ratio=0.0, generator=g)
        loss = res["modular_loss"] + res["loss_kd"] + (res["logits"] * case["uw"]).sum()
        out[f"umeml_gan/{mode}"] = [res["logits"].detach(), res["modular_loss"].detach(),
                                    loss.detach(), _param_grads(model, loss / ax.size, ax)]
    return out


def bf16_nets(case, ax=None):
    """TransMIL (flash) and UMEML_GAN (train forward, dropout 0) under the
    bf16 policy (``amp_call``), in both layouts on a seq axis ``ax`` (its
    band of the bag), or on one rank (``ax`` None, the whole bag):
    {net/mode: [logits, loss, parameter gradients]}.  UMEML_GAN's loss is
    its modularity plus the weighted logits (its distillation term is held
    apart: see ``test_torch_sequence_parallel.py``)."""
    from imp_torch.engine.precision import amp_call

    out = {}
    for mode in (("gather", "ring") if ax is not None else ("one",)):
        def cut(batch):
            if ax is None:
                return dict(batch)
            return dict(batch, img=band(batch["img"], ax, 1),
                        img_mask=band(batch["img_mask"], ax, 1))

        seq = dict(seq=ax, sp_mode=mode) if ax is not None else {}
        size = ax.size if ax is not None else 1
        net = TransMIL_NET(4, case["feat"], attention="flash", **seq)
        net.load_state_dict(case["transmil_sd"], strict=True)
        logits = amp_call(net, "forward", torch.bfloat16,
                          cut({"img": case["img"], "img_mask": case["img_mask"]}))
        loss = (logits * case["lw"]).sum()
        out[f"transmil/{mode}"] = [logits.detach(), loss.detach(),
                                   _param_grads(net, loss / size, ax or LOCAL)]
        model = UMEML_GAN(**umeml_kwargs(case["feat"], case["groups"]), **seq)
        model.load_state_dict(case["umeml_sd"], strict=True)
        _zero_dropout(model)
        g = torch.Generator().manual_seed(0)
        res = amp_call(model, "forward", torch.bfloat16, cut(case["ubatch"]), train=True,
                       replace_ratio=0.0, generator=g)
        loss = res["modular_loss"] + (res["logits"] * case["uw"]).sum()
        out[f"umeml_gan/{mode}"] = [res["logits"].detach(), loss.detach(),
                                    _param_grads(model, loss / size, ax or LOCAL)]
    return out


def sequence_rank(rank: int, path: str):
    """Every check of ``test_torch_sequence_parallel.py`` at sp 2 (ranks 0-1
    and 2-3) and sp 4, the bf16 nets at sp 2; returns {sp: {check:
    results}} of this rank."""
    case = torch.load(path, weights_only=False)
    results = {}
    for sp, ax in seq_axes(dist.get_world_size()).items():
        res = {}
        for part in (_modularity, _cross, _self_attention, _translayer_ppeg, _transmil,
                     _umeml_gan):
            res.update(part(case, ax))
        if sp == 2:
            res.update({"bf16/" + k: v for k, v in bf16_nets(case, ax).items()})
        results[sp] = res
    return results


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


def trainer_cfg(root: str, out: str, trainer: str, mesh_shape, mode: str, repo: str,
                extra=()):
    """The port's cfg of a tiny TransMIL (flash), MBTRAIN (UMEML_GAN,
    hidden 32) or HFB run on the mesh ``mesh_shape`` of ``('data', 'seq')``,
    with the options ``extra`` (``TRAINER.PREC bf16``, ...)."""
    from imp_torch.config import clean_cfg

    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(repo, "configs/Survival", {
        "MBTRAIN": "UMEML_GAN.yaml"}.get(trainer, f"{trainer}.yaml")))
    cfg.DATASET.ROOT, cfg.OUTPUT_DIR, cfg.SEED, cfg.DATASET.FOLD = root, out, 1, 1
    cfg.TRAINER.NAME, cfg.VERBOSE = trainer, False
    cfg.merge_from_list(trainer_opts(trainer, mesh_shape, mode) + list(extra))
    clean_cfg(cfg, trainer)
    cfg.freeze()
    return cfg


def trainer_opts(trainer: str, mesh_shape, mode: str):
    opts = ["DATASET.BAG_PAD", "64", "DATASET.PATH.DIM", "32", "TPU.PREFETCH", "0",
            "MODEL.DROPOUT", "0.0", "DATALOADER.TRAIN.BATCH_SIZE", "4",
            "DATALOADER.TEST.BATCH_SIZE", "4", "TPU.MESH_AXES", "('data','seq')",
            "TPU.MESH_SHAPE", str(tuple(mesh_shape)), "TPU.SP_ATTENTION", mode]
    if trainer == "MBTRAIN":
        return opts + ["MODEL.HIDDEN_DIM", "32"]
    if trainer == "HFB":
        return opts
    return opts + ["TPU.ATTENTION", "flash"]


def one_step(trainer_name: str, cfg, with_eval: bool = False):
    """One step of a fresh trainer (dropout 0; MBTRAIN with its GAN phase,
    then one CCA update over two batches): (metrics, the gradients each
    optimizer stepped on, the state after the step), and with ``with_eval``
    the stepped model's eval logits of the first test batch (every data
    rank's rows)."""
    from imp_torch.engine import build_trainer

    tr = build_trainer(cfg, device="cpu")
    _zero_dropout(tr.model)
    seen = []
    opts = ([tr.optimizer] if trainer_name != "MBTRAIN"
            else [tr.main_opt, tr.gen_opt, tr.dis_p_opt, tr.dis_o_opt])
    for opt in opts:
        def step(grads, _orig=opt.step):
            seen.append([None if g is None else g.detach().clone() for g in grads])
            return _orig(grads)

        opt.step = step
    db = tr._device_batch(next(iter(tr.train_loader)))
    metrics = tr.train_step(db, **({"train_gan": True} if trainer_name == "MBTRAIN" else {}))
    if trainer_name == "MBTRAIN":  # then one CCA update over a group of two batches
        group = []
        for batch in list(tr.train_loader)[:2]:
            d = tr._device_batch(batch)
            state = tr.generator.get_state()
            with torch.no_grad():
                group.append((d, state) + tr._cca_forward(d, False))

        class Recorder:
            def step(self, grads):
                seen.append([g.detach().clone() for g in grads])

        metrics["cca_loss"] = tr.cca_update(group, Recorder(), False)
    out = ({k: float(v) for k, v in metrics.items()}, seen,
           {k: v.detach().clone() for k, v in tr.model.state_dict().items()})
    if not with_eval:
        return out
    batch = next(iter(tr.test_loader))
    with torch.no_grad():
        logits = tr.model(tr._device_batch(batch))
    if isinstance(logits, dict):  # UMEML_GAN's outputs
        logits = logits["logits"]
    return out + (tr._gather_rows(logits, len(batch["patient_id"])),)


MESHES = (((2, 1), "gather"), ((1, 2), "gather"), ((1, 2), "ring"))
BF16 = ("TRAINER.PREC", "bf16")
#: (trainer, mesh shape, layout, options) of the steps beyond MESHES: bf16
#: under sp, a ``model`` axis the trainer replicates over, and HFB's
#: BatchNorm over ``data`` (on its own tree of 1 000 genes)
EXTRA_STEPS = (("TransMIL", (1, 2), "gather", BF16), ("TransMIL", (1, 2), "ring", BF16),
               ("MBTRAIN", (1, 2), "ring", BF16),
               ("TransMIL", (1, 2), "gather", ("TPU.MESH_AXES", "('data','model')")),
               ("HFB", (2, 1), "gather", ()))


def nystrom_odd_batch(rank: int, case: dict):
    """A Nyström attention whose batch of 3 is wrap-padded to 4 and split
    over a data axis of two ranks (rank 1 holds sample 2 and the copy of
    sample 0), its pseudo-inverse normalised over both ranks: this rank's
    output and the parameter gradients of both ranks' summed loss."""
    ax = Axis("data", 2, rank, dist.group.WORLD, [0, 1])
    attn = NystromAttention(**case["kwargs"])
    attn.load_state_dict(case["state"], strict=True)
    set_batch_axis(attn, ax)
    rows = slice(2 * rank, 2 * rank + 2)
    out = attn(case["x"][rows])
    return out.detach(), _param_grads(attn, (out * case["w"][rows]).sum(), ax)


def float64_grads(cfg):
    """The gradients of a fresh one-process StandardTrainer's first step
    (its loss on the first training batch), replayed in float64, in the
    optimizer's parameter order."""
    from imp_torch.engine import build_trainer

    tr = build_trainer(cfg, device="cpu")
    _zero_dropout(tr.model).double()
    db = {k: v.double() if v.is_floating_point() else v
          for k, v in tr._device_batch(next(iter(tr.train_loader))).items()}
    out = tr.model(db, train=True, generator=tr.generator)
    logits = out["logits"] if isinstance(out, dict) else out
    loss = tr.task_loss(logits, db) + tr.extra_loss(out, db)
    return list(torch.autograd.grad(loss, tr.optimizer.params))


def extra_step(root: str, hfb_root: str, out: str, repo: str, name, shape, mode, extra):
    """:func:`one_step` of an :data:`EXTRA_STEPS` entry, with the eval
    logits (``shape`` (1, 1): the one-process step)."""
    cfg = trainer_cfg(hfb_root if name == "HFB" else root, out, name, shape, mode, repo, extra)
    return one_step(name, cfg, with_eval=True)


def trainer_rank(rank: int, root: str, out: str, repo: str, hfb_root: str):
    """The trainer steps of every mesh of :data:`MESHES` for TransMIL and
    MBTRAIN and of :data:`EXTRA_STEPS`, then one CLI epoch of TransMIL at
    (1, 2) ring, where rank 1 may not write a checkpoint, then
    :func:`nystrom_odd_batch` on the case saved at
    ``<out>/nystrom_odd_batch.pt``; returns the steps, the epoch's eval
    logits on the first test batch and the odd batch's results."""
    steps = {}
    for name in ("TransMIL", "MBTRAIN"):
        for shape, mode in MESHES:
            cfg = trainer_cfg(root, os.path.join(out, f"step{rank}"), name, shape, mode, repo)
            steps[(name, shape, mode)] = one_step(name, cfg)
    for entry in EXTRA_STEPS:
        steps[entry] = extra_step(root, hfb_root, os.path.join(out, f"step{rank}"), repo, *entry)
    import imp_torch.engine.trainer as trainer_mod
    from imp_torch.engine import build_trainer
    from imp_torch.tools import train

    saved = trainer_mod.save_checkpoint
    if rank != 0:
        def refuse(*args, **kwargs):
            raise AssertionError("a rank other than 0 wrote a checkpoint")

        trainer_mod.save_checkpoint = refuse
    cli_out = os.path.join(out, "cli")
    argv = ["--root", root, "--seed", "1", "--trainer", "TransMIL", "--config-file",
            os.path.join(repo, "configs/Survival/TransMIL.yaml"), "--output-dir", cli_out,
            "--device", "cpu"] + trainer_opts("TransMIL", (1, 2), "ring") + [
            "OPTIM.MAX_EPOCH", "1"]
    try:
        result = train.run(argv)
    finally:
        trainer_mod.save_checkpoint = saved
    # the trained weights' eval logits under the ring, on the first test batch
    cfg = trainer_cfg(root, os.path.join(out, f"eval{rank}"), "TransMIL", (1, 2), "ring", repo)
    tr = build_trainer(cfg, device="cpu")
    tr.load_model(cli_out)
    batch = next(iter(tr.test_loader))
    with torch.no_grad():
        logits = tr._gather_rows(tr.model(tr._device_batch(batch)), len(batch["patient_id"]))
    odd = nystrom_odd_batch(rank, torch.load(os.path.join(out, "nystrom_odd_batch.pt"),
                                             weights_only=False))
    return {"steps": steps, "cli_result": result, "logits": logits, "odd_batch": odd}


# ---------------------------------------------------------------------------
# the CLIP towers: tensor and pipeline parallelism, the extraction tools
# ---------------------------------------------------------------------------


def block_mesh(dims: dict):
    """The mesh of ``dims`` (axis -> size) on each block of consecutive
    ranks of its size (a world of 4 holds two meshes of 2): every rank
    creates every group, in one order."""
    import numpy as np

    from imp_torch.parallel.mesh import MESH_AXES, Mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    full = [dims.get(a, 1) for a in MESH_AXES]
    size = int(np.prod(full))
    grid = np.arange(world).reshape([world // size] + full)
    axes = []
    for k, name in enumerate(MESH_AXES):
        mine = Axis(name, ranks=[rank])
        if full[k] > 1:
            for line in np.moveaxis(grid, k + 1, -1).reshape(-1, full[k]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = Axis(name, full[k], list(line).index(rank), group,
                                [int(r) for r in line])
        axes.append(mine)
    members = [int(r) for r in grid[rank // size].reshape(-1)]
    return Mesh(dict(zip(MESH_AXES, full)), *axes, Axis("block", size, members.index(rank),
                                                         None, members), torch.device("cpu"))


def tower_rank(rank: int, path: str):
    """The tensor- and pipeline-parallel towers of the case at
    ``path`` on every mesh it lists; returns {case name: features}."""
    from imp_torch.models.clip import TextTransformer, VisionTransformer
    from imp_torch.parallel.pipeline import make_pp_encode, put_pp_params, split_vision_params_pp
    from imp_torch.parallel.tensor import (make_tp_encode, make_tp_encode_text, put_tp_params,
                                           split_text_params_tp, split_vision_params_tp)

    case = torch.load(path, weights_only=False)
    out = {}
    vit = VisionTransformer(**case["vit_kwargs"])
    txt = TextTransformer(**case["txt_kwargs"])
    for dp, tp in case.get("tp", ()):
        mesh = block_mesh({"data": dp, "model": tp})
        params = put_tp_params(split_vision_params_tp(case["vit_state"], tp), mesh)
        out[("vit", dp, tp)] = make_tp_encode(vit, mesh)(params, case["images"])
        out[("vit_bytes", dp, tp)] = sum(v.numel() * v.element_size()
                                         for blk in params["shard"].values() for v in blk.values())
        params = put_tp_params(split_text_params_tp(case["txt_state"], tp), mesh)
        out[("text", dp, tp)] = make_tp_encode_text(txt, mesh)(params, case["tokens"])
    for dp, pp, mb in case.get("pp", ()):
        mesh = block_mesh({"data": dp, "pipe": pp})
        params = put_pp_params(split_vision_params_pp(case["vit_state"], pp), mesh)
        out[("pp", dp, pp, mb)] = make_pp_encode(vit, mesh, mb)(params, case["images"])
    return out


def tools_rank(rank: int, cfg: dict, root: str, out: str):
    """``clip_feature_dp`` over this group, then ``clip_feature --tp`` and
    ``--pp`` over its slides, with the tiny tower ``cfg`` as ViT-B/32 (the
    spawned ranks import the config table afresh); a rank other than 0 may
    not write."""
    from imp_torch.models import clip
    from imp_torch.tools import clip_feature, clip_feature_dp

    clip.CLIP_CONFIGS["ViT-B/32"] = cfg
    if rank != 0:
        def refuse(*args, **kwargs):
            raise AssertionError("a rank other than 0 wrote features")

        clip_feature.write_features = clip_feature_dp.write_features = refuse
    argv = ["--root", root, "--dataset", "tcga_x", "--output-dir", os.path.join(out, "dp"),
            "--model", "clip_vit_b32", "--random-weights", "--batch-size", "3",
            "--device", "cpu"]
    clip_feature_dp.main(argv)
    clip_feature_dp.main(argv)  # the resume: every slide done
    src = os.path.join(root, "tcga_x", "images", "train")
    for flag in ("--tp", "--pp"):
        clip_feature.main(["--src", src, "--dst", os.path.join(out, flag[2:]), "--model",
                           "ViT-B/32", "--key", "clip_feature", "--random-weights",
                           "--batch-size", "4", "--microbatches", "2", flag, "2",
                           "--device", "cpu"])
    return rank
