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
from imp_torch.parallel.collectives import Axis, _all_reduce, _gather

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
    for m in model.modules():
        if isinstance(m, (NystromAttention, ExactSelfAttention)):
            m.dropout = 0.0
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


def sequence_rank(rank: int, path: str):
    """Every check of ``test_torch_sequence_parallel.py`` at sp 2 (ranks 0-1
    and 2-3) and sp 4; returns {sp: {check: results}} of this rank."""
    case = torch.load(path, weights_only=False)
    results = {}
    for sp, ax in seq_axes(dist.get_world_size()).items():
        res = {}
        for part in (_modularity, _cross, _self_attention, _translayer_ppeg, _transmil,
                     _umeml_gan):
            res.update(part(case, ax))
        results[sp] = res
    return results


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


def trainer_cfg(root: str, out: str, trainer: str, mesh_shape, mode: str, repo: str):
    """The port's cfg of a tiny TransMIL (flash) or MBTRAIN (UMEML_GAN,
    hidden 32) run on the mesh ``mesh_shape`` of ``('data', 'seq')``."""
    from imp_torch.config import clean_cfg

    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(repo, "configs/Survival",
                                     {"MBTRAIN": "UMEML_GAN.yaml"}.get(trainer, "TransMIL.yaml")))
    cfg.DATASET.ROOT, cfg.OUTPUT_DIR, cfg.SEED, cfg.DATASET.FOLD = root, out, 1, 1
    cfg.TRAINER.NAME, cfg.VERBOSE = trainer, False
    cfg.merge_from_list(trainer_opts(trainer, mesh_shape, mode))
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
    return opts + ["TPU.ATTENTION", "flash"]


def one_step(trainer_name: str, cfg):
    """One step of a fresh trainer (dropout 0; MBTRAIN with its GAN phase,
    then one CCA update over two batches): (metrics, the gradients each
    optimizer stepped on, the state after the step)."""
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
    return ({k: float(v) for k, v in metrics.items()}, seen,
            {k: v.detach().clone() for k, v in tr.model.state_dict().items()})


MESHES = (((2, 1), "gather"), ((1, 2), "gather"), ((1, 2), "ring"))


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


def trainer_rank(rank: int, root: str, out: str, repo: str):
    """The trainer steps of every mesh of :data:`MESHES` for TransMIL and
    MBTRAIN, then one CLI epoch of TransMIL at (1, 2) ring, where rank 1
    may not write a checkpoint, then :func:`nystrom_odd_batch` on the case
    saved at ``<out>/nystrom_odd_batch.pt``; returns the steps, the epoch's
    eval logits on the first test batch and the odd batch's results."""
    steps = {}
    for name in ("TransMIL", "MBTRAIN"):
        for shape, mode in MESHES:
            cfg = trainer_cfg(root, os.path.join(out, f"step{rank}"), name, shape, mode, repo)
            steps[(name, shape, mode)] = one_step(name, cfg)
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
