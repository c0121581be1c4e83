"""Benchmark: UMEML_GAN survival training throughput (slides/s) on one card,
at the reference workload scale (bags padded to 10 000 x 512-d features,
hidden 256, 6 prototypes); the counterpart of the JAX package's root
``bench.py``.

    python -m imp_torch.tools.bench [--prec fp32|bf16|amp] [--batch-size 8]
        [--no-gan] [--no-mod] [--no-opt] [--no-kd] [--device cuda]
        [--baseline output/bench_torch_baseline.json]

The timed region is the full train step with the GAN phase on
(:func:`build_step`): one encode forward shared by the generator and
discriminator updates and the main loss, then the main update, as
``imp_torch.engine.mbtrain.MBTRAIN`` runs it.  The knockouts drop a phase
for cost attribution.  ``--prec bf16``/``amp`` run the encode and the
main phase's ``finish`` under the precision policy
(:func:`imp_torch.engine.precision.amp_call`).

Protocol: 8 untimed steps, then 5 windows of 15 steps, each synchronised
at both ends.  ``value`` is the median window's slides/s (the JAX tool
reports the best window; here the same step moves between calls, so the
median is the figure and ``best`` and every window stand beside it).

The baseline file (``--baseline``, under the gitignored ``output/`` by
default) is a dict keyed by the run's description: its shape, precision,
attention, pseudo-inverse mode, knockouts and card.  A key seen for the
first time is recorded and reports ``vs_baseline`` 1.0, so runs of
different shapes never compare.  The JAX package's ``bench_baseline.json``
is neither read nor written.

Prints one JSON line.  ``--device cuda`` on a host without a card fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from imp_torch.engine.mbtrain import DIS_KEYS, GEN_KEYS

#: reference gene-group sizes (umeml_gan.py:274)
GENE_GROUP_SIZES = (82, 330, 513, 440, 1538, 451)
#: the kernels a step may launch (K4-K7), reported per step
STEP_KERNELS = ("modularity_deg", "modularity_combined", "pinv_fwd", "pinv_bwd")
BURN_IN, WINDOWS, WINDOW_STEPS = 8, 5, 15
REPLACE_RATIO = 0.1
DEFAULT_BASELINE = os.path.join("output", "bench_torch_baseline.json")


def build_canonical_model(hidden: int = 256, feat_dim: int = 512, device="cuda",
                          **model_kwargs):
    """The canonical bench model (UMEML_GAN at the shipped config) on
    ``device``, its weights drawn from seed 0.  ``model_kwargs`` reach the
    ``umeml_gan`` builder (``pinv_mode``, ``head_fused``, ``stacked_pairs``,
    ``bag_dtype``).  One definition shared by :func:`build_step` and
    ``bench_anatomy``.  Returns ``(cfg, model)``."""
    from imp_torch.config import get_cfg_default
    from imp_torch.models import build_model  # looked up at call time, as JAX does

    cfg = get_cfg_default()
    cfg.MODEL.NAME = "umeml_gan"
    cfg.MODEL.HIDDEN_DIM = hidden
    cfg.MODEL.FUSION = "concat"
    cfg.MODEL.DROPOUT = 0.25
    cfg.MODEL.UMEML.PROTOTYPES = 6
    cfg.MODEL.UMEML.REGISTERS = 3
    cfg.DATASET.PATH.DIM = feat_dim  # flax infers it from the batch; torch builds with it
    starts = np.cumsum([0] + list(GENE_GROUP_SIZES))
    groups = [list(range(starts[i], starts[i + 1])) for i in range(len(GENE_GROUP_SIZES))]
    model = build_model("umeml_gan", cfg=cfg, num_classes=4, gene_group_indexes=groups,
                        device=device, generator=torch.Generator().manual_seed(0),
                        **model_kwargs)
    return cfg, model


def bench_optim(optim_cfg):
    """``optim_cfg`` (an ``OPTIM`` node) at the bench's main optimizer
    settings: LR 2e-4, WD 1e-4, cosine, one warm-up epoch, 10 epochs."""
    optim_cfg.LR, optim_cfg.WEIGHT_DECAY, optim_cfg.LR_SCHEDULER = 2e-4, 1e-4, "cosine"
    optim_cfg.WARMUP_EPOCH, optim_cfg.MAX_EPOCH = 1, 10
    return optim_cfg


def make_batch(batch_size: int, bag_pad: int, feat_dim: int, num_genes: int) -> Dict:
    """The bench batch as numpy arrays, drawn from ``default_rng(0)`` in the
    order and dtypes of the JAX bench, so both packages see the same
    numbers."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(bag_pad // 3, bag_pad, size=batch_size)
    lengths[-1] = bag_pad
    return {
        "img": rng.normal(size=(batch_size, bag_pad, feat_dim)).astype(np.float32),
        "img_mask": np.arange(bag_pad)[None, :] < lengths[:, None],
        "mol": rng.lognormal(size=(batch_size, num_genes)).astype(np.float32),
        "label": rng.integers(0, 4, batch_size).astype(np.int32),
        "censorship": rng.integers(0, 2, batch_size).astype(np.float32),
        "without_omic": np.zeros((batch_size,), np.float32),
        "insample_without_omic": np.zeros((batch_size, num_genes), np.int32),
        "omic_means": np.ones((num_genes,), np.float32),
    }


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card that is absent raises (a
    measurement never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card (torch.cuda.is_available() is false)")
    return device


def build_step(batch_size=2, bag_pad=10000, feat_dim=512, num_genes=3360, hidden=256,
               prec="fp32", no_gan=False, no_mod=False, no_opt=False, no_kd=False,
               device="cuda", **model_kwargs):
    """``(step, state, batch)``: ``step(state, batch, generator,
    replace_ratio) -> loss`` runs one full train step in place on
    ``state`` (the model and its four optimizers, under the JAX state's
    names) and returns the loss, a 0-d tensor on the device.  Its parts
    stand on it as ``step.encode(state, batch, generator)``,
    ``step.gan_phase(state, enc)`` and ``step.loss_and_grads(state, batch,
    generator, replace_ratio)`` (the step without the main update).

    One encode forward (its graph kept) serves the GAN phase and the main
    loss.  The GAN phase steps the generators, then ``dis_p``, then
    ``dis_o``, each by Adam with coupled decay 1e-4 at lr 1e-4 on the
    gradient of its own loss with respect to its own parameters (the
    discriminators see the updated generators).  The main loss (survival
    NLL at alpha 0, plus the modularity loss and the distillation loss)
    runs ``finish`` with the updated generators and is differentiated with
    respect to every non-discriminator parameter through ``finish`` and
    the kept encode; ``build_optimizer`` (LR 2e-4, WD 1e-4, cosine, one
    warm-up epoch of 100 updates, 10 epochs) steps them, with coupled decay
    on all of them (the JAX bench passes no decay mask).  ``no_opt``
    consumes the gradients as ``loss + 0 * sum(g)`` and skips the update."""
    from imp_torch.engine.precision import amp_call, bf16_matmul_scope
    from imp_torch.engine.trainer import device_batch
    from imp_torch.losses.survival import build_loss
    from imp_torch.optim import build_optimizer, gan_optimizer

    device = check_device(device)
    cfg, model = build_canonical_model(hidden, feat_dim, device, **model_kwargs)
    batch = device_batch(make_batch(batch_size, bag_pad, feat_dim, num_genes), device)

    named = dict(model.named_parameters())

    def part(keep):
        return [p for n, p in named.items() if keep(n.split(".")[0])]

    main_params = part(lambda top: top not in DIS_KEYS)
    state = {
        "model": model,
        "opt_state": build_optimizer(bench_optim(cfg.OPTIM), main_params, updates_per_epoch=100),
        "gen_opt": gan_optimizer(part(lambda t: t in GEN_KEYS), 1e-4, 1e-4),
        "dis_p_opt": gan_optimizer(part(lambda t: t == "gan_discriminator_p"), 1e-4, 1e-4),
        "dis_o_opt": gan_optimizer(part(lambda t: t == "gan_discriminator_o"), 1e-4, 1e-4),
    }
    loss_obj = build_loss("nllsurvloss_new", alpha=0.0, reduction="mean")
    cdtype = torch.bfloat16 if prec in ("bf16", "amp", "fp16") else None

    def encode(state, batch, generator: torch.Generator):
        """The encode forward, its graph kept for the main loss."""
        return amp_call(state["model"], "encode", cdtype, batch, train=True,
                        generator=generator)

    def gan_phase(state, enc) -> torch.Tensor:
        """The generators', then ``dis_p``'s, then ``dis_o``'s Adam step on
        ``enc``'s detached features; returns the last loss."""
        model = state["model"]
        hp, ho = enc["h_path"].detach(), enc["h_omic"].detach()
        with bf16_matmul_scope(cdtype):
            for name, loss_fn in (("gen_opt", model.gen_loss), ("dis_p_opt", model.dis_p_loss),
                                  ("dis_o_opt", model.dis_o_loss)):
                opt = state[name]
                loss = loss_fn(hp, ho)
                opt.step(torch.autograd.grad(loss, opt.params, allow_unused=True))
        return loss.detach()

    def loss_and_grads(state, batch, generator: torch.Generator, replace_ratio: float):
        """The step up to the main update: the encode, the GAN phase (which
        steps its three optimizers) and the main loss with its gradients
        with respect to the main optimizer's parameters."""
        model = state["model"]
        with bf16_matmul_scope(cdtype):
            enc = encode(state, batch, generator)
            if not no_gan:
                gan_phase(state, enc)
            out = amp_call(model, "finish", cdtype, enc, batch, train=True,
                           replace_ratio=replace_ratio, generator=generator)
            loss = loss_obj(out["logits"], batch["label"], batch["censorship"])
            if not no_mod:
                loss = loss + out["modular_loss"]
            if not no_kd:
                loss = loss + out["loss_kd"]
            grads = torch.autograd.grad(loss, state["opt_state"].params, allow_unused=True)
        return loss, grads

    def step(state, batch, generator: torch.Generator, replace_ratio: float) -> torch.Tensor:
        loss, grads = loss_and_grads(state, batch, generator, replace_ratio)
        if no_opt:  # consume the gradients without the optimizer update
            return (loss + 0.0 * sum(g.sum() for g in grads if g is not None)).detach()
        state["opt_state"].step(grads)
        return loss.detach()

    # its parts, for bench_anatomy's sections and the kernels' check on the card
    step.encode, step.gan_phase, step.loss_and_grads = encode, gan_phase, loss_and_grads
    return step, state, batch


def describe(batch_size, bag_pad, feat_dim, num_genes, hidden, prec, model,
             knockouts: Dict[str, bool], card: str) -> Dict:
    """The run's description: its shape, precision, attention and
    pseudo-inverse mode as the model resolved them, knockouts, card."""
    from imp_torch.ops.attention import NystromAttention

    modes = sorted({m.pinv_mode for m in model.modules() if isinstance(m, NystromAttention)})
    return {"batch": batch_size, "bag_pad": bag_pad, "feat_dim": feat_dim,
            "num_genes": num_genes, "hidden": hidden, "prec": prec,
            "attention": model.attention, "pinv_mode": ",".join(modes) or None,
            **knockouts, "card": card}


def baseline_ratio(path: str, description: Dict, value: float) -> float:
    """``value`` over the baseline recorded under ``description``'s key in
    the dict at ``path``; a key seen for the first time is recorded and
    gives 1.0.  No other key is read."""
    key = json.dumps(description, sort_keys=True)
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    if key not in table:
        table[key] = {"slides_per_sec": value}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return value / table[key]["slides_per_sec"]


def time_windows(step, state, batch, batch_size: int, device, seed: int = 1,
                 burn_in: int = BURN_IN, windows: int = WINDOWS,
                 window_steps: int = WINDOW_STEPS) -> Dict:
    """``burn_in`` untimed steps, then ``windows`` synchronised windows of
    ``window_steps`` steps: slides/s of each window, their median and
    best, the last loss, and the kernels launched per timed step."""
    from imp_torch import kernels
    from imp_torch.utils.profiling import synchronize

    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(burn_in):
        loss = step(state, batch, g, REPLACE_RATIO)
    synchronize(device)
    kernels.reset_launches()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(window_steps):
            loss = step(state, batch, g, REPLACE_RATIO)
        synchronize(device)
        rates.append(batch_size * window_steps / (time.perf_counter() - t0))
    counted = kernels.launches()
    steps = windows * window_steps
    return {"value": statistics.median(rates), "best": max(rates), "windows": rates,
            "loss": float(loss),
            "launches_per_step": {k: counted[k] / steps for k in STEP_KERNELS}}


def card_of(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    from imp_torch.utils.profiling import card_line

    return card_line() if torch.device(device).type == "cuda" else "cpu"


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prec", default="fp32", choices=["fp32", "bf16", "amp"])
    # canonical = 8, the throughput configuration (UMEML_GAN_THROUGHPUT.yaml)
    ap.add_argument("--batch-size", type=int, default=8)
    for k in ("no-gan", "no-mod", "no-opt", "no-kd"):
        ap.add_argument(f"--{k}", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    args = ap.parse_args(argv)

    knockouts = {k: getattr(args, k) for k in ("no_gan", "no_mod", "no_opt", "no_kd")}
    b, bag_pad, feat_dim, num_genes, hidden = args.batch_size, 10000, 512, 3360, 256
    step, state, batch = build_step(b, bag_pad, feat_dim, num_genes, hidden, args.prec,
                                    device=args.device, **knockouts)
    timing = time_windows(step, state, batch, b, args.device)
    card = card_of(args.device)
    desc = describe(b, bag_pad, feat_dim, num_genes, hidden, args.prec, state["model"],
                    knockouts, card)
    row = {
        "metric": "umeml_gan_train_slides_per_sec_bag10k",
        "value": timing["value"],
        "unit": "slides/sec",
        "vs_baseline": baseline_ratio(args.baseline, desc, timing["value"]),
        "best": timing["best"], "windows": timing["windows"],
        "step_ms_median": b / timing["value"] * 1e3,
        **{k: v for k, v in desc.items() if k != "card"},
        "launches_per_step": timing["launches_per_step"],
        "loss_finite": bool(np.isfinite(timing["loss"])),
        "card": card, "device": str(torch.device(args.device)),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
