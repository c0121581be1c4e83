"""Where a sequence-parallel UMEML_GAN step leaves the one-rank step, on one
card: ``python3 sp_precision_probe.py`` (without a card: a dry run of the
same code at a 300-token bag on the CPU).

``chip_smoke.py``'s ``train_sp`` finds the gradients of ``p_proto`` and of
the proto blocks' norm weights ~1.3e-4 from the one-rank step under sp.
This script takes UMEML_GAN at batch 8, bag 10 000 (``train_sp``'s one-rank
trainer) and runs one train forward and backward (loss: task +
modularity + distillation) as

* ``K`` the one-rank model through the kernels, ``P`` through the plain
  versions, ``X64`` its float64 replay (plain versions);
* ``S`` the gather layout's code on an axis of one rank (distributed
  softmax in the prototype cross-attention, the sharded modularity
  passes), ``S64`` its float64 replay;
* ``A`` only the cross-attention sharded, ``B`` only the modularity passes;

and prints one JSON line: each run's loss, every gradient past 3e-5 of
``X64`` (also its modularity part alone), the pairs whose prototype argmax
differs between runs (``chip_smoke.argmax_flips``), and the spread of
float32 itself: six copies of the weights each moved by 2^-22 (relative,
normal), one-rank and layout, each against its own float64 replay.
"""

import copy
import json
import os
import sys
import tempfile
import time

import torch

import chip_smoke as C


def main() -> int:
    from imp_torch import kernels
    from imp_torch.parallel.collectives import Axis

    t0 = time.time()
    if torch.cuda.is_available():
        print(C.card_line(), flush=True)
        kernels.build()
        for name in kernels.KERNELS:
            kernels.load(name)
    else:
        C.DEVICE = "cpu"
        C.TRAIN_LENGTHS = tuple(min(x, 300) for x in C.TRAIN_LENGTHS)
        C.FLAGSHIP["DATASET.BAG_PAD"] = 300
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = C.make_train_tree(os.path.join(tmp, "tree"))
        tr, db = C.sp_trainer(root, os.path.join(tmp, "o"), "MBTRAIN", (1, 1), "gather")
        names = [n for n, _ in tr.model.named_parameters()]
        db64 = {k: v.double() if v.is_floating_point() else v for k, v in db.items()}

        def run(model, batch):
            params = list(model.parameters())
            with C.modularity_inputs() as seen, tr._scope():
                out = model(batch, train=True,
                            generator=torch.Generator(device=batch["img"].device).manual_seed(0))
                mod = out["modular_loss"]
                total = tr.task_loss(out["logits"], batch) + mod + out["loss_kd"]
                g_total = torch.autograd.grad(total, params, allow_unused=True, retain_graph=True)
                g_mod = torch.autograd.grad(mod, params, allow_unused=True)

            def fill(gs):
                return [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(params, gs)]
            return {"total": fill(g_total), "mod": fill(g_mod), "inputs": seen[0],
                    "loss": total.item(), "modular_loss": mod.item()}

        def layout(model, cross: bool, passes: bool):
            m = copy.deepcopy(model)
            ax = Axis("seq")
            m.seq, m.sp_mode = (ax if passes else None), "gather"
            for blk in m.proto_g_blocks:
                blk.cross_attn.seq = ax if cross else None
            return m

        runs = {"K": run(tr.model, db)}
        with C.plain_everything():
            runs["P"] = run(tr.model, db)
            m64 = copy.deepcopy(tr.model).double()
            runs["X64"] = run(m64, db64)
            runs["S64"] = run(layout(m64, True, True), db64)
            del m64
        runs["S"] = run(layout(tr.model, True, True), db)
        runs["A"] = run(layout(tr.model, True, False), db)
        runs["B"] = run(layout(tr.model, False, True), db)
        res["losses"] = {k: [v["loss"], v["modular_loss"]] for k, v in runs.items()}

        ref, rows = runs["X64"], {}
        for i, n in enumerate(names):
            x = ref["total"][i]
            row = {k: C.rel_err(runs[k]["total"][i].double(), x)
                   for k in ("K", "P", "S", "S64", "A", "B")}
            row["S_vs_K"] = C.rel_err(runs["S"]["total"][i], runs["K"]["total"][i])
            if ref["mod"][i].abs().max() > 0:  # the modularity part, relative to the whole
                for k in ("K", "S"):
                    row[f"modularity_part_{k}"] = ((runs[k]["mod"][i].double() - ref["mod"][i])
                                                   .abs().max() / x.abs().max()
                                                   .clamp_min(1e-30)).item()
            if max(row.values()) > 3e-5:
                rows[n] = row
        res["grads_past_3e-5_vs_X64"] = rows
        res["argmax_flips"] = {f"{a}_vs_{b}": C.argmax_flips(runs[a]["inputs"], runs[b]["inputs"])
                               for a, b in (("K", "X64"), ("S", "X64"), ("S", "K"),
                                            ("A", "K"), ("B", "K"))}
        del runs

        watch = [i for i, n in enumerate(names) if n == "p_proto" or "norm1.weight" in n]
        spread = []
        for trial in range(6):
            gen = torch.Generator(device=C.DEVICE).manual_seed(100 + trial)
            for which in ("one_rank", "layout"):
                m = copy.deepcopy(tr.model) if which == "one_rank" else layout(tr.model, True, True)
                with torch.no_grad():
                    for p in m.parameters():
                        p.mul_(1 + 2.0 ** -22 * torch.randn(p.shape, generator=gen,
                                                            device=p.device))
                g32 = run(m, db)["total"]
                with C.plain_everything():
                    g64 = run(copy.deepcopy(m).double(), db64)["total"]
                errs = {names[i]: C.rel_err(g32[i].double(), g64[i]) for i in range(len(names))}
                worst = max(errs, key=errs.get)
                spread.append({"trial": trial, "run": which,
                               "watched": {names[i]: errs[names[i]] for i in watch},
                               "worst": [worst, errs[worst]]})
                del m, g32, g64
        res["float32_spread"] = spread
    res["seconds"] = time.time() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
