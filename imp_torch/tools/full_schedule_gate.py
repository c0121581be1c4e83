"""Full-schedule throughput-vs-quality gate on the port — the counterpart of
``tools/full_schedule_gate.sh``:

    python -m imp_torch.tools.full_schedule_gate [OUT_DIR] [--root DATA] \\
        [--seeds 1 2 3 4 5] [--device cuda|cpu] [KEY VALUE ...]

It holds the batch-8 + linear-lr throughput configuration
(``configs/Survival/UMEML_GAN_THROUGHPUT.yaml``, arm ``b8``) against the
batch-2 reference schedule (``configs/Survival/UMEML_GAN.yaml``, arm
``b2``) at the full 10-epoch curriculum (GAN from epoch 3, the replacement
ramp from epoch 5, a CCA epoch after every epoch but the last) on the same
synthetic folds: 200 slides, bags of 256-2048 patches of 512 features,
1 020 genes in groups of 170, seed 0, ``DATASET.BAG_PAD 2048``.  Seeds are
interleaved (seed 1 b2, seed 1 b8, seed 2 b2, ...) so a partial run stays
comparable; a run whose directory holds ``done`` is skipped.  Each run goes
through ``imp_torch.tools.run_method`` (in process) into
``OUT_DIR/<arm>/Survival/<config>/seed<N>``; the gate ends with
``imp_torch.tools.parse_test_res --keyword cindex`` over each arm.

The root is made once (``--root``, default ``OUT_DIR/data``).  Where h5py
is absent the bags are written with ``np.save`` (``<slide>.h5.npy``, the
same numbers) and read back with ``np.load`` (:func:`npy_bags`).
"""

from __future__ import annotations

import argparse
import contextlib
import os.path as osp
import time
from typing import Dict, Optional, Sequence

import numpy as np

from . import parse_test_res
from .run_method import main as run_method, take_seeds

ARMS = {"b2": "UMEML_GAN", "b8": "UMEML_GAN_THROUGHPUT"}
TREE = dict(num_slides=200, bag_min=256, bag_max=2048, feat_dim=512, num_genes=1020,
            group_size=170, seed=0)
BAG_PAD = 2048


def has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def make_root(root: str) -> None:
    """The gate's synthetic tree under ``root`` (once)."""
    from ..data import synthetic

    if not osp.isdir(osp.join(root, "tcga_glioma")):
        synthetic.materialize(root, bags=True if has_h5py() else "npy", **TREE)
        print(f"materialized {root}", flush=True)


@contextlib.contextmanager
def npy_bags():
    """The port's SlideDataset reading ``<slide>.h5.npy`` where h5py is
    absent (the rest of the reader as usual); nothing changes with h5py."""
    if has_h5py():
        yield
        return
    from ..data.manager import SlideDataset

    def load(self, idx):
        return np.load(self.data_source[idx].impath + ".npy").astype(np.float32, copy=False)

    reader = SlideDataset._load_bag
    SlideDataset._load_bag = load
    try:
        yield
    finally:
        SlideDataset._load_bag = reader


def arm_dir(out: str, arm: str) -> str:
    return osp.join(out, arm, "Survival", ARMS[arm])


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the arms' seeds (interleaved, finished runs skipped), then parse
    each arm; returns {"runs": {(arm, seed): metric or "skipped"},
    "summary": {arm: {metric: (mean, sd)}}, "seconds": {(arm, seed): s}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="fullgate_out")
    ap.add_argument("--root", default="", help="the synthetic root (default OUT/data)")
    ap.add_argument("--seeds", nargs="+", default=["1", "2", "3", "4", "5"])
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    args, opts = ap.parse_known_args(argv)
    args.seeds, more = take_seeds(args.seeds)
    opts = more + opts
    root = args.root or osp.join(args.out, "data")
    make_root(root)

    runs, seconds = {}, {}
    with npy_bags():
        for seed in args.seeds:
            for arm, config in ARMS.items():
                run_dir = osp.join(arm_dir(args.out, arm), f"seed{seed}")
                if osp.isfile(osp.join(run_dir, "done")):
                    print(f"SKIP {arm} seed{seed} (done)", flush=True)
                    runs[(arm, seed)] = "skipped"
                    continue
                print(f"=== {time.strftime('%H:%M:%S')} RUN {arm} seed{seed} ===", flush=True)
                t0 = time.perf_counter()
                res = run_method(["Survival", config, "MBTRAIN", root, "--seeds", str(seed),
                                  "--device", args.device,
                                  "--output-root", osp.join(args.out, arm),
                                  "DATASET.BAG_PAD", str(BAG_PAD), *opts])
                seconds[(arm, seed)] = time.perf_counter() - t0
                runs[(arm, seed)] = res["results"][seed]
                open(osp.join(run_dir, "done"), "w").close()
    print(f"=== {time.strftime('%H:%M:%S')} ALL DONE ===")
    summary = {}
    for arm in ARMS:
        print(f"--- {arm} ---")
        metric = parse_test_res.metric_regex("cindex")
        parse_test_res.parse_function(metric, directory=arm_dir(args.out, arm),
                                      end_signal="Finish training")
        summary[arm] = parse_test_res.summarize(parse_test_res.collect(
            metric, directory=arm_dir(args.out, arm), end_signal="Finish training"))
    return {"runs": runs, "summary": summary, "seconds": seconds}


if __name__ == "__main__":
    main()
