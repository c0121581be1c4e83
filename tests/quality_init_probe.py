"""Which part of a fold's result comes from the initial weights: one fold of
the CPU quality study (``imp_torch.tools.quality_parity``'s root and
options, dropout and the replacement ramp on), trained by imp_tpu's MBTRAIN
and by the port's MBTRAIN, the port either from its own initial draw or
from the JAX trainer's initial ``params`` (``imp_torch.convert``):

    python tests/quality_init_probe.py --root qp_data --task Survival --fold 1 \\
        [--init-seed 101] [--port-init jax|own] [--no-jax]

``--init-seed`` sets ``SEED`` (the initial draw and the dropout stream of
both packages) apart from the fold (default: the fold, as the protocol
does).  Prints one ``RESULT`` JSON line: the fold, the seed, and the test
metric of each run.  A helper of the study, not a test: it imports both
packages and runs on the CPU.
"""

import argparse
import contextlib
import io
import json
import os
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--task", default="Survival")
    ap.add_argument("--fold", type=int, required=True)
    ap.add_argument("--init-seed", type=int, default=None)
    ap.add_argument("--port-init", default="jax", choices=("jax", "own"))
    ap.add_argument("--no-jax", action="store_true", help="do not train the JAX side")
    ap.add_argument("--out", default="qp_probe")
    args = ap.parse_args(argv)
    seed = args.fold if args.init_seed is None else args.init_seed

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    import flax
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in ("matplotlib", "torch.utils.tensorboard"):  # slow imports, no output needed
        sys.modules[name] = None
    import numpy as np
    from flax.traverse_util import flatten_dict

    from imp_tpu.config import get_cfg_default as jax_cfg_default
    from imp_tpu.engine import build_trainer as jax_build_trainer
    from imp_torch.config import get_cfg_default
    from imp_torch.convert import umeml_gan_state_dict
    from imp_torch.engine import build_trainer
    from imp_torch.tools.quality_parity import build_parser, options

    opts = options(build_parser().parse_args(["--run", "--task", args.task]))

    def cfg_of(get_default, out):
        cfg = get_default()
        cfg.merge_from_file(osp.join(REPO, "configs", args.task, "UMEML_GAN.yaml"))
        cfg.TRAINER.NAME, cfg.SEED, cfg.DATASET.FOLD = "MBTRAIN", seed, args.fold
        cfg.DATASET.ROOT, cfg.OUTPUT_DIR, cfg.VERBOSE = args.root, out, False
        cfg.merge_from_list(opts)
        return cfg

    init = flax.linen.Module.init  # compiled: op by op it takes ~20 s

    def jit_init(self, rngs, *a, method=None, **kw):
        return jax.jit(lambda r, *b: init(self, r, *b, method=method, **kw))(rngs, *a)

    flax.linen.Module.init = jit_init
    base = osp.join(args.out, f"{args.task}_fold{args.fold}_seed{seed}_{args.port_init}")
    jcfg = cfg_of(jax_cfg_default, osp.join(base, "jax"))
    jcfg.TPU.MESH_SHAPE = (1,)
    jtrainer = jax_build_trainer(jcfg)
    result = {"task": args.task, "fold": args.fold, "seed": seed, "port_init": args.port_init}
    if not args.no_jax:
        with contextlib.redirect_stdout(io.StringIO()):
            result["imp_tpu"] = float(jtrainer.train())
    cfg = cfg_of(get_cfg_default, osp.join(base, "port"))
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    if args.port_init == "jax":
        params = {"/".join(k): np.asarray(v)
                  for k, v in flatten_dict(jtrainer.state["params"]).items()}
        trainer.model.load_state_dict(umeml_gan_state_dict(params), strict=True)
    with contextlib.redirect_stdout(io.StringIO()):
        result["imp_torch"] = float(trainer.train())
    print("RESULT", json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
