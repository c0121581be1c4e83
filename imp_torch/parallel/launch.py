"""Spawn a local group of ranks — the torch form of JAX's one process that
sees every device.  The CPU tests and ``chip_smoke.py`` use it;
``torchrun`` does the same job for ``python -m imp_torch.tools.train``.

:func:`spawn` starts ``nprocs`` processes (``torch.multiprocessing``'s
spawn context), each joining one process group through a ``file://``
rendezvous with a timeout on its collectives, and runs ``fn(rank, *args)``
in each.  What ``fn`` returns comes back through ``torch.save`` files.  It
waits for all of them within a wall limit: when the limit passes, or a
rank fails, it kills every rank and raises, so a stalled collective fails
the caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for, rank_device


def _rank_main(fn, rank, nprocs, init_file, device, threads, out_dir, timeout, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    try:
        torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(device, nprocs), init_method=f"file://{init_file}",
                                rank=rank, world_size=nprocs,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence = (), device: str = "cpu",
          timeout: float = 120.0, threads: int = 1) -> List[Any]:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each run in its own
    rank of one process group on ``device`` (``cuda`` puts rank r on card
    r, or shares the cards there are over gloo).  ``fn`` must be importable
    by module and name.  Raises ``TimeoutError`` when the ranks are not all
    done within ``timeout`` seconds, ``RuntimeError`` when one fails; every
    rank is killed either way."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="imp_spawn_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        coll_timeout = max(10, int(timeout) - 5)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nprocs, init_file, device, threads, tmp,
                                   coll_timeout, tuple(args)))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                       f"not done within {timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
