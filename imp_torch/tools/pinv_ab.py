"""Time versions of the pseudo-inverse kernels (K6, K7) in turns on one card,
and probe what their band products wait on.

Usage (on a CUDA host with nvcc):
    python -m imp_torch.tools.pinv_ab [--source LABEL=PATH ...]
        [--shape G,M ...] [--iters 20] [--probe] [--out FILE]

Each ``--source`` is a copy of ``imp_torch/csrc/pinv.cu`` (by default the
checkout's own, labelled ``current``).  Each is built with nvcc and
``imp_torch.kernels.NVCC_FLAGS`` beside the checkout's ``csrc/*.cuh`` into
``build/pinv_ab/`` and loaded with ``ctypes``.  At every shape the sources
run in turns A, B, ..., B, A on the same softmax-row inputs.  Each turn
gives K6's and K7's mean device ms over ``--iters`` launches (CUDA events),
the host µs per launch call, and the relative error of z, dx and Σdcp
against the plain versions.  ``--probe`` adds the probe of what a band
product waits on: one 8-CTA cluster, or sixteen at once, where each CTA
reads 8 KB bands (16 rows of 128 floats), one band and a barrier of the CTA
a round, from its own shared memory (``local``), from peer CTAs' shared
memory (``dsmem``), or from a global matrix that stays in L2 (``l2``,
``ld.global.cg``); or passes the cluster barrier, alone (``barrier``) or
after a fence (``fence_barrier``), once a round.  Each line gives clock64
cycles per round (and bytes per cycle and SM for reads).  Every result is one JSON line on stdout and in ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path

from imp_torch import kernels

PROBE_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
constexpr int kBandF4 = 16 * 128 / 4;  // one band: 16 rows of 128 floats

// mode 0: read peers' shared memory; 1: own shared memory; 2: global (L2);
// 3: the cluster barrier alone; 4: a fence, then the cluster barrier (the
// kernels' cluster_sync). A read round is one band (each thread's share of
// it in flight at once), then a barrier of the CTA, as one k-slice of a
// band product.
__global__ void probe(int mode, int rounds, const float4* __restrict__ gsrc, float* sink,
                      long long* cycles) {
  __shared__ float4 band[kBandF4];
  auto cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), size = cluster.num_blocks();
  for (int i = threadIdx.x; i < kBandF4; i += blockDim.x) band[i] = make_float4(i, rank, 1.f, 2.f);
  const float4* mat = gsrc + (size_t)(blockIdx.x / size) * size * kBandF4;
  cluster.sync();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    if (mode >= 3) {
      if (mode == 4) __threadfence();
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      continue;
    }
    const int peer = (rank + 1 + r % (size - 1)) % size;
    const float4* src = mode == 0 ? cluster.map_shared_rank(band, peer)
                      : mode == 1 ? band : mat + peer * kBandF4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBandF4; i += blockDim.x) {
      const float4 v = mode == 2 ? __ldcg(src + i) : src[i];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
  cluster.sync();  // no CTA leaves while a peer reads its band
}

extern "C" int imp_probe(int mode, int rounds, int ctas, int threads, const void* gsrc,
                         void* sink, void* cycles) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 8;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int err = static_cast<int>(cudaLaunchKernelEx(&cfg, probe, mode, rounds,
                                                static_cast<const float4*>(gsrc),
                                                static_cast<float*>(sink),
                                                static_cast<long long*>(cycles)));
  return err ? err : static_cast<int>(cudaDeviceSynchronize());
}
"""

OUT_DIR = kernels.BUILD_DIR.parent / "pinv_ab"
ITERS = 6  # Newton-Schulz steps, as the Nystrom layers run them


def emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def build(label: str, source: Path, functions: dict) -> ctypes.CDLL:
    """``source`` built beside the checkout's headers, loaded, with the
    argtypes of ``functions`` set."""
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(kernels.NVCC_FLAGS).encode())
    for header in sorted(kernels.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    work = OUT_DIR / f"{label}-{digest.hexdigest()[:12]}"
    lib = work / "lib.so"
    if not lib.is_file():
        work.mkdir(parents=True, exist_ok=True)
        for header in kernels.CSRC.glob("*.cuh"):
            shutil.copy(header, work / header.name)
        (work / source.name).write_bytes(text)
        done = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                               str(work / source.name)], capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{done.stdout}{done.stderr}")
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in functions.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def pinv_functions() -> dict:
    out = {}
    for name in ("pinv_fwd", "pinv_bwd"):
        out.update(kernels.KERNELS[name][1])
    return out


def layout(lib, m: int, iters: int) -> list:
    vals = [ctypes.c_int() for _ in range(8)]
    err = lib.imp_pinv_layout(m, iters, *map(ctypes.byref, vals))
    if err:
        raise RuntimeError(f"imp_pinv_layout({m}) failed: cudaError {err}")
    return [v.value for v in vals]


def turn(lib, x, c, g_out, ref, reps: int) -> dict:
    """One source's K6 and K7 at one shape: device ms by CUDA events, host
    µs per launch call, relative errors against the plain versions."""
    import torch

    g, m, _ = x.shape
    lay = layout(lib, m, ITERS)
    ws_f = torch.empty(max(1, g * lay[4]), device=x.device)
    ws_b = torch.empty(max(1, g * lay[5]), device=x.device)
    z, dx = torch.empty_like(x), torch.empty_like(x)
    dcp = torch.empty(g, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def fwd():
        return lib.imp_pinv_fwd_f32(x.data_ptr(), c.data_ptr(), z.data_ptr(), ws_f.data_ptr(),
                                    g, m, ITERS, stream)

    def bwd():
        return lib.imp_pinv_bwd_f32(x.data_ptr(), c.data_ptr(), g_out.data_ptr(), dx.data_ptr(),
                                    dcp.data_ptr(), ws_b.data_ptr(), g, m, ITERS, stream)

    row = {"layout": lay}
    for name, fn in (("fwd", fwd), ("bwd", bwd)):
        for _ in range(3):
            if fn():
                raise RuntimeError(f"{name} launch failed at g = {g}, m = {m}")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        row[f"{name}_ms"] = start.elapsed_time(end) / reps
        row[f"{name}_host_us_per_call"] = 1e6 * host / reps
    z_ref, dx_ref, dc_ref = ref

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    row.update(z_rel=rel(z, z_ref), dx_rel=rel(dx, dx_ref), dc_rel=rel(dcp.sum(), dc_ref))
    return row


def run_pinv(sources: dict, shapes, reps: int, out) -> None:
    import torch

    from imp_torch.ops import pinv as P

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {label: build(label, path, pinv_functions()) for label, path in sources.items()}
    order = list(libs) + list(reversed(libs))
    for g, m in shapes:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.softmax(torch.randn(g, m, m, device="cuda", generator=gen), dim=-1)
        g_out = torch.randn(g, m, m, device="cuda", generator=gen)
        c = P.norm_scalar(x).reshape(1)
        dx_ref, dcp_ref = P.pinv_bwd_reference(x, c, g_out, ITERS)
        ref = (P.pinv_fwd_reference(x, c, ITERS), dx_ref, dcp_ref.sum())
        for i, label in enumerate(order):
            emit({"source": label, "turn": i + 1, "g": g, "m": m,
                  **turn(libs[label], x, c, g_out, ref, reps)}, out)


def run_probe(out) -> None:
    import torch

    lib = build("probe", _probe_source(), {"imp_probe": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3})
    src = torch.randn(16 * 8 * 16 * 128, device="cuda")
    for ctas in (8, 128):
        for threads in (128, 256):
            for rounds in (8, 64):
                for mode, name in enumerate(("dsmem", "local", "l2", "barrier", "fence_barrier")):
                    sink = torch.empty(ctas * threads, device="cuda")
                    cycles = torch.zeros(ctas, dtype=torch.int64, device="cuda")
                    for _ in range(2):  # the second launch is the one read
                        err = lib.imp_probe(mode, rounds, ctas, threads, src.data_ptr(),
                                            sink.data_ptr(), cycles.data_ptr())
                        if err:
                            raise RuntimeError(f"probe {name} failed: cudaError {err}")
                    cyc = statistics.mean(cycles.tolist())
                    row = {"probe": name, "ctas": ctas, "threads": threads, "rounds": rounds,
                           "cycles": cyc, "cycles_per_round": cyc / rounds}
                    if mode < 3:
                        row["bytes_per_cycle_per_sm"] = rounds * 8192 / cyc
                    emit(row, out)


def _probe_source() -> Path:
    path = OUT_DIR / "probe.cu"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(PROBE_SRC)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--shape", action="append", default=[], metavar="G,M")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sources = dict(s.split("=", 1) for s in args.source) or {"current": kernels.CSRC / "pinv.cu"}
    shapes = [tuple(map(int, s.split(","))) for s in args.shape] or [(16, 128), (64, 128), (8, 256)]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    run_pinv({k: Path(v) for k, v in sources.items()}, shapes, args.iters, args.out)
    if args.probe:
        run_probe(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
