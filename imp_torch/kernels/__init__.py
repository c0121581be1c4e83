"""Build, load and count the hand-written Hopper kernels of ``imp_torch/csrc``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  A library is built at first use, named by a hash of its source
and flags and of every header ``csrc/*.cuh`` (the sources include them),
under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); a later run with the same sources loads it again.  Several
kernels may share one source and its library (K2 and K3 live in
``flash_bwd.cu``, K4 and K5 in ``modularity.cu``, K6 and K7 in ``pinv.cu``).
:func:`build` starts one ``nvcc`` per source, all at once.

Each wrapper calls :func:`count_launch` where it launches its kernel and
nowhere else, so a run can show that its main path went through the
kernels: :func:`reset_launches` before it, :func:`launches` after.

Nothing here runs at import: this module imports on a host with no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: kernel name -> (source under csrc/, {C function: argtypes}); every C
#: function returns a cudaError_t as an int (of the launch, or of a query
#: such as ``imp_flash_bwd_layout``, which fills its int pointers)
KERNELS = {
    "flash_fwd": (
        "flash_fwd.cu",
        {"imp_flash_fwd_f32": [_P] * 6 + [_I] * 5 + [_P],
         "imp_flash_fwd_layout": [_I] + [ctypes.POINTER(_I)] * 2},
    ),
    "flash_bwd_dq": (
        "flash_bwd.cu",
        {"imp_flash_bwd_dq_f32": [_P] * 8 + [_I] * 5 + [_P],
         "imp_flash_bwd_layout": [_I] + [ctypes.POINTER(_I)] * 3},
    ),
    "flash_bwd_dkv": (
        "flash_bwd.cu",
        {"imp_flash_bwd_dkv_f32": [_P] * 9 + [_I] * 5 + [_P]},
    ),
    # K1-K3's bf16-operand entries (TRAINER.PREC bf16): the same libraries,
    # each entry counted apart (K1's widens to the fp32 kernel; K2's and
    # K3's are kernels of their own, dq_kernel_bf16 and dkv_kernel_bf16)
    "flash_fwd_bf16": (
        "flash_fwd.cu",
        {"imp_flash_fwd_bf16": [_P] * 6 + [_I] * 5 + [_P]},
    ),
    "flash_bwd_dq_bf16": (
        "flash_bwd.cu",
        {"imp_flash_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_P],
         "imp_flash_bwd_layout_bf16": [_I] + [ctypes.POINTER(_I)] * 3},
    ),
    "flash_bwd_dkv_bf16": (
        "flash_bwd.cu",
        {"imp_flash_bwd_dkv_bf16": [_P] * 9 + [_I] * 5 + [_P]},
    ),
    "modularity_deg": (
        "modularity.cu",
        {"imp_modularity_deg_f32": [_P] * 4 + [_I] * 3 + [_P],
         "imp_modularity_layout": [_I] * 3 + [ctypes.POINTER(_I)] * 4},
    ),
    "modularity_combined": (
        "modularity.cu",
        {"imp_modularity_combined_f32": [_P] * 11 + [_I] * 6 + [_F, _P],
         "imp_modularity_layout": [_I] * 3 + [ctypes.POINTER(_I)] * 4},
    ),
    "pinv_fwd": (
        "pinv.cu",
        {"imp_pinv_fwd_f32": [_P] * 4 + [_I] * 3 + [_P],
         "imp_pinv_layout": [_I] * 2 + [ctypes.POINTER(_I)] * 8},
    ),
    "pinv_bwd": (
        "pinv.cu",
        {"imp_pinv_bwd_f32": [_P] * 6 + [_I] * 3 + [_P]},
    ),
}

_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    _launches[name] += 1


def launches() -> Dict[str, int]:
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the Hopper kernels are built "
            "from imp_torch/csrc at first use on a CUDA host"
        )
    return found


def library_path(name: str) -> Path:
    """The shared library of kernel ``name``: one per source, so kernels
    that share a source share a build.  Its name hashes the source, every
    header of ``csrc`` and the flags, so an edited header is rebuilt."""
    source = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the sources of the named kernels (all by default) that are
    not built yet, one ``nvcc`` per source, all started together.  Returns,
    per source, the build seconds (0 when it was built already) and the
    ``ptxas`` report (registers, shared memory, spills).  Raises with the
    compiler's output if any build fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    jobs = {}
    sources = {KERNELS[n][0]: n for n in names}  # one kernel stands for its source
    for src, name in sources.items():
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.is_file():
            report[src] = {
                "seconds": 0.0,
                "ptxas": log.read_text() if log.is_file() else "",
            }
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp, out, log, time.perf_counter(),
        )
    failed = []
    for src, (proc, tmp, out, log, t0) in jobs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exit {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        log.write_text(text)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[src] = {"seconds": seconds, "ptxas": text}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
