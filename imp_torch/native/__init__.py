"""Native (C) runtime components — the counterpart of
``imp_tpu/native/__init__.py``: ``cindex.c`` is built on demand with the host
C compiler into ``build/native/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ctypes.  Every consumer treats a ``None``
result as "use the numpy path"."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "cindex.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


class _CIndexResult(ctypes.Structure):
    _fields_ = [
        ("numerator", ctypes.c_double),
        ("denominator", ctypes.c_double),
        ("concordant", ctypes.c_longlong),
        ("discordant", ctypes.c_longlong),
        ("tied_risk", ctypes.c_longlong),
        ("tied_time", ctypes.c_longlong),
    ]


def _build_and_load() -> Optional[ctypes.CDLL]:
    lib_path = BUILD_DIR / "imp_torch_cindex.so"
    try:
        if not lib_path.exists() or lib_path.stat().st_mtime < _SRC.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run([cc, "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp), "-lm"],
                                   check=True, capture_output=True)
                    os.replace(tmp, lib_path)
                    break
                except (FileNotFoundError, subprocess.CalledProcessError):
                    continue
            else:
                return None
        lib = ctypes.CDLL(str(lib_path))
        lib.weighted_concordance.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
            ctypes.c_double,
            ctypes.POINTER(_CIndexResult),
        ]
        lib.weighted_concordance.restype = None
        return lib
    except Exception:
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
    return _LIB


def native_weighted_concordance(event, time_arr, estimate, weights, tied_tol=1e-8):
    """C weighted concordance; returns None if the library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    event = np.ascontiguousarray(np.asarray(event, dtype=np.uint8))
    time_arr = np.ascontiguousarray(np.asarray(time_arr, dtype=np.float64))
    estimate = np.ascontiguousarray(np.asarray(estimate, dtype=np.float64))
    weights = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
    res = _CIndexResult()
    lib.weighted_concordance(
        event.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        time_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        estimate.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_longlong(len(time_arr)),
        ctypes.c_double(tied_tol),
        ctypes.byref(res),
    )
    if res.denominator == 0.0:
        from ..evaluation.survival_metrics import NoComparablePairError

        raise NoComparablePairError("Data has no comparable pairs.")
    return (
        res.numerator / res.denominator,
        int(res.concordant),
        int(res.discordant),
        int(res.tied_risk),
        int(res.tied_time),
    )
