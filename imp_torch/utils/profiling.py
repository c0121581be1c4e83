"""Timing and tracing on the card: the one harness of ``chip_smoke.py`` and
the bench tools (``imp_torch.tools.bench`` and its siblings).

* :func:`cuda_ms` — a kernel's device time by CUDA events over many calls;
* :func:`host_ms` — synchronised host milliseconds per call (the card's
  work ends inside the timed region; on a CPU tensor, the CPU's time);
  :func:`call_ms` — the first on a card, the second elsewhere;
* :func:`traced` / :func:`profiled` — a ``torch.profiler`` window behind
  primer kernels, traced again when it lost a timed kernel's records;
  :func:`device_rows`, :func:`device_ms_by`, :func:`device_ms` and
  :func:`device_busy_ms` read such a window;
* :func:`time_step` — a train step's median and p90 host ms, its device
  busy ms and the device ms of named kernels;
* :func:`card_line` — the card's name and power limit as ``nvidia-smi``
  gives them, written beside every number.

A failed integrity check raises ``AssertionError`` (not ``assert``, which
vanishes under ``-O``).  :data:`TRACE_SESSIONS` and :data:`TRACE_SHORT`
keep what every traced window of the process lost, for the report of a
whole run.  The module imports with no CUDA; its functions that trace or
time the card need one.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np

#: tiny kernels (``torch.cuda._sleep``: ``spin_kernel``) launched at the
#: start of each traced window.  The profiler loses the first kernel
#: records of a session, the more the older the process (none early in a
#: run; every record of a short window at its end, after the CLIP phases),
#: whichever library launched the kernels, which run and give their
#: results all the same; the primers take the loss, and a window in which
#: none of them survived is traced again with four times as many
TRACE_PRIMERS = 64
PRIMER_KERNEL = "spin_kernel"
#: (primers launched, primer records in the trace) of every traced window
TRACE_SESSIONS: list = []
#: the loss can also strike past the primers (a window whose primers
#: survived held 4 launches of ``dkv_kernel`` in 5 calls): such a window is
#: traced again, at most this many times
TRACE_RETRIES = 4
#: {kernel: (records, calls)} of every window traced again for such a loss
TRACE_SHORT: list = []


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    """``name, power limit`` of the first card, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synchronize(device) -> None:
    """Wait for the card's queued work where ``device`` is a card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, iters: int, device, warmup: int = 3) -> float:
    """Mean host milliseconds of ``fn()`` over ``iters`` calls after
    ``warmup`` untimed ones, the card synchronised before and after."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def call_ms(fn, iters: int, device, warmup: int = 3) -> float:
    """Mean ms of ``fn()``: by CUDA events (:func:`cuda_ms`) on a card, by
    the synchronised host clock (:func:`host_ms`) elsewhere."""
    import torch

    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters, warmup)
    return host_ms(fn, iters, device, warmup)


def short_counts(prof, kernel_names, iters: int) -> dict:
    """{kernel: (records, calls)} of each of ``kernel_names`` whose records
    in the trace ``prof`` are no multiple of ``iters`` (each call launches
    it as often): the trace lost some."""
    rows = device_rows(prof.key_averages())
    counts = {k: sum(e.count for e in rows if k in e.key) for k in kernel_names}
    return {k: (n, iters) for k, n in counts.items() if n % iters}


def traced(fn, iters: int, whole=()):
    """The ``torch.profiler`` session of ``iters`` calls of ``fn`` (after
    one untimed call), behind ``TRACE_PRIMERS`` primer kernels; None where
    CUPTI refuses to trace the card.  A session in which a kernel named in
    ``whole`` lost records is traced again, at most ``TRACE_RETRIES``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    primers, retries = TRACE_PRIMERS, 0
    while True:
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(primers):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:  # CUPTI refused: report, do not fail the run
            print(f"profiling: profiler unavailable: {e}", file=sys.stderr)
            return None
        seen = sum(e.count for e in prof.key_averages() if PRIMER_KERNEL in e.key)
        TRACE_SESSIONS.append((primers, seen))
        if not seen:  # the loss may reach into fn's records: more primers
            _require(primers < 64 * TRACE_PRIMERS,
                     f"the trace lost all of {primers} primer kernels: {TRACE_SESSIONS[-4:]}")
            primers *= 4
            continue
        short = short_counts(prof, whole, iters)
        if not short:
            return prof
        TRACE_SHORT.append(short)
        _require(retries < TRACE_RETRIES,
                 f"{retries + 1} traces in a row lost records of a timed kernel: "
                 f"{TRACE_SHORT[-retries - 1:]}")
        retries += 1


def profiled(fn, iters: int, whole=()):
    """The key averages of :func:`traced`; None where CUPTI refuses.  Fails
    where the trace holds no device row of ``fn``: every traced ``fn`` runs
    device work."""
    prof = traced(fn, iters, whole)
    if prof is None:
        return None
    events = prof.key_averages()
    _require(device_rows(events), f"the trace of {getattr(fn, '__name__', fn)} holds no "
                                  "device row")
    return events


def device_rows(events):
    """The rows of a trace that are device work (kernels, copies, sets).
    A CPU row (an aten op, ``cudaLaunchKernel``) also carries the device
    time of the kernels it launched, so summing every row counts a kernel
    more than once.  The primer kernels of :func:`traced` are left out."""
    from torch.autograd import DeviceType

    return [e for e in events or ()
            if e.device_type == DeviceType.CUDA and PRIMER_KERNEL not in e.key]


def device_ms_by(fn, kernel_names, iters: int = 20) -> dict:
    """Mean device time per call of ``fn`` of each CUDA kernel whose name
    holds one of ``kernel_names``; None where the trace holds no device time
    for it.  Fails where a kernel's launches in the trace are no multiple
    of ``iters`` (each call launches it as often) in every one of
    :func:`traced`'s attempts: the trace lost some."""
    rows = device_rows(profiled(fn, iters, kernel_names))
    totals = {}
    for k in kernel_names:
        mine = [e for e in rows if k in e.key]
        count = sum(e.count for e in mine)
        _require(count % iters == 0, f"{count} launches of {k} in a trace of {iters} calls")
        totals[k] = sum(e.self_device_time_total for e in mine)
    return {k: v / iters / 1e3 if v else None for k, v in totals.items()}


def device_ms(fn, kernel_name: str, iters: int = 20):
    """Mean device time of the CUDA kernel named ``kernel_name`` per call of
    ``fn``; None where the trace holds no device time for it."""
    return device_ms_by(fn, (kernel_name,), iters)[kernel_name]


def device_busy_ms(fn, iters: int = 5):
    """Mean device time of all device work per call of ``fn`` (the busy part
    of its wall time); None where the trace holds no device time."""
    total = sum(e.self_device_time_total for e in device_rows(profiled(fn, iters)))
    return total / iters / 1e3 if total else None


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_step(step, kernel_names, timed: int, traced: int = 3):
    """Median and p90 host ms of ``timed`` calls of ``step()`` (synchronised,
    after warm-up), the device busy ms per step, the device ms of
    ``kernel_names`` per step (together and by kernel) over ``traced``
    traced steps, and the peak device memory.  ``step()`` returns a dict with a ``loss``."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    events = profiled(step, traced, kernel_names)
    rows = device_rows(events)
    for k in kernel_names:  # each step launches a kernel as often: none lost
        count = sum(e.count for e in rows if k in e.key)
        _require(count % traced == 0, f"{count} launches of {k} in a trace of {traced} steps")
    busy = sum(e.self_device_time_total for e in rows) / traced / 1e3 if rows else None

    def named_ms(names):
        return (sum(e.self_device_time_total for e in rows
                    if any(k in e.key for k in names)) / traced / 1e3) if rows else None

    median = float(np.median(times)) * 1e3
    return {
        "step_ms_median": median, "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "timed_steps": timed, "kernels_device_ms_per_step": named_ms(kernel_names),
        "kernels_timed": list(kernel_names),
        "by_kernel_device_ms_per_step": {k: named_ms((k,)) for k in kernel_names},
        "device_busy_ms_per_step": busy,
        # every row of the trace summed, for comparison: kernels counted
        # again under the CPU rows that launched them
        "all_trace_rows_ms_per_step": sum(e.self_device_time_total
                                          for e in events or ()) / traced / 1e3,
        "device_idle_share": None if busy is None else 1.0 - busy / median,
        "peak_device_gib": peak, "loss_finite": bool(np.isfinite(float(metrics["loss"]))),
    }
