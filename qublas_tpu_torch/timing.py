"""Timing on the card, for ``chip_smoke.py`` and ``experiments/``.

Nothing in the package's entry points uses these: they measure it.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

__all__ = ["card_line", "timeit", "device_us", "host_us"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def timeit(fn, runs=10, warmup=2) -> float:
    """Median milliseconds of ``runs`` calls of ``fn``, each between two
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, runs=20) -> dict:
    """Microseconds of device time per call of ``fn``, by kernel name (its
    first 60 characters), from a torch.profiler trace of ``runs`` calls
    after one warm-up call, read by ``utils.profiling``'s parser."""
    from .utils.profiling import device_busy

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(runs):
            fn()

    got = device_busy(run)
    out = {}
    for name, sec in (got["ops"] if got else {}).items():
        out[name[:60]] = out.get(name[:60], 0.0) + sec * 1e6 / runs
    return out


def host_us(fn, runs=100) -> float:
    """Microseconds of host time to enqueue one call of ``fn`` (the card
    finishes each call sooner than the host issues the next, or the queue
    absorbs the difference)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / runs * 1e6
