"""Device timing with CUDA events.

PyTorch returns to the host before the device finishes, so a host clock
without a synchronise measures the enqueue.  :func:`cuda_times_ms` records
events on the current stream around each call, waits for the end event, and
returns the per-call times; :func:`cuda_median_ms` returns their median.
Both need a CUDA device and raise without one: there is no host-clock
fallback.  :func:`times_ms` takes the device from its caller: CUDA events on
a CUDA device, the host clock only where the caller names the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def cuda_times_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 10) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn()`` after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_times_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_median_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds per call of ``fn()`` after ``warmup`` calls."""
    return statistics.median(cuda_times_ms(fn, warmup, iters))


def times_ms(fn: Callable[[], object], device, warmup: int = 1, iters: int = 5) -> list:
    """Milliseconds of each of ``iters`` calls of ``fn()`` on ``device``:
    :func:`cuda_times_ms` on a CUDA device; on the CPU, the host clock."""
    if torch.device(device).type == "cuda":
        return cuda_times_ms(fn, warmup, iters)
    if torch.device(device).type != "cpu":
        raise ValueError(f"times_ms times cuda or cpu work, got {device}")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times
