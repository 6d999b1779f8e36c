"""Device timing with CUDA events.

PyTorch returns to the host before the device finishes, so a host clock
without a synchronise measures the enqueue.  :func:`cuda_median_ms` records
events on the current stream around each call, waits for the end event, and
returns the median of the per-call times.  It needs a CUDA device and raises
without one: there is no host-clock fallback.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_median_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds per call of ``fn()`` after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_median_ms needs a CUDA device")
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
    return statistics.median(times)
