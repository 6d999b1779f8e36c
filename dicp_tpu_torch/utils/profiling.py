"""Profiling and steady-state timing: the counterpart of
``dicp_tpu/utils/profiling.py``.

:func:`trace` records a ``torch.profiler`` trace that TensorBoard reads
(the kernels appear under their launchers' names, e.g.
``cluster_search_kernel``), as JAX's records an xplane trace.
:func:`benchmark` times ``fn()`` on the host clock after warm-up, waiting
for the card after every call, so its wall clock is the call's: the card is
local, and ``torch.cuda.synchronize`` returns when its work is done.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/tb'): fn()``.

    Records the host's activity and, when a CUDA device is present, the
    card's, and writes a TensorBoard trace (``*.pt.trace.json``) into
    ``log_dir`` on exit."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _sync(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out`` (nested
    tuples, lists, dicts and named tuples)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(out)
    for device in devices:
        torch.cuda.synchronize(device)


def benchmark(fn: Callable, n: int = 10, warmup: int = 1,
              force_wallclock: bool = False) -> dict:
    """Steady-state timing of ``fn()``, warm-up excluded.

    Returns {mean_s, min_s, compile_s, n}: ``compile_s`` is the warm-up's
    time (the kernels' first build and load fall there).  Each call is
    followed by a synchronise with the devices of the tensors it returns.
    ``force_wallclock`` is kept for JAX's signature and changes nothing: the
    JAX helper refuses remote TPU runtimes, whose dispatches are
    acknowledged before they run; a local card has no such mode."""
    del force_wallclock
    if warmup < 1:
        raise ValueError("benchmark() needs warmup >= 1: the first call "
                         "pays the kernels' build and load and must not be timed")
    t0 = time.perf_counter()
    for _ in range(warmup):
        _sync(fn())
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        _sync(fn())
        times.append(time.perf_counter() - t0)
    return {"mean_s": sum(times) / n, "min_s": min(times), "compile_s": compile_s, "n": n}
