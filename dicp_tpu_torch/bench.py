"""The headline benchmark on one CUDA device: batched differentiable pt2pl
ICP, forward and backward, B = 256.

    python -m dicp_tpu_torch.bench            (BENCH_FULL=1 for two more rates)

bench.py's configuration: the 65-point pair of tests/data replicated to a
256-pair batch, f32, pt2pl, dim 2, trim 5, Huber 1, 100 iterations at most,
tolerance 1e-6.  One timed unit is one :func:`register_ift` forward (the
whole-solve kernel K4, ``fused_small=True``) and the gradient of sum(T)
with respect to the sources.  The units are timed with CUDA events, one
event pair per call, after a warm-up that pays the kernels' build and
functorch's first forward-mode call; the rate is B over the median, and
the spread of the calls goes to stderr.  The same unit captured as one
CUDA graph, forward and backward (:data:`fwdbwd_jit`, the counterpart of
bench.py's ``jax.jit(jax.value_and_grad(...))``), is timed in turns with
it; its rate goes to stderr beside the eager one, and the JSON line keeps
the eager unit's.  ``BENCH_FULL=1`` adds the unrolled gradient's rate
(:func:`fwdbwd` through :func:`register`, bench.py's ``unrolled_step``),
the same unit captured forward and backward (:data:`unrolled_jit`, the
counterpart of bench.py's jitted ``unrolled_step``: JAX's scan driver as a
fixed trip of run-once steps) and the forward-only rate (the early-exit
driver), timed in turns with the headline.

Gates, as bench.py's: T finite; the IFT and the unrolled gradients finite;
their cosine > 0.99.  Detail goes to stderr with the card's name and power
limit; the last line of stdout is one JSON object with bench.py's keys
(``metric``, ``value``, ``unit``, ``vs_baseline``).

bench.py's chained ``lax.scan`` clock and its watchdog exist for a remote
TPU runtime that acknowledges dispatches before they run; they are not
ported.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ift import register_ift
from dicp_tpu_torch.jit import jit
from dicp_tpu_torch.registration import register
from dicp_tpu_torch.utils.timing import times_ms

# The reference implementation's own rate for this configuration: PyTorch,
# f64, one CPU core (BASELINE.md).  It is no TPU figure.
BASELINE_REG_PER_S = 1293.0
METRIC = "pt2pl_diff_B256_fwdbwd_registrations_per_s"
B = 256
DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
HEAD = dict(icp_type="pt2pl", differentiable=True, max_iterations=100, tolerance=1e-6,
            dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
TOL_COSINE = 0.99


def head_config() -> ICPConfig:
    """The timed configuration: bench.py's, histories off, K4 as the forward."""
    return ICPConfig(**HEAD, collect_histories=False, fused_small=True)


def reference_batch(batch: int = B, dtype=torch.float32, device=None):
    """bench.py's inputs: (source (B, 65, 3), target (B, 65, 6), T_init)."""
    device = torch.device("cuda" if device is None else device)
    scan = np.load(DATA / "points_scan.npy")
    mp = np.load(DATA / "points_map.npy")
    src = torch.as_tensor(np.stack([scan[:, :3]] * batch), dtype=dtype, device=device)
    tgt = torch.as_tensor(np.stack([mp] * batch), dtype=dtype, device=device)
    ti = torch.eye(4, dtype=dtype, device=device).expand(batch, 4, 4).contiguous()
    return src, tgt, ti


def fwdbwd(entry: Callable, cfg: ICPConfig, src, tgt, ti):
    """One timed unit: ``entry`` forward and the gradient of sum(T) with
    respect to the sources.  Returns (result, sum(T), gradient)."""
    s = src.clone().requires_grad_(True)
    res = entry(s, tgt, ti, None, cfg)
    value = res.T.sum()
    (grad,) = torch.autograd.grad(value, s)
    return res, value.detach(), grad


def _unit(src, tgt, ti, cfg: ICPConfig):
    """The IFT unit over plain tensors, what :data:`fwdbwd_jit` captures:
    (result, sum(T), gradient with respect to the sources)."""
    with torch.enable_grad():
        return fwdbwd(register_ift, cfg, src, tgt, ti)


# The headline unit, forward and backward, as one captured program on the
# card (the forward's K4 launch, the index closure at the fixed point, the
# vmapped JVPs, the VJP and the k x k solve).
fwdbwd_jit = jit(_unit, static_argnames=("cfg",), name="fwdbwd")


def _unrolled(src, tgt, ti, cfg: ICPConfig):
    """The unrolled unit over plain tensors, what :data:`unrolled_jit`
    captures: (result, sum(T), gradient with respect to the sources)."""
    with torch.enable_grad():
        return fwdbwd(register, cfg, src, tgt, ti)


# The unrolled gradient, forward and backward, as one captured program on
# the card (bench.py's ``jax.jit`` of ``unrolled_step``): under capture the
# solve on which autograd records takes the fixed trip, a run-once node per
# step forward and backward, so the program waits for no host read.
unrolled_jit = jit(_unrolled, static_argnames=("cfg",), name="unrolled")


def forward_only(cfg: ICPConfig, src, tgt, ti):
    """The forward alone on the early-exit driver (bench.py's fwd_step)."""
    return register(src, tgt, ti, None, cfg.with_(differentiable=False, driver="while")).T


def time_alternated(calls: Dict[str, Callable], device, iters: int = 5,
                    rounds: int = 2, max_ms: Optional[float] = None) -> Dict[str, list]:
    """ms of each call of each entry, the entries visited in turns (A B C C
    B A for ``rounds`` = 2), ``iters`` calls per visit after one warm-up
    call (:func:`utils.timing.times_ms`).

    With ``max_ms`` an entry is warmed up before its first visit only, and
    the first entry's warm-up, timed, sets the depth: a visit spends at most
    ``max_ms`` on it (one call at least), and where one call takes longer
    the turns stop after two rounds."""
    names = list(calls)
    once = max_ms is not None
    warm = set()
    if once:
        first = times_ms(calls[names[0]], device, warmup=0, iters=1)[0]
        iters = max(1, min(iters, int(max_ms // max(first, 1e-3))))
        rounds = min(rounds, 2) if first > max_ms else rounds
        warm.add(names[0])
    order = []
    for r in range(rounds):
        order += names if r % 2 == 0 else names[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name] += times_ms(calls[name], device, warmup=0 if name in warm else 1,
                                iters=iters)
        if once:
            warm.add(name)
    return times


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def gates(src, tgt, ti, log=sys.stderr) -> dict:
    """bench.py's gates on its inputs: the first IFT forward and backward
    (the kernels' build and functorch's first forward-mode call fall here,
    outside every timed window), the unrolled gradient, T finite, both
    gradients finite, their cosine > 0.99.  Raises on a failed gate."""
    t0 = time.perf_counter()
    res, _, g_ift = fwdbwd(register_ift, head_config(), src, tgt, ti)
    first_s = time.perf_counter() - t0
    _, _, g_unr = fwdbwd(register, ICPConfig(**HEAD), src, tgt, ti)
    cos = cosine(g_ift, g_unr)
    print(f"first call (build, functorch's first forward-mode call): {first_s:.1f} s on "
          f"{src.device}; IFT vs unrolled gradient cosine {cos:.6f}", file=log)
    if not bool(torch.isfinite(res.T).all()):
        raise RuntimeError("non-finite transforms")
    if not (bool(torch.isfinite(g_ift).all()) and bool(torch.isfinite(g_unr).all())):
        raise RuntimeError("non-finite gradients")
    if not cos > TOL_COSINE:
        raise RuntimeError(f"IFT/unrolled gradient mismatch (cosine {cos})")
    return {"result": res, "grad_ift": g_ift, "grad_unrolled": g_unr, "cosine": cos,
            "first_s": first_s}


def run(device=None, full: bool = False, log=sys.stderr) -> dict:
    """Gate and time the headline; returns the times (ms per call of each
    variant), the gate values and the rate."""
    device = torch.device("cuda" if device is None else device)
    batch = B
    src, tgt, ti = reference_batch(batch, device=device)
    cfg = head_config()
    gate = gates(src, tgt, ti, log)
    calls = {"IFT fwd+bwd": lambda: fwdbwd(register_ift, cfg, src, tgt, ti)}
    if device.type == "cuda":
        calls["IFT fwd+bwd captured"] = lambda: fwdbwd_jit(src, tgt, ti, cfg)
    if full:
        calls["unrolled fwd+bwd"] = lambda: fwdbwd(register, ICPConfig(**HEAD), src, tgt, ti)
        if device.type == "cuda":
            calls["unrolled fwd+bwd captured"] = lambda: unrolled_jit(src, tgt, ti,
                                                                      ICPConfig(**HEAD))
        calls["forward only (while)"] = lambda: forward_only(cfg, src, tgt, ti)
    times = time_alternated(calls, device)
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"{name} B={batch}: median {med:.4f} ms -> {batch / med * 1e3:.1f} reg/s; "
              f"spread {min(ms):.4f}-{max(ms):.4f} ms over {len(ms)} calls", file=log)
    ms = statistics.median(times["IFT fwd+bwd"])
    return {"times": times, "ms": ms, "rate": batch / ms * 1e3, **gate,
            "iterations": float(gate["result"].iterations.max())}


def main(device=None) -> dict:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        print(f"card: {card_line()} ({torch.cuda.get_device_name(device)})", file=sys.stderr)
    else:
        print("device: cpu (host clock; not a device metric)", file=sys.stderr)
    out = run(device, full=bool(os.environ.get("BENCH_FULL")))
    line = {"metric": METRIC,
            "value": round(out["rate"], 1),
            "unit": "registrations/s/chip",
            "vs_baseline": round(out["rate"] / BASELINE_REG_PER_S, 2)}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
