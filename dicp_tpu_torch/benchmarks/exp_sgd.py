"""SGD-ICP against the full solver on one CUDA device: the counterpart of
``benchmarks/exp_sgd.py``.

Mini-batch stochastic GN (:func:`register_sgd`, O(k m) per iteration)
against the full pt2pl :func:`register` (auto tier), both from the same
precomputed 6-column target (weighted normals), at n = m = 20k (k = 1024)
and 100k (k = 2048): ms per registration (CUDA events, median of 5 after
one call) and the transform error of each.  ``DICP_SGD_SMOKE=1`` runs one
2k-point size instead.

    python -m dicp_tpu_torch.benchmarks.exp_sgd
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.benchmarks.bench_suite import (TOL_POSE, _clock, _device, _emit, _err,
                                                   _gate, _med, _times)
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.registration import register
from dicp_tpu_torch.sgd_icp import register_sgd

XI = (0.1, -0.08, 0.05, 0.04, -0.03, 0.05)
SIZES = (("20k", 20_000, 1024, 40), ("100k", 100_000, 2048, 40))
FULL = ICPConfig(icp_type="pt2pl", differentiable=False, driver="while", max_iterations=40,
                 tolerance=1e-6, dim=3, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                 collect_histories=False)
# tests/test_sgd_icp.py's bar for a mini-batch solve in f32
TOL_SGD = 1e-3


def _scene(n, seed=5):
    """A 40 m saddle with a sine ripple: (n, 3) f64."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, size=(n, 2))
    z = (0.01 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)
         + 0.5 * np.sin(0.4 * xy[:, 0]))
    return np.column_stack([xy, z])


def main(device=None) -> dict:
    """Emit sgd_gn_<size>_k<k> and full_pt2pl_<size> for each size."""
    device = _device(device)
    T_np = se3.vec2tran(torch.tensor(XI, dtype=torch.float64)).numpy()
    sizes = (("2k", 2_000, 256, 30),) if os.environ.get("DICP_SGD_SMOKE") else SIZES
    rows, clock = [], _clock(device)
    for label, n, k, iters in sizes:
        scene = _scene(n)
        src = (scene @ T_np[:3, :3].T + T_np[:3, 3]).astype(np.float32)
        S = torch.as_tensor(src[None], device=device)
        tgt3 = torch.as_tensor(scene.astype(np.float32)[None], device=device)
        # both solvers get the same target normals (a per-map cost)
        Tg = torch.cat([tgt3, estimate_normals(tgt3, method="weighted")], dim=-1)
        Ti = torch.eye(4, dtype=torch.float32, device=device)[None]

        def sgd():
            return register_sgd(S, Tg, Ti, 0, minibatch=k, iterations=iters, tolerance=1e-6)

        def full():
            return register(S, Tg, Ti, None, FULL)

        res = sgd()
        err_s = _err(np.linalg.inv(T_np), res.T[0])
        name = f"sgd_gn_{label}_k{k}"
        _gate(err_s < TOL_SGD, name, f"transform error {err_s} < {TOL_SGD}")
        ms_s = _times(lambda: sgd().T, device)
        rows.append(_emit(name, _med(ms_s), "ms/registration", ms_s, transform_err=err_s,
                          iterations=float(res.iterations[0]),
                          converged=bool(res.converged[0]), clock=clock))
        resf = full()
        err_f = _err(np.linalg.inv(T_np), resf.T[0])
        _gate(err_f < TOL_POSE, f"full_pt2pl_{label}", f"transform error {err_f} < {TOL_POSE}")
        ms_f = _times(lambda: full().T, device)
        rows.append(_emit(f"full_pt2pl_{label}", _med(ms_f), "ms/registration", ms_f,
                          transform_err=err_f, sgd_speedup=round(_med(ms_f) / _med(ms_s), 3),
                          iterations=float(resf.iterations[0]), clock=clock))
    return {"rows": rows}


if __name__ == "__main__":
    main()
