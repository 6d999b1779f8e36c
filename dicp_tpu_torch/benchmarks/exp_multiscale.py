"""Multiscale pyramid against single-scale full resolution at 100k points
on one CUDA device: the counterpart of ``benchmarks/exp_multiscale.py``.

From a FAR initialization the full-resolution solver walks to the basin in
full-resolution iterations; the pyramid walks there on a coarse voxel level
and polishes at full resolution.  Both must land within 1e-3 of the truth;
the metric is ms per registration (CUDA events, median of 5 after one
call).

    python -m dicp_tpu_torch.benchmarks.exp_multiscale
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.benchmarks.bench_suite import (TOL_POSE, _clock, _device, _emit, _err,
                                                   _gate, _make_scene, _med, _times)
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.multiscale import ScaleLevel, register_multiscale
from dicp_tpu_torch.registration import register

N = 100_000
XI = (0.8, -0.5, 0.2, 0.05, -0.08, 0.12)   # ~4x the suite's large_cloud offset
CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=40, tolerance=1e-5,
                dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0, nn_method="cluster",
                collect_histories=False)
LEVELS = (ScaleLevel(1.0, 4096, 4096, 15, 1e-3, trim_dist=8.0, nn_method="dense"),
          ScaleLevel(0.0, 0, 0, 40, 1e-5))


def main(device=None, first_call=None) -> dict:
    """Emit singlescale_100k_farinit and multiscale_100k_farinit.
    ``first_call(label)``: a context manager entered around each variant's
    first, untimed call ("single", "pyramid")."""
    device = _device(device)
    target = torch.as_tensor(_make_scene(N), device=device)
    T_np = se3.vec2tran(torch.tensor(XI, dtype=torch.float64)).numpy()
    source = torch.as_tensor((target[:, :3].double().cpu().numpy() @ T_np[:3, :3].T
                              + T_np[:3, 3]).astype(np.float32), device=device)
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    T_true = np.linalg.inv(T_np)

    def single():
        return register(source[None], target[None], eye, None, CFG)

    def pyramid():
        return register_multiscale(source[None], target[None], eye, None, CFG, LEVELS)

    def first(label, fn):
        with (first_call(label) if first_call else contextlib.nullcontext()):
            out = fn()
        return out

    clock = _clock(device)
    res_s = first("single", single)
    err_s = _err(T_true, res_s.T[0])
    _gate(err_s < TOL_POSE, "singlescale_100k_farinit", f"transform error {err_s} < {TOL_POSE}")
    ms_s = _times(lambda: single().T, device)
    rows = [_emit("singlescale_100k_farinit", _med(ms_s), "ms/registration", ms_s,
                  transform_err=err_s, iterations=float(res_s.iterations[0]), clock=clock)]
    res_m = first("pyramid", pyramid)
    err_m = _err(T_true, res_m.result.T[0])
    _gate(err_m < TOL_POSE, "multiscale_100k_farinit", f"transform error {err_m} < {TOL_POSE}")
    ms_m = _times(lambda: pyramid().result.T, device)
    rows.append(_emit("multiscale_100k_farinit", _med(ms_m), "ms/registration", ms_m,
                      transform_err=err_m,
                      level_iterations=[float(x) for x in res_m.level_iterations[:, 0]],
                      speedup_vs_singlescale=round(_med(ms_s) / _med(ms_m), 3), clock=clock))
    return {"rows": rows, "single": res_s, "pyramid": res_m, "ms_single": ms_s,
            "ms_pyramid": ms_m}


if __name__ == "__main__":
    main()
