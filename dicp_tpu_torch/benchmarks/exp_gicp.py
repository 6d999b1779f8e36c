"""GICP throughput on one CUDA device: the counterpart of
``benchmarks/exp_gicp.py``.

Batched plane-to-plane solves on a curved scene: registrations/s of
:func:`register_gicp` at B = 64, n = m = 600 (a dense 600 x 600 block per
pair, no kernel), the same batch through :func:`register_gicp_ift` forward
and backward, and an identically shaped pt2pt :func:`register` for the cost
ratio.  CUDA events, median of 5 after one call, results fetched.

    python -m dicp_tpu_torch.benchmarks.exp_gicp
"""

from __future__ import annotations

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.benchmarks.bench_suite import (TOL_POSE, _clock, _device, _emit, _err,
                                                   _gate, _med, _times)
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.gicp import register_gicp, register_gicp_ift
from dicp_tpu_torch.registration import register

B, N = 64, 600
XI = (0.2, -0.15, 0.1, 0.06, -0.04, 0.08)
PT2PT = ICPConfig(icp_type="pt2pt", differentiable=False, driver="while", max_iterations=30,
                  tolerance=1e-6, dim=3, trim_dist=100.0, loss_name="huber", loss_metric=1e9,
                  collect_histories=False)


def saddle_batch(device=None):
    """B copies of a 600-point saddle (seed 11) and of it moved by XI:
    (source, target, T_init) f32 tensors and the truth (4, 4) f64."""
    device = _device(device)
    rng = np.random.default_rng(11)
    xy = rng.uniform(-3, 3, size=(N, 2))
    scene = np.column_stack([xy, 0.09 * (xy[:, 0] ** 2 - xy[:, 1] ** 2)])
    T_np = se3.vec2tran(torch.tensor(np.array(XI, np.float32))).numpy().astype(np.float64)
    src = (scene @ T_np[:3, :3].T + T_np[:3, 3]).astype(np.float32)
    S = torch.as_tensor(np.stack([src] * B), device=device)
    Tg = torch.as_tensor(np.stack([scene.astype(np.float32)] * B), device=device)
    Ti = torch.eye(4, dtype=torch.float32, device=device).expand(B, 4, 4).contiguous()
    return S, Tg, Ti, np.linalg.inv(T_np)


def main(device=None) -> dict:
    """Emit gicp_b64, gicp_ift_fwdbwd_b64 and pt2pt_b64_same_shape; returns
    the rows, the first results and the IFT gradient of the first call."""
    device = _device(device)
    S, Tg, Ti, T_true = saddle_batch(device)

    def gicp():
        return register_gicp(S, Tg, Ti, max_iterations=30, tolerance=1e-6)

    def ift():
        a = S.clone().requires_grad_(True)
        res = register_gicp_ift(a, Tg, Ti, max_iterations=30, tolerance=1e-6)
        return torch.autograd.grad(res.T.sum(), a)[0]

    def pt2pt():
        return register(S, Tg, Ti, None, PT2PT)

    clock = _clock(device)
    res_g = gicp()
    err_g = _err(T_true, res_g.T)
    _gate(err_g < TOL_POSE, "gicp_b64", f"transform error {err_g} < {TOL_POSE}")
    ms_g = _times(lambda: gicp().T, device)
    rows = [_emit("gicp_b64", _med(ms_g), "ms/batch", ms_g,
                  registrations_per_s=B / _med(ms_g) * 1e3, transform_err=err_g,
                  iterations=float(res_g.iterations[0]), clock=clock)]

    g_ift = ift()
    _gate(bool(torch.isfinite(g_ift).all()) and float(g_ift.abs().max()) > 0,
          "gicp_ift_fwdbwd_b64", "gradient finite and nonzero")
    ms_i = _times(ift, device)
    rows.append(_emit("gicp_ift_fwdbwd_b64", _med(ms_i), "ms/batch", ms_i,
                      registrations_per_s=B / _med(ms_i) * 1e3, clock=clock))

    res_p = pt2pt()
    err_p = _err(T_true, res_p.T)
    _gate(err_p < TOL_POSE, "pt2pt_b64_same_shape", f"transform error {err_p} < {TOL_POSE}")
    ms_p = _times(lambda: pt2pt().T, device)
    rows.append(_emit("pt2pt_b64_same_shape", _med(ms_p), "ms/batch", ms_p,
                      registrations_per_s=B / _med(ms_p) * 1e3,
                      gicp_cost_ratio=round(_med(ms_g) / _med(ms_p), 3), transform_err=err_p,
                      clock=clock))
    return {"rows": rows, "gicp": res_g, "pt2pt": res_p, "grad_ift": g_ift,
            "inputs": (S, Tg, Ti), "T_true": T_true}


if __name__ == "__main__":
    main()
