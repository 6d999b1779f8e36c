"""Online serving demo: the streaming registration pipeline in ~60 lines.

Scans arrive as a stream, and ``dicp_tpu_torch.pipeline.stream_odometry``

  * ships each preprocessed scan host->device once (a pinned, non-blocking
    copy on a copy stream),
  * solves each window of K consecutive pairs in one batched call (the port
    runs one window at a time: its solver syncs once per iteration, where
    the JAX package keeps several windows in flight),
  * seeds every window with the constant-velocity prior (warm start,
    default on), and
  * optionally ships scans as packed (n, 4) uint16 (8 bytes per point,
    decoded on the card).

Checks: ATE < 1e-2 for both streams.

Run:  python -m dicp_tpu_torch.examples.serving_demo
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from dicp_tpu_torch import ICPConfig, se3
from dicp_tpu_torch.io import ScanDataset, save_bin
from dicp_tpu_torch.odometry import ate
from dicp_tpu_torch.pipeline import stream_odometry


def main(device=None) -> dict:
    device = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(0)
    n, S = 20_000, 24
    scene = rng.uniform(-15.0, 15.0, size=(n, 3)).astype(np.float32)

    # ground-truth trajectory: constant twist per frame
    xi = torch.tensor([0.04, 0.02, 0.01, 0.004, 0.002, 0.01], dtype=torch.float32)
    T_step = se3.vec2tran(xi).numpy()
    cfg = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=3, trim_dist=1.0,
                    loss_name="huber", loss_metric=0.5, nn_method="auto")
    with tempfile.TemporaryDirectory(prefix="dicp_serving_") as tmpdir:
        T, poses_true = np.eye(4, dtype=np.float32), []
        for i in range(S):
            Ti = np.linalg.inv(T).astype(np.float32)
            scan = scene @ Ti[:3, :3].T + Ti[:3, 3]
            save_bin(os.path.join(tmpdir, f"{i:04d}.bin"),
                     np.hstack([scan, np.zeros((n, 1), np.float32)]))
            poses_true.append(T.copy())
            T = T @ T_step
        truth = torch.as_tensor(np.stack(poses_true))

        # disk -> host preprocess -> card, windowed solves with the
        # constant-velocity warm start (default)
        ds = ScanDataset.from_dir(tmpdir, max_points=n, voxel=None, workers=2, prefetch=4)
        t0 = time.perf_counter()
        res = stream_odometry(((pts[:, :3], w) for pts, w in ds), cfg, window=4, device=device)
        poses = res.poses.cpu()
        dt = time.perf_counter() - t0
        err = float(ate(poses, truth, align=False))
        print(f"f32 stream : {S} scans in {dt:.2f}s wall ({S / dt:.1f} fps incl. the first "
              f"call), ATE {err:.2e}, all converged: {bool(res.converged.all())}")
        if not (err < 1e-2):
            raise RuntimeError("trajectory drifted")

        # quantized transfers: 8 B/point over the wire instead of 12, weights
        # elided (quantize takes weightless scans with no zero-row padding)
        ds = ScanDataset.from_dir(tmpdir, max_points=n, voxel=None, workers=2, prefetch=4)
        t0 = time.perf_counter()
        res_q = stream_odometry(((pts[:, :3], None) for pts, _ in ds), cfg, window=4,
                                quantize=True, device=device)
        poses_q = res_q.poses.cpu()
        dt_q = time.perf_counter() - t0
        err_q = float(ate(poses_q, truth, align=False))
        print(f"quantized  : {S} scans in {dt_q:.2f}s wall ({S / dt_q:.1f} fps incl. the "
              f"first call), ATE {err_q:.2e}")
        if not (err_q < 1e-2):
            raise RuntimeError("quantized trajectory drifted")
    return {"ate": err, "ate_quantized": err_q, "fps": S / dt, "fps_quantized": S / dt_q}


if __name__ == "__main__":
    main()
