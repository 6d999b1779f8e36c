"""Closed-loop SLAM demo: scan-to-map odometry + loop closures + pose graph.

The port's ``slam`` stack on a synthetic multi-lap circuit, the scenario
loop closure exists for: a capacity-bounded sliding map forgets old
geometry (LRU eviction), so odometry noise accumulates into drift, and
revisiting the start only helps if the revisit is detected and fed back
through the pose graph.

Pipeline per scan:
  predict pose (EMA constant-velocity)
    -> register the scan against the fused voxel map (pt2pl)
    -> merge the posed scan into the map (running means, LRU eviction)
    -> every few scans: freeze a keyframe anchor / check for a revisit
       -> on revisit: two-stage registration against the anchor snapshot
          -> accepted closures become relative pose-graph edges
finally:
  robust (Huber-IRLS) pose-graph refinement -> drift-corrected trajectory
    -> a map rebuilt at the refined poses.

Checks: a closure accepted, the refined ATE below the map's voxel (0.25 m),
the rebuilt map's median distance to the surface below the voxel.
Scans are f64 on the CPU and f32 on the card.

Run:  python -m dicp_tpu_torch.examples.slam_demo              (3 laps)
      SLAM_DEMO_LAPS=6 python -m dicp_tpu_torch.examples.slam_demo
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dicp_tpu_torch import ICPConfig, se3
from dicp_tpu_torch.odometry import ate
from dicp_tpu_torch.slam import rebuild_map, slam_odometry


VOXEL = 0.25


def make_world(n=40_000, R=5.0, seed=0):
    """Wavy ground surface around a circular circuit."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, 3))
    pts[:, 0] = rng.uniform(-R - 8, R + 8, n)
    pts[:, 1] = rng.uniform(-R - 8, R + 8, n)
    pts[:, 2] = np.sin(pts[:, 0] * 0.6) * np.cos(pts[:, 1] * 0.5) * 1.5
    return pts


def make_scans(laps, per_lap=32, n=1200, r=6.0, noise=0.04, R=5.0, seed=3, dtype=np.float32):
    """Local-frame range scans along the circuit + ground-truth poses."""
    rng = np.random.default_rng(seed)
    world = make_world(R=R)
    scans, poses = [], []
    for k in range(int(laps * per_lap) + 1):
        th = 2 * np.pi * k / per_lap
        t = np.array([R * np.cos(th), R * np.sin(th), 0.0])
        yaw = th + np.pi / 2 + 0.05 * np.sin(k * 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        Rm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3] = Rm
        T[:3, 3] = t
        d = np.linalg.norm(world[:, :2] - t[None, :2], axis=1)
        idx = np.flatnonzero(d < r)
        sel = rng.choice(idx, n, replace=len(idx) < n)
        scans.append(((world[sel] - t) @ Rm + rng.normal(scale=noise, size=(n, 3))).astype(dtype))
        poses.append(T)
    P = np.stack(poses)
    # SLAM gauge: pose 0 = identity (trajectory in the scan-0 frame); P[0]
    # maps that frame back to the world the analytic surface lives in
    return scans, np.einsum("ij,kjl->kil", np.linalg.inv(P[0]), P), P[0]


def main(device=None) -> dict:
    device = torch.device("cuda" if device is None else device)
    laps = int(os.environ.get("SLAM_DEMO_LAPS", "3"))
    dtype = np.float64 if device.type == "cpu" else np.float32
    scans, poses_true, T0 = make_scans(laps, dtype=dtype)
    print(f"{len(scans)} scans, {laps} laps of a 5 m circuit, sigma=0.04 noise, "
          f"2048-voxel sliding map")

    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-5,
                    dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                    collect_histories=False)
    res = slam_odometry(((s, None) for s in scans), cfg, capacity=2048, voxel=VOXEL,
                        anchor_every=4, closure_gap=24, detect_every=2, detect_radius=5.0,
                        accept_ratio=0.5, max_closures=100, closure_info=30.0,
                        refine_iterations=25, device=device)

    truth = torch.as_tensor(poses_true, dtype=res.poses.dtype, device=res.poses.device)
    a_front = float(ate(res.poses_front, truth, align=False))
    a_ref = float(ate(res.poses, truth, align=False))
    print(f"closures accepted: {len(res.closures)}")
    for c in res.closures[:5]:
        print(f"  anchor {c.anchor_idx:3d} -> scan {c.scan_idx:3d}  "
              f"matched_ratio {c.matched_ratio:.3f}")
    if len(res.closures) > 5:
        print(f"  ... and {len(res.closures) - 5} more")
    print(f"front-end ATE (drifting): {a_front:.4f}")
    print(f"refined   ATE          : {a_ref:.4f}  ({a_front / max(a_ref, 1e-12):.1f}x lower)")

    # drift-corrected map: re-merge all scans at the refined poses, in the
    # scan-0 gauge frame, mapped back to the world (T0) for the comparison
    m = rebuild_map(scans, res.poses, capacity=16384, voxel=VOXEL)
    valid = (m.count > 0).cpu().numpy()
    pts = m.pos.cpu().double().numpy()[valid] @ T0[:3, :3].T + T0[:3, 3]
    zerr = np.abs(pts[:, 2] - np.sin(pts[:, 0] * 0.6) * np.cos(pts[:, 1] * 0.5) * 1.5)
    print(f"rebuilt map: {valid.sum()} voxels, median |z - surface| "
          f"= {np.median(zerr):.3f} (voxel 0.25)")
    final_err = float(np.linalg.norm(se3.tran2vec(torch.as_tensor(
        np.linalg.inv(poses_true[-1]) @ res.poses[-1].cpu().double().numpy())).numpy()))
    print(f"final-pose error after refinement: {final_err:.4f}")
    if not res.closures:
        raise RuntimeError("no loop closure accepted")
    if not (a_ref < VOXEL):
        raise RuntimeError(f"refined ATE {a_ref} m above the voxel")
    if not (np.median(zerr) < VOXEL):
        raise RuntimeError("the rebuilt map sits off the surface")
    return {"closures": len(res.closures), "ate_front": a_front, "ate_refined": a_ref,
            "median_z_err": float(np.median(zerr)), "final_pose_err": final_err,
            "scans": len(scans)}


if __name__ == "__main__":
    main()
