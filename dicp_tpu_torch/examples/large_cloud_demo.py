"""Full-resolution large-cloud registration with self-computed normals.

The 100k-point serving workflow on the card:

1. estimate surface normals for the map with the kernel-weighted PCA path
   (candidates from the cluster index, no (n, n) matrix);
2. register a 100k-point scan against the 100k-point map at full
   resolution: the Hilbert cluster index is built once per solve and
   queried every Gauss-Newton iteration through the search kernel;
3. check the exactness certificate of the final correspondences.

Checks: transform error < 1e-3, converged, every certified correspondence
at the distance of the scan's own point (the scan is the map, moved).

Run:  python -m dicp_tpu_torch.examples.large_cloud_demo
"""

from __future__ import annotations

import numpy as np
import torch

from dicp_tpu_torch import ICPConfig, register_jit, se3
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn
from dicp_tpu_torch.ops.normals import estimate_normals


def make_scene(n=100_000, seed=0):
    """Three orthogonal planes, n points, f64 ground truth on the host."""
    rng = np.random.default_rng(seed)
    axes = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts = []
    for k in range(3):
        uv = rng.uniform(-20, 20, size=(n // 3 + 1, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(axes[k])]]
        pts.append(uv @ basis + axes[k] * (2.0 + k))
    return np.vstack(pts)[:n]


N = 100_000                     # points in the map and in the scan


def main(device=None) -> dict:
    device = torch.device("cuda" if device is None else device)
    n = N
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    map_pts = make_scene(n)

    # ground-truth offset, applied on the host in f64
    xi = torch.tensor([0.2, -0.1, 0.05, 0.01, -0.02, 0.03], dtype=torch.float64)
    T_st = se3.vec2tran(xi).numpy()
    scan = (map_pts @ T_st[:3, :3].T + T_st[:3, 3]).astype(np.float32)

    target3 = torch.as_tensor(map_pts.astype(np.float32), device=device)
    source = torch.as_tensor(scan, device=device)

    # 1. normals for the map (computed, not assumed)
    normals = estimate_normals(target3, method="weighted")
    target6 = torch.cat([target3, normals], dim=-1)

    # 2. full-resolution registration through the cluster index
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-5, dim=3, trim_dist=2.0,
                    loss_name="huber", loss_metric=1.0, nn_method="cluster")
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    res = register_jit(source[None], target6[None], eye, None, cfg=cfg)
    T_pred = res.T[0].cpu().double().numpy()
    err = float(np.linalg.norm(se3.tran2vec(torch.as_tensor(
        np.linalg.inv(T_st) @ np.linalg.inv(T_pred))).numpy()))
    converged = bool(res.converged[0])
    print(f"registered {n} vs {n}: {float(res.iterations[0]):.0f} GN iterations, "
          f"transform error {err:.2e}, converged={converged}")

    # 3. exactness accounting on the final correspondences (the transform
    #    applied on the host in f64)
    index = build_cluster_index(target3, 128)
    aligned = torch.as_tensor((scan.astype(np.float64) @ T_pred[:3, :3].T + T_pred[:3, 3])
                              .astype(np.float32), device=device)
    idx, d2, cert = cluster_nn(index, aligned, probes=32)
    certified = float(cert.float().mean())
    median_res = float(torch.median(torch.sqrt(d2)))
    # every scan point lies on its own map point (moved back): a certified
    # answer is at most that point's distance
    own = ((aligned.double() - target3.double()) ** 2).sum(-1)
    exact = bool((d2.double()[cert] <= own[cert] + 1e-6).all())
    print(f"final correspondences: {100 * certified:.2f}% certified-exact, median residual "
          f"{median_res:.2e} m")
    if not (err < 1e-3):
        raise RuntimeError(f"transform error {err}")
    if not converged:
        raise RuntimeError("the solve did not converge")
    if not exact:
        raise RuntimeError("a certified correspondence is farther than the scan point's own")
    return {"transform_err": err, "iterations": float(res.iterations[0]),
            "certified_pct": 100 * certified, "median_residual": median_res}


if __name__ == "__main__":
    main()
