#!/usr/bin/env python3
"""Smoke test of dicp_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: a CUDA device is required (no CPU continuation); prints the card's
   name and power limit; checks that float32 matmuls run in full precision.
1. build: compiles the CUDA kernel K1 (csrc/tiled_nn.cu) from the checkout.
2. K1 against its plain PyTorch version on the card, bit for bit: indices and
   squared distances identical, at the main path's shapes and at edge cases.
3. the reference contract on the dense tier: the 65-point pair of tests/data
   at B=256, pt2pl, dim 2, trim 5, huber 1, tol 1e-6, f32; transform error
   against the known truth < 1e-3.
4. the main path at real size on the kernel tier: 8 pairs of a synthetic
   LiDAR-like scene, 12,288 source points against 16,000 target points with
   normals, pt2pl, dim 3; every pair's rotation and translation error < 1e-3,
   and K1 launched at least once per Gauss-Newton iteration.

The line before the last is a JSON object describing each kernel of the path;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from dicp_tpu_torch import ICP, ICPConfig, se3
from dicp_tpu_torch.convert import to_torch
from dicp_tpu_torch.ops import _build, tiled_knn
from dicp_tpu_torch.utils.timing import cuda_median_ms

ROOT = Path(__file__).resolve().parent
SEED = 0
B, N_SRC, M_TGT = 8, 12288, 16000  # phase 4: the slice at real size
TOL_POSE = 1e-3                    # rad and m, phases 3 and 4


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase0_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    _check(torch.backends.cuda.matmul.allow_tf32 is False,
           "torch.backends.cuda.matmul.allow_tf32 is False")
    _check(torch.get_float32_matmul_precision() == "highest",
           "torch.get_float32_matmul_precision() == 'highest'")
    print(f"phase 0 ok: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def phase1_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build("tiled_nn")
    tiled_knn._kernel()  # load and bind
    seconds = time.perf_counter() - t0
    log = Path(str(lib) + ".log")
    report = log.read_text().strip() if log.exists() else "(built earlier)"
    print(f"phase 1 ok: built {lib.name} in {seconds:.2f} s\n{report}")


def lidar_scene(rng: np.random.Generator, m: int) -> np.ndarray:
    """(m, 6) points with exact unit normals on a ground plane, four walls and
    a dozen yawed boxes in a 30 m square: a street-corner scan's surfaces."""
    planes = []  # (origin, u, v, normal, area)

    def rect(origin, u, v):
        origin, u, v = (np.asarray(a, np.float64) for a in (origin, u, v))
        normal = np.cross(u, v)
        area = np.linalg.norm(normal)
        planes.append((origin, u, v, normal / area, area))

    half, height = 15.0, 4.0
    rect([-half, -half, 0], [2 * half, 0, 0], [0, 2 * half, 0])           # ground
    for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):                    # walls
        c = np.array([sx * half, sy * half, 0.0])
        along = np.array([-sy, sx, 0.0]) * 2 * half
        rect(c - along / 2, along, [0, 0, height])
    for _ in range(12):                                                   # boxes
        cx, cy = rng.uniform(-11, 11, size=2)
        w, d, h = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(1, 3)
        yaw = rng.uniform(0, np.pi)
        ex = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        ey = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        c = np.array([cx, cy, 0.0])
        corner = c - ex * w / 2 - ey * d / 2
        rect(corner + [0, 0, h], ex * w, ey * d)                          # top
        rect(corner, [0, 0, h], ex * w)                                   # -ey face
        rect(corner + ey * d, ex * w, [0, 0, h])                          # +ey face
        rect(corner, ey * d, [0, 0, h])                                   # -ex face
        rect(corner + ex * w, [0, 0, h], ey * d)                          # +ex face
    areas = np.array([p[4] for p in planes])
    which = rng.choice(len(planes), size=m, p=areas / areas.sum())
    st = rng.uniform(0, 1, size=(m, 2))
    origin, u, v, normal = (np.stack([planes[i][k] for i in which]) for k in range(4))
    pts = origin + st[:, :1] * u + st[:, 1:] * v
    return np.hstack([pts, normal])


def random_transforms(rng: np.random.Generator, count: int, max_angle_deg: float,
                      max_shift: float) -> np.ndarray:
    """(count, 4, 4) rigid transforms, rotation <= max_angle_deg, shift <= max_shift."""
    out = np.tile(np.eye(4), (count, 1, 1))
    for i in range(count):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = np.deg2rad(rng.uniform(0.5, max_angle_deg))
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        out[i, :3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
        shift = rng.normal(size=3)
        out[i, :3, 3] = shift / np.linalg.norm(shift) * rng.uniform(0.05, max_shift)
    return out


def scene_pairs(rng: np.random.Generator, batch: int, n: int, m: int):
    """Targets (batch, m, 6), sources (batch, n, 3) and the true source-to-
    target transforms (batch, 4, 4).  Each source is a random n-subset of its
    target moved by the inverse of its transform, so the truth is exact."""
    targets, sources = [], []
    T_true = random_transforms(rng, batch, max_angle_deg=5.0, max_shift=0.3)
    for i in range(batch):
        tgt = lidar_scene(rng, m)
        sub = tgt[rng.permutation(m)[:n], :3]
        R, t = T_true[i, :3, :3], T_true[i, :3, 3]
        sources.append((sub - t) @ R)  # R^T (q - t)
        targets.append(tgt)
    return (np.stack(sources).astype(np.float32), np.stack(targets).astype(np.float32),
            T_true)


def pose_errors(T_true: torch.Tensor, T_est: torch.Tensor):
    """(rotation error rad, translation error m) per batch element."""
    dR = T_true[:, :3, :3] @ T_est[:, :3, :3].transpose(-1, -2)
    rot = torch.linalg.vector_norm(se3.log_so3(dR), dim=-1)
    trans = torch.linalg.vector_norm(T_true[:, :3, 3] - T_est[:, :3, 3], dim=-1)
    return rot, trans


def phase2_kernel(device, sources: np.ndarray, targets: np.ndarray) -> dict:
    """K1 and its plain version on the same card tensors: exact agreement."""
    rng = np.random.default_rng(SEED + 2)
    near = rng.normal(size=(1, 4000, 3)).astype(np.float32)
    cases = {
        "main path (8, 12288, 16000)": (sources, targets[..., :3]),
        "n=1, m=1": (rng.normal(size=(1, 1, 3)), rng.normal(size=(1, 1, 3))),
        "ragged n, m": (rng.normal(size=(3, 1000, 3)) * 5, rng.normal(size=(3, 3001, 3)) * 5),
        "all equidistant": (np.zeros((1, 7, 3)), np.ones((1, 2500, 3))),
        "far query": (np.full((1, 1, 3), 1e4), near),
    }
    main_err = None
    for name, (x_np, y_np) in cases.items():
        x = to_torch(x_np, device, torch.float32)
        y = to_torch(y_np, device, torch.float32)
        idx_k, d2_k = tiled_knn.nn_distances(x, y)
        idx_p, d2_p = tiled_knn.nn_distances_plain(x, y)
        torch.cuda.synchronize()
        _check(torch.equal(idx_k, idx_p), f"K1 indices equal the plain version's ({name})")
        _check(torch.equal(d2_k, d2_p), f"K1 d2 bit-equal to the plain version's ({name})")
        err = float((d2_k - d2_p).abs().max())
        if name == "all equidistant":
            _check(bool((idx_k == 0).all()), "ties resolve to index 0")
        if name.startswith("main"):
            main_err = err
        print(f"  K1 == plain: {name}: {tuple(x.shape)} x {tuple(y.shape)}, "
              f"max |d2 diff| {err}")

    x = to_torch(sources, device, torch.float32)
    y = to_torch(targets[..., :3], device, torch.float32)
    ms = cuda_median_ms(lambda: tiled_knn.nn_distances(x, y), warmup=3, iters=20)
    plain_ms = cuda_median_ms(lambda: tiled_knn.nn_distances_plain(x, y), warmup=1, iters=5)
    pairs = x.shape[0] * x.shape[1] * y.shape[1]
    print(f"phase 2 ok: K1 {ms:.4f} ms, plain {plain_ms:.4f} ms at "
          f"{tuple(x.shape)} x {tuple(y.shape)} ({pairs / ms / 1e6:.1f} Gpair/s)")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms}


def phase3_reference(device) -> None:
    """bench.py's configuration, forward only, on the dense tier."""
    scan = np.load(ROOT / "tests" / "data" / "points_scan.npy").astype(np.float32)
    mp = np.load(ROOT / "tests" / "data" / "points_map.npy").astype(np.float32)
    batch = 256
    _check(ICPConfig().resolved_nn_method(65, 65, device) == "dense",
           "the 65-point pair resolves to the dense tier")
    src = to_torch(np.stack([scan[:, :3]] * batch), device)
    tgt = to_torch(np.stack([mp] * batch), device)
    ti = to_torch(np.stack([np.eye(4, dtype=np.float32)] * batch), device)
    before = tiled_knn.launches
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=100,
                 tolerance=1e-6, device=device)
    res = solver.icp(src, tgt, ti, trim_dist=5.0,
                     loss_fn={"name": "huber", "metric": 1.0}, dim=2)
    torch.cuda.synchronize()
    _check(tiled_knn.launches == before, "the dense tier launches no K1")
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    T_est = res["T"].to(torch.float64)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(T_est)), dim=-1)
    _check(bool(torch.isfinite(res["T"]).all()), "finite transforms")
    _check(float(err.max()) < TOL_POSE, f"reference pair error {float(err.max())} < {TOL_POSE}")
    print(f"phase 3 ok: B={batch} reference pair, max transform error "
          f"{float(err.max()):.3e}, iterations {float(res['stats']['iterations'].max())}")


def phase4_slice(device, sources: np.ndarray, targets: np.ndarray, T_true: np.ndarray):
    """The main path at real size; returns (K1 launches in one solve, ms/solve)."""
    n, m = sources.shape[1], targets.shape[1]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "pallas",
           f"({n}, {m}) resolves to the tiled kernel tier")
    src = to_torch(sources, device)
    tgt = to_torch(targets, device)
    ti = torch.eye(4, dtype=torch.float32, device=device).expand(len(sources), 4, 4)
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=50,
                 tolerance=1e-6, device=device)

    def solve():
        return solver.icp(src, tgt, ti, trim_dist=2.0,
                          loss_fn={"name": "huber", "metric": 0.5}, dim=3)

    tiled_knn.launches = 0
    res = solve()
    torch.cuda.synchronize()
    launches = tiled_knn.launches

    iters = res["stats"]["iterations"]
    _check(res["T"].device.type == device.type and res["pc"].device.type == device.type,
           "results stay on the card")
    _check(res["T"].shape == (len(sources), 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "finite (B, 4, 4) transforms")
    _check(launches >= int(iters.max()) >= 1,
           f"K1 launched {launches} times, at least once per iteration ({int(iters.max())})")
    rot, trans = pose_errors(torch.as_tensor(T_true, device=device),
                             res["T"].to(torch.float64))
    print(f"  per pair: iterations {iters.tolist()}, converged "
          f"{res['stats']['converged'].tolist()}")
    print(f"  rotation error (rad) {rot.tolist()}\n  translation error (m) {trans.tolist()}")
    _check(float(rot.max()) < TOL_POSE, f"rotation errors < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation errors < {TOL_POSE} m")
    ms = cuda_median_ms(solve, warmup=1, iters=5)
    print(f"phase 4 ok: {len(sources)} x {n} -> {m} pt2pl, {ms:.3f} ms per icp call "
          f"(median of 5), {float(iters.mean()):.2f} iterations per pair, "
          f"K1 launches {launches}")
    return launches, ms


def main() -> None:
    card = phase0_device()
    device = torch.device("cuda", 0)
    phase1_build()
    sources, targets, T_true = scene_pairs(np.random.default_rng(SEED), B, N_SRC, M_TGT)
    k1 = phase2_kernel(device, sources, targets)
    phase3_reference(device)
    launches, _ = phase4_slice(device, sources, targets, T_true)
    kernels = [{
        "name": "tiled_nn",
        "route": "cuda",
        "source": "dicp_tpu_torch/csrc/tiled_nn.cu",
        "replaces": "dicp_tpu/ops/pallas_knn.py:50",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
