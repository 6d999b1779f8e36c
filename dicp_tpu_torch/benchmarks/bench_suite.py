"""The extended benchmark suite on one CUDA device: the counterpart of
``benchmarks/bench_suite.py``, with its ten names, its rows, sizes,
configurations and seeds.

    python -m dicp_tpu_torch.benchmarks.bench_suite [name ...]

Names: svd_pair, pt2pl_pair, batch256, large_cloud, normals, odometry,
capacity, pipeline, scan_to_map, solvers (no name: all ten).

Each row prints one JSON line ``{name, value, unit, ...detail}`` under the
JAX row's name, with the JAX row's detail fields, and raises if its
correctness gate fails.  A timed row also carries ``median_ms``,
``spread_ms`` (the fastest and slowest repetition) and ``reps``, and
``clock``: every row times with CUDA events (``utils.timing.times_ms``,
one event pair per call, each call ending in a host fetch of its results);
on the CPU, which only the tests ask for, the host clock.  Where the JAX
suite differences two chain lengths or two iteration budgets to isolate a
part, this one times both budgets the same way and differences their
medians.  The JAX suite's chained ``lax.scan`` clock, and its tricks to make
a chain consume every output, exist for a remote TPU runtime and are not
ported.

``DICP_SOLVERS_AA_ONLY`` skips the delegated ``exp_*`` rows of
``solvers``, ``DICP_S2M_STEP_ONLY`` the host-loop rows of
``scan_to_map`` and ``DICP_S2M_LOOP_ONLY`` its step rows, as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from dicp_tpu_torch import bench, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.utils.timing import times_ms

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
REPS = 5                       # timed repetitions of a row, after one warm-up call
TOL_POSE = 1e-3                # rad and m: the port's registration gate (chip_smoke.py)
TOL_NORMAL_DEG = 2.0           # median angle of weighted normals to the exact ones
# the reference pair's truth: inv(vec2tran([1, 1, 0, 0, 0, 0.1]))
PAIR_XI = (1.0, 1.0, 0.0, 0.0, 0.0, 0.1)
HEAD_CFG = ICPConfig(**bench.HEAD)   # bench.py's configuration, histories on


# --- the JAX suite's generators (bit-equal to theirs) --------------------------

def _pair(dtype=np.float32):
    """The tests/data pair: (scan (65, 6), map (65, 6))."""
    return (np.load(DATA / "points_scan.npy").astype(dtype),
            np.load(DATA / "points_map.npy").astype(dtype))


def _batch_inputs(B, device=None):
    """The pair replicated B times: source (B, 65, 3), target (B, 65, 6),
    T_init (B, 4, 4), f32 tensors on ``device`` (bench.py's inputs)."""
    return bench.reference_batch(B, device=_device(device))


def _make_scene(n=100_000):
    """Three orthogonal 40 m planes: (n, 6) f32 points with exact normals."""
    rng = np.random.default_rng(0)
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrm = [], []
    for k in range(3):
        uv = rng.uniform(-20, 20, size=(n // 3 + 1, 2)).astype(np.float32)
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (2.0 + k))
        nrm.append(np.tile(normals[k], (n // 3 + 1, 1)))
    return np.hstack([np.vstack(pts)[:n], np.vstack(nrm)[:n]]).astype(np.float32)


def _wavy_sequence(S, n, step_xi, seed=0, noise=0.0):
    """S f32 scans of a wavy n-point surface along a constant step, built on
    the host in f64: (scans, poses (S, 4, 4) f32, step (4, 4) f32)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-20, 20, (n, 3))
    base[:, 2] = (np.sin(base[:, 0] * 0.35) * np.cos(base[:, 1] * 0.3) * 2.0)
    if noise:
        base = base + rng.normal(scale=noise, size=base.shape)
    step_T = se3.vec2tran(torch.tensor(np.array(step_xi, np.float32))).numpy().astype(np.float64)
    scans, poses = [], []
    T = np.eye(4)
    for _ in range(S):
        Ti = np.linalg.inv(T)
        scans.append((base @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
        poses.append(T.astype(np.float32).copy())
        T = T @ step_T
    return scans, np.stack(poses), step_T.astype(np.float32)


# --- rows, clocks and gates ------------------------------------------------------

def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _emit(name, value, unit, ms: Optional[List[float]] = None, **detail) -> dict:
    """Print one row as JSON; ``ms``: the per-repetition times behind it."""
    if name not in ROW_NAMES:
        raise ValueError(f"{name} is not a row of ROWS")
    row = {"name": name, "value": round(float(value), 3), "unit": unit, **detail}
    if ms is not None:
        row.update(median_ms=round(statistics.median(ms), 4),
                   spread_ms=[round(min(ms), 4), round(max(ms), 4)], reps=len(ms))
    print(json.dumps(row), flush=True)
    return row


def _gate(cond: bool, row: str, what: str) -> None:
    if not cond:
        raise RuntimeError(f"{row}: gate failed: {what}")


def _fetch(out):
    """Copy every tensor of ``out`` to the host (a fetch waits for the work)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(*map(_fetch, out)) if hasattr(out, "_fields") else [
            _fetch(o) for o in out]
    return out


def _clock(device) -> str:
    return "cuda events" if _device(device).type == "cuda" else "host (cpu)"


def _times(fn: Callable, device, reps: int = REPS) -> List[float]:
    """ms of each of ``reps`` calls of ``fn`` after one, its results fetched."""
    return times_ms(lambda: _fetch(fn()), _device(device), warmup=1, iters=reps)


def _med(ms: List[float]) -> float:
    return statistics.median(ms)


def _err(T_true: np.ndarray, T_est) -> float:
    """|log(T_true T_est^-1)| in f64 on the host (the largest over a batch)."""
    T_est = torch.as_tensor(_fetch(T_est)).double().reshape(-1, 4, 4)
    v = se3.tran2vec(torch.as_tensor(T_true, dtype=torch.float64) @ torch.linalg.inv(T_est))
    return float(torch.linalg.vector_norm(v, dim=-1).max())


def _pair_truth() -> np.ndarray:
    return se3.tran_inv(se3.vec2tran(torch.tensor(PAIR_XI, dtype=torch.float64))).numpy()


def _moved(points: np.ndarray, xi) -> tuple:
    """``points`` moved by vec2tran(xi) on the host in f64: (moved f32, the
    transform f64)."""
    T = se3.vec2tran(torch.tensor(np.array(xi, np.float32))).numpy().astype(np.float64)
    moved = (points[:, :3].astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return moved, T


# --- config #1-#3: the reference pair ---------------------------------------------

def bench_svd_pair(device=None):
    """Config #1: point-to-point SVD ICP on the tests/data pair."""
    from dicp_tpu_torch.svd_icp import pt2pt_svd_icp

    device = _device(device)
    scan, mp = _pair()
    src = torch.as_tensor(scan[:, :3], device=device)
    tgt = torch.as_tensor(mp[:, :3], device=device)

    def call():
        return pt2pt_svd_icp(src, tgt, max_iterations=60, tolerance=1e-9,
                             differentiable=False, device=device)

    ms = _times(lambda: call().T, device)
    res = call()
    err = _err(_pair_truth(), res.T)
    _gate(err < TOL_POSE, "svd_pair", f"transform error {err} < {TOL_POSE}")
    return [_emit("svd_pair", _med(ms), "ms/pair", ms, transform_err=err,
                  iterations=int(res.iterations), clock=_clock(device))]


def bench_pt2pl_pair(device=None):
    """Config #2: point-to-plane IRLS ICP with the Huber loss."""
    from dicp_tpu_torch.registration import register

    device = _device(device)
    scan, mp = _pair()
    src = torch.as_tensor(scan[None, :, :3], device=device)
    tgt = torch.as_tensor(mp[None], device=device)
    ti = torch.eye(4, dtype=torch.float32, device=device)[None]
    cfg = HEAD_CFG.with_(differentiable=False)
    ms = _times(lambda: register(src, tgt, ti, None, cfg).T, device)
    res = register(src, tgt, ti, None, cfg)
    err = _err(_pair_truth(), res.T[0])
    _gate(err < TOL_POSE, "pt2pl_pair", f"transform error {err} < {TOL_POSE}")
    return [_emit("pt2pl_pair", _med(ms), "ms/pair", ms, transform_err=err,
                  iterations=float(res.iterations[0]), clock=_clock(device))]


def bench_batch256(device=None):
    """Config #3: B=256 batched differentiable ICP, forward and backward:
    the unrolled gradient and the IFT one (bench.py's headline; K4 as its
    forward), measured by :func:`bench.run` with its ``BENCH_FULL`` variants
    (in turns, after bench.py's gates)."""
    device = _device(device)
    times = bench.run(device, full=True)["times"]
    rows = []
    for name, key in (("batch256_fwdbwd", "unrolled fwd+bwd"),
                      ("batch256_fwdbwd_ift", "IFT fwd+bwd")):
        rate = bench.B / _med(times[key]) * 1e3
        rows.append(_emit(name, rate, "registrations/s", times[key],
                          vs_cpu_baseline=round(rate / bench.BASELINE_REG_PER_S, 2),
                          clock=_clock(device)))
    return rows


B_CAP = 4096


def bench_capacity(device=None):
    """The headline configuration at B=4096 (K4 as the IFT's forward), with
    and without ``batch_chunk=1024``; the peak device memory of each."""
    device = _device(device)
    B = B_CAP
    src, tgt, ti = _batch_inputs(B, device)
    cfg = bench.head_config()
    rows, first = [], None
    for name, c, extra in (("batch4096_fwdbwd_ift", cfg, {}),
                           ("batch4096_fwdbwd_ift_chunked", cfg.with_(batch_chunk=1024),
                            {"batch_chunk": 1024})):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        res, _, grad = bench.fwdbwd(bench.register_ift, c, src, tgt, ti)
        peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda"
                else None)
        _gate(bool(torch.isfinite(res.T).all()) and bool(torch.isfinite(grad).all()),
              name, "finite transforms and gradients")
        if first is None:
            first = (res.T.detach(), grad)
        else:   # the chunks solve the same pairs
            dT = float((first[0] - res.T.detach()).abs().max())
            _gate(dT <= 1e-6, name, f"chunked transforms within 1e-6 of the unchunked ({dT})")
            extra.update(T_bit_equal=bool(torch.equal(first[0], res.T.detach())),
                         grad_max_abs_diff=float((first[1] - grad).abs().max()))
        ms = _times(lambda c=c: bench.fwdbwd(bench.register_ift, c, src, tgt, ti)[2], device)
        rate = B / _med(ms) * 1e3
        rows.append(_emit(name, rate, "registrations/s", ms,
                          vs_cpu_baseline=round(rate / bench.BASELINE_REG_PER_S, 2),
                          peak_memory_gib=None if peak is None else round(peak, 3),
                          clock=_clock(device), **extra))
    return rows


# --- config #4: 100k-point clouds ------------------------------------------------

N_LARGE = 100_000              # the large-cloud and normals rows' cloud
LARGE_XI = (0.2, -0.1, 0.05, 0.01, -0.02, 0.03)
LARGE_CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                      tolerance=1e-5, dim=3, trim_dist=2.0, loss_name="huber",
                      loss_metric=1.0, nn_method="cluster")


def bench_large_cloud(device=None):
    """Config #4: 100k-point registration through the cluster index (built
    once per solve, queried every GN iteration), the brute-force 1-NN kernel
    K1 alone, the index's exact 1-NN and 16-NN (K2, K3) alone, and the
    solve on voxel-downsampled and full-resolution sources."""
    from dicp_tpu_torch.ops import tiled_knn
    from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_knn, cluster_nn
    from dicp_tpu_torch.ops.voxel import voxel_downsample
    from dicp_tpu_torch.registration import register

    device = _device(device)
    n = N_LARGE
    scene = _make_scene(n)
    moved, T_st = _moved(scene, LARGE_XI)
    target = torch.as_tensor(scene, device=device)
    tgt3 = target[:, :3].contiguous()
    source = torch.as_tensor(moved, device=device)
    T_true = np.linalg.inv(T_st)
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    rows, clock = [], _clock(device)

    ms = _times(lambda: tiled_knn.nn_distances(source, tgt3), device)
    idx_ref, d2_ref = tiled_knn.nn_distances(source, tgt3)
    rows.append(_emit("pallas_knn_100k", _med(ms), "ms", ms, pairs=n * n, clock=clock))

    ms_b = _times(lambda: build_cluster_index(tgt3, 128).centers, device)
    index = build_cluster_index(tgt3, 128)
    ms_q = _times(lambda: cluster_nn(index, source, probes=32), device)
    idx, d2, cert = cluster_nn(index, source, probes=32)
    agree = float((idx == idx_ref).float().mean())
    # certified answers are exact: the same point or a tie at the same distance
    exact = bool(((idx == idx_ref) | (d2 == d2_ref))[cert].all())
    _gate(exact, "cluster_knn_100k", "every certified answer equals the brute-force one")
    total = [b + q for b, q in zip(ms_b, ms_q)]
    rows.append(_emit("cluster_knn_100k", _med(ms_b) + _med(ms_q), "ms", total,
                      build_ms=round(_med(ms_b), 3), query_ms=round(_med(ms_q), 3),
                      certified_pct=round(100 * float(cert.float().mean()), 3),
                      agreement_vs_bruteforce_pct=round(100 * agree, 4),
                      note="solver amortizes the one-time build over all GN iterations",
                      clock=clock))

    knn = {}
    for fused, tag in ((None, "cluster_knn16_100k"), (False, "cluster_knn16_100k_xla")):
        ms = _times(lambda f=fused: cluster_knn(index, source, k=16, probes=32, fused=f), device)
        knn[tag] = cluster_knn(index, source, k=16, probes=32, fused=fused)
        detail = ({"certified_pct": round(100 * float(knn[tag][2].float().mean()), 3)}
                  if fused is None else
                  {"note": "the candidate matrix and 16 extraction passes in PyTorch"})
        rows.append(_emit(tag, _med(ms), "ms", ms, k=16, clock=clock, **detail))
    (_, d_k, c_k), (_, d_x, c_x) = knn.values()
    _gate(torch.allclose(d_k, d_x, rtol=1e-5, atol=1e-6) and torch.equal(c_k, c_x),
          "cluster_knn16_100k", "the 16 distances and certificates equal the PyTorch path's")

    def reg_voxel():
        v = voxel_downsample(source, 0.5)
        return register(v.points[None], target[None], eye, v.weight[None], LARGE_CFG)

    def reg_full():
        return register(source[None], target[None], eye, None, LARGE_CFG)

    for name, fn in (("large_cloud_100k", reg_voxel), ("large_cloud_100k_fullres", reg_full)):
        ms = _times(lambda fn=fn: fn().T, device)
        res = fn()
        err = _err(T_true, res.T[0])
        _gate(err < TOL_POSE, name, f"transform error {err} < {TOL_POSE}")
        rows.append(_emit(name, _med(ms), "ms/registration", ms, transform_err=err,
                          iterations=float(res.iterations[0]), clock=clock))
    return rows


def bench_normals(device=None):
    """Weighted PCA normals of the 100k cloud through the cluster index (no
    (n, n) matrix), then a pt2pl registration that computes its own target
    normals."""
    from dicp_tpu_torch.ops.normals import estimate_normals
    from dicp_tpu_torch.registration import register

    device = _device(device)
    n = N_LARGE
    scene = _make_scene(n)
    tgt3 = torch.as_tensor(scene[:, :3], device=device)
    true_n = scene[:, 3:6]

    def est(p):
        return estimate_normals(p, method="weighted")

    ms = _times(lambda: est(tgt3), device)
    nrm = est(tgt3).cpu().numpy()
    dots = np.abs(np.sum(nrm * true_n, axis=-1))
    median_deg = float(np.degrees(np.arccos(np.clip(np.median(dots), 0.0, 1.0))))
    _gate(median_deg < TOL_NORMAL_DEG, "normals_100k",
          f"median angle to the exact normals {median_deg} < {TOL_NORMAL_DEG} deg")
    rows = [_emit("normals_100k", _med(ms), "ms", ms, method="weighted",
                  mean_abs_dot_vs_truth=round(float(dots.mean()), 6),
                  pct_within_5deg=round(100 * float((dots > np.cos(np.radians(5))).mean()), 3),
                  median_angle_deg=round(median_deg, 6), clock=_clock(device))]

    moved, T_st = _moved(scene, LARGE_XI)
    source = torch.as_tensor(moved, device=device)
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]

    def e2e():
        tgt6 = torch.cat([tgt3, est(tgt3)], dim=-1)
        return register(source[None], tgt6[None], eye, None, LARGE_CFG)

    ms = _times(lambda: e2e().T, device)
    res = e2e()
    err = _err(np.linalg.inv(T_st), res.T[0])
    _gate(err < TOL_POSE, "large_cloud_100k_selfnormals", f"transform error {err} < {TOL_POSE}")
    rows.append(_emit("large_cloud_100k_selfnormals", _med(ms), "ms/registration", ms,
                      transform_err=err, iterations=float(res.iterations[0]),
                      clock=_clock(device)))
    return rows


def bench_odometry(device=None):
    """Config #5: 63 scan pairs of the tests/data map along a constant step
    in one batched odometry call, and the trajectory's ATE."""
    from dicp_tpu_torch.odometry import ate, odometry

    device = _device(device)
    _, mp = _pair(np.float32)
    S = 64
    step_T = se3.vec2tran(torch.tensor([0.05, 0.08, 0, 0, 0, 0.02])).numpy()
    T = np.eye(4, dtype=np.float32)
    scans, poses = [], []
    for _ in range(S):
        Ti = np.linalg.inv(T)
        scans.append(np.hstack([mp[:, :3] @ Ti[:3, :3].T + Ti[:3, 3],
                                mp[:, 3:6] @ Ti[:3, :3].T]).astype(np.float32))
        poses.append(T.copy())
        T = T @ step_T
    scans_t = torch.as_tensor(np.stack(scans), device=device)
    truth = torch.as_tensor(np.stack(poses), device=device)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
    ms = _times(lambda: odometry(scans_t, cfg).poses, device)
    res = odometry(scans_t, cfg)
    err = float(ate(res.poses, truth, align=False))
    conv = bool(res.converged.all())
    _gate(conv and err < TOL_POSE, "odometry_64scans",
          f"every pair converged ({conv}), ATE {err} < {TOL_POSE}")
    return [_emit("odometry_64scans", (S - 1) / _med(ms) * 1e3, "pairs/s", ms, ate=err,
                  solves_per_step=1, all_converged=conv, clock=_clock(device))]


# --- the streaming pipeline ------------------------------------------------------

PIPE_N, PIPE_S, PIPE_S2 = 60_000, 16, 64   # points per scan; scans swept, streamed
PIPE_STEP_XI = (0.04, 0.02, 0.01, 0.004, 0.002, 0.01)
PIPE_CFG = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30,
                     tolerance=1e-5, dim=3, trim_dist=1.0, loss_name="huber",
                     loss_metric=0.5, nn_method="cluster")
# (voxel, max points, nn_method) of the accuracy-versus-voxel sweep
PIPE_SWEEP = ((0.4, 4096, "pallas"), (0.2, 16384, "cluster"), (0.1, 65536, "cluster"),
              (None, 61440, "cluster"))
# (window, warm start, quantized) of the streamed rows
PIPE_STREAMS = ((1, True, False), (4, True, False), (8, True, False), (8, False, False),
                (1, True, True), (4, True, True))
PIPE_REPS = 3
TOL_STREAM = 1e-3              # bench_suite.py:657: the accuracy bound of a setting


def _write_scans(directory: str, scene: np.ndarray, S: int, T_step: np.ndarray) -> None:
    from dicp_tpu_torch.io import save_bin

    T = np.eye(4, dtype=np.float32)
    for i in range(S):
        Ti = np.linalg.inv(T).astype(np.float32)
        scan = scene @ Ti[:3, :3].T + Ti[:3, 3]
        save_bin(os.path.join(directory, f"{i:04d}.bin"),
                 np.hstack([scan, np.zeros((scan.shape[0], 1), np.float32)]))
        T = T @ T_step


def _rel_err(rels: torch.Tensor, step_inv: np.ndarray) -> float:
    v = se3.tran2vec(rels.cpu().double() @ torch.as_tensor(step_inv, dtype=torch.float64))
    return float(torch.linalg.vector_norm(v, dim=-1).max())


def bench_pipeline(device=None):
    """End-to-end streaming odometry from disk: ScanDataset (range filter,
    voxel grid on the host) -> one pinned copy per scan -> registration on
    the card, one pair at a time (the sweep) and through stream_odometry
    (the windowed rows); every transform is fetched inside the timed run."""
    from dicp_tpu_torch.io import ScanDataset
    from dicp_tpu_torch.pipeline import stream_odometry
    from dicp_tpu_torch.registration import register

    device = _device(device)
    scene = _make_scene(PIPE_N)[:, :3]
    T_step = se3.vec2tran(torch.tensor(PIPE_STEP_XI, dtype=torch.float32)).numpy()
    step_inv = np.linalg.inv(T_step.astype(np.float64))
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    results, rows, clock = {}, [], _clock(device)
    sweep = [] if os.environ.get("DICP_BENCH_STREAM_Q_ONLY") else PIPE_SWEEP
    combos = (((1, True, True), (4, True, True)) if os.environ.get("DICP_BENCH_STREAM_Q_ONLY")
              else PIPE_STREAMS)
    S, S2 = PIPE_S, PIPE_S2
    with tempfile.TemporaryDirectory(prefix="dicp_bench_") as tmpdir, \
            tempfile.TemporaryDirectory(prefix="dicp_bench_stream_") as tmpdir2:
        _write_scans(tmpdir, scene, S, T_step)

        def run_pipeline(voxel, max_pts, cfg):
            ds = ScanDataset.from_dir(tmpdir, max_points=max_pts, voxel=voxel, workers=4,
                                      prefetch=4)
            prev, rels = None, []
            for pts_np, w_np in ds:
                cur = torch.as_tensor(pts_np[:, :3], device=device)
                w = torch.as_tensor(w_np, device=device)
                if prev is not None:
                    rels.append(register(cur[None], prev[None], eye, w[None], cfg).T[0])
                prev = cur
            return torch.stack(rels)

        for voxel, max_pts, nn in sweep:
            cfg = PIPE_CFG.with_(nn_method=nn)
            ms = _times(lambda: run_pipeline(voxel, max_pts, cfg), device, reps=PIPE_REPS)
            err = _rel_err(run_pipeline(voxel, max_pts, cfg), step_inv)
            tag = "raw" if voxel is None else str(voxel)
            fps = S / _med(ms) * 1e3
            results[tag] = (fps, err)
            rows.append(_emit(f"pipeline_sweep_voxel_{tag}", fps, "frames/s", ms, rel_err=err,
                              scans=S, raw_pts=PIPE_N, max_pts=max_pts, nn_method=nn,
                              clock=clock))

        _write_scans(tmpdir2, scene, S2, T_step)

        def run_streamed(W, warm, quant):
            ds = ScanDataset.from_dir(tmpdir2, max_points=61440, voxel=None, workers=4,
                                      prefetch=4)

            def gen():
                for pts, w in ds:
                    p = pts[:, :3]
                    if quant:
                        # a weightless transfer needs the zero-row pads replaced
                        # by real rows (pads at the origin would bias the solve)
                        pad = w == 0
                        n_pad = int(pad.sum())
                        if n_pad:
                            p[pad] = p[~pad][:n_pad]
                        yield p, None
                    else:
                        yield p, w

            return stream_odometry(gen(), PIPE_CFG, window=W, warm_start=warm, quantize=quant,
                                   device=device).rel_transforms

        for W, warm, quant in combos:
            ms = _times(lambda: run_streamed(W, warm, quant), device, reps=PIPE_REPS)
            err = _rel_err(run_streamed(W, warm, quant), step_inv)
            tag = f"streamW{W}" + ("" if warm else "_cold") + ("_q" if quant else "")
            fps = S2 / _med(ms) * 1e3
            results[tag] = (fps, err)
            name = (f"pipeline_stream_window{W}" + ("" if warm else "_cold")
                    + ("_q16" if quant else ""))
            _gate(err <= TOL_STREAM, name, f"rel err {err} <= {TOL_STREAM}")
            rows.append(_emit(name, fps, "frames/s", ms, rel_err=err, scans=S2, raw_pts=PIPE_N,
                              window=W, warm_start=warm, quantized=quant, clock=clock))

    ok = [(tag, f, e) for tag, (f, e) in results.items() if e <= TOL_STREAM]
    _gate(bool(ok), "pipeline_stream", f"some setting meets rel err <= {TOL_STREAM}")
    tag, fps, err = max(ok, key=lambda t: t[1])
    rows.append(_emit("pipeline_stream", fps, "frames/s", rel_err=err, chosen=tag))
    return rows


# --- scan-to-map odometry --------------------------------------------------------

S2M_S, S2M_N, S2M_CAP, S2M_VOXEL = 12, 60_000, 65_536, 0.25
S2M_STEP_XI = (0.06, 0.03, 0.01, 0.004, 0.002, 0.015)
S2M_CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-6,
                    dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                    nn_method="cluster", collect_histories=False)
S2M_SGD = dict(solver="sgd", sgd_minibatch=2048, sgd_iterations=30)
TOL_ATE_GN, TOL_ATE_SGD = 1e-3, 5e-3   # host-loop ATE gates (chip_smoke.py phase 18)
# (row, scan_to_map_odometry keywords, ATE bound) of the host-loop rows
S2M_LOOP_VARIANTS = (("scan_to_map_60k", {}, TOL_ATE_GN),
                     ("scan_to_map_60k_sgd", S2M_SGD, TOL_ATE_SGD),
                     ("scan_to_map_60k_sgd_sub", dict(S2M_SGD, merge_subsample=20_000),
                      TOL_ATE_SGD))
S2M_LOOP_REPS = 3
S2M_CHAIN_REPS = 2


def scan_to_map_sequence():
    """The scan-to-map deployment: 12 scans of a 60,000-point wavy surface."""
    return _wavy_sequence(S2M_S, S2M_N, S2M_STEP_XI)


def _final_pose_err(truth_last: np.ndarray, pose) -> float:
    d = np.linalg.inv(truth_last.astype(np.float64)) @ _fetch(pose).double().numpy()
    return float(torch.linalg.vector_norm(se3.tran2vec(torch.as_tensor(d))))


def scan_to_map_host_loop(device=None, variants=S2M_LOOP_VARIANTS, seq=None,
                          reps: int = S2M_LOOP_REPS, first_run=None, emit: bool = True) -> dict:
    """Host-loop serving rate of scan_to_map_odometry (one map_step per scan,
    the poses fetched at the end): one untimed run, then ``reps`` timed
    runs, per ``(label, keywords, ATE bound)`` variant.  Every variant is
    gated (every scan converged, the untimed run's ATE below its bound);
    ``emit`` prints its row (a label of ``ROWS``).  ``first_run(label)``: a
    context manager entered around each variant's untimed run (chip_smoke.py
    counts and records the kernels there).  Returns each label's (first
    result, timed results, ms) and its row (None unless emitted)."""
    from dicp_tpu_torch.mapping import scan_to_map_odometry
    from dicp_tpu_torch.odometry import OdometryResult, ate

    device = _device(device)
    scans, poses_true, _ = scan_to_map_sequence() if seq is None else seq
    truth = torch.as_tensor(poses_true, dtype=torch.float64)
    S = len(scans)

    def run(kw):
        res = scan_to_map_odometry(((s, None) for s in scans), S2M_CFG, capacity=S2M_CAP,
                                   voxel=S2M_VOXEL, seed=0, device=device, **kw)
        return OdometryResult(*(_fetch(a) for a in res))

    out = {}
    for label, kw, bound in variants:
        with (first_run(label) if first_run else contextlib.nullcontext()):
            first = run(kw)
        runs = []
        ms = times_ms(lambda: runs.append(run(kw)), device, warmup=0, iters=reps)
        err = _final_pose_err(poses_true[-1], first.poses[-1])
        traj = float(ate(first.poses.double(), truth, align=False))
        conv = bool(first.converged.all())
        _gate(conv, label, "every scan converged")
        _gate(traj < bound, label, f"ATE {traj} < {bound}")
        row = None
        if emit:
            row = _emit(label, S / _med(ms) * 1e3, "frames/s", ms, final_pose_err=err, ate=traj,
                        scans=S, raw_pts=S2M_N, map_cap=S2M_CAP, voxel=S2M_VOXEL,
                        all_converged=conv, clock=_clock(device),
                        **{k: v for k, v in kw.items() if k != "solver"})
        out[label] = {"first": first, "runs": runs, "ms": ms, "final_pose_err": err,
                      "ate": traj, "row": row}
    return out


def _s2m_chain(scans, step, cfg, K, insert, solver, skw, device):
    """map_step over scans 1..K-1 from a map of scan 0, the map carried from
    step to step, each prediction the previous pose times the step; returns
    the last pose and the iterations, fetched."""
    from dicp_tpu_torch.mapping import empty_map, map_merge, map_step

    m = map_merge(empty_map(S2M_CAP, torch.float32, device), scans[0], S2M_VOXEL,
                  with_normals=True, mode="mean")
    pose = torch.eye(4, dtype=torch.float32, device=device)
    its = []
    for i in range(1, K):
        key = i - 1 if solver == "sgd" else None
        pose, _, it, m = map_step(m, scans[i], pose @ step, None, cfg, S2M_VOXEL, insert=insert,
                                  merge_mode="mean", solver=solver, key=key, **skw)
        its.append(it)
    return _fetch(pose), _fetch(torch.stack(its))


def scan_to_map_step_rows(device=None, seq=None, reps: int = S2M_CHAIN_REPS):
    """Device cost per scan of the chained map_step, by differencing chains
    of 3 and 12 scans (CUDA events, median of ``reps`` after one run each):
    solve of 10 iterations with and without the merge, 20 against 10 for
    one GN iteration, the SGD front end with and without a subsampled
    merge.  ``vs_gn_step`` compares each SGD step with a GN step of the same
    configuration and iteration budget (30, early exit)."""
    device = _device(device)
    scans_np, poses_true, step_np = scan_to_map_sequence() if seq is None else seq
    scans = [torch.as_tensor(s, device=device) for s in scans_np]
    step = torch.as_tensor(step_np, device=device)
    k_small, k_big = 3, len(scans)

    def timed(insert, cfg, solver="gn", **skw):
        med, spread = {}, {}
        for K in (k_small, k_big):
            ms = _times(lambda: _s2m_chain(scans, step, cfg, K, insert, solver, skw, device),
                        device, reps=reps)
            med[K], spread[K] = _med(ms), [round(min(ms), 3), round(max(ms), 3)]
        pose, its = _s2m_chain(scans, step, cfg, k_big, insert, solver, skw, device)
        err = _final_pose_err(poses_true[k_big - 1], pose)
        tol = TOL_ATE_SGD if solver == "sgd" else TOL_POSE
        _gate(err < tol, f"scan-to-map chain ({solver}, insert={insert})",
              f"final pose error {err} < {tol}")
        per_scan = (med[k_big] - med[k_small]) / (k_big - k_small)
        return per_scan, {f"chain{K}_ms": round(med[K], 3) for K in med} | {
            f"chain{K}_spread_ms": spread[K] for K in spread} | {"final_pose_err": err}

    clock = _clock(device)
    cfg10 = S2M_CFG.with_(const_iter=True, max_iterations=10)
    cfg20 = S2M_CFG.with_(const_iter=True, max_iterations=20)
    dt_full, d_full = timed(True, cfg10)
    dt_solve, d_solve = timed(False, cfg10)
    rows = [_emit("scan_to_map_60k_step", dt_full, "ms/scan", merge_ms=round(dt_full - dt_solve, 3),
                  solve10_ms=round(dt_solve, 3), reps=reps, clock=clock, **d_full,
                  note="const_iter=10, chains of 3 and 12 scans; merge = full - insert_off")]
    dt_solve20, _ = timed(False, cfg20)
    rows.append(_emit("scan_to_map_gn_iter", max(0.0, (dt_solve20 - dt_solve) / 10.0),
                      "ms/iteration", reps=reps, clock=clock,
                      note="const_iter 20-vs-10 differencing, 60k scan vs 65k-cap map"))
    dt_gn30, _ = timed(True, S2M_CFG)
    dt_sgd, d_sgd = timed(True, S2M_CFG, **S2M_SGD)
    note = ("vs_gn_step: a GN step of the same configuration and iteration budget "
            f"(max_iterations 30, early exit, insert=True: {dt_gn30:.3f} ms/scan) over this step")
    rows.append(_emit("scan_to_map_60k_step_sgd", dt_sgd, "ms/scan", sgd_minibatch=2048,
                      sgd_iterations=30, vs_gn_step=round(dt_gn30 / dt_sgd, 2),
                      gn_step_ms=round(dt_gn30, 3), reps=reps, clock=clock, **d_sgd, note=note))
    dt_sub, d_sub = timed(True, S2M_CFG, merge_subsample=20_000, **S2M_SGD)
    rows.append(_emit("scan_to_map_60k_step_sgd_sub", dt_sub, "ms/scan", sgd_minibatch=2048,
                      sgd_iterations=30, merge_subsample=20_000,
                      vs_gn_step=round(dt_gn30 / dt_sub, 2), reps=reps, clock=clock, **d_sub,
                      note=note))
    return rows


def bench_scan_to_map(device=None, loop: bool = True):
    """Scan-to-map odometry at serving scale: 60k-point raw scans against a
    65,536-row fused voxel map; the chained step rows, then the host-loop
    rows (``loop=False``: chip_smoke.py's phase 18 runs those)."""
    seq = scan_to_map_sequence()
    rows = []
    if not os.environ.get("DICP_S2M_LOOP_ONLY"):
        rows += scan_to_map_step_rows(device, seq)
    if loop and not os.environ.get("DICP_S2M_STEP_ONLY"):
        rows += [v["row"] for v in scan_to_map_host_loop(device, seq=seq).values()]
    return rows


# --- the solver zoo --------------------------------------------------------------

def bench_solvers(device=None, delegates=("exp_gicp", "exp_sgd", "exp_multiscale")):
    """GICP, SGD against the full solver and the pyramid (the ``exp_*``
    modules' rows), Anderson acceleration on the pt2pt pair, and the AA
    forward with the IFT backward at the headline's B=256.  ``delegates``:
    the ``exp_*`` modules to run (chip_smoke.py runs two of them in its
    phase 19)."""
    from dicp_tpu_torch.benchmarks import exp_gicp, exp_multiscale, exp_sgd
    from dicp_tpu_torch.ift import register_ift
    from dicp_tpu_torch.registration import register

    device = _device(device)
    rows = []
    if not os.environ.get("DICP_SOLVERS_AA_ONLY"):
        mods = {"exp_gicp": exp_gicp, "exp_sgd": exp_sgd, "exp_multiscale": exp_multiscale}
        for name in delegates:
            rows += mods[name].main(device)["rows"]

    scan, mp = _pair()
    src1 = torch.as_tensor(scan[None, :, :3], device=device)
    tgt1 = torch.as_tensor(mp[None], device=device)
    ti1 = torch.eye(4, dtype=torch.float32, device=device)[None]
    base = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=100, tolerance=1e-6,
                     dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     collect_histories=False)
    for m, tol, tag in ((0, 1e-6, "aa_off"), (3, 1e-6, "aa_m3"), (0, 1e-10, "aa_off_tol10"),
                        (3, 1e-10, "aa_m3_tol10")):
        cfg = base.with_(anderson_m=m, tolerance=tol)
        res = register(src1, tgt1, ti1, None, cfg)
        err = _err(_pair_truth(), res.T[0])
        _gate(err < TOL_POSE, f"pt2pt_pair_{tag}", f"transform error {err} < {TOL_POSE}")
        ms = _times(lambda c=cfg: register(src1, tgt1, ti1, None, c).T, device)
        rows.append(_emit(f"pt2pt_pair_{tag}", _med(ms), "ms/pair", ms,
                          iterations=float(res.iterations[0]), converged=bool(res.converged[0]),
                          transform_err=err, clock=_clock(device)))

    B = 256
    srcB, tgtB, tiB = _batch_inputs(B, device)
    cfgd = ICPConfig(icp_type="pt2pl", differentiable=True, driver="while", max_iterations=100,
                     tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
                     collect_histories=False)
    grads = {}
    for m, tag in ((0, "off"), (3, "m3")):
        cfg = cfgd.with_(anderson_m=m)
        _, _, grads[tag] = bench.fwdbwd(register_ift, cfg, srcB, tgtB, tiB)
        _gate(bool(torch.isfinite(grads[tag]).all()), f"batch256_ift_aa_{tag}", "finite gradient")
        ms = _times(lambda c=cfg: bench.fwdbwd(register_ift, c, srcB, tgtB, tiB)[2], device)
        rows.append(_emit(f"batch256_ift_aa_{tag}", B / _med(ms) * 1e3, "registrations/s", ms,
                          clock=_clock(device)))
    g_off, g_m3 = grads["off"].double(), grads["m3"].double()
    gdiff = float((g_m3 - g_off).abs().max() / max(1e-12, float(g_off.abs().max())))
    cos = bench.cosine(g_m3, g_off)
    _gate(cos > bench.TOL_COSINE, "aa_ift_grad_reldiff",
          f"cosine of the AA-forward and while-forward IFT gradients {cos} > "
          f"{bench.TOL_COSINE}")
    rows.append(_emit("aa_ift_grad_reldiff", gdiff, "max_rel", cosine=cos,
                      note="AA fwd + IFT bwd vs while fwd + IFT bwd, same fixed point"))
    return rows


# every row each name emits, under the JAX suite's row names (exp_sgd's smoke
# size included)
ROWS = {
    "svd_pair": ("svd_pair",),
    "pt2pl_pair": ("pt2pl_pair",),
    "batch256": ("batch256_fwdbwd", "batch256_fwdbwd_ift"),
    "large_cloud": ("pallas_knn_100k", "cluster_knn_100k", "cluster_knn16_100k",
                    "cluster_knn16_100k_xla", "large_cloud_100k", "large_cloud_100k_fullres"),
    "normals": ("normals_100k", "large_cloud_100k_selfnormals"),
    "odometry": ("odometry_64scans",),
    "capacity": ("batch4096_fwdbwd_ift", "batch4096_fwdbwd_ift_chunked"),
    "pipeline": ("pipeline_sweep_voxel_0.4", "pipeline_sweep_voxel_0.2",
                 "pipeline_sweep_voxel_0.1", "pipeline_sweep_voxel_raw",
                 "pipeline_stream_window1", "pipeline_stream_window4", "pipeline_stream_window8",
                 "pipeline_stream_window8_cold", "pipeline_stream_window1_q16",
                 "pipeline_stream_window4_q16", "pipeline_stream"),
    "scan_to_map": ("scan_to_map_60k_step", "scan_to_map_gn_iter", "scan_to_map_60k_step_sgd",
                    "scan_to_map_60k_step_sgd_sub", "scan_to_map_60k", "scan_to_map_60k_sgd",
                    "scan_to_map_60k_sgd_sub"),
    "solvers": ("gicp_b64", "gicp_ift_fwdbwd_b64", "pt2pt_b64_same_shape",
                "sgd_gn_20k_k1024", "full_pt2pl_20k", "sgd_gn_100k_k2048", "full_pt2pl_100k",
                "sgd_gn_2k_k256", "full_pt2pl_2k",
                "singlescale_100k_farinit", "multiscale_100k_farinit",
                "pt2pt_pair_aa_off", "pt2pt_pair_aa_m3", "pt2pt_pair_aa_off_tol10",
                "pt2pt_pair_aa_m3_tol10", "batch256_ift_aa_off", "batch256_ift_aa_m3",
                "aa_ift_grad_reldiff"),
}
ROW_NAMES = frozenset(name for rows in ROWS.values() for name in rows)

ALL = {
    "svd_pair": bench_svd_pair,
    "pt2pl_pair": bench_pt2pl_pair,
    "batch256": bench_batch256,
    "large_cloud": bench_large_cloud,
    "normals": bench_normals,
    "odometry": bench_odometry,
    "capacity": bench_capacity,
    "pipeline": bench_pipeline,
    "scan_to_map": bench_scan_to_map,
    "solvers": bench_solvers,
}


def main(names=None, device=None) -> list:
    device = _device(device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", file=sys.stderr, flush=True)
    rows = []
    for name in names or list(ALL):
        rows += ALL[name](device)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
