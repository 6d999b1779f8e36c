#!/usr/bin/env python3
"""Smoke test of dicp_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: a CUDA device is required (no CPU continuation); prints the card's
   name and power limit; checks that float32 matmuls run in full precision.
1. build: compiles the CUDA kernels of the checkout, one nvcc per source, all
   started together (csrc/tiled_nn.cu, cluster_search.cu, cluster_topk.cu,
   fused_gn.cu, score_nn.cu);
   prints K1's -Xptxas=-v report.
2. K1 against its plain PyTorch version on the card, bit for bit: indices and
   squared distances identical, at the main path's shapes and at edge cases
   (a duplicated nearest target split across K1's target-slice boundary, m
   not a multiple of the slice or stage width, fewer targets than slices,
   targets that are not 16-byte aligned); timed; and the share of (warp,
   query slot, 32-target chunk) triples in which some lane would find a new
   best, the re-scan rate of a chunked argmin, at the main path's shape.
3. the reference contract on the dense tier: the 65-point pair of tests/data
   at B=256, pt2pl, dim 2, trim 5, huber 1, tol 1e-6, f32; transform error
   against the known truth < 1e-3.
4. the main path at real size on the kernel tier: 8 pairs of a synthetic
   LiDAR-like scene, 12,288 source points against 16,000 target points with
   normals, pt2pl, dim 3; every pair's rotation and translation error < 1e-3,
   and K1 launched at least once per Gauss-Newton iteration.
5. the cluster kernels' -Xptxas=-v reports (K2 and K5: csrc/cluster_search.cu,
   which must show no register spills; K3: csrc/cluster_topk.cu), and K3's
   launch geometry at the cluster tier's block for each list length
   (threads, registers, spilled bytes).
6. K2 and K5 against their plain PyTorch versions on the card, bit for bit
   (best, row, bound) at the two raw-scan shapes and at edge cases (among
   them a duplicated candidate split across K2's column-slice boundary, g = 7
   served by 4-byte copies, points that are not 16-byte aligned, g = 2000 in
   three staging passes, a NaN target point and a NaN query, which must leave
   their queries uncertified); timed; then a subprocess launches K2 with a
   group id outside [0, G) and must fail with a CUDA error (the kernel's
   __trap).
7. K3 against its plain version, bit for bit (d2, rows, bound), at 100k x
   100k (k = 16, 1, 2, 5, 32) and at edge cases: duplicated points across
   group boundaries, k beyond a query's finite candidates (the column-0
   fill), g = 7, g = 2000 in four staging tiles per group, points that are
   not 16-byte aligned, a NaN target point and a NaN
   query (held to the plain version as phase 6 holds K2); a subprocess
   launches K3 with a group id outside [0, G) and must fail with a CUDA
   error.  Timed call by call and back to back.
8. the single-pair raw-scan path: weighted PCA normals of a 100,000-point map
   (median angle to the exact normals < 2 deg), cluster k-NN normals (K3),
   and ICP.icp of the map's points, permuted and moved, through the cluster
   tier (K2 at least once per iteration; rotation and translation errors
   < 1e-3); then cluster_nn(use_pallas=True) (K5) equal to the K2 path.
9. batched raw scans: 8 pairs of 50,000 -> 60,000 points through the cluster
   tier; every pair's errors < 1e-3, K2 launched.
10. the whole-solve kernel K4's -Xptxas=-v report (csrc/fused_gn.cu, built in
    phase 1 with the others), which must show no register spills, and its
    launch geometry (lanes per point, threads, registers) at phase 11's two
    main shapes.
11. K4 against its plain version on the same card tensors: the headline's
    configuration (the reference pair at B=256, pt2pl, dim 2, trim 5,
    huber 1, tol 1e-6), the gate's largest shape (256 pairs of 256 -> 512
    points of the LiDAR-like scene, pt2pl, dim 3) and edge cases (pt2pt dim 3
    cauchy, prior weights with zeros, B=5, n=1, the trim loss at steepness 2,
    every loss with pt2pl dim 3 and with pt2pt dim 2, n=256 with m=512 at
    dim 2, m=1, n and m not multiples of the lane split); convergence,
    iterations and matched ratio equal, T within 1e-5, pc within 1e-4, two
    launches identical.  Timed call by call and back to back against the
    plain version, and the forward A/B: register(fused_small=True) against
    the loop, alternated in one process.
12. the headline path: the reference pair at B=256 through register_ift with
    K4 as the forward, value sum(T) and its gradient with respect to the
    sources; transform error < 1e-3, gradients finite and nonzero, cosine
    with the unrolled gradient > 0.99, K4 launched once per call.  Timed
    (registrations per second) alternated with the IFT on the loop forward
    and with the unrolled gradient, on dicp_tpu_torch.bench's clock
    (bench.time_alternated); phase 22 prints bench_suite's batch256 rows
    from these times.

13. the score-form 1-NN kernels K6 and K7 (csrc/score_nn.cu, built in phase 1):
    their -Xptxas=-v report, which must show no register spills, then each
    against its plain version on the same card tensors, bit for bit (indices
    and scores): 4096 x 4096 at every (tq, tm) of the A/B table, one
    100k x 100k call each, m < tm, m not a multiple of tm, K6 at tm not a
    multiple of 4 (4-byte copies), n = 1, n not a multiple of tq, duplicated
    targets (ties to the first copy), f64 inputs, a NaN target point (held
    to the plain version with that point out of reach: the kernels skip its
    column, the plain versions drop its target tile) and a NaN query
    ((inf, 0)).  Timed at 100k x 100k, call by call and back to back.
14. the A/B entry point itself, ``dicp_tpu_torch.benchmarks.exp_knn.main()``:
    v0 (K1), v1 (K6) and v2 (K7) correct within the tie tolerance at
    4096 x 4096 against an f64 argmin, then the seven rows timed at
    100k x 100k in this process.
15. Gumbel soft NN on the card: ICP.icp with use_gumbel=True at the headline
    configuration (the reference pair at B=256) with a seeded generator,
    finite with transform error < 0.5; one streamed gumbel_nn at phase 4's
    8 x 12,288 -> 16,000 shape, finite and inside the targets' bounding box,
    and equal to hard NN on a well-separated lattice at tau = 1e-3.
17. LiDAR odometry over raw scans (benchmarks/bench_suite.py:585-660): 64
    lidar_scene scans of 60,000 points moved along a constant step, written
    as .bin files and read back through ScanDataset(max_points=61440,
    workers=4, prefetch=4); pt2pt, trim 1, Huber 0.5, 30 iterations, tol
    1e-5, the cluster tier.  stream_odometry at W = 1 warm, W = 8 warm and
    cold (f32) and W = 1 warm quantized and weightless (pads replaced by real
    rows): frames/s (median of 3 runs after one) and rel err, <= 1e-4 (f32)
    and <= 1e-3 (quantized), K2 launched on every pair; W = 1 warm again
    with the scans read before the run (what ScanDataset in the loop
    costs); the 63 pairs in one
    batched odometry call (iterations and convergence equal to the cold
    W = 8 stream's, transforms within 1e-5; peak memory); K2 against its
    plain version bit for bit (best, row, bound) on the arguments of the
    first and last K2 call of each f32 stream's first run and of a batched
    odometry call, recorded as the solver passed them: padded targets, whose
    zero rows form groups of radius 0 at the origin, and the source pads as
    queries on them; the pose graph with
    loop closures (i, i+8) (ATE < 1e-3, two calls bit-equal); resume from a
    checkpoint (within 1e-5 of one shot); voxel_downsample of one scan (two
    calls bit-equal, the count equal to numpy's); pt2pt_svd_icp on the
    reference pair at B=256 (error < 1e-3) and the 180-degree Kabsch case in
    f64; the host preprocessing time per scan.
18. scan-to-map odometry at the JAX suite's deployment (benchmarks/
    bench_suite.py:688-840, no cut): 12 scans of a +-20 m wavy 60,000-point
    surface along a constant step against a 65,536-row fused voxel map
    (voxel 0.25; pt2pl, trim 2, Huber 0.5, 30 iterations, tol 1e-6, the
    cluster tier), run by dicp_tpu_torch.benchmarks.bench_suite's host loop,
    which prints its scan_to_map_60k, _sgd and _sgd_sub rows.
    scan_to_map_odometry with gn, sgd (2,048 per
    mini-batch, 30 iterations, a fixed seed), sgd with merge_subsample
    20,000, and quantized gn: frames/s (median of 3 runs after one, poses
    fetched), final-pose error and ATE against the exact truth, iterations
    and K2 launches per scan; gates: every scan converged, ATE < 1e-3 (gn),
    < 5e-3 (sgd), < max(5 x gn's, 2e-3) (quantized), four same-seed sgd
    runs bit-equal, K2 on every gn scan and never on the sgd path.  K2
    against its plain version bit for bit on the first and last K2 call of
    the gn stream, whose targets hold groups of the map's sentinel rows (a
    gate).  A mature map built by map_step: at most 65,536 occupied rows,
    its empty rows beyond the occupied box; map_step with insert=True and
    insert=False and map_merge of one scan alone (CUDA events, median of 5).
19. GICP and the multiscale pyramid at the JAX suite's deployments, run by
    dicp_tpu_torch.benchmarks.exp_gicp and exp_multiscale, which print their
    rows.  GICP
    (benchmarks/exp_gicp.py:27-100): B = 64 pairs of a 600-point saddle
    (seed 11), register_gicp (30 iterations, tol 1e-6; no kernel: a dense
    600 x 600 block per pair) timed and its error < 1e-3; the same-shape
    pt2pt register for the cost ratio; register_gicp_ift forward and
    backward, its gradient finite, nonzero and of cosine > 0.99 with the
    unrolled differentiable=True gradient; the f32 ~50 m radius case of
    tests/test_gicp.py:190 finite with error < 5e-4.  The pyramid
    (benchmarks/exp_multiscale.py:27-120): bench_suite's 100,000-point
    three-plane scene from the FAR init, pt2pl, trim 2, Huber 1, the cluster
    tier; single scale (40 iterations, tol 1e-5) against the pyramid (a 1 m,
    4,096-slot dense level of 15 iterations at tol 1e-3 and trim 8, then
    full resolution): ms per registration (CUDA events, median of 5 after
    one), both errors < 1e-3, level iterations and K2 launches per call;
    K2 against its plain version bit for bit on the first and last K2 call
    of the pyramid's full-resolution level.
20. closed-loop SLAM at real scan size: tests/test_slam.py:54-98's circuit
    (a 5 m circle, scan radius 6 m, noise 0.04, seed 3) with 60,000-point
    f32 scans drawn without replacement from a 1,000,000-point world, 2
    laps of 32 scans (65), the test's configuration with slam_odometry's
    default 8,192-row map: the front end on the tiled tier (K1), each
    closure against a 60,000-row anchor on the cluster tier (K2).  Frames/s
    (65 / wall s, refined poses fetched; median of 3 after one run),
    accepted closures of the attempts, front and refined ATE (align=False),
    the median closure error; ms per map_step, _closure_solve and
    refine_robust in the first run (CUDA events); K1 launches per scan and
    K2 per closure attempt.  Gates: a closure accepted, each with gap >= 24
    and ratio >= 0.5; median closure error < 0.03; refined ATE <= front ATE
    + 1e-3; K1 and K2 bit-equal to their plain versions on the first and
    last call of each recorded by the stream (K1's first target holds the
    map's empty rows, all on its sentinel: exact ties); a half lap accepts
    no closure.  Then refine_robust's first call in a fresh process
    (functorch's first use) against its second.
21. dicp_tpu_torch.parallel in a world of one rank on NCCL (make_mesh((1, 1))
    on the card; the backend must be nccl; the group is destroyed at the
    end): register_map_sharded at phase 8's pair (converged, errors < 1e-3,
    T within 1e-4 of register's, K2 once per iteration and once in the
    final cost pass, bit-equal to its plain version on the first and last
    call, iterations + 1 all-reduces of <= 87 elements; sharded_fused=False
    gives the same iterations and T within 1e-4), timed beside register;
    register_map_sharded_ift's gradient of sum(T * probe) into the source
    (finite, nonzero, cosine > 0.99 with the unrolled gradient; fwd+bwd
    ms; the collectives the backward adds); register_ring_sharded at phase
    4's first pair (within 1e-5 of the dense map-sharded T, no kernel);
    register_batch_sharded at phase 9's batch (T bit-equal to register's,
    K2 launched, no collective); pose_graph_optimize_partitioned on phase
    20's front-end graph (within 1e-4 of pose_graph_optimize) and
    refine_robust(mesh=...) against the dense refine (positions within
    1e-2, ATE within 5%), both timed.
22. the headline bench entry, the suite and the examples:
    dicp_tpu_torch.bench.main() in this process (its gates, its JSON line);
    every row of dicp_tpu_torch.benchmarks.bench_suite.ALL at the JAX
    suite's sizes that no earlier phase measures (batch256 printed from
    phase 12's times, scan_to_map's step rows only, solvers' exp_sgd and AA
    rows), each printing its JSON line and raising on its gate; the four
    examples' main() with their checks; the kernels' launches per row and
    example; K1, K2 and K3 held to their plain versions bit for bit on the
    first two calls of each recorded from the large_cloud row, K4 with phase
    11's gates on the first two recorded from the capacity row; then
    utils.profiling.benchmark and trace (the trace must name K4's kernel)
    and visualization.plot_overlay of card tensors (where matplotlib is
    installed).  Each row's and example's seconds are printed.
16. (run after 17-22) a torch.profiler pass over 3 calls each of phases
    4, 8, 9 and 12's calls, one W = 1 warm stream of phase 17's first 9
    scans, one gn scan-to-map stream of phase 18's first 4 scans, one
    SLAM stream of phase 20's first 6 scans and 3 of phase 21's map-sharded
    calls (in a world of one of its own, NCCL's share of device time too):
    host wall time, device busy share, K1's or K2's share of device time,
    device ops per pair, scan or iteration. It comes last: host-bound
    timings taken after the profiler has been on in a process run slower.

Phases 2, 6, 7, 11 and 13 time K1, K2, K5, K3, K4, K6 and K7 call by call
through their wrappers, as runs before them did (the kernels line's ``ms``), and print
beside it the time back to back (20 launches between two CUDA events, median
of 7 rounds: the kernel's time, free of the host's launch overhead).

Each main path (phases 4, 8, 9, 12, 14, each run of 17 and 18, the pyramid of 19,
the first SLAM run of 20, phase 21's map-sharded and batch-sharded solves and
each row and example of 22) is driven with
the kernels' launch counts set to 0 just before it and read just after.  The
line before the last is a JSON object describing each kernel of the paths,
with its bound: the larger of its operations at the H100's f32 rate and its
bytes (each input read once, each output written once) at its memory rate,
for this run's inputs; K1's entry also holds its launches per SLAM scan
(phase 20), K2's its launches per streamed pair and per batched odometry
call (phase 17), per scan of each scan-to-map stream (phase 18), per SLAM
closure attempt (phase 20), per pyramid call (phase 19) and per map-sharded
call (phase 21); K1-K4's entries hold their launches per suite row and
example (phase 22).  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.

    python3 chip_smoke.py --ab DIR

times instead, on one card in one process, K1, K2, K5, K3, K4, K6 and K7
built from ``DIR/dicp_tpu_torch/csrc`` (another checkout, e.g. an earlier
commit unpacked with ``git archive``, whose launchers have this checkout's C
signatures: checked in the sources) against this checkout's, in turns
(DIR's, this, this, DIR's), at the main path's shapes (K3 at 100k -> 100k
and 8 x 50k -> 60k with k = 16; K4 at the headline and at 256 x 256 -> 512;
K6 and K7 at 100k x 100k for 256 x 2048 and 512 x 4096, beside this
checkout's score_nn.cu built at the other slice count), after holding each
to the plain versions, call by call and back to back; then phases 4, 8, 9
and 12 end to end and K4 through its wrapper, each checkout's own, one
process each, in the same turns.  The last line holds every time as JSON.

    python3 chip_smoke.py --ab DIR --only score

times K6 and K7 alone that way: neither lies on a path.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from dicp_tpu_torch import ICP, ICPConfig, bench, io, knn, pt2pt_svd_icp, register, register_ift
from dicp_tpu_torch import se3, slam, svd_icp
from dicp_tpu_torch.benchmarks import bench_suite, exp_gicp, exp_knn, exp_multiscale
from dicp_tpu_torch.examples import large_cloud_demo, odometry_demo, serving_demo, slam_demo
from dicp_tpu_torch.convert import to_torch
from dicp_tpu_torch.gicp import register_gicp
from dicp_tpu_torch.losses import VALID_LOSSES
from dicp_tpu_torch.mapping import empty_map, map_merge, map_step
from dicp_tpu_torch.odometry import (ate, odometry, odometry_pose_graph, pose_graph_optimize,
                                     resumable_odometry)
from dicp_tpu_torch.ops import _build, cluster_search, fused_gn, tiled_knn
from dicp_tpu_torch.ops import cluster_knn as ck
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.ops.voxel import voxel_downsample
from dicp_tpu_torch.parallel import (_comm, make_mesh, pose_graph_optimize_partitioned,
                                     register_batch_sharded, register_map_sharded,
                                     register_map_sharded_ift, register_ring_sharded)
from dicp_tpu_torch.pipeline import stream_odometry
from dicp_tpu_torch.registration import _preprocess
from dicp_tpu_torch import visualization
from dicp_tpu_torch.utils import profiling
from dicp_tpu_torch.utils.timing import cuda_median_ms

ROOT = Path(__file__).resolve().parent
SEED = 0
B, N_SRC, M_TGT = 8, 12288, 16000  # phase 4: the slice at real size
TOL_POSE = 1e-3                    # rad and m, phases 3, 4, 8 and 9
KERNELS = ("tiled_nn", "cluster_search", "cluster_topk", "fused_gn", "score_nn")
M_MAP = 100_000                    # phases 6-8: one raw scan against its map
B_RAW, N_RAW, M_RAW = 8, 50_000, 60_000  # phases 6 and 9: batched raw scans
PROBES, GROUP = 32, 128            # the cluster tier's defaults
TOL_NORMAL_DEG = 2.0               # phase 8: median weighted-normal angle
B_HEAD = 256                       # phases 11 and 12: bench.py's batch
N_GATE, M_GATE = 256, 512          # phase 11: the fused gate's largest pair
N_SCORE = 100_000                  # phases 13 and 14: the A/B's timing size
# (tq, tm) of the A/B's rows (benchmarks/exp_knn.py:277-285)
SCORE_TILES = ((256, 2048), (512, 4096), (256, 4096), (512, 2048))
SCORE_OPS = 7.0                    # per (query, column): 3 mul, 3 add, 1 compare
TOL_GUMBEL = 0.5                   # phase 15: tests/test_icp.py:189's bound
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12  # H100 SXM: f32 non-tensor-core, HBM3 per s
# instructions per s the CUDA cores can issue: 132 SMs x 128 lanes x 1.98 GHz;
# built --fmad=false each f32 operation is one instruction
ISSUE_RATE = 132 * 128 * 1.98e9
# the headline configuration (bench.py): pt2pl, dim 2, trim 5, huber 1
HEAD = dict(icp_type="pt2pl", differentiable=True, max_iterations=100, tolerance=1e-6,
            dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations at
    the f32 rate and the bytes at the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def _report(lib: Path) -> str:
    log = Path(str(lib) + ".log")
    return log.read_text().strip() if log.exists() else "(built earlier)"


def phase1_build() -> dict:
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    tiled_knn._kernel()  # load and bind
    seconds = time.perf_counter() - t0
    print(f"phase 1 ok: built {', '.join(lib.name for lib in libs.values())} "
          f"in {seconds:.2f} s\n{_report(libs['tiled_nn'])}")
    return libs


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


def _issue_ms(ops: float) -> float:
    """The no-FMA issue ceiling: one instruction per f32 operation."""
    return ops / ISSUE_RATE * 1e3


def _rescan_share(x: torch.Tensor, y: torch.Tensor, chunk: int = 32) -> float:
    """For K1's schedule (a warp's 32 lanes x LANE_Q query slots over one
    target slice), the share of (warp, slot, chunk) triples in which some lane
    finds a chunk minimum strictly below its running best: how often a chunked
    fminf argmin would have to re-scan a chunk."""
    B, n, m = x.shape[0], x.shape[1], y.shape[1]
    lanes, slots = 32, tiled_knn.LANE_Q
    width = tiled_knn.slice_width(m)
    hits = total = 0
    for b in range(B):
        for lo in range(0, m, width):
            d2 = _pairwise_d2(x[b], y[b, lo:lo + width])
            pad = -d2.shape[1] % chunk
            d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
            mins = d2.reshape(n, -1, chunk).amin(-1)
            before = torch.cat([torch.full_like(mins[:, :1], float("inf")),
                                torch.cummin(mins, dim=1).values[:, :-1]], dim=1)
            better = mins < before
            qpad = -n % (lanes * slots)
            better = torch.nn.functional.pad(better, (0, 0, 0, qpad))
            per_warp = better.reshape(-1, slots, lanes, better.shape[1]).any(dim=2)
            hits += int(per_warp.sum())
            total += per_warp.numel()
    return hits / total


def _pairwise_d2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x[:, None, 0] - y[None, :, 0]
    d2 = diff * diff
    for c in (1, 2):
        diff = x[:, None, c] - y[None, :, c]
        d2 = d2 + diff * diff
    return d2


def phase2_kernel(device, sources: np.ndarray, targets: np.ndarray) -> dict:
    """K1 and its plain version on the same card tensors: exact agreement."""
    rng = np.random.default_rng(SEED + 2)
    near = rng.normal(size=(1, 4000, 3)).astype(np.float32)
    # K1 cuts m = 1000 targets into slices of 252: a duplicated nearest target
    # at 251 | 252 must resolve to 251
    dup = rng.normal(size=(1, 1000, 3))
    dup[0, 252] = dup[0, 251]
    cases = {
        "main path (8, 12288, 16000)": (sources, targets[..., :3]),
        "n=1, m=1": (rng.normal(size=(1, 1, 3)), rng.normal(size=(1, 1, 3))),
        "ragged n, m": (rng.normal(size=(3, 1000, 3)) * 5, rng.normal(size=(3, 3001, 3)) * 5),
        "all equidistant": (np.zeros((1, 7, 3)), np.ones((1, 2500, 3))),
        "far query": (np.full((1, 1, 3), 1e4), near),
        "duplicate across the slice boundary": (dup[:, [251, 251]] + [[[1e-3] * 3, [-1e-3] * 3]],
                                                dup),
        "m not a multiple of the slice or stage": (rng.normal(size=(2, 300, 3)),
                                                   rng.normal(size=(2, 1001, 3))),
        "m = 3, fewer targets than slices": (rng.normal(size=(1, 200, 3)),
                                             rng.normal(size=(1, 3, 3))),
    }
    cases = {name: (to_torch(x, device, torch.float32), to_torch(y, device, torch.float32))
             for name, (x, y) in cases.items()}
    # the ragged case's targets 4 bytes past a 16-byte boundary: 4-byte copies
    x, y = cases["ragged n, m"]
    buf = torch.empty(y.numel() + 1, dtype=torch.float32, device=device)
    buf[1:] = y.reshape(-1)
    cases["targets not 16-byte aligned"] = (x, buf[1:].view(y.shape))
    _check(buf[1:].data_ptr() % 16 != 0, "the moved targets are not 16-byte aligned")
    main_err = None
    for name, (x, y) in cases.items():
        idx_k, d2_k = tiled_knn.nn_distances(x, y)
        idx_p, d2_p = tiled_knn.nn_distances_plain(x, y)
        torch.cuda.synchronize()
        _check(torch.equal(idx_k, idx_p), f"K1 indices equal the plain version's ({name})")
        _check(torch.equal(d2_k, d2_p), f"K1 d2 bit-equal to the plain version's ({name})")
        err = float((d2_k - d2_p).abs().max())
        if name == "all equidistant":
            _check(bool((idx_k == 0).all()), "ties resolve to index 0")
        if name.startswith("duplicate"):
            _check(idx_k[0].tolist() == [251, 251], "the duplicate resolves to the lower index")
        if name.startswith("main"):
            main_err = err
        print(f"  K1 == plain: {name}: {tuple(x.shape)} x {tuple(y.shape)}, "
              f"max |d2 diff| {err}")

    x = to_torch(sources, device, torch.float32)
    y = to_torch(targets[..., :3], device, torch.float32)
    ms = cuda_median_ms(lambda: tiled_knn.nn_distances(x, y), warmup=3, iters=20)
    chain_ms = _chain_ms(lambda: tiled_knn.nn_distances(x, y))
    plain_ms = cuda_median_ms(lambda: tiled_knn.nn_distances_plain(x, y), warmup=1, iters=5)
    pairs = x.shape[0] * x.shape[1] * y.shape[1]
    # 9 flops per (query, target) pair; read both clouds, write idx and d2
    bound = _bound(9.0 * pairs, 4.0 * (x.numel() + y.numel()) + 8.0 * x.shape[0] * x.shape[1])
    share = _rescan_share(x, y)
    print(f"phase 2 ok: K1 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back), "
          f"plain {plain_ms:.4f} ms at "
          f"{tuple(x.shape)} x {tuple(y.shape)} ({pairs / chain_ms / 1e6:.1f} Gpair/s back "
          f"to back); bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), issue ceiling "
          f"{_issue_ms(9.0 * pairs):.4f} ms; a chunked argmin would re-scan "
          f"{share:.4f} of (warp, slot, 32-target chunk) triples")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


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


def _reset_launches() -> None:
    tiled_knn.launches = 0
    fused_gn.launches = 0
    cluster_search.fused_search.launches = 0
    cluster_search.block_search.launches = 0
    cluster_search.fused_topk.launches = 0
    exp_knn.nn_v1.launches = 0
    exp_knn.nn_v2.launches = 0


def _launches() -> dict:
    return {"tiled_nn": tiled_knn.launches,
            "cluster_search": cluster_search.fused_search.launches,
            "cluster_block_search": cluster_search.block_search.launches,
            "cluster_topk": cluster_search.fused_topk.launches}


def phase4_slice(device, sources: np.ndarray, targets: np.ndarray, T_true: np.ndarray):
    """The main path at real size; returns (K1 launches in one solve, the solve)."""
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

    _reset_launches()
    res = solve()
    torch.cuda.synchronize()
    launches = _launches()["tiled_nn"]

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
    return launches, solve


def _ptxas(report: str) -> list:
    """(entry function, registers, spill bytes, stack bytes) for each kernel
    of a -Xptxas=-v report."""
    rows = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        stack = re.search(r"(\d+) bytes stack frame", block)
        _check(regs is not None and spill is not None, f"a ptxas report for {name}")
        rows.append((name, int(regs.group(1)), int(spill.group(1)) + int(spill.group(2)),
                     int(stack.group(1)) if stack else 0))
    return rows


def _no_spills(report: str, what: str) -> list:
    rows = _ptxas(report)
    _check(bool(rows), f"{what}: ptxas reported its kernels")
    for name, regs, spill, _ in rows:
        _check(spill == 0, f"{what}: no register spills in {name} ({spill} bytes)")
    return rows


def phase5_cluster_build(libs: dict) -> None:
    cluster_search._search_kernel()  # load and bind
    cluster_search._topk_kernel()
    for name in ("cluster_search", "cluster_topk"):
        print(f"  {libs[name].name}:\n{_report(libs[name])}")
    _no_spills(_report(libs["cluster_search"]), "cluster_search")
    regs = {}
    for name, r, spill, _ in _ptxas(_report(libs["cluster_topk"])):
        regs[int(re.search(r"cluster_topk_kernelILi(\d+)E", name).group(1))] = (r, spill)
    for k in (1, 2, 4, 8, 16, 32):
        plan = cluster_search.topk_plan(ck.FUSED_QBLOCK, k)
        r, spill = regs[plan["K"]]
        print(f"  K3 at Qs = {ck.FUSED_QBLOCK}, k = {k}: list K = {plan['K']}, one query per "
              f"thread, {plan['threads']} threads, {r} registers, {spill} bytes spilled")
    print("phase 5 ok: cluster kernels built and bound, no register spills in K2/K5")


def raw_scan_pair(rng: np.random.Generator, m: int):
    """The single-pair path's inputs: a map (m, 6) with exact normals, the
    map's points permuted and moved by the inverse of a known transform
    (m, 3), and that transform (4, 4) (source to target, <= 5 deg, <= 0.3 m)."""
    mp = lidar_scene(rng, m)
    T_true = random_transforms(rng, 1, max_angle_deg=5.0, max_shift=0.3)[0]
    R, t = T_true[:3, :3], T_true[:3, 3]
    scan = (mp[rng.permutation(m), :3] - t) @ R
    return mp.astype(np.float32), scan.astype(np.float32), T_true


def _search_inputs(y: torch.Tensor, x: torch.Tensor, probes: int = PROBES,
                   group: int = GROUP):
    """What the cluster tier hands K2, K5 and K3 for queries x against
    targets y (both ([B,] n, 3)): the index and the query blocks with their
    selected groups, built on x's device as cluster_nn builds them."""
    index = ck.build_cluster_index(y, group)
    ix, xq, _ = ck._with_batch(index, x)
    xb, _, _ = ck._sorted_blocks(ix, xq, qblock=ck.FUSED_QBLOCK)
    bsel, _ = ck._block_select(ix, xb, probes)
    return ix, xb, bsel


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, counting equal entries (inf == inf included) as 0."""
    d = torch.where(a == b, torch.zeros_like(a), (a.double() - b.double()).abs().to(a.dtype))
    return float(d.max()) if d.numel() else 0.0


def _edge_cases(device, rng: np.random.Generator) -> dict:
    """name -> (targets (m, 3), queries (n, 3), probes, group)."""
    near = rng.uniform(-1, 1, (3000, 3))
    base = rng.uniform(-10, 10, (1500, 3))
    cases = {
        "P = G": (rng.uniform(-1, 1, (300, 3)), rng.uniform(-1, 1, (200, 3)), 8, 64),
        "m not a multiple of g": (rng.uniform(-5, 5, (777, 3)), rng.uniform(-5, 5, (300, 3)),
                                  3, 128),
        "one query": (near, rng.uniform(-1, 1, (1, 3)), 4, 128),
        "duplicate targets": (np.concatenate([base, base]),
                              base + rng.normal(scale=1e-3, size=base.shape), 4, 64),
        "all targets equidistant": (np.ones((2500, 3)), np.zeros((130, 3)), 4, 128),
        "far query": (near, np.full((1, 3), 1e4), 4, 128),
        "g = 7, not a multiple of 4 (4-byte copies)": (rng.uniform(-5, 5, (900, 3)),
                                                       rng.uniform(-5, 5, (300, 3)), 5, 7),
        "g = 2000: three staging passes": (rng.uniform(-5, 5, (14000, 3)),
                                           rng.uniform(-5, 5, (200, 3)), 5, 2000),
    }
    return {name: (to_torch(y, device, torch.float32), to_torch(x, device, torch.float32), p, g)
            for name, (y, x, p, g) in cases.items()}


def _raw_cases(device, rng: np.random.Generator, aligned_ix) -> dict:
    """name -> (index-like (points, centers, radius), xb, bsel) given directly."""
    # P = 8 groups of 64: 512 columns in K2's 8 slices of 64; one point at
    # columns 63 | 64 (the end of slice 0, the start of slice 1), queries on it
    G, g, P = 20, 64, 8
    pts = rng.uniform(-5, 5, (G, g, 3))
    sel = rng.permutation(G)[:P]
    pts[sel[1], 0] = pts[sel[0], 63]
    xb = rng.uniform(-5, 5, (1, 128, 3))
    xb[0, :4] = pts[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    centers = pts.mean(axis=1)
    radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
    f32 = lambda a: to_torch(a, device, torch.float32)  # noqa: E731
    dup = SimpleNamespace(points=f32(pts), centers=f32(centers), radius=f32(radius))
    bsel = torch.as_tensor(sel[None].astype(np.int32), device=device)
    # the same index with its points 4 bytes past a 16-byte boundary
    ix, xq, sq = aligned_ix
    buf = torch.empty(ix.points.numel() + 1, dtype=torch.float32, device=device)
    buf[1:] = ix.points.reshape(-1)
    moved = SimpleNamespace(points=buf[1:].view(ix.points.shape), centers=ix.centers,
                            radius=ix.radius)
    _check(moved.points.data_ptr() % 16 != 0, "the moved points are not 16-byte aligned")
    # compact groups with a NaN point in group 3, so its center and radius are
    # NaN (as the cluster index computes them), left out by block 1's
    # selection; and a NaN query in block 1
    nan_pts = rng.uniform(-0.5, 0.5, (G, g, 3)) + rng.uniform(-5, 5, (G, 1, 3))
    nan_pts[3, 5] = np.nan
    nan_xb = rng.uniform(-5, 5, (3, 128, 3))
    nan_xb[0, :8] = nan_pts[3, 6] + 1e-3
    nan_xb[1, 7] = np.nan
    nan_c = nan_pts.mean(axis=1)
    nan_r = np.linalg.norm(nan_pts - nan_c[:, None], axis=-1).max(axis=1)
    nan = SimpleNamespace(points=f32(nan_pts), centers=f32(nan_c), radius=f32(nan_r))
    nan_sel = torch.tensor([[3, 1, 2, 0], [4, 5, 6, 7], [8, 3, 9, 10]], dtype=torch.int32,
                           device=device)
    return {"duplicate across the column-slice boundary": (dup, f32(xb), bsel),
            "points not 16-byte aligned (4-byte copies)": (moved, xq, sq),
            NAN_CASE: (nan, f32(nan_xb), nan_sel)}


NAN_CASE = "a NaN target point and a NaN query"


def _nan_expected(args):
    """What K2 and K5 must give on NAN_CASE, where the plain bound is NaN for
    every query: the plain versions with each NaN point at inf (a NaN
    candidate loses like an inf one) and each NaN group given radius inf (a
    bound term of 0 unless the block selected it); a NaN query finds nothing
    (best inf, column 0's row for K2, row 0 for K5) and gets the bound 0."""
    points, centers, radius, xb, bsel = args
    finite = torch.where(torch.isnan(points), torch.inf, points)
    bad = torch.isnan(centers).any(-1) | torch.isnan(radius)
    best, row, bound = cluster_search.fused_search_plain(
        finite, torch.where(bad[:, None], 0.0, centers), torch.where(bad, torch.inf, radius),
        xb, bsel)
    best5, row5 = cluster_search.block_search_plain(finite, xb, bsel)
    lost = torch.isnan(xb).any(-1)
    first = (bsel[..., :1] * points.shape[-2]).expand_as(row)
    return ((torch.where(lost, torch.inf, best), torch.where(lost, first, row),
             torch.where(lost, 0.0, bound)),
            (torch.where(lost, torch.inf, best5), torch.where(lost, 0, row5)))


TRAP_SNIPPET = """
import sys, torch
from dicp_tpu_torch.ops import cluster_search
dev = torch.device("cuda", 0)
points = torch.zeros(10, 8, 3, device=dev)
centers, radius = torch.zeros(10, 3, device=dev), torch.zeros(10, device=dev)
xb = torch.zeros(2, 128, 3, device=dev)
bsel = torch.tensor([[0, 1], [2, 10]], dtype=torch.int32, device=dev)  # 10 is not in [0, 10)
if sys.argv[1] == "K2":
    cluster_search.fused_search(points, centers, radius, xb, bsel)
else:
    cluster_search.fused_topk(points, centers, radius, xb, bsel, 4)
print("launched", flush=True)
torch.cuda.synchronize()
print("no error", flush=True)
"""


def _trap_check(kernel: str) -> str:
    """K2 or K3 with a group id outside [0, G), in a process of its own: the
    launch is taken without a host check, and the kernel's __trap surfaces at
    the synchronisation as a CUDA error."""
    run = subprocess.run([sys.executable, "-c", TRAP_SNIPPET, kernel], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    errors = [line for line in run.stderr.splitlines() if "CUDA error" in line]
    _check(run.returncode != 0 and "launched" in run.stdout and "no error" not in run.stdout
           and bool(errors), f"{kernel}: an out-of-range group id fails with a CUDA error "
           f"(rc {run.returncode}, stdout {run.stdout!r}, stderr tail {run.stderr[-400:]!r})")
    return errors[-1]


def phase6_search_kernels(device, mp: np.ndarray, scan: np.ndarray,
                          raw_targets: np.ndarray, raw_sources: np.ndarray) -> dict:
    """K2 and K5 against their plain versions on the same card tensors."""
    shapes = {
        f"single pair {len(scan)} -> {len(mp)}": (to_torch(mp[:, :3], device),
                                                  to_torch(scan, device), PROBES, GROUP),
        f"batched {raw_sources.shape[0]} x {raw_sources.shape[1]} -> {raw_targets.shape[1]}": (
            to_torch(raw_targets[..., :3], device), to_torch(raw_sources, device), PROBES, GROUP),
    }
    rng = np.random.default_rng(SEED + 6)
    shapes.update(_edge_cases(device, rng))
    inputs = {name: _search_inputs(y, x, probes, group)
              for name, (y, x, probes, group) in shapes.items()}
    inputs.update(_raw_cases(device, rng, inputs["m not a multiple of g"]))
    err = {"cluster_search": 0.0, "cluster_block_search": 0.0}
    for name, (ix, xb, bsel) in inputs.items():
        args = (ix.points, ix.centers, ix.radius, xb, bsel)
        group = ix.points.shape[-2]
        k2 = cluster_search.fused_search(*args)
        k5 = cluster_search.block_search(ix.points, xb, bsel)
        if name == NAN_CASE:
            p2, p5 = _nan_expected(args)
        else:
            p2 = cluster_search.fused_search_plain(*args)
            p5 = cluster_search.block_search_plain(ix.points, xb, bsel)
        torch.cuda.synchronize()
        for what, a, b in zip(("best", "row", "bound"), k2, p2):
            _check(torch.equal(a, b), f"K2 {what} bit-equal to the plain version's ({name})")
        for what, a, b in zip(("best", "row"), k5, p5):
            _check(torch.equal(a, b), f"K5 {what} bit-equal to the plain version's ({name})")
        found = k2[0] < torch.inf  # else K2's row is column 0's, K5's row 0
        _check(torch.equal(k5[0], k2[0]) and torch.equal(k5[1][found], k2[1][found]),
               f"K5's argmin equals K2's ({name})")
        if name == "P = G":
            _check(bool(torch.isinf(k2[2]).all()), "every group selected: bound inf")
        if name == "all targets equidistant":
            _check(bool((k2[1] == bsel[..., :1] * group).all()),
                   "ties resolve to the first candidate column")
        if name.startswith("duplicate across"):
            _check(bool((k2[1][0, :4] == bsel[0, 0] * group + 63).all()),
                   "the duplicate resolves to the lower column")
        if name == NAN_CASE:
            past = (bsel != 3).all(-1)[:, None] | torch.isnan(xb).any(-1)
            _check(bool((k2[2][past] == 0).all()) and not bool((k2[0] <= k2[2])[past].any())
                   and bool((k2[2][~past] > 0).any()),
                   "no query is certified past the NaN group or for the NaN query")
        e2 = max(_max_abs_diff(k2[0], p2[0]), _max_abs_diff(k2[2], p2[2]))
        e5 = _max_abs_diff(k5[0], p5[0])
        err["cluster_search"] = max(err["cluster_search"], e2)
        err["cluster_block_search"] = max(err["cluster_block_search"], e5)
        print(f"  K2, K5 == plain: {name}: xb {tuple(xb.shape)}, bsel {tuple(bsel.shape)}, "
              f"G {ix.points.shape[-3]}, g {group}, max |diff| {e2}, {e5}")
    print(f"  out-of-range group id, in a subprocess: {_trap_check('K2')}")

    times = []
    for label in list(shapes)[:2]:  # the two raw-scan shapes
        ix, xb, bsel = inputs[label]
        args = (ix.points, ix.centers, ix.radius, xb, bsel)
        t = {
            "cluster_search": cuda_median_ms(lambda: cluster_search.fused_search(*args),
                                             warmup=3, iters=20),
            "cluster_search chain": _chain_ms(lambda: cluster_search.fused_search(*args)),
            "cluster_search plain": cuda_median_ms(
                lambda: cluster_search.fused_search_plain(*args), warmup=1, iters=5),
            "cluster_block_search": cuda_median_ms(
                lambda: cluster_search.block_search(ix.points, xb, bsel), warmup=3, iters=20),
            "cluster_block_search chain": _chain_ms(
                lambda: cluster_search.block_search(ix.points, xb, bsel)),
            "cluster_block_search plain": cuda_median_ms(
                lambda: cluster_search.block_search_plain(ix.points, xb, bsel),
                warmup=1, iters=5),
        }
        pairs = xb.shape[:-1].numel() * bsel.shape[-1] * ix.points.shape[-2]
        work2, work5 = _search_work(ix, xb, bsel, 1, True), _search_work(ix, xb, bsel, 1, False)
        k2_bound = _bound(*work2)
        print(f"  {label}: K2 {t['cluster_search']:.4f} ms call by call "
              f"({t['cluster_search chain']:.4f} ms back to back; plain "
              f"{t['cluster_search plain']:.4f}), K5 {t['cluster_block_search']:.4f} ms "
              f"({t['cluster_block_search chain']:.4f} back to back; plain "
              f"{t['cluster_block_search plain']:.4f}); {pairs:.3e} (query, candidate) pairs, "
              f"K2 {pairs / t['cluster_search chain'] / 1e6:.1f} Gpair/s back to back; "
              f"K2 bound {k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']}), issue "
              f"ceiling {_issue_ms(work2[0]):.4f} ms; K5 bound "
              f"{_bound(*work5)['bound_ms']:.4f} ms, issue ceiling {_issue_ms(work5[0]):.4f} ms")
        times.append(t)
    single = times[0]
    ix, xb, bsel = inputs[list(shapes)[0]]
    bounds = {"cluster_search": _bound(*_search_work(ix, xb, bsel, 1, True)),
              "cluster_block_search": _bound(*_search_work(ix, xb, bsel, 1, False))}
    print(f"phase 6 ok: K2 and K5 bit-equal to their plain versions in every case; bounds "
          f"at the single pair {bounds}")
    return {name: {"max_abs_err": err[name], "ms": single[name],
                   "plain_ms": single[f"{name} plain"], **bounds[name], "library_ms": None}
            for name in ("cluster_search", "cluster_block_search")}


def _search_work(ix, xb, bsel, k: int, with_bound: bool):
    """(flops, bytes) a cluster search needs: 9 flops per (query, candidate)
    pair; with the bound, 13 per (query, non-selected group) (difference,
    norm, sqrt, the 1 - 8 eps scale, radius, clamp, square).  Bytes: the
    grouped points, the queries and the selection read once (centers and
    radii too with the bound); k (d2, row) pairs per query written, plus the
    bound."""
    G, g = ix.points.shape[-3], ix.points.shape[-2]
    queries = xb.shape[:-1].numel()
    P = bsel.shape[-1]
    flops = 9.0 * queries * P * g
    nbytes = 4.0 * (ix.points.numel() + xb.numel() + bsel.numel()) + 8.0 * queries * k
    if with_bound:
        flops += 13.0 * queries * (G - P)
        nbytes += 4.0 * (ix.centers.numel() + ix.radius.numel()) + 4.0 * queries
    return flops, nbytes


def _topk_nan_expected(args, k: int):
    """What K3 must give on NAN_CASE, as _nan_expected for K2: the plain
    version with each NaN point at inf and each NaN group at radius inf; a
    NaN query lists nothing (d2 inf, column 0's row) and gets the bound 0."""
    points, centers, radius, xb, bsel = args
    finite = torch.where(torch.isnan(points), torch.inf, points)
    bad = torch.isnan(centers).any(-1) | torch.isnan(radius)
    d2, rows, bound = cluster_search.fused_topk_plain(
        finite, torch.where(bad[:, None], 0.0, centers), torch.where(bad, torch.inf, radius),
        xb, bsel, k)
    lost = torch.isnan(xb).any(-1)
    first = (bsel[..., :1] * points.shape[-2])[..., None].expand_as(rows)
    return (torch.where(lost[..., None], torch.inf, d2), torch.where(lost[..., None], first, rows),
            torch.where(lost, 0.0, bound))


def _topk_cases(device, rng: np.random.Generator, main) -> list:
    """(name, (points, centers, radius, xb, bsel), k) for phase 7."""
    f32 = lambda a: to_torch(a, device, torch.float32)  # noqa: E731

    def index_of(pts):
        centers = pts.mean(axis=1)
        radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
        return f32(pts), f32(centers), f32(radius)

    ix, xb, bsel = main
    cases = [(f"{M_MAP} -> {M_MAP}, k = {k}", (ix.points, ix.centers, ix.radius, xb, bsel), k)
             for k in (16, 1, 2, 5, 32)]
    # P = 8 groups of 64: points duplicated at columns 63 | 64 and 127 | 128
    G, g, P = 20, 64, 8
    pts = rng.uniform(-5, 5, (G, g, 3))
    sel = rng.permutation(G)[:P]
    pts[sel[1], 0] = pts[sel[0], 63]
    pts[sel[2], 0] = pts[sel[1], 63]
    q = rng.uniform(-5, 5, (1, 128, 3))
    q[0, :4] = pts[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    q[0, 4:8] = pts[sel[1], 63] + rng.normal(scale=1e-4, size=(4, 3))
    dup = index_of(pts) + (f32(q), torch.as_tensor(sel[None].astype(np.int32), device=device))
    cases += [(f"duplicates across group boundaries, k = {k}", dup, k) for k in (5, 16)]
    # 3 selected groups of 32 with 3 finite points each: 9 finite candidates
    pts = rng.uniform(-5, 5, (6, 32, 3))
    pts[:, 3:] = 1e20
    few = index_of(pts) + (f32(rng.uniform(-5, 5, (2, 128, 3))),
                           torch.as_tensor(np.stack([rng.permutation(6)[:3] for _ in range(2)])
                                           .astype(np.int32), device=device))
    cases += [(f"k = {k} beyond the 9 finite candidates (column-0 fill)", few, k)
              for k in (16, 32)]
    searched = {}
    for name, (y, x, probes, group), k in (
            ("g = 7",
             (rng.uniform(-5, 5, (900, 3)), rng.uniform(-5, 5, (300, 3)), 5, 7), 16),
            ("g = 2000: four staging tiles per group",
             (rng.uniform(-5, 5, (14000, 3)), rng.uniform(-5, 5, (200, 3)), 5, 2000), 32),
            ("m not a multiple of g",
             (rng.uniform(-5, 5, (777, 3)), rng.uniform(-5, 5, (300, 3)), 3, 128), 8)):
        i, qb, sb = searched[name] = _search_inputs(f32(y), f32(x), probes, group)
        cases.append((name, (i.points, i.centers, i.radius, qb, sb), k))
    raw = _raw_cases(device, rng, searched["m not a multiple of g"])
    for name in ("points not 16-byte aligned (4-byte copies)", NAN_CASE):
        i, qb, sb = raw[name]
        cases.append((name, (i.points, i.centers, i.radius, qb, sb), 16))
    return cases


def phase7_topk_kernel(device, mp: np.ndarray, scan: np.ndarray) -> dict:
    """K3 against its plain version on the same card tensors, bit for bit."""
    y, x = to_torch(mp[:, :3], device), to_torch(scan, device)
    ix, xb, bsel = _search_inputs(y, x)
    rng = np.random.default_rng(SEED + 7)
    err = 0.0
    for name, args, k in _topk_cases(device, rng, (ix, xb, bsel)):
        kern = cluster_search.fused_topk(*args, k)
        plain = _topk_nan_expected(args, k) if name == NAN_CASE \
            else cluster_search.fused_topk_plain(*args, k)
        torch.cuda.synchronize()
        for what, a, b in zip(("d2", "rows", "bound"), kern, plain):
            _check(torch.equal(a, b), f"K3 {what} bit-equal to the plain version's ({name})")
        if name.startswith("duplicates"):
            _check(bool((kern[0][0, :8, 0] == kern[0][0, :8, 1]).all()),
                   "duplicate distances are kept for later ranks")
        if "column-0 fill" in name:
            fill = ~torch.isfinite(kern[0])
            first = (args[4][..., :1] * args[0].shape[-2])[..., None].expand_as(kern[1])
            _check(bool(fill.any()) and torch.equal(kern[1][fill], first[fill]),
                   "past the finite candidates K3 fills with column 0's row")
        if name == NAN_CASE:
            past = (args[4] != 3).all(-1)[:, None] | torch.isnan(args[3]).any(-1)
            _check(bool((kern[2][past] == 0).all())
                   and not bool((kern[0][..., -1] <= kern[2])[past].any()),
                   "no query is certified past the NaN group or for the NaN query")
        e = max(_max_abs_diff(kern[0], plain[0]), _max_abs_diff(kern[2], plain[2]))
        err = max(err, e)
        print(f"  K3 == plain: {name}: xb {tuple(args[3].shape)}, P {args[4].shape[-1]}, "
              f"g {args[0].shape[-2]}, max |diff| {e}")
    print(f"  out-of-range group id, in a subprocess: {_trap_check('K3')}")
    args = (ix.points, ix.centers, ix.radius, xb, bsel, 16)
    ms = cuda_median_ms(lambda: cluster_search.fused_topk(*args), warmup=3, iters=20)
    chain_ms = _chain_ms(lambda: cluster_search.fused_topk(*args))
    plain_ms = cuda_median_ms(lambda: cluster_search.fused_topk_plain(*args), warmup=1, iters=3)
    work = _search_work(ix, xb, bsel, 16, True)
    bound = _bound(*work)
    print(f"phase 7 ok: K3 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back), plain "
          f"{plain_ms:.4f} ms at {len(scan)} -> {len(mp)}, k = 16, P = {PROBES}; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), issue ceiling "
          f"{_issue_ms(work[0]):.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def _angles_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between unit vectors up to sign, in degrees."""
    cos = torch.clamp(torch.abs(torch.sum(a.double() * b.double(), dim=-1)), max=1.0)
    return torch.rad2deg(torch.arccos(cos))


def phase8_single_pair(device, mp: np.ndarray, scan: np.ndarray, T_true: np.ndarray) -> dict:
    """The single-pair raw-scan path: normals for the map, then pt2pl through
    the cluster index.  Returns the launch counts of the path, the solve and
    its (source, target with normals) on the card."""
    pts = to_torch(mp[:, :3], device)
    exact = to_torch(mp[:, 3:6], device)
    src = to_torch(scan, device)
    n, m = src.shape[0], pts.shape[0]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "cluster",
           f"({n}, {m}) resolves to the cluster tier")
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                 device=device, cluster_probes=PROBES, cluster_group=GROUP)
    ti = torch.eye(4, dtype=torch.float32, device=device)

    _reset_launches()
    normals = estimate_normals(pts, method="weighted")
    knn_normals = estimate_normals(pts, k=16, method="cluster")
    target = torch.cat([pts, normals], dim=-1)
    res = solver.icp(src, target, ti, trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=3)
    index = ck.build_cluster_index(pts, GROUP)
    idx_k5, d2_k5, cert_k5 = ck.cluster_nn(index, src, probes=PROBES, use_pallas=True)
    torch.cuda.synchronize()
    launches = _launches()

    angle = _angles_deg(normals, exact)
    knn_angle = _angles_deg(knn_normals, exact)
    med = float(torch.median(angle))
    print(f"  weighted normals: median angle {med:.4f} deg, mean {float(angle.mean()):.4f} "
          f"deg; cluster k-NN (k = 16) normals: median {float(torch.median(knn_angle)):.4f} deg")
    _check(normals.shape == (m, 3) and bool(torch.isfinite(normals).all()),
           "finite (m, 3) weighted normals")
    _check(med < TOL_NORMAL_DEG, f"median weighted-normal angle {med} < {TOL_NORMAL_DEG} deg")
    _check(launches["cluster_topk"] >= 1, "estimate_normals(method='cluster') launched K3")

    iters = int(res["stats"]["iterations"].max())
    _check(res["T"].shape == (1, 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "a finite (1, 4, 4) transform")
    _check(launches["cluster_search"] >= iters >= 1,
           f"K2 launched {launches['cluster_search']} times, at least once per iteration "
           f"({iters})")
    rot, trans = pose_errors(torch.as_tensor(T_true[None], device=device),
                             res["T"].to(torch.float64))
    print(f"  {n} -> {m} pt2pl: {iters} iterations, converged "
          f"{bool(res['stats']['converged'][0])}, rotation error {float(rot[0]):.3e} rad, "
          f"translation error {float(trans[0]):.3e} m")
    _check(float(rot.max()) < TOL_POSE, f"rotation error < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation error < {TOL_POSE} m")

    # the final correspondences as the solver computes them: queries ordered
    # once at T_init, then the certificate and the brute-force fix-up budget
    cfg = ICPConfig(cluster_probes=PROBES, cluster_group=GROUP)
    order = ck.query_order(index, src)
    T_est = res["T"][0]
    ps = src @ T_est[:3, :3].T + T_est[:3, 3]
    _, _, cert = ck.cluster_nn(index, ps, probes=PROBES, order=order)
    budget = cfg.resolved_cluster_fixup(n)
    unc = int((~cert).sum())
    print(f"  final correspondences: certified {float(cert.float().mean()):.6f} before the "
          f"fix-up; {unc} uncertified, {min(unc, budget)} brute-forced (budget {budget}), "
          f"{max(0, unc - budget)} left out")

    idx_k2, d2_k2, cert_k2 = ck.cluster_nn(index, src, probes=PROBES)
    _check(torch.equal(idx_k5, idx_k2) and torch.equal(d2_k5, d2_k2)
           and torch.equal(cert_k5, cert_k2), "cluster_nn(use_pallas=True) (K5) equals the K2 path")

    def solve():
        return solver.icp(src, target, ti, trim_dist=2.0,
                          loss_fn={"name": "huber", "metric": 1.0}, dim=3)

    ms = cuda_median_ms(solve, warmup=1, iters=5)
    normals_ms = cuda_median_ms(lambda: estimate_normals(pts, method="weighted"),
                                warmup=1, iters=5)
    print(f"phase 8 ok: {n} -> {m} pt2pl through the cluster tier, {ms:.3f} ms per icp call "
          f"(median of 5), weighted normals {normals_ms:.3f} ms; launches {launches}")
    return launches, solve, (src, target)


def phase9_batched(device, sources: np.ndarray, targets: np.ndarray, T_true: np.ndarray) -> dict:
    """Batched raw scans through the cluster tier; returns the launch counts
    and the solve."""
    n, m = sources.shape[1], targets.shape[1]
    _check(ICPConfig().resolved_nn_method(n, m, device) == "cluster",
           f"({n}, {m}) resolves to the cluster tier")
    src, tgt = to_torch(sources, device), to_torch(targets, device)
    ti = torch.eye(4, dtype=torch.float32, device=device).expand(len(sources), 4, 4)
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                 device=device, cluster_probes=PROBES, cluster_group=GROUP)

    def solve():
        return solver.icp(src, tgt, ti, trim_dist=2.0, loss_fn={"name": "huber", "metric": 1.0},
                          dim=3)

    _reset_launches()
    res = solve()
    torch.cuda.synchronize()
    launches = _launches()
    iters = res["stats"]["iterations"]
    _check(res["T"].shape == (len(sources), 4, 4) and bool(torch.isfinite(res["T"]).all()),
           "finite (B, 4, 4) transforms")
    _check(launches["cluster_search"] >= int(iters.max()) >= 1,
           f"K2 launched {launches['cluster_search']} times, at least once per iteration "
           f"({int(iters.max())})")
    rot, trans = pose_errors(torch.as_tensor(T_true, device=device), res["T"].to(torch.float64))
    print(f"  per pair: iterations {iters.tolist()}\n  rotation error (rad) {rot.tolist()}\n"
          f"  translation error (m) {trans.tolist()}")
    _check(float(rot.max()) < TOL_POSE, f"rotation errors < {TOL_POSE} rad")
    _check(float(trans.max()) < TOL_POSE, f"translation errors < {TOL_POSE} m")
    ms = cuda_median_ms(solve, warmup=1, iters=5)
    print(f"phase 9 ok: {len(sources)} x {n} -> {m} pt2pl through the cluster tier, "
          f"{ms:.3f} ms per icp call (median of 5); launches {launches}")
    return launches, solve


def phase10_fused_build(libs: dict) -> None:
    fused_gn._kernel()  # load and bind
    report = _report(libs["fused_gn"])
    print(f"  {libs['fused_gn'].name}:\n{report}")
    regs = {}
    for name, r, _, stack in _no_spills(report, "fused_gn"):
        found = re.search(r"fused_gn_kernelILi(\d)ELb([01])E", name)
        regs[(int(found.group(1)), found.group(2) == "1")] = (r, stack)
    for label, n, m, k in (("headline", 65, 65, 3), ("gate's largest", N_GATE, M_GATE, 6)):
        plan = fused_gn.launch_plan(n, m)
        r, stack = regs[(k, True)]
        print(f"  K4 at the {label} ({n} -> {m}, pt2pl, k = {k}): {plan['lanes']} lanes per "
              f"point, {plan['threads']} threads, {r} registers, {stack} bytes stack")
    print("phase 10 ok: K4 built and bound (four instances: pt2pl/pt2pt x dim 3/2), no "
          "register spills")


def reference_batch(device, batch: int = B_HEAD):
    """bench.py's inputs: the 65-point reference pair replicated to ``batch``
    (dicp_tpu_torch.bench.reference_batch)."""
    return bench.reference_batch(batch, device=device)


def random_pairs(rng: np.random.Generator, batch: int, n: int, m: int, dim: int,
                 normals: bool):
    """tests/test_fused_gn.py's scene: each target a permuted exact transform
    of its source plus far outliers (every query has a unique exact match)."""
    src = rng.uniform(-2.0, 2.0, (batch, n, 3))
    if dim == 2:
        src[..., 2] = 0.0
    tgts = []
    for b in range(batch):
        th = rng.uniform(-0.15, 0.15)
        C = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                      [0.0, 0.0, 1.0]])
        t = np.array([0.1 * rng.normal(), 0.1 * rng.normal(), 0.0])
        pts = np.concatenate([src[b][rng.permutation(n)], rng.uniform(50, 60, (m - n, 3))])
        tgts.append(pts @ C.T + t)
    tgt = np.stack(tgts)
    if normals:
        nrm = rng.normal(size=(batch, m, 3))
        if dim == 2:
            nrm[..., 2] = 0.0
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        tgt = np.concatenate([tgt, nrm], axis=-1)
    return src.astype(np.float32), tgt.astype(np.float32)


def _k4_args(cfg: ICPConfig, src, tgt, ti, weight=None):
    """What registration hands K4: the preprocessed solver tensors with
    per-point weights."""
    source, target, w, C, r = _preprocess(cfg, src, tgt, ti, weight)
    if cfg.icp_type == "pt2pt":
        w = w[:, ::3]
    return source[..., :3].contiguous(), target, w, C, r


def _k4_work(args, iters: torch.Tensor, tcols: int):
    """(flops, bytes) of the whole solves K4 ran: per executed iteration and
    source point, 8 flops per target (difference form) plus ~220 for the
    weights, the Jacobian row and its normal-equation products (the Pallas
    cost estimate's count); inputs read once, results written once."""
    source, target, w = args[:3]
    B, n, m = source.shape[0], source.shape[1], target.shape[1]
    flops = float(iters.double().sum()) * n * (8.0 * m + 220.0)
    nbytes = 4.0 * (B * n * 3 + B * m * tcols + B * n + B * 12) + 4.0 * (B * 16 + B * n)
    return flops, nbytes


def phase11_fused_kernel(device) -> dict:
    """K4 against its plain version on the same card tensors; timed; and the
    forward A/B of register(fused_small=True) against the loop."""
    rng = np.random.default_rng(SEED + 12)
    base = dict(differentiable=False, driver="while", collect_histories=False,
                max_iterations=40, tolerance=1e-5, nn_method="dense")
    main = _k4_main_inputs(device)
    (head_cfg, (src, tgt, ti)), (gate_cfg, gate) = main.values()
    cases = {"headline: reference pair B=256, pt2pl dim 2": (head_cfg, (src, tgt, ti, None)),
             "gate's largest: 256 x 256 -> 512 LiDAR-like, pt2pl dim 3": (gate_cfg,
                                                                          (*gate, None))}

    def edge(name, batch, n, m, dim, normals, weight=None, **kw):
        e_src, e_tgt = random_pairs(rng, batch, n, m, dim, normals)
        w = None if weight is None else to_torch(weight, device)
        cases[name] = (ICPConfig(**{**base, "dim": dim, "fused_small": True, **kw}),
                       (to_torch(e_src, device), to_torch(e_tgt, device),
                        torch.eye(4, device=device).expand(batch, 4, 4), w))

    edge("pt2pt dim 3 cauchy", 8, 40, 48, 3, False, icp_type="pt2pt", loss_name="cauchy",
         loss_metric=2.0)
    edge("prior weights with zeros, hard trim", 5, 40, 40, 2, False,
         weight=(rng.random((5, 40)) > 0.2).astype(np.float32), icp_type="pt2pt",
         trim_dist=3.0)
    edge("B=5 pt2pl dim 2", 5, 30, 30, 2, True, icp_type="pt2pl", loss_name="huber")
    edge("n=1 pt2pt dim 2", 3, 1, 8, 2, False, icp_type="pt2pt", loss_name="huber")
    edge("trim loss, steepness 2", 4, 40, 40, 2, False, icp_type="pt2pt", differentiable=True,
         loss_name="trim", loss_metric=2.0, tanh_steepness=2.0)
    for loss in VALID_LOSSES + (None,):
        edge(f"loss {loss}, pt2pl dim 3", 3, 48, 64, 3, True, icp_type="pt2pl",
             differentiable=True, loss_name=loss, loss_metric=2.0 if loss else 1.0,
             trim_dist=4.0)
    # the lane split's edges: the most threads, one target, ragged n and m
    edge("n=256, m=512 pt2pl dim 2", 4, N_GATE, M_GATE, 2, True, icp_type="pt2pl",
         loss_name="huber")
    # one target for 40 points (n = 1 would leave the rotation to the damping
    # alone, a singular solve): the translation fits the mean and the rotation
    # step vanishes, through one padded chunk of targets
    m1_src = rng.uniform(-2.0, 2.0, (3, 40, 3)).astype(np.float32)
    m1_tgt = rng.uniform(-2.0, 2.0, (3, 1, 3)).astype(np.float32)
    cases["m=1: 40 points against one target, pt2pt dim 3"] = (
        ICPConfig(**base, dim=3, fused_small=True, icp_type="pt2pt"),
        (to_torch(m1_src, device), to_torch(m1_tgt, device),
         torch.eye(4, device=device).expand(3, 4, 4), None))
    edge(f"n=37, m=43: not multiples of the lane split ({fused_gn.lanes_for(37, 43)} lanes) "
         f"or of {fused_gn.CHUNK}", 5, 37, 43, 3, True, icp_type="pt2pl", loss_name="huber")
    for loss in VALID_LOSSES + (None,):
        edge(f"loss {loss}, pt2pt dim 2", 3, 48, 64, 2, False, icp_type="pt2pt",
             differentiable=True, loss_name=loss, loss_metric=2.0 if loss else 1.0,
             trim_dist=4.0)

    err, work = 0.0, {}
    for name, (cfg, (s, t, i, w)) in cases.items():
        args = _k4_args(cfg, s, t, i, w)
        before = fused_gn.launches
        out = fused_gn.fused_gn_solve(*args, cfg)
        again = fused_gn.fused_gn_solve(*args, cfg)
        plain = fused_gn.fused_gn_solve_plain(*args, cfg)
        torch.cuda.synchronize()
        _check(fused_gn.launches == before + 2, f"K4 launched twice ({name})")
        for a, b in zip(out, again):
            _check(torch.equal(a, b), f"two K4 launches give identical outputs ({name})")
        C, r, conv, iters, ratio = out[:5]
        Cp, rp, convp, itersp, ratiop = plain[:5]
        for what, a, b in (("converged", conv, convp), ("iterations", iters, itersp),
                           ("matched ratio", ratio, ratiop)):
            _check(torch.equal(a, b), f"K4 {what} equal to the plain version's ({name}): "
                   f"{a.tolist()} vs {b.tolist()}")
        dT = max(float((C - Cp).abs().max()), float((r - rp).abs().max()))
        pc = torch.einsum("nij,npj->npi", C, args[0]) + r[:, None, :]
        pcp = torch.einsum("nij,npj->npi", Cp, args[0]) + rp[:, None, :]
        dpc = float((pc - pcp).abs().max())
        _check(dT < 1e-5, f"K4 T within 1e-5 of the plain version's ({name}): {dT}")
        _check(dpc < 1e-4, f"K4 pc within 1e-4 of the plain version's ({name}): {dpc}")
        _check(bool(torch.isfinite(C).all()), f"finite K4 rotations ({name})")
        err = max(err, dT)
        work[name] = (args, cfg, iters)
        print(f"  K4 == plain: {name}: {tuple(args[0].shape)} -> {tuple(args[1].shape)}, "
              f"iterations {sorted(set(iters.tolist()))}, converged "
              f"{int(conv.sum())}/{len(conv)}, max |T diff| {dT:.3e}, max |pc diff| {dpc:.3e}")

    timed = {}
    for name in list(cases)[:2]:
        args, cfg, iters = work[name]
        ms = cuda_median_ms(lambda: fused_gn.fused_gn_solve(*args, cfg), warmup=3, iters=20)
        chain_ms = _chain_ms(lambda: fused_gn.fused_gn_solve(*args, cfg))
        plain_ms = cuda_median_ms(lambda: fused_gn.fused_gn_solve_plain(*args, cfg),
                                  warmup=1, iters=5)
        bound = _bound(*_k4_work(args, iters, 6 if cfg.icp_type == "pt2pl" else 3))
        timed[name] = {"ms": ms, "plain_ms": plain_ms, **bound}
        print(f"  {name}: K4 {ms:.4f} ms call by call ({chain_ms:.4f} ms back to back through "
              f"the wrapper; the difference {ms - chain_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}), "
              f"{float(iters.sum()):.0f} element-iterations")

    # the forward A/B at the headline's configuration, alternated in one process
    ab_cfg = {fused: head_cfg.with_(fused_small=fused) for fused in (True, False)}

    def forward(fused):
        with torch.no_grad():
            return register(src, tgt, ti, None, ab_cfg[fused])

    before = fused_gn.launches
    res_k, res_l = forward(True), forward(False)
    torch.cuda.synchronize()
    _check(fused_gn.launches == before + 1, "register(fused_small=True) launches K4 once")
    _check(torch.equal(res_k.iterations, res_l.iterations), "K4 and loop iterations equal")
    dT = float((res_k.T - res_l.T).abs().max())
    _check(dT < 1e-5, f"K4 and loop transforms within 1e-5: {dT}")
    ab = {True: [], False: []}
    for fused in (True, False, False, True):
        ab[fused].append(cuda_median_ms(lambda: forward(fused), warmup=1, iters=5))
    print(f"  forward A/B at B={B_HEAD} (headline config): register(fused_small=True) "
          f"{ab[True]} ms, loop {ab[False]} ms (order K4, loop, loop, K4); "
          f"iterations {float(res_k.iterations.max())}, |T diff| {dT:.3e}")
    head = timed[list(cases)[0]]
    print(f"phase 11 ok: K4 matches its plain version in {len(cases)} cases; headline "
          f"K4 {head['ms']:.4f} ms vs plain {head['plain_ms']:.4f} ms")
    return {"max_abs_err": err, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None}


def _profile(fn, label: str, calls: int = 3, focus: tuple = ()) -> float:
    """Device busy share of ``calls`` calls under torch.profiler: the kernels'
    summed device time over the host wall time of the window (the profiler's
    own overhead included), the launches per call, the top kernels, and the
    share of device time of each kernel named in ``focus``.  Returns the
    device ops per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own rows (kernels, copies): CPU-op rows repeat their time
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    shares = {name: sum(e.self_device_time_total for e in rows if name in e.key) / 1e3
              / max(busy_ms, 1e-9) for name in focus}
    print(f"  profile of {label} ({calls} calls): wall {wall_ms / calls:.3f} ms, device busy "
          f"{busy_ms / calls:.3f} ms per call, busy share {busy_ms / wall_ms:.3f}; "
          f"{launches / calls:.0f} device ops per call; share of device time "
          + ", ".join(f"{name} {share:.3f}" for name, share in shares.items())
          + "; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / calls:.3f} ms x"
                      f"{e.count / calls:.0f}" for e in top))
    return launches / calls


def phase12_headline(device):
    """bench.py's headline through dicp_tpu_torch.bench (register_ift with K4
    as the forward; BENCH_FULL's unrolled and forward-only rates beside it),
    with this phase's own checks on what it returns; returns K4's launches
    in one call and the call."""
    out = bench.run(device, full=True, log=sys.stdout)
    src, tgt, ti = reference_batch(device)
    cfg = bench.head_config()

    def call():
        return bench.fwdbwd(register_ift, cfg, src, tgt, ti)

    _reset_launches()
    call()
    torch.cuda.synchronize()
    launches = fused_gn.launches
    _check(launches == 1, f"K4 launched once per call ({launches})")

    res, grad, grad_u = out["result"], out["grad_ift"], out["grad_unrolled"]
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(res.T.detach().double())), dim=-1)
    _check(float(err.max()) < TOL_POSE, f"headline transform error {float(err.max())} < "
           f"{TOL_POSE}")
    _check(bool((grad != 0).any()), "IFT gradient nonzero")
    _check(bool((grad_u != 0).any()), "unrolled gradient nonzero")
    _, value_l, grad_l = bench.fwdbwd(register_ift, cfg.with_(fused_small=False), src, tgt, ti)
    cos_l = bench.cosine(grad, grad_l)
    print(f"  B={B_HEAD}: transform error {float(err.max()):.3e}, iterations "
          f"{out['iterations']}, sum(T) {float(res.T.detach().sum()):.6f} (loop forward "
          f"{float(value_l):.6f}); gradient cosine with the unrolled {out['cosine']:.8f}, "
          f"with the loop-forward IFT {cos_l:.8f}")
    ms, rate = out["ms"], out["rate"]
    print(f"pt2pl_diff_B256_fwdbwd_registrations_per_s = {rate} registrations/s "
          f"({ms} ms per forward+backward, median of the K4-forward IFT calls)")
    print(f"phase 12 ok: register_ift with K4 as the forward, {ms:.4f} ms per "
          f"forward+backward at B={B_HEAD} ({rate:.1f} registrations/s); K4 launches "
          f"{launches}")
    return launches, call


def _score_bound(n: int, m: int) -> dict:
    """K6/K7's bound: SCORE_OPS f32 operations per (query, column) pair;
    the two clouds read once, the index and the score written once."""
    return _bound(SCORE_OPS * n * m, 12.0 * (n + m) + 8.0 * n)


def _score_cases(cloud) -> list:
    """(name, queries, targets, (tq, tm) list, targets for the plain
    version or None) for phase 13."""
    base = cloud(3000)
    first = [SCORE_TILES[0]]
    # a NaN coordinate in one target point: the kernels skip its column, the
    # plain versions drop its target tile, so they are held to the plain
    # version with the point moved out of reach (|y|^2 overflows to inf)
    nan_y = cloud(5000)
    nan_x = cloud(1000)
    nan_x[:4] = nan_y[11:15] + 1e-3
    nan_y[10, 1] = np.nan
    far = nan_y.copy()
    far[10] = 1e30
    nan_q = cloud(1000)
    nan_q[7, 2] = np.nan
    return [
        ("4096 x 4096", cloud(4096), cloud(4096), SCORE_TILES, None),
        (f"{N_SCORE} x {N_SCORE}", cloud(N_SCORE), cloud(N_SCORE), first, None),
        ("m < tm: 1000 x 300", cloud(1000), cloud(300), first, None),
        ("m not a multiple of tm: 777 x 5001", cloud(777), cloud(5001), SCORE_TILES, None),
        ("tm not a multiple of 4 (K6's 4-byte copies): 777 x 5001", cloud(777), cloud(5001),
         [(256, 2047), (64, 1001)], None),
        ("n = 1", cloud(1), cloud(5000), first, None),
        ("n not a multiple of tq: 1000 x 5000 at 64 x 256", cloud(1000), cloud(5000),
         [(64, 256)], None),
        ("duplicated targets", base[:1000] + cloud(1000) * 2e-4,
         np.concatenate([base, base]), first, None),
        ("f64 inputs", cloud(2000, np.float64), cloud(3000, np.float64), first, None),
        (NAN_TARGET, nan_x, nan_y, [SCORE_TILES[0], (64, 1001)], far),
        ("a NaN query", nan_q, cloud(5000), first, None),
    ]


NAN_TARGET = "a NaN target point"


def phase13_score_kernels(device, libs: dict) -> dict:
    """K6 and K7 against their plain versions on the same card tensors, bit
    for bit; no register spills; timed at 100k x 100k, call by call and back
    to back."""
    exp_knn._kernels()  # load and bind
    report = _report(libs["score_nn"])
    print(f"  {libs['score_nn'].name}:\n{report}")
    for name, regs, _, _ in _no_spills(report, "score_nn"):
        print(f"  {name}: {regs} registers, no spills")
    rng = np.random.default_rng(SEED + 13)

    def cloud(n, dtype=np.float32):
        return rng.uniform(-50, 50, (n, 3)).astype(dtype)

    err = {"score_nn_v1": 0.0, "score_nn_v2": 0.0}
    for name, x_np, y_np, tiles, y_plain in _score_cases(cloud):
        x, y = to_torch(x_np, device), to_torch(y_np, device)
        yp = y if y_plain is None else to_torch(y_plain, device)
        for tq, tm in tiles:
            runs = [("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain, {})]
            if tm % 4 == 0:  # K7 takes tm a multiple of 4
                runs.append(("score_nn_v2", exp_knn.nn_v2, exp_knn.nn_v2_plain, {}))
            if (tq, tm) == SCORE_TILES[0]:
                runs.append(("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain,
                             {"semantics": True}))
            for kname, fn, plain_fn, kw in runs:
                idx_k, s_k = fn(x, y, tq=tq, tm=tm, **kw)
                idx_p, s_p = plain_fn(x, yp, tq=tq, tm=tm, **kw)
                torch.cuda.synchronize()
                what = f"{kname} {tq}x{tm}{' semantics' if kw else ''} ({name})"
                _check(idx_k.shape == (x.shape[0],) and idx_k.dtype == torch.int32,
                       f"{what}: (n,) int32 indices")
                _check(torch.equal(idx_k, idx_p), f"{what}: indices equal the plain version's")
                _check(torch.equal(s_k, s_p), f"{what}: scores bit-equal to the plain version's")
                if y_plain is None:
                    err[kname] = max(err[kname], _max_abs_diff(s_k, s_p))
                if name == "duplicated targets":
                    _check(bool((idx_k < len(y_np) // 2).all()),
                           f"{what}: ties to the first copy")
                if name == NAN_TARGET:
                    _check(idx_k[:4].tolist() == [11, 12, 13, 14], f"{what}: nearest found")
                    dropped = int((plain_fn(x, y, tq=tq, tm=tm, **kw)[0] != idx_k).sum())
                    _check(dropped > 0, f"{what}: the plain version drops the NaN's tile")
                    print(f"    {what}: the plain version on the NaN targets differs in "
                          f"{dropped} of {len(idx_k)} queries (its tile dropped)")
                if name == "a NaN query":
                    _check(int(idx_k[7]) == 0 and float(s_k[7]) == float("inf"),
                           f"{what}: a NaN query gives (inf, 0)")
        print(f"  K6, K7 == plain: {name}: {tuple(x.shape)} x {tuple(y.shape)} {x.dtype}, "
              f"tiles {list(tiles)}")

    x, y = (to_torch(cloud(N_SCORE), device) for _ in range(2))
    out = {}
    bound = _score_bound(N_SCORE, N_SCORE)
    ops = SCORE_OPS * N_SCORE * N_SCORE
    for kname, fn, plain_fn in (("score_nn_v1", exp_knn.nn_v1, exp_knn.nn_v1_plain),
                                ("score_nn_v2", exp_knn.nn_v2, exp_knn.nn_v2_plain)):
        ms = cuda_median_ms(lambda: fn(x, y), warmup=3, iters=20)
        chain_ms = _chain_ms(lambda: fn(x, y))
        plain_ms = cuda_median_ms(lambda: plain_fn(x, y), warmup=1, iters=3)
        out[kname] = {"max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": None}
        print(f"  {kname} at {N_SCORE} x {N_SCORE}, 256 x 2048: {ms:.4f} ms call by call "
              f"({chain_ms:.4f} ms back to back), plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {SCORE_OPS:.0f} f32 "
              f"operations per pair; {bound['bound_ms'] / chain_ms:.3f} of it back to back), "
              f"issue ceiling {_issue_ms(ops):.4f} ms ({chain_ms / _issue_ms(ops):.2f} x)")
    print("phase 13 ok: K6 and K7 bit-equal to their plain versions in every case, no "
          "register spills")
    return out


def phase14_exp_knn() -> dict:
    """The A/B entry point; returns the launches of its run."""
    _reset_launches()
    result = exp_knn.main(time_n=N_SCORE)
    torch.cuda.synchronize()
    launches = {"score_nn_v1": exp_knn.nn_v1.launches, "score_nn_v2": exp_knn.nn_v2.launches,
                "tiled_nn": tiled_knn.launches}
    _check(all(result["correct"].values()) and list(result["correct"]) == ["v0", "v1", "v2"],
           f"v0, v1 and v2 correct at 4096 x 4096: {result['correct']}")
    _check(len(result["ms"]) == 7, "seven rows timed")
    for name, count in launches.items():
        _check(count > 0, f"{name} launched by exp_knn.main() ({count})")
    print(f"phase 14 ok: exp_knn.main() correct for {list(result['correct'])}, seven rows "
          f"timed at {N_SCORE} x {N_SCORE}; launches {launches}")
    return launches


def phase15_gumbel(device, sources: np.ndarray, targets: np.ndarray) -> None:
    """Gumbel soft NN on the card: the headline solve with a seeded
    generator, and the streamed soft neighbour at phase 4's shape."""
    src, tgt, ti = reference_batch(device)
    solver = ICP(icp_type="pt2pl", differentiable=True, max_iterations=HEAD["max_iterations"],
                 tolerance=HEAD["tolerance"], device=device, use_gumbel=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    t0 = time.perf_counter()
    res = solver.icp(src, tgt, ti, trim_dist=HEAD["trim_dist"],
                     loss_fn={"name": "huber", "metric": HEAD["loss_metric"]}, dim=HEAD["dim"],
                     key=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(res["T"].to(torch.float64))), dim=-1)
    _check(bool(torch.isfinite(res["T"]).all()), "finite Gumbel transforms")
    _check(float(err.max()) < TOL_GUMBEL,
           f"Gumbel transform error {float(err.max())} < {TOL_GUMBEL}")
    print(f"  ICP.icp(use_gumbel=True) at B={B_HEAD}: transform error max "
          f"{float(err.max()):.4e}, median {float(err.median()):.4e}; iterations "
          f"{float(res['stats']['iterations'].max())}; {wall:.3f} s (host clock)")

    x, y = to_torch(sources, device), to_torch(targets, device)
    n, m = x.shape[-2], y.shape[-2]
    _check(n * m > knn.DENSE_MAX_ENTRIES, "the soft neighbour streams at phase 4's shape")
    soft = knn.gumbel_nn(x, y, SEED + 15)
    lo, hi = y.amin(dim=-2, keepdim=True), y.amax(dim=-2, keepdim=True)
    slack = 1e-4 * float(y.abs().max())
    _check(soft.shape == y.shape[:1] + (n, y.shape[-1]) and bool(torch.isfinite(soft).all()),
           "a finite (B, n, 6) soft neighbour")
    _check(bool((soft >= lo - slack).all() and (soft <= hi + slack).all()),
           "the soft neighbour lies inside the targets' bounding box")
    ms = cuda_median_ms(lambda: knn.gumbel_nn(x, y, SEED + 15), warmup=1, iters=3)

    # a lattice of spacing 30 m: every query's nearest target is far nearer
    # than its next, so the softmax at tau 1e-3 is one-hot whatever the noise
    rng = np.random.default_rng(SEED + 15)
    grid = np.stack(np.meshgrid(*[np.arange(26)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = np.stack([grid[rng.permutation(len(grid))[:m]] * 30.0 for _ in range(len(sources))])
    lat_y = np.concatenate([lat + rng.normal(scale=0.01, size=lat.shape),
                            rng.normal(size=lat.shape)], axis=-1)
    pick = rng.integers(0, m, size=(len(sources), n))
    lat_x = np.take_along_axis(lat, pick[..., None], axis=1) + rng.normal(scale=2.0,
                                                                         size=(len(sources), n, 3))
    ly, lx = to_torch(lat_y, device), to_torch(lat_x, device)
    soft = knn.gumbel_nn(lx, ly, SEED + 16, tau=1e-3)
    hard = knn.find_nn_normalized(lx, ly, use_pallas=True)
    gap = float((soft - hard).abs().max())
    _check(gap <= 1e-4 * float(ly.abs().max()), f"lattice: soft NN equals hard NN ({gap})")
    print(f"phase 15 ok: Gumbel solve at B={B_HEAD}; streamed gumbel_nn at "
          f"{tuple(x.shape)} -> {tuple(y.shape)} {ms:.3f} ms (median of 3), inside the "
          f"box; on the lattice max |soft - hard| {gap:.3e}")


# --- phase 17: LiDAR odometry over raw 60k-point scans ------------------------

# benchmarks/bench_suite.py:585-660 (pipeline_stream): 64 raw scans of 60,000
# points read through ScanDataset(max_points=61440), moved along a constant
# step (benchmarks/exp_pipeline.py:50-51), pt2pt on the cluster tier
S_SEQ, N_SCAN, MAX_POINTS = 64, 60_000, 61_440
STEP_XI = (0.04, 0.02, 0.01, 0.004, 0.002, 0.01)
ODO_CFG = ICPConfig(icp_type="pt2pt", differentiable=False, max_iterations=30, tolerance=1e-5,
                    dim=3, trim_dist=1.0, loss_name="huber", loss_metric=0.5,
                    nn_method="cluster")
# (window, warm start, quantized) of the streamed modes
STREAM_MODES = ((1, True, False), (8, True, False), (8, False, False), (1, True, True))
TOL_REL, TOL_REL_Q16 = 1e-4, 1e-3   # bench_suite.py:657's bar for the quantized stream
TOL_ODO = 1e-5                      # batched odometry and resume against the streams
TOL_ATE = 1e-3
CLOSURE_GAP = 8
PROFILE_SCANS = 9                   # phase 16's profiled stream: 8 pairs


def write_sequence(directory: Path, rng: np.random.Generator):
    """S_SEQ scans of one lidar_scene as 4-column .bin files (x, y, z, 0):
    scan i is the scene seen from pose step^i.  Returns the true poses
    (S_SEQ, 4, 4) f64 and the step."""
    scene = lidar_scene(rng, N_SCAN)[:, :3]
    step = se3.vec2tran(torch.tensor(STEP_XI, dtype=torch.float64)).numpy()
    poses, T = [], np.eye(4)
    for i in range(S_SEQ):
        Ti = np.linalg.inv(T)
        scan = (scene @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        io.save_bin(str(directory / f"{i:04d}.bin"),
                    np.hstack([scan, np.zeros((N_SCAN, 1), np.float32)]))
        poses.append(T)
        T = T @ step
    return np.stack(poses), step


def _stream_items(ds, weightless: bool):
    """(points (n, 3), weight) per scan; weightless, the zero-row pads are
    replaced by real rows first (bench_suite.py:608-617): pads at the
    origin would act as real points."""
    for pts, w in ds:
        p = pts[:, :3]
        if weightless:
            p = p.copy()
            pad = w == 0
            p[pad] = p[~pad][:int(pad.sum())]
            yield p, None
        else:
            yield p, w


def _rel_errors(rel: torch.Tensor, step: np.ndarray) -> torch.Tensor:
    """|log(rel step^-1)| per pair, in f64 on the host."""
    step_inv = torch.as_tensor(np.linalg.inv(step))
    return torch.linalg.vector_norm(se3.tran2vec(rel.detach().cpu().double() @ step_inv), dim=-1)


# the launcher of each kernel that a main path reaches through a module
# attribute (so that a recorder can stand in for it)
RECORDERS = {"tiled_nn": (tiled_knn, "_nn_distances_cuda"),
             "cluster_search": (cluster_search, "fused_search"),
             "cluster_topk": (cluster_search, "fused_topk"),
             "fused_gn": (fused_gn, "_fused_gn_cuda")}


@contextlib.contextmanager
def _recording(name: str, calls: dict):
    """While active, kernel ``name``'s launcher (``RECORDERS[name]``) also
    keeps copies of the arguments of its first and its latest call under
    "first" and "last" (one device copy per tensor argument per call).  A
    wrapper that counts its launches on its own attribute keeps its count:
    the count moves to the recorder and back."""
    owner, attr = RECORDERS[name]
    kernel = getattr(owner, attr)

    def record(*args):
        calls["last"] = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                              for a in args)
        calls.setdefault("first", calls["last"])
        return kernel(*args)

    counted = hasattr(kernel, "launches")
    if counted:
        record.launches = kernel.launches
    setattr(owner, attr, record)
    try:
        yield calls
    finally:
        setattr(owner, attr, kernel)
        if counted:
            kernel.launches = record.launches


def _k1_duplicates(x, y, idx) -> str:
    """The targets' duplicated rows (a map's empty rows all sit on its
    sentinel): exact ties that K1 resolves to the first index, as the plain
    version does."""
    rows = y.reshape(-1, 3)
    uniq, counts = torch.unique(rows, dim=0, return_counts=True)
    dup = int(counts[counts > 1].sum())
    on_dup = int(torch.isin(idx.reshape(-1), torch.nonzero(
        (rows[:, None, :] == uniq[counts > 1][None]).all(-1).any(-1))[:, 0]).sum()) \
        if dup else 0
    return (f"{tuple(x.shape)} queries, {tuple(y.shape)} targets of which {dup} rows are "
            f"duplicates ({int((counts > 1).sum())} distinct points), {on_dup} queries "
            f"matched to a duplicated row")


def _k2_pads(args, got, pad_point, pad_label: str):
    """K2's groups whose points all sit on the pad point (``pad_point(points)``,
    None for the origin: phase 17's zero-row pads): their count and a report."""
    points, _, radius, xb, _ = args
    pad = (torch.zeros(3, dtype=points.dtype, device=points.device)
           if pad_point is None else pad_point(points))
    on_pad = (points == pad).all(-1).all(-1)                  # (..., G)
    radii = radius[on_pad]
    at_pad = (xb == pad).all(-1)
    return int(on_pad.sum()), (
        f"{int(on_pad.sum())} groups of pad rows {pad_label} (radius "
        f"{float(radii.max()) if radii.numel() else float('nan'):.3e} at most), "
        f"{int(at_pad.sum())} queries {pad_label}, {int((got[0] == 0).sum())} queries at "
        f"distance 0")


def _held_to_plain(name: str, recorded: dict, pads=None) -> float:
    """Kernel ``name`` against its plain version on the same card tensors, on
    each call recorded by :func:`_recording` (``recorded``: label -> calls):
    K1, K2 and K3 bit for bit, K4 with phase 11's gates (iterations,
    convergence and ratio equal, T within 1e-5).  Returns the largest
    |difference| (0 when equal).  ``pads`` = (pad_point, label), K2 only:
    gates that some recorded target holds a group of pad rows and reports
    them (``_k2_pads``)."""
    launcher = getattr(*RECORDERS[name])
    plain_of = {"tiled_nn": (tiled_knn.nn_distances_plain, ("index", "d2")),
                "cluster_search": (cluster_search.fused_search_plain, ("best", "row", "bound")),
                "cluster_topk": (cluster_search.fused_topk_plain, ("d2", "rows", "bound"))}
    err, pad_groups = 0.0, 0
    for label, calls in recorded.items():
        _check("first" in calls, f"{name} launched and recorded in {label}")
        for which in ("first", "last"):
            if which == "last" and calls["last"] is calls["first"]:
                continue
            args = calls[which]
            got = launcher(*args)
            where = f"the {which} {name} call of {label}"
            if name == "fused_gn":
                plain = fused_gn.fused_gn_solve_plain(*args[:6])
                for what, a, b in zip(("converged", "iterations", "matched ratio"),
                                      got[2:5], plain[2:5]):
                    _check(torch.equal(a, b), f"K4 {what} equal to the plain version's on "
                           f"{where}")
                dT = max(_max_abs_diff(got[0], plain[0]), _max_abs_diff(got[1], plain[1]))
                _check(dT < 1e-5, f"K4 T within 1e-5 of the plain version's on {where}: {dT}")
                err = max(err, dT)
                print(f"  {name} == plain on {where}: {tuple(args[0].shape)} -> "
                      f"{tuple(args[1].shape)}, max |T diff| {dT:.3e}")
                continue
            plain_fn, names = plain_of[name]
            plain = plain_fn(*args)
            torch.cuda.synchronize()
            for what, a, b in zip(names, got, plain):
                _check(torch.equal(a, b), f"{name} {what} bit-equal to the plain version's on "
                       f"{where}")
            if name == "tiled_nn":
                err = max(err, _max_abs_diff(got[1], plain[1]))
                print(f"  {name} == plain on {where}: {_k1_duplicates(*args, got[0])}")
                continue
            err = max(err, _max_abs_diff(got[0], plain[0]), _max_abs_diff(got[-1], plain[-1]))
            detail = f"xb {tuple(args[3].shape)}, G {args[0].shape[-3]}"
            if name == "cluster_search":
                detail += f", {int((got[0] <= got[2]).sum())}/{got[0].numel()} certified"
            if pads is not None:
                n_pad, report = _k2_pads(args, got, *pads)
                pad_groups += n_pad
                detail += f", {report}"
            print(f"  {name} == plain on {where}: {detail}")
    _check(pads is None or pad_groups > 0,
           f"the recorded {name} calls hold groups of pad rows {pads[1] if pads else ''}")
    return err


def phase17_lidar_odometry(device, workdir: Path):
    """The raw-scan odometry front end of the serving path; returns K2's
    launch counts, the W = 1 warm stream (for phase 16's profile) and K2's
    largest |difference| to its plain version on the path's own calls."""
    t_phase = time.perf_counter()
    poses_true, step = write_sequence(workdir, np.random.default_rng(SEED + 17))
    ds = io.ScanDataset.from_dir(str(workdir), max_points=MAX_POINTS, voxel=None,
                                 workers=4, prefetch=4)
    pairs = S_SEQ - 1
    native = io.native_available()   # builds the host runtime on first use
    host = list(ds)
    _check(len(host) == S_SEQ and host[0][0].shape == (MAX_POINTS, 4),
           f"{S_SEQ} scans of ({MAX_POINTS}, 4) from the dataset")
    _check(all(np.all(np.any(p[w > 0, :3] != 0, axis=1)) for p, w in host),
           "no real point lies exactly at the origin (zero rows are the pads)")
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in ds:
            pass
        passes.append((time.perf_counter() - t0) * 1e3 / S_SEQ)
    print(f"  native runtime available: {native}; ScanDataset alone "
          f"{statistics.median(passes):.3f} ms per scan (4 workers, prefetch 4; median of 3 "
          f"passes: {', '.join(f'{t:.3f}' for t in passes)})")

    def stream(window, warm, quant, scans=ds):
        res = stream_odometry(_stream_items(scans, quant), ODO_CFG, window=window,
                              warm_start=warm, quantize=quant, device=device)
        return res._replace(rel_transforms=res.rel_transforms.cpu())  # the host fetch

    launches = {}
    streams = {}
    rates = {}
    recorded = {}
    for window, warm, quant in STREAM_MODES:
        label = f"W={window} {'warm' if warm else 'cold'}{' quantized' if quant else ' f32'}"
        _reset_launches()
        if quant:
            res = stream(window, warm, quant)
        else:
            with _recording("cluster_search",
                        recorded.setdefault(f"the {label} stream", {})):
                res = stream(window, warm, quant)
        torch.cuda.synchronize()
        k2 = _launches()["cluster_search"]
        _check(k2 >= pairs // window, f"{label}: K2 launched ({k2})")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            stream(window, warm, quant)
            times.append(time.perf_counter() - t0)
        err = float(_rel_errors(res.rel_transforms, step).max())
        tol = TOL_REL_Q16 if quant else TOL_REL
        print(f"  stream {label}: {S_SEQ / statistics.median(times):.3f} frames/s (median of "
              f"3 after one run; runs {', '.join(f'{t:.4f}' for t in times)} s), rel err "
              f"{err:.3e}, iterations {float(res.iterations.float().mean()):.3f} per pair, "
              f"{int(res.converged.sum())}/{pairs} converged, K2 {k2 / pairs:.3f} launches "
              f"per pair")
        _check(err <= tol, f"{label}: rel err {err} <= {tol}")
        launches[label] = k2
        streams[(window, warm, quant)] = res
        rates[label] = S_SEQ / statistics.median(times)
    times = []
    for _ in range(3):   # the same stream without ScanDataset in the loop
        t0 = time.perf_counter()
        stream(1, True, False, host)
        times.append(time.perf_counter() - t0)
    print(f"  stream W=1 warm f32, the {S_SEQ} scans read before the run: "
          f"{S_SEQ / statistics.median(times):.3f} frames/s (runs "
          f"{', '.join(f'{t:.4f}' for t in times)} s), through ScanDataset "
          f"{rates['W=1 warm f32']:.3f}")

    # odometry takes no weights: the flag gives its zero-row pads the weight 0
    # that ScanDataset's weights give them in the streams
    cfg = ODO_CFG.with_(source_zeroes_are_pad=True)
    scans = torch.as_tensor(np.stack([p[:, :3] for p, _ in host]), device=device)
    cold = streams[(8, False, False)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    _reset_launches()
    t0 = time.perf_counter()
    odo = odometry(scans, cfg)
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    k2_odo = _launches()["cluster_search"]
    launches["batched odometry"] = k2_odo
    diff = float((odo.rel_transforms.cpu() - cold.rel_transforms).abs().max())
    same_iters = torch.equal(odo.iterations.cpu(), cold.iterations.cpu())
    same_conv = torch.equal(odo.converged.cpu(), cold.converged.cpu())
    print(f"  batched odometry: {pairs} pairs in one register call, {odo_s * 1e3:.3f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before), K2 {k2_odo} launches per call; against the "
          f"cold W=8 stream: max |rel diff| {diff:.3e}, iterations equal {same_iters}, "
          f"converged equal {same_conv}")
    _check(k2_odo > 0, "batched odometry launched K2")
    _check(same_iters and same_conv, "batched odometry's iterations and convergence equal "
           "the cold W=8 stream's")
    _check(diff <= TOL_ODO, f"batched odometry within {TOL_ODO} of the cold W=8 stream")
    with _recording("cluster_search", recorded.setdefault("a batched odometry call", {})):
        odometry(scans, cfg)   # outside the counted runs: only to record K2's arguments
    k2_err = _held_to_plain("cluster_search", recorded, pads=(None, "at the origin"))
    del recorded

    li = torch.arange(0, S_SEQ - CLOSURE_GAP, CLOSURE_GAP)
    closures = (li, li + CLOSURE_GAP)
    truth = torch.as_tensor(poses_true, device=device)
    graphs, pg_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        graphs.append(odometry_pose_graph(scans, cfg, loop_closures=closures))
        torch.cuda.synchronize()
        pg_s.append(time.perf_counter() - t0)
    same_bits = torch.equal(graphs[0].poses, graphs[1].poses)
    err_pg = float(ate(graphs[0].poses.double(), truth, align=False))
    err_odo = float(ate(odo.poses.double(), truth, align=False))
    print(f"  pose graph: {len(li)} loop closures (i, i+{CLOSURE_GAP}), odometry_pose_graph "
          f"{pg_s[1] * 1e3:.3f} ms (the first call in the process {pg_s[0] * 1e3:.3f} ms); "
          f"ATE (align=False) {err_pg:.3e} (odometry alone {err_odo:.3e}); two calls "
          f"bit-equal: {same_bits}")
    _check(err_pg < TOL_ATE, f"pose-graph ATE {err_pg} < {TOL_ATE}")

    ckpt = workdir / "odometry.npz"
    half = S_SEQ // 2       # an interrupted run over scans [0, half]
    resumable_odometry(scans[:half + 1], cfg, checkpoint_path=str(ckpt), chunk=16)
    _check(int(np.load(ckpt)["step"]) == half, f"the interrupted run checkpointed {half} pairs")
    resumed = resumable_odometry(scans, cfg, checkpoint_path=str(ckpt), chunk=16)
    diff_resume = float((resumed.poses - odo.poses).abs().max())
    print(f"  resume: {half} pairs, then all {pairs} from the checkpoint in chunks of 16; "
          f"max |pose diff| to one-shot odometry {diff_resume:.3e}")
    _check(diff_resume <= TOL_ODO, f"resumed poses within {TOL_ODO} of one-shot odometry")

    pts = scans[0]
    vox = [voxel_downsample(pts, 0.1) for _ in range(2)]
    cells = len(np.unique(np.floor(pts.cpu().numpy() / np.float32(0.1)).astype(np.int32),
                          axis=0))
    same_vox = all(torch.equal(a, b) for a, b in zip(*vox))
    print(f"  voxel grid: {MAX_POINTS} points at 0.1 m -> {int(vox[0].count)} cells "
          f"(numpy {cells}); two calls bit-equal: {same_vox}")
    _check(same_vox, "voxel_downsample gives the same bits twice")
    _check(int(vox[0].count) == cells, "voxel count equals numpy's count of distinct cells")

    src, tgt, ti = reference_batch(device)
    t0 = time.perf_counter()
    svd = pt2pt_svd_icp(src, tgt[..., :3], ti, max_iterations=100, tolerance=1e-10,
                        differentiable=False)
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    T_true = se3.tran_inv(se3.vec2tran(xi)).to(device)
    err_svd = torch.linalg.vector_norm(
        se3.tran2vec(T_true @ torch.linalg.inv(svd.T.double())), dim=-1)
    # tests/test_icp.py:210-223 in f64 (in f32, 32 power-iteration steps
    # leave ~5e-4 of this case unconverged)
    p = torch.as_tensor(np.random.default_rng(SEED).normal(size=(1, 200, 3)), device=device)
    Rz = torch.diag(torch.tensor([-1.0, -1.0, 1.0], dtype=torch.float64, device=device))
    C, r = svd_icp._kabsch(p, p @ Rz.T, torch.ones((1, 200), dtype=torch.float64,
                                                    device=device))
    err_180 = float((C[0] - Rz).abs().max())
    print(f"  SVD-ICP: B={B_HEAD} reference pair (dense), {svd_ms:.3f} ms, max transform "
          f"error {float(err_svd.max()):.3e}, iterations {int(svd.iterations.max())}; "
          f"180-degree Kabsch (f64) max |C - Rz| {err_180:.3e}")
    _check(float(err_svd.max()) < TOL_POSE, f"SVD-ICP error < {TOL_POSE}")
    _check(err_180 < 1e-6, "Kabsch recovers the 180-degree rotation")
    print(f"phase 17 ok: {S_SEQ} raw scans, K2 launches {launches}, "
          f"{time.perf_counter() - t_phase:.1f} s")
    # the profile's W = 1 stream is cut to PROFILE_SCANS scans: the profiler's
    # own processing of the full stream's ~95,000 device ops took ~50 s
    head = io.ScanDataset(ds.paths[:PROFILE_SCANS], max_points=MAX_POINTS, voxel=None,
                          workers=4, prefetch=4)
    return launches, lambda: stream(1, True, False, head), k2_err


# phase 18: the JAX suite's scan_to_map deployment (benchmarks/bench_suite.py:688-840),
# no cut: bench_suite's deployment, 12 scans of a 60,000-point wavy surface
# against a 65,536-row map (dicp_tpu_torch/benchmarks/bench_suite.py, S2M_*)
S_S2M, N_S2M = bench_suite.S2M_S, bench_suite.S2M_N
CAP_S2M, VOXEL_S2M, S2M_CFG = bench_suite.S2M_CAP, bench_suite.S2M_VOXEL, bench_suite.S2M_CFG
PROFILE_S2M_SCANS = 4               # phase 16's profiled scan-to-map stream


def _sentinel(points: torch.Tensor) -> torch.Tensor:
    """The map's empty-row sentinel hi + 2 extent + 1: the coordinate-wise
    largest row of a map target (the index's own pads at 1e15 left out)."""
    rows = points.reshape(-1, 3)
    return rows[(rows < ck.SENTINEL).all(-1)].amax(0)


def phase18_scan_to_map(device):
    """Scan-to-map odometry at the JAX suite's deployment, through
    bench_suite's host loop (its scan_to_map_60k, _sgd and _sgd_sub rows);
    returns K2's launches per stream, K2's largest |difference| on the
    path's own calls and a short gn stream for phase 16's profile."""
    t_phase = time.perf_counter()
    seq = bench_suite.scan_to_map_sequence()
    scans, poses_true, step = seq
    launches, recorded = {}, {}

    @contextlib.contextmanager
    def first_run(label):
        _reset_launches()
        with (_recording("cluster_search",
                         recorded.setdefault("the gn scan-to-map stream", {}))
              if label == "scan_to_map_60k" else contextlib.nullcontext()):
            yield
        torch.cuda.synchronize()
        launches[label] = _launches()["cluster_search"]

    out = bench_suite.scan_to_map_host_loop(device, seq=seq, first_run=first_run)
    # the quantized stream's bar: tests/test_mapping.py:146's
    quantized = (("gn, quantized", dict(quantize=True),
                  max(5 * out["scan_to_map_60k"]["ate"], 2e-3)),)
    out.update(bench_suite.scan_to_map_host_loop(device, variants=quantized, seq=seq,
                                                 first_run=first_run, emit=False))
    for label, o in out.items():
        res, k2 = o["first"], launches[label]
        its = res.iterations[1:].double()
        print(f"  stream {label}: {S_S2M / statistics.median(o['ms']) * 1e3:.3f} frames/s "
              f"(median of {len(o['ms'])} after one run; runs "
              f"{', '.join(f'{t:.2f}' for t in o['ms'])} ms), final-pose error "
              f"{o['final_pose_err']:.3e}, ATE (align=False) {o['ate']:.3e}, "
              f"{int(res.converged.sum())}/{S_S2M} converged, iterations per scan "
              f"{float(its.mean()):.3f} (min {float(its.min()):.0f}, max "
              f"{float(its.max()):.0f}), K2 {k2 / (S_S2M - 1):.3f} launches per scan")
        if "sgd" in label:
            _check(k2 == 0, f"{label}: the SGD mini-batch search runs no kernel ({k2})")
            same = all(torch.equal(r.poses, res.poses) for r in o["runs"])
            print(f"  {label}: four runs with one seed give equal poses, bit for bit: {same}")
            _check(same, f"{label}: two runs with one seed give the same poses")
        else:
            _check(k2 >= S_S2M - 1, f"{label}: K2 launched on every solved scan ({k2})")
    k2_err = _held_to_plain("cluster_search", recorded,
                            pads=(_sentinel, "on the map's sentinel"))
    gn = out["scan_to_map_60k"]["first"]

    # a mature map built by map_step over scans 0-10 at the gn stream's poses
    # (bench_suite.py's chained step: insert=True against insert=False)
    dev_scans = [torch.as_tensor(s, device=device) for s in scans]
    m = map_merge(empty_map(CAP_S2M, torch.float32, device), dev_scans[0], VOXEL_S2M,
                  mode="mean")
    step_dev = torch.as_tensor(step, dtype=torch.float32, device=device)
    for k in range(1, S_S2M - 1):
        t_pred = gn.poses[k - 1].to(device) @ step_dev
        _, _, _, m = map_step(m, dev_scans[k], t_pred, None, S2M_CFG, VOXEL_S2M,
                              merge_mode="mean")
    t_pred = gn.poses[S_S2M - 2].to(device) @ step_dev
    last = dev_scans[-1]

    def step_call(insert):
        return lambda: map_step(m, last, t_pred, None, S2M_CFG, VOXEL_S2M, insert=insert,
                                merge_mode="mean")

    pose, ok, iters, final_map = step_call(True)()
    full_ms = cuda_median_ms(step_call(True), warmup=1, iters=5)
    solve_ms = cuda_median_ms(step_call(False), warmup=1, iters=5)
    merge_ms = cuda_median_ms(lambda: map_merge(m, last @ pose[:3, :3].T + pose[:3, 3],
                                                VOXEL_S2M, mode="mean"), warmup=1, iters=5)
    occupied = final_map.count > 0
    n_occ = int(occupied.sum())
    empty_rows, rows = final_map.pos[~occupied], final_map.pos[occupied]
    beyond = bool((empty_rows > rows.amax(0)).all()) if empty_rows.numel() else True
    print(f"  mature map after {S_S2M} scans: {n_occ}/{CAP_S2M} occupied rows, "
          f"{CAP_S2M - n_occ} empty rows beyond the occupied box: {beyond}; map_step of scan "
          f"{S_S2M - 1} ({float(iters):.0f} iterations, converged {bool(ok)}): insert=True "
          f"{full_ms:.3f} ms, insert=False {solve_ms:.3f} ms (merge by difference "
          f"{full_ms - solve_ms:.3f} ms), map_merge of the {N_S2M}-point scan alone "
          f"{merge_ms:.3f} ms (CUDA events, median of 5)")
    _check(n_occ <= CAP_S2M, "the map holds at most its capacity")
    _check(beyond, "the map's empty rows sit beyond its occupied bounding box")
    print(f"phase 18 ok: {S_S2M} scans of {N_S2M} points against a {CAP_S2M}-row map, K2 "
          f"launches {launches}, {time.perf_counter() - t_phase:.1f} s")
    profile_seq = (scans[:PROFILE_S2M_SCANS], poses_true[:PROFILE_S2M_SCANS], step)
    return launches, k2_err, lambda: bench_suite.scan_to_map_host_loop(
        device, variants=(("gn", {}, bench_suite.TOL_ATE_GN),), seq=profile_seq, reps=0,
        emit=False)


# --- phase 19: GICP and the multiscale pyramid at the JAX suite's deployments -----

# dicp_tpu_torch/benchmarks/exp_gicp.py (B = 64 pairs of a 600-point saddle,
# seed 11) and exp_multiscale.py (100k points of bench_suite's scene, FAR init)


def _log_err(T_true: np.ndarray, T_est: torch.Tensor) -> torch.Tensor:
    """|log(T_true T_est^-1)| per element, in f64 on the host."""
    T_est = T_est.detach().cpu().double()
    return torch.linalg.vector_norm(
        se3.tran2vec(torch.as_tensor(T_true) @ torch.linalg.inv(T_est)), dim=-1)


def phase19_gicp_multiscale(device) -> dict:
    """GICP (exp_gicp's rows) and the pyramid (exp_multiscale's rows);
    returns K2's launches per pyramid call and its largest |difference| on
    the pyramid's own calls."""
    t_phase = time.perf_counter()
    gicp = exp_gicp.main(device)
    S, Tg, Ti = gicp["inputs"]
    g_ift = gicp["grad_ift"]
    a = S.clone().requires_grad_(True)
    unrolled = register_gicp(a, Tg, Ti, max_iterations=30, tolerance=1e-6, differentiable=True)
    g_unr = torch.autograd.grad(unrolled.T.sum(), a)[0]
    cos = bench.cosine(g_ift, g_unr)
    print(f"  register_gicp_ift's gradient: cosine with the unrolled differentiable=True "
          f"gradient {cos:.6f}")
    _check(bool(torch.isfinite(g_unr).all()) and float(g_unr.abs().max()) > 0,
           "GICP unrolled gradient finite and nonzero")
    _check(cos > 0.99, f"GICP IFT gradient cosine with the unrolled one {cos} > 0.99")

    # tests/test_gicp.py:190: ~50 m radius in f32, the equilibrated solve
    rng = np.random.default_rng(3)
    xy = rng.uniform(-50, 50, size=(800, 2))
    wide = np.column_stack([xy, 0.02 * (xy[:, 0] ** 2 - xy[:, 1] ** 2) / 50.0]).astype(np.float32)
    T_w = se3.vec2tran(torch.tensor([0.3, -0.2, 0.1, 0.004, -0.003, 0.006],
                                    dtype=torch.float64)).numpy()
    src_w = (wide.astype(np.float64) @ T_w[:3, :3].T + T_w[:3, 3]).astype(np.float32)
    res_w = register_gicp(torch.as_tensor(src_w[None], device=device),
                          torch.as_tensor(wide[None], device=device),
                          torch.eye(4, dtype=torch.float32, device=device)[None],
                          max_iterations=60, tolerance=1e-7)
    finite = bool(torch.isfinite(res_w.T).all())
    err_w = float(_log_err(np.linalg.inv(T_w), res_w.T)[0])
    print(f"  GICP f32 at ~50 m radius: finite {finite}, error {err_w:.3e}")
    _check(finite and err_w < 5e-4, f"GICP f32 realistic radius: finite, error {err_w} < 5e-4")

    launches, recorded = {}, {}

    @contextlib.contextmanager
    def first_call(label):
        _reset_launches()
        with (_recording("cluster_search",
                         recorded.setdefault("the pyramid's full-resolution level", {}))
              if label == "pyramid" else contextlib.nullcontext()):
            yield
        torch.cuda.synchronize()
        launches[label] = _launches()["cluster_search"]

    exp_multiscale.main(device, first_call=first_call)
    k2_single, k2_pyr = launches["single"], launches["pyramid"]
    k2_err = _held_to_plain("cluster_search", recorded)
    print(f"  multiscale: K2 launches per call: single scale {k2_single}, pyramid {k2_pyr}")
    _check(k2_single > 0 and k2_pyr > 0, "K2 launched on both full-resolution solves")
    print(f"phase 19 ok: GICP and the pyramid, {time.perf_counter() - t_phase:.1f} s")
    return {"launches_per_multiscale_call": k2_pyr, "launches_single": k2_single,
            "k2_err": k2_err}


# --- phase 20: closed-loop SLAM at real scan size -----------------------------

# tests/test_slam.py:44-98's circuit and configuration with 60,000-point scans
# drawn from a 1,000,000-point world, two laps, and slam_odometry's default
# capacity of 8,192 rows: the front end on the tiled tier (K1), the closures
# against 60,000-row anchors on the cluster tier (K2)
N_SLAM, WORLD_SLAM, LAPS_SLAM, PER_LAP = 60_000, 1_000_000, 2, 32
SLAM_CFG = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-5,
                     dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                     collect_histories=False)
SLAM_KW = dict(capacity=8192, voxel=0.25, anchor_every=4, closure_gap=24, detect_every=2,
               detect_radius=5.0, accept_ratio=0.5, max_closures=100, closure_info=30.0,
               refine_iterations=25)
PROFILE_SLAM_SCANS = 6              # phase 16's SLAM stream (~10,700 ops per scan)
FUNCTORCH_SNIPPET = """
import json, time, torch
from dicp_tpu_torch import se3
from dicp_tpu_torch.odometry import PoseGraph
from dicp_tpu_torch.slam import refine_robust
dev = torch.device("cuda", 0)
torch.linalg.solve(torch.eye(6, device=dev), torch.ones(6, device=dev))
xi = torch.zeros((65, 6), device=dev)
xi[:, 0] = torch.arange(65, device=dev) * 0.1
poses = se3.vec2tran(xi)
i = torch.arange(64, device=dev)
graph = PoseGraph(torch.cat([i, i[:8]]), torch.cat([i + 1, i[:8] + 32]),
                  torch.cat([se3.compose(se3.tran_inv(poses[:-1]), poses[1:]),
                             se3.compose(se3.tran_inv(poses[:8]), poses[32:40])]),
                  torch.ones(72, device=dev))
torch.cuda.synchronize()
times = []
for _ in range(2):
    t0 = time.perf_counter()
    refine_robust(poses, graph, iterations=25)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
print(json.dumps(times))
"""


def slam_circuit(laps: float, partial: bool = False):
    """tests/test_slam.py's _make_scans at N_SLAM points per scan: local-frame
    f32 scans along a 5 m circle (scan radius 6 m, noise 0.04, seed 3) drawn
    without replacement from a WORLD_SLAM-point wavy surface; returns the
    scans, the truth in the scan-0 gauge and the scan-0 pose."""
    R, r, noise = 5.0, 6.0, 0.04
    wrng = np.random.default_rng(0)
    world = np.empty((WORLD_SLAM, 3))
    world[:, 0] = wrng.uniform(-R - 8, R + 8, WORLD_SLAM)
    world[:, 1] = wrng.uniform(-R - 8, R + 8, WORLD_SLAM)
    world[:, 2] = np.sin(world[:, 0] * 0.6) * np.cos(world[:, 1] * 0.5) * 1.5
    rng = np.random.default_rng(3)
    n_scans = int(laps * PER_LAP) + (0 if partial else 1)
    poses, scans = [], []
    for k in range(n_scans):
        th = 2 * np.pi * k / PER_LAP
        t = np.array([R * np.cos(th), R * np.sin(th), 0.0])
        yaw = th + np.pi / 2 + 0.05 * np.sin(k * 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        Rm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = Rm, t
        idx = np.flatnonzero(np.linalg.norm(world[:, :2] - t[None, :2], axis=1) < r)
        sel = rng.choice(idx, N_SLAM, replace=len(idx) < N_SLAM)
        local = (world[sel] - t) @ Rm + rng.normal(scale=noise, size=(N_SLAM, 3))
        scans.append(local.astype(np.float32))
        poses.append(T)
    P = np.stack(poses)
    return scans, np.einsum("ij,kjl->kil", np.linalg.inv(P[0]), P), P[0]


@contextlib.contextmanager
def _timed_calls(module, name: str, log: list, kernel_counts: bool = False):
    """While active, each call of ``module.name`` is timed with CUDA events
    (ms appended to ``log``; with ``kernel_counts``, K2's launches in the
    call too)."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        k2 = cluster_search.fused_search.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        end.synchronize()
        log.append((start.elapsed_time(end), cluster_search.fused_search.launches - k2)
                   if kernel_counts else start.elapsed_time(end))
        return out

    setattr(module, name, timed)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def phase20_slam(device):
    """slam_odometry over two laps of 60,000-point scans; returns K1's
    launches per scan, K2's per closure attempt, the largest |difference| of
    each kernel on the path's own calls, a short stream for phase 16 and the
    first run's result with the truth (phase 21's pose graph)."""
    t_phase = time.perf_counter()
    scans, poses_true, T0 = slam_circuit(LAPS_SLAM)
    S = len(scans)
    truth = torch.as_tensor(poses_true)
    t_gen = time.perf_counter() - t_phase

    def run(count=S, src=scans):
        res = slam.slam_odometry(((p, None) for p in src[:count]), SLAM_CFG, device=device,
                                 **SLAM_KW)
        return res._replace(poses=res.poses.cpu(), poses_front=res.poses_front.cpu())

    rec1, rec2, closure_log, step_log, refine_log = {}, {}, [], [], []
    _reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_recording("tiled_nn", rec1.setdefault("the SLAM front end", {})))
        stack.enter_context(_recording("cluster_search",
                                       rec2.setdefault("the SLAM closure solves", {})))
        stack.enter_context(_timed_calls(slam, "_closure_solve", closure_log, True))
        stack.enter_context(_timed_calls(slam, "map_step", step_log))
        stack.enter_context(_timed_calls(slam, "refine_robust", refine_log))
        t0 = time.perf_counter()
        res = run()
        first_s = time.perf_counter() - t0
    counts = _launches()
    k1, k2 = counts["tiled_nn"], counts["cluster_search"]
    attempts = len(closure_log)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    a_front = float(ate(res.poses_front.double(), truth, align=False))
    a_ref = float(ate(res.poses.double(), truth, align=False))
    # |log(T_true^-1 T_rel)| per closure, as tests/test_slam.py:108-115
    errs = [float(torch.linalg.vector_norm(se3.tran2vec(
        torch.as_tensor(np.linalg.inv(poses_true[c.anchor_idx]) @ poses_true[c.scan_idx]).inverse()
        @ c.T_rel.cpu().double()))) for c in res.closures]
    its = res.iterations[1:].double()
    print(f"  SLAM, {LAPS_SLAM} laps x {PER_LAP} scans ({S}) of {N_SLAM} points from a "
          f"{WORLD_SLAM}-point world (built in {t_gen:.1f} s), capacity "
          f"{SLAM_KW['capacity']}: {S / statistics.median(times):.3f} frames/s (median of 3 "
          f"after one; runs {', '.join(f'{t:.3f}' for t in times)} s; the instrumented first "
          f"run {first_s:.3f} s)")
    print(f"  closures: {len(res.closures)} accepted of {attempts} attempts, pairs "
          f"{[(c.anchor_idx, c.scan_idx) for c in res.closures]}, ratios min "
          f"{min((c.matched_ratio for c in res.closures), default=float('nan')):.3f}, median "
          f"closure error {float(np.median(errs)) if errs else float('nan'):.3e}; ATE "
          f"(align=False) front {a_front:.4f} m, refined {a_ref:.4f} m; front-end iterations "
          f"per scan {float(its.mean()):.2f} (max {float(its.max()):.0f}), converged "
          f"{int(res.converged.sum())}/{S}")
    step_ms = statistics.median(step_log)
    closure_ms = statistics.median(t for t, _ in closure_log) if closure_log else float("nan")
    print(f"  per call (CUDA events, the first run): map_step {step_ms:.3f} ms (median of "
          f"{len(step_log)}), _closure_solve {closure_ms:.3f} ms (median of {attempts}), "
          f"refine_robust {', '.join(f'{t:.1f}' for t in refine_log)} ms; K1 "
          f"{k1 / (S - 1):.3f} launches per scan ({k1}), K2 "
          f"{k2 / max(attempts, 1):.3f} per closure attempt ({k2}; per attempt "
          f"{[n for _, n in closure_log]})")
    _check(len(res.closures) >= 1, "SLAM accepted a closure")
    for c in res.closures:
        _check(c.scan_idx - c.anchor_idx >= SLAM_KW["closure_gap"]
               and c.matched_ratio >= SLAM_KW["accept_ratio"],
               f"closure {c.anchor_idx} -> {c.scan_idx}: gap and ratio")
    _check(float(np.median(errs)) < 0.03, "median closure error < 0.03")
    _check(a_ref <= a_front + 1e-3, f"refined ATE {a_ref} <= front ATE {a_front} + 1e-3")
    _check(k1 >= S - 1, f"K1 launched on every front-end solve ({k1})")
    _check(k2 > 0 and k2 == sum(n for _, n in closure_log), "K2 launched only by the closures")
    k1_err = _held_to_plain("tiled_nn", rec1)
    k2_err = _held_to_plain("cluster_search", rec2)

    half, _, _ = slam_circuit(0.5, partial=True)
    res_half = run(len(half), half)
    print(f"  half lap ({len(half)} scans): {len(res_half.closures)} closures, refined poses "
          f"equal the front end's: {torch.equal(res_half.poses, res_half.poses_front)}")
    _check(len(res_half.closures) == 0 and torch.equal(res_half.poses, res_half.poses_front),
           "no closure without a revisit")
    proc = subprocess.run([sys.executable, "-c", FUNCTORCH_SNIPPET], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    _check(proc.returncode == 0, f"the cold refine_robust subprocess ran: {proc.stderr[-2000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"  refine_robust in a fresh process (65 poses, 72 edges, 25 iterations, 2 passes): "
          f"first call {cold[0] * 1e3:.1f} ms (functorch's first use), second "
          f"{cold[1] * 1e3:.1f} ms")
    print(f"phase 20 ok: SLAM, {len(res.closures)} closures, K1 {k1} and K2 {k2} launches, "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ({"launches": k1, "launches_per_slam_scan": k1 / (S - 1), "k1_err": k1_err},
            {"launches": k2, "launches_per_slam_closure": k2 / max(attempts, 1),
             "k2_err": k2_err}, lambda: run(PROFILE_SLAM_SCANS), (res, truth))


def _collectives() -> dict:
    """The collectives ``parallel._comm`` counted: (kind, ranks, elements) -> count."""
    return dict(_comm.counts)


def phase21_parallel(device, pair, T_pair: np.ndarray, sources: np.ndarray,
                     targets: np.ndarray, T_true: np.ndarray, raw_sources: np.ndarray,
                     raw_targets: np.ndarray, T_raw: np.ndarray, slam_case) -> dict:
    """dicp_tpu_torch.parallel in a world of one rank on NCCL (make_mesh((1, 1))
    on the card): the map-sharded solve of phase 8's pair (K2 in every
    iteration), its IFT gradient, the ring at phase 4's shape, the
    batch-sharded solve of phase 9's batch and the partitioned pose graph and
    refine_robust(mesh=...) of phase 20's graph.  The group is destroyed at
    the end of the phase.  Returns K2's launches and largest |difference| on
    the path, and the map-sharded call (on a mesh given) for phase 16's
    profile."""
    t_phase = time.perf_counter()
    mesh = make_mesh((1, 1))
    _check(dist.get_backend() == "nccl", f"the world of one runs on NCCL ({dist.get_backend()})")
    try:
        out = _phase21_body(device, mesh, pair, T_pair, sources, targets, T_true, raw_sources,
                            raw_targets, T_raw, slam_case)
    finally:
        dist.destroy_process_group()
    print(f"phase 21 ok: dicp_tpu_torch.parallel on NCCL (world of one), "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def _phase21_body(device, mesh, pair, T_pair, sources, targets, T_true, raw_sources,
                  raw_targets, T_raw, slam_case) -> dict:
    src, target = pair
    n, m = src.shape[0], target.shape[0]
    ti = torch.eye(4, dtype=torch.float32, device=device)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-5,
                    dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0,
                    cluster_probes=PROBES, cluster_group=GROUP, collect_histories=False)
    _check(cfg.resolved_nn_method(n, m, device) == "cluster", "phase 8's pair is cluster-tier")

    def sharded(c=cfg):
        return register_map_sharded(mesh, src, target, ti, cfg=c)

    def single():
        return register(src[None], target[None], ti[None], None, cfg)

    # the map-sharded solve: K2 once per iteration and once in the final cost
    # pass, one all-reduce per iteration and one in the cost pass
    rec = {}
    _reset_launches()
    _comm.reset_counts()
    with _recording("cluster_search", rec.setdefault("the map-sharded solve", {})):
        res = sharded()
        torch.cuda.synchronize()
    k2_map = _launches()["cluster_search"]
    counts = _collectives()
    it = int(res.iterations)
    ref = single()
    rot, trans = pose_errors(torch.as_tensor(T_pair[None], device=device),
                             res.T[None].to(torch.float64))
    diff = float((res.T - ref.T[0]).abs().max())
    print(f"  map-sharded {n} -> {m} pt2pl (cluster tier): {it} iterations, converged "
          f"{bool(res.converged)}, rotation error {float(rot[0]):.3e} rad, translation error "
          f"{float(trans[0]):.3e} m, |T - register's T| {diff:.3e} (register: "
          f"{int(ref.iterations[0])} iterations); K2 {k2_map} launches; collectives {counts}")
    _check(bool(res.converged), "the map-sharded solve converged")
    _check(float(rot[0]) < TOL_POSE and float(trans[0]) < TOL_POSE,
           f"map-sharded errors < {TOL_POSE}")
    _check(diff < 1e-4, "map-sharded T within 1e-4 of register's (the same fixed point)")
    _check(k2_map == it + 1, f"K2 launched once per iteration and in the cost pass ({k2_map}, "
           f"{it} iterations)")
    _check(sum(counts.values()) == it + 1
           and all(kind == "all_reduce" and numel <= 2 * (36 + 6 + 1) + 1
                   for kind, _, numel in counts), "one all-reduce of <= 87 elements per "
           "iteration and one in the cost pass")
    k2_err = _held_to_plain("cluster_search", rec)

    res_x = sharded(cfg.with_(sharded_fused=False))
    diff_x = float((res_x.T - res.T).abs().max())
    print(f"  sharded_fused=False (the group scan): {int(res_x.iterations)} iterations, "
          f"converged {bool(res_x.converged)}, |T - K2 path's T| {diff_x:.3e}")
    _check(int(res_x.iterations) == it and bool(res_x.converged) == bool(res.converged)
           and diff_x < 1e-4, "the group-scan path gives K2's T, iterations and convergence")
    ms_sharded = cuda_median_ms(sharded, warmup=1, iters=5)
    ms_single = cuda_median_ms(single, warmup=1, iters=5)
    print(f"  map-sharded call {ms_sharded:.3f} ms against register (phase 8's solve) "
          f"{ms_single:.3f} ms (CUDA events, median of 5 after one)")

    # the sharded IFT against the unrolled gradient
    cfg_d = cfg.with_(differentiable=True)
    probe = torch.linspace(0.5, 1.5, 16, device=device).reshape(4, 4)

    def grad_of(fn):
        s = src.clone().requires_grad_(True)
        r = fn(mesh, s, target, ti, cfg=cfg_d)
        return r, torch.autograd.grad(torch.sum(r.T * probe), s)[0]

    _comm.reset_counts()
    s = src.clone().requires_grad_(True)
    r_i = register_map_sharded_ift(mesh, s, target, ti, cfg=cfg_d)
    fwd = _collectives()
    _comm.reset_counts()
    g_i = torch.autograd.grad(torch.sum(r_i.T * probe), s)[0]
    torch.cuda.synchronize()
    bwd = _collectives()
    _, g_u = grad_of(register_map_sharded)
    cos = bench.cosine(g_i, g_u)
    ms_ift = cuda_median_ms(lambda: grad_of(register_map_sharded_ift), warmup=1, iters=5)
    print(f"  sharded IFT: {int(r_i.iterations)} iterations, converged {bool(r_i.converged)}; "
          f"gradient cosine with the unrolled one {cos:.6f}, |g| {float(g_i.norm()):.3e}; "
          f"fwd+bwd {ms_ift:.3f} ms; forward collectives {fwd}, the backward added {bwd}")
    _check(bool(torch.isfinite(g_i).all()) and bool((g_i != 0).any()),
           "finite, nonzero IFT gradient")
    _check(cos > 0.99, f"IFT gradient cosine {cos} > 0.99")

    # the ring at phase 4's shape (the dense tile fits; no kernel)
    cfg4 = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=50, tolerance=1e-6,
                     dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                     collect_histories=False)
    s4, t4 = to_torch(sources[0], device), to_torch(targets[0], device)
    _reset_launches()
    _comm.reset_counts()
    ring = register_ring_sharded(mesh, s4, t4, cfg=cfg4)
    ring_counts = _collectives()
    ring_launches = _launches()
    dense = register_map_sharded(mesh, s4, t4, cfg=cfg4.with_(nn_method="dense"))
    rot4, trans4 = pose_errors(torch.as_tensor(T_true[:1], device=device),
                               ring.T[None].to(torch.float64))
    diff4 = float((ring.T - dense.T).abs().max())
    ms_ring = cuda_median_ms(lambda: register_ring_sharded(mesh, s4, t4, cfg=cfg4), warmup=1,
                             iters=5)
    print(f"  ring {s4.shape[0]} -> {t4.shape[0]}: {int(ring.iterations)} iterations, "
          f"|T - dense map-sharded T| {diff4:.3e}, rotation error {float(rot4[0]):.3e}, "
          f"translation error {float(trans4[0]):.3e}; {ms_ring:.3f} ms; collectives "
          f"{ring_counts}; kernel launches {ring_launches}")
    _check(diff4 < 1e-5, "ring T within 1e-5 of the dense map-sharded T")
    _check(float(rot4[0]) < TOL_POSE and float(trans4[0]) < TOL_POSE, "ring errors < 1e-3")
    _check(not any(ring_launches.values()), "the ring runs no kernel")

    # batch-sharded at phase 9's batch: register's bits, K2, no collective
    cfg9 = cfg.with_(collect_histories=True)
    s9, t9 = to_torch(raw_sources, device), to_torch(raw_targets, device)
    ti9 = torch.eye(4, dtype=torch.float32, device=device).expand(len(raw_sources), 4, 4)
    _reset_launches()
    _comm.reset_counts()
    res_b = register_batch_sharded(mesh, s9, t9, ti9, cfg=cfg9)
    torch.cuda.synchronize()
    k2_batch = _launches()["cluster_search"]
    batch_counts = _collectives()
    ref_b = register(s9, t9, ti9, None, cfg9)
    rot9, trans9 = pose_errors(torch.as_tensor(T_raw, device=device), res_b.T.to(torch.float64))
    print(f"  batch-sharded {tuple(s9.shape)} -> {tuple(t9.shape)}: T bit-equal to register's "
          f"{torch.equal(res_b.T, ref_b.T)}, K2 {k2_batch} launches, collectives "
          f"{batch_counts}, max rotation error {float(rot9.max()):.3e}")
    _check(torch.equal(res_b.T, ref_b.T), "batch-sharded T bit-equal to register's")
    _check(k2_batch > 0, "K2 launched by the batch-sharded solve")
    _check(not batch_counts, "no collective in the batch-sharded solve")
    _check(float(rot9.max()) < TOL_POSE and float(trans9.max()) < TOL_POSE,
           "batch-sharded errors < 1e-3")

    # the partitioned pose graph and refine_robust(mesh=...) on phase 20's
    # front-end graph (functorch is warm: phases 12 and 20 used it)
    slam_res, truth = slam_case
    poses = slam_res.poses_front.to(device)
    graph = slam.build_pose_graph(poses, slam_res.closures, SLAM_KW["closure_info"],
                                  converged=slam_res.converged)
    its = SLAM_KW["refine_iterations"]
    _comm.reset_counts()
    part = pose_graph_optimize_partitioned(poses, graph, mesh, iterations=its)
    pg_counts = _collectives()
    dense_pg, _ = pose_graph_optimize(poses, graph, iterations=its)
    pg_diff = float((part - dense_pg).abs().max())
    ref_mesh = slam.refine_robust(poses, graph, mesh=mesh, iterations=its)
    ref_dense = slam.refine_robust(poses, graph, iterations=its)
    pos_diff = float(torch.linalg.vector_norm(ref_mesh[:, :3, 3] - ref_dense[:, :3, 3],
                                              dim=-1).max())
    a_dense = float(ate(ref_dense.double().cpu(), truth, align=False))
    a_mesh = float(ate(ref_mesh.double().cpu(), truth, align=False))
    ms_part = cuda_median_ms(lambda: pose_graph_optimize_partitioned(poses, graph, mesh,
                                                                     iterations=its),
                             warmup=1, iters=3)
    ms_dense = cuda_median_ms(lambda: pose_graph_optimize(poses, graph, iterations=its),
                              warmup=1, iters=3)
    print(f"  pose graph ({poses.shape[0]} poses, {graph.edges_i.shape[0]} edges, {its} "
          f"iterations): |partitioned - dense| {pg_diff:.3e}; {ms_part:.1f} ms against dense "
          f"{ms_dense:.1f} ms (median of 3 after one); collectives {pg_counts}; "
          f"refine_robust(mesh) vs dense: position difference {pos_diff:.3e} m, ATE "
          f"{a_mesh:.5f} against {a_dense:.5f} m")
    _check(pg_diff < 1e-4, "partitioned pose graph within 1e-4 of the dense one")
    _check(pos_diff < 1e-2, "refine_robust(mesh) positions within 1e-2 of the dense refine")
    _check(abs(a_mesh - a_dense) < 0.05 * max(a_dense, 1e-9), "ATE within 5% of the dense")
    return {"launches": k2_map + k2_batch, "launches_per_map_sharded_call": k2_map,
            "k2_err": k2_err, "iterations": it,
            "call": lambda mesh_: register_map_sharded(mesh_, src, target, ti, cfg=cfg)}


# --- phase 22: the bench entry, the suite's rows and the examples ---------------

# rows of bench_suite.ALL measured by earlier phases: scan_to_map's host
# loop by phase 18, the exp_gicp and exp_multiscale rows of solvers by phase 19
SUITE_ROWS = ("svd_pair", "pt2pl_pair", "batch256", "large_cloud", "normals", "odometry",
              "capacity", "pipeline", "scan_to_map", "solvers")
# the rows and examples whose first and last call of each kernel they launch
# are recorded and held to the plain versions
RECORD_ROWS = {"large_cloud": ("tiled_nn", "cluster_search", "cluster_topk"),
               "normals": ("cluster_search",), "capacity": ("fused_gn",),
               "pipeline": ("tiled_nn", "cluster_search"),
               "large_cloud_demo": ("cluster_search",), "odometry_demo": ("tiled_nn",),
               "serving_demo": ("cluster_search",)}
EXAMPLES = {"large_cloud_demo": large_cloud_demo, "odometry_demo": odometry_demo,
            "serving_demo": serving_demo, "slam_demo": slam_demo}


def _all_launches() -> dict:
    return {**_launches(), "fused_gn": fused_gn.launches}


def phase22_bench_suite_examples(device) -> dict:
    """dicp_tpu_torch.bench in this process, every row of bench_suite.ALL
    that no earlier phase measures, and the four examples; the kernels'
    launches per row and example, and K1-K4 held to their plain versions on
    the first and last calls recorded from the rows and examples of
    ``RECORD_ROWS``."""
    t_phase = time.perf_counter()
    per_row, seconds, errs = {}, {}, {}

    def counted(label, fn, record=()):
        _reset_launches()
        t0 = time.perf_counter()
        calls = {name: {} for name in record}
        with contextlib.ExitStack() as stack:
            for name in record:
                stack.enter_context(_recording(name, calls[name]))
            out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        per_row[label] = {k: v for k, v in _all_launches().items() if v}
        print(f"  {label}: {seconds[label]:.1f} s, kernel launches {per_row[label]}", flush=True)
        for name, recorded in calls.items():
            errs[name] = max(errs.get(name, 0.0), _held_to_plain(name, {label: recorded}))
        return out

    line = counted("bench", lambda: bench.main(device))
    _check(line["metric"] == bench.METRIC and line["value"] > 0,
           f"dicp_tpu_torch.bench printed {bench.METRIC}: {line}")
    _check(per_row["bench"].get("fused_gn", 0) > 0, "K4 launched by dicp_tpu_torch.bench")
    rows = {}
    for name in SUITE_ROWS:
        if name == "scan_to_map":
            fn = lambda: bench_suite.bench_scan_to_map(device, loop=False)   # noqa: E731
        elif name == "solvers":
            fn = lambda: bench_suite.bench_solvers(device, delegates=("exp_sgd",))  # noqa: E731
        else:
            fn = functools.partial(bench_suite.ALL[name], device)
        rows[name] = counted(name, fn, RECORD_ROWS.get(name, ()))
    n_rows = sum(len(r) for r in rows.values())
    for name, kernels in (("large_cloud", ("tiled_nn", "cluster_search", "cluster_topk")),
                          ("capacity", ("fused_gn",))):
        for k in kernels:
            _check(per_row[name].get(k, 0) > 0, f"{k} launched by the {name} row")
    results = {}
    for name, module in EXAMPLES.items():
        results[name] = counted(name, lambda module=module: module.main(device),
                                RECORD_ROWS.get(name, ()))
    _check(per_row["large_cloud_demo"].get("cluster_search", 0) > 0,
           "K2 launched by the large-cloud demo")
    print(f"  examples: {json.dumps(results)}")

    # utils.profiling and visualization on card tensors, after every timing
    # of this phase (a profiler slows host-bound timings after it)
    src, tgt, ti = reference_batch(device)

    def head_call():
        return bench.fwdbwd(register_ift, bench.head_config(), src, tgt, ti)[2]

    stats = profiling.benchmark(head_call, n=5)
    print(f"  utils.profiling.benchmark of one headline fwd+bwd: {stats}")
    _check(stats["n"] == 5 and 0 < stats["min_s"] <= stats["mean_s"], "benchmark() statistics")
    with tempfile.TemporaryDirectory(prefix="dicp_trace_") as log_dir:
        with profiling.trace(log_dir):
            head_call()
            torch.cuda.synchronize()
        traces = sorted(Path(log_dir).rglob("*.pt.trace.json*"))
        text = "".join(f.read_text(errors="replace") for f in traces if f.suffix == ".json")
        print(f"  utils.profiling.trace wrote {[f.name for f in traces]} "
              f"({sum(f.stat().st_size for f in traces)} bytes)")
        _check(bool(traces) and "fused_gn_kernel" in text,
               "the trace holds K4 under its launcher's name (fused_gn_kernel)")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("  visualization: matplotlib is not installed here; plot_overlay not driven")
        else:
            png = Path(log_dir) / "overlay.png"
            visualization.plot_overlay(src[0], tgt[0, :, :3], file_name=str(png))
            _check(png.stat().st_size > 0, "plot_overlay wrote a PNG from card tensors")
            print(f"  visualization.plot_overlay of card tensors: {png.stat().st_size} bytes")
    print(f"phase 22 ok: dicp_tpu_torch.bench, {n_rows} suite rows of {len(SUITE_ROWS)} names "
          f"here (scan_to_map's host loop in phase 18, "
          f"exp_gicp and exp_multiscale in phase 19), the four examples; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": per_row, "seconds": seconds, "max_abs_err": errs}



def main() -> None:
    card = phase0_device()
    device = torch.device("cuda", 0)
    libs = phase1_build()
    sources, targets, T_true = scene_pairs(np.random.default_rng(SEED), B, N_SRC, M_TGT)
    k1 = phase2_kernel(device, sources, targets)
    phase3_reference(device)
    launches, slice_solve = phase4_slice(device, sources, targets, T_true)
    phase5_cluster_build(libs)
    mp, scan, T_pair = raw_scan_pair(np.random.default_rng(SEED + 8), M_MAP)
    raw_sources, raw_targets, T_raw = scene_pairs(np.random.default_rng(SEED + 9),
                                                  B_RAW, N_RAW, M_RAW)
    timed = phase6_search_kernels(device, mp, scan, raw_targets, raw_sources)
    timed["cluster_topk"] = phase7_topk_kernel(device, mp, scan)
    single, single_solve, pair = phase8_single_pair(device, mp, scan, T_pair)
    batched, batched_solve = phase9_batched(device, raw_sources, raw_targets, T_raw)
    phase10_fused_build(libs)
    k4 = phase11_fused_kernel(device)
    k4_launches, headline_call = phase12_headline(device)
    scored = phase13_score_kernels(device, libs)
    ab_launches = phase14_exp_knn()
    phase15_gumbel(device, sources, targets)
    with tempfile.TemporaryDirectory(prefix="dicp_smoke_scans_") as workdir:
        odo_launches, stream_w1, k2_err = phase17_lidar_odometry(device, Path(workdir))
        s2m_launches, k2_err_s2m, s2m_stream = phase18_scan_to_map(device)
        pyramid = phase19_gicp_multiscale(device)
        slam_k1, slam_k2, slam_stream, slam_case = phase20_slam(device)
        par = phase21_parallel(device, pair, T_pair, sources, targets, T_true, raw_sources,
                               raw_targets, T_raw, slam_case)
        suite = phase22_bench_suite_examples(device)
        timed["cluster_search"]["max_abs_err"] = max(timed["cluster_search"]["max_abs_err"],
                                                     k2_err, k2_err_s2m, pyramid["k2_err"],
                                                     slam_k2["k2_err"], par["k2_err"])
        k1["max_abs_err"] = max(k1["max_abs_err"], slam_k1["k1_err"])
        for name, got in (("tiled_nn", k1), ("cluster_search", timed["cluster_search"]),
                          ("cluster_topk", timed["cluster_topk"]), ("fused_gn", k4)):
            got["max_abs_err"] = max(got["max_abs_err"], suite["max_abs_err"].get(name, 0.0))
        # last, so that no timing above runs after the profiler has been on
        _profile(slice_solve, "phase 4", focus=("tiled_nn_kernel",))
        _profile(single_solve, "phase 8 (icp call)", focus=("cluster_search_kernel",))
        _profile(batched_solve, "phase 9", focus=("cluster_search_kernel",))
        _profile(headline_call, "phase 12, IFT, K4 forward", focus=("fused_gn_kernel",))
        ops = _profile(stream_w1, f"phase 17, W=1 warm stream of {PROFILE_SCANS} scans",
                       calls=1, focus=("cluster_search_kernel",))
        print(f"  phase 17 stream: {ops / (PROFILE_SCANS - 1):.1f} device ops per pair")
        ops = _profile(s2m_stream, f"phase 18, gn scan-to-map stream of {PROFILE_S2M_SCANS} "
                       "scans", calls=1, focus=("cluster_search_kernel",))
        print(f"  phase 18 stream: {ops / PROFILE_S2M_SCANS:.1f} device ops per scan")
        ops = _profile(slam_stream, f"phase 20, SLAM stream of {PROFILE_SLAM_SCANS} scans",
                       calls=1, focus=("tiled_nn_kernel", "cluster_search_kernel"))
        print(f"  phase 20 stream: {ops / PROFILE_SLAM_SCANS:.1f} device ops per scan")
        # phase 21's map-sharded call in a world of one of its own
        mesh = make_mesh((1, 1))
        try:
            ops = _profile(lambda: par["call"](mesh), "phase 21, map-sharded call on NCCL",
                           focus=("cluster_search_kernel", "nccl"))
        finally:
            dist.destroy_process_group()
        print(f"  phase 21 map-sharded: {ops / (par['iterations'] + 1):.1f} device ops per "
              f"iteration ({par['iterations']} iterations and the cost pass)")
    print("phase 16 ok: profiles of phases 4, 8, 9, 12, 17, 18, 20 and 21")

    def suite_launches(name):
        """Phase 22's launches of kernel ``name``: per row or example, and their sum."""
        rows = {label: c[name] for label, c in suite["launches"].items() if c.get(name)}
        return rows, sum(rows.values())
    kernels = [{
        "name": "tiled_nn",
        "route": "cuda",
        "source": "dicp_tpu_torch/csrc/tiled_nn.cu",
        "replaces": "dicp_tpu/ops/pallas_knn.py:50",
        **k1,
        "launches": launches + slam_k1["launches"] + suite_launches("tiled_nn")[1],
        "launches_per_slam_scan": slam_k1["launches_per_slam_scan"],
        "launches_per_suite_row": suite_launches("tiled_nn")[0],
    }]
    sources_of = {"cluster_search": ("dicp_tpu_torch/csrc/cluster_search.cu",
                                     "dicp_tpu/ops/pallas_cluster.py:126"),
                  "cluster_block_search": ("dicp_tpu_torch/csrc/cluster_search.cu",
                                           "dicp_tpu/ops/pallas_cluster.py:33"),
                  "cluster_topk": ("dicp_tpu_torch/csrc/cluster_topk.cu",
                                   "dicp_tpu/ops/pallas_cluster.py:278")}
    for name, (source, replaces) in sources_of.items():
        count = single[name] + batched[name]
        _check(count > 0, f"{name} launched on the raw-scan paths ({count})")
        extra = {}
        if name == "cluster_search":
            count += (sum(odo_launches.values()) + sum(s2m_launches.values())
                      + pyramid["launches_single"] + pyramid["launches_per_multiscale_call"]
                      + slam_k2["launches"] + par["launches"])
            extra = {"launches_per_streamed_pair": {
                         label: k / (S_SEQ - 1) for label, k in odo_launches.items()
                         if label != "batched odometry"},
                     "launches_per_batched_odometry_call": odo_launches["batched odometry"],
                     "launches_per_scan_to_map_scan": {
                         label: k / (S_S2M - 1) for label, k in s2m_launches.items()},
                     "launches_per_slam_closure": slam_k2["launches_per_slam_closure"],
                     "launches_per_multiscale_call": pyramid["launches_per_multiscale_call"],
                     "launches_per_map_sharded_call": par["launches_per_map_sharded_call"]}
        per_row, in_suite = suite_launches(name)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count + in_suite, **timed[name], **extra,
                        "launches_per_suite_row": per_row})
    _check(k4_launches > 0, f"fused_gn launched on the headline path ({k4_launches})")
    kernels.append({"name": "fused_gn", "route": "cuda",
                    "source": "dicp_tpu_torch/csrc/fused_gn.cu",
                    "replaces": "dicp_tpu/ops/fused_gn.py:167",
                    "launches": k4_launches + suite_launches("fused_gn")[1], **k4,
                    "launches_per_suite_row": suite_launches("fused_gn")[0]})
    for name, replaces in (("score_nn_v1", "benchmarks/exp_knn.py:69"),
                           ("score_nn_v2", "benchmarks/exp_knn.py:137")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "dicp_tpu_torch/csrc/score_nn.cu", "replaces": replaces,
                        "launches": ab_launches[name], **scored[name]})
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def _chain_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of the device ms per call of ``reps`` calls
    queued back to back between two CUDA events (the host's launch overhead
    hides behind the queue)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _launch_signature(source: Path, name: str) -> str:
    """The ``extern "C"`` declaration of ``name`` in a kernel source,
    whitespace collapsed."""
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text())
    _check(found is not None, f"{source} declares {name}")
    return " ".join(found.group(1).split())


AB_KERNELS = ("tiled_nn", "cluster_search", "cluster_topk", "fused_gn", "score_nn")
# each source's launchers, bound with this checkout's argtypes
LAUNCHERS = {"tiled_nn": ("tiled_nn",), "cluster_search": ("cluster_search",),
             "cluster_topk": ("cluster_topk",), "fused_gn": ("fused_gn",),
             "score_nn": ("score_nn_v1", "score_nn_v2")}


def _argtypes() -> dict:
    v1, v2 = exp_knn._kernels()
    return {"tiled_nn": tiled_knn._kernel().argtypes,
            "cluster_search": cluster_search._search_kernel().argtypes,
            "cluster_topk": cluster_search._topk_kernel().argtypes,
            "fused_gn": fused_gn._kernel().argtypes,
            "score_nn_v1": v1.argtypes, "score_nn_v2": v2.argtypes}


def _build_other(root: Path, names) -> dict:
    """The launchers of ``names`` built from ``root``'s sources with this
    checkout's flags, one nvcc each, started together:
    {launcher without "_launch": function}.  Each launcher must have this
    checkout's C signature (checked in the sources), and is bound with it."""
    import ctypes

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = _build.BUILD_DIR / f"other-lib{name}.so"
        src = root / "dicp_tpu_torch" / "csrc" / f"{name}.cu"
        for fn in LAUNCHERS[name]:
            mine = _launch_signature(ROOT / "dicp_tpu_torch" / "csrc" / f"{name}.cu",
                                     f"{fn}_launch")
            _check(_launch_signature(src, f"{fn}_launch") == mine,
                   f"{src}'s {fn}_launch has this checkout's signature ({mine})")
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                        str(lib), str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), lib)
    fns, argtypes = {}, _argtypes()
    for name, (proc, lib) in jobs.items():
        _, err = proc.communicate()
        _check(proc.returncode == 0, f"nvcc built {name} from {root}: {err[-2000:]}")
        for fn in LAUNCHERS[name]:
            fns[fn] = getattr(ctypes.CDLL(str(lib)), f"{fn}_launch")
            fns[fn].argtypes = argtypes[fn]
            fns[fn].restype = ctypes.c_int
    return fns


PATHS_SNIPPET = """
import numpy as np, torch
import chip_smoke as c
from dicp_tpu_torch import ICPConfig
from dicp_tpu_torch.ops import fused_gn
dev = torch.device("cuda", 0)
src, tgt, T = c.scene_pairs(np.random.default_rng(c.SEED), c.B, c.N_SRC, c.M_TGT)
c.phase4_slice(dev, src, tgt, T)
mp, scan, Tp = c.raw_scan_pair(np.random.default_rng(c.SEED + 8), c.M_MAP)
c.phase8_single_pair(dev, mp, scan, Tp)
rs, rt, Tr = c.scene_pairs(np.random.default_rng(c.SEED + 9), c.B_RAW, c.N_RAW, c.M_RAW)
c.phase9_batched(dev, rs, rt, Tr)
c.phase12_headline(dev)
cfg = ICPConfig(**c.HEAD, driver="while", collect_histories=False, fused_small=True)
args = c._k4_args(cfg, *c.reference_batch(dev))
call = lambda: fused_gn.fused_gn_solve(*args, cfg)
print("K4 wrapper ms", c.cuda_median_ms(call, warmup=3, iters=20), c._chain_ms(call))
"""


def _ab_paths(parent: Path) -> dict:
    """Phases 4, 8 and 9 end to end (ms per icp call, median of 5), phase 12's
    registrations/s, and K4 through its wrapper at the headline (call by
    call and back to back), each checkout in a process of its own, in turns
    (parent, this, this, parent)."""
    rows = {name: {"parent": [], "this": []}
            for name in ("phase 4 icp call", "phase 8 icp call", "phase 9 icp call",
                         "phase 12 registrations/s", "K4 wrapper, call by call",
                         "K4 wrapper, back to back")}
    for who in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", PATHS_SNIPPET],
                             cwd=parent if who == "parent" else ROOT, capture_output=True,
                             text=True, timeout=600)
        _check(run.returncode == 0, f"phases 4, 8, 9, 12 of {who}: {run.stderr[-2000:]}")
        for k, ms in re.findall(r"^phase (\d) ok: .*?([\d.]+) ms per icp call", run.stdout,
                                flags=re.M):
            rows[f"phase {k} icp call"][who].append(float(ms))
        rate = re.search(r"^pt2pl_diff_B256_fwdbwd_registrations_per_s = ([\d.]+)", run.stdout,
                         flags=re.M)
        wrapper = re.search(r"^K4 wrapper ms ([\d.]+) ([\d.]+)", run.stdout, flags=re.M)
        _check(rate is not None and wrapper is not None, f"phase 12 and K4 timed ({who})")
        rows["phase 12 registrations/s"][who].append(float(rate.group(1)))
        rows["K4 wrapper, call by call"][who].append(float(wrapper.group(1)))
        rows["K4 wrapper, back to back"][who].append(float(wrapper.group(2)))
    for name, times in rows.items():
        _check(all(len(t) == 2 for t in times.values()), f"{name} timed twice each")
        print(f"  {name}: parent {times['parent']}, this {times['this']} "
              f"(order parent, this, this, parent; one process each)")
    return rows


def _k4_main_inputs(device) -> dict:
    """K4's two main shapes (phase 11 and --ab): label -> (config, (source,
    target, T_init))."""
    head_cfg = ICPConfig(**HEAD, driver="while", collect_histories=False, fused_small=True)
    g_src, g_tgt, _ = scene_pairs(np.random.default_rng(SEED + 11), B_HEAD, N_GATE, M_GATE)
    gate_cfg = ICPConfig(differentiable=False, driver="while", collect_histories=False,
                         max_iterations=40, tolerance=1e-5, nn_method="dense", icp_type="pt2pl",
                         dim=3, trim_dist=2.0, loss_name="huber", loss_metric=0.5,
                         fused_small=True)
    return {f"headline B={B_HEAD}, 65 -> 65": (head_cfg, reference_batch(device)),
            f"{B_HEAD} x {N_GATE} -> {M_GATE}": (
                gate_cfg, (to_torch(g_src, device), to_torch(g_tgt, device),
                           torch.eye(4, device=device).expand(B_HEAD, 4, 4)))}


def main_ab(parent: Path, only: str | None = None) -> None:
    """K1, K2, K5, K3, K4, K6 and K7 of ``parent`` against this checkout's,
    on one card, in turns (parent, this, this, parent) at the main path's
    shapes (K6/K7 at the A/B's), each launcher called directly on the same
    tensors after holding both to the plain versions: timed call by call (as
    phases 2, 6, 7, 11 and 13 time the wrappers) and back to back.  Then the
    paths end to end (_ab_paths).  ``only="score"`` times K6 and K7 alone
    (neither lies on a path)."""
    card = phase0_device()
    device = torch.device("cuda", 0)
    names = ("score_nn",) if only == "score" else AB_KERNELS
    _build.build_all(names)
    other = _build_other(parent, names)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = {}

    def record(name, calls, check):
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        check()
        order = list(calls) + list(calls)[::-1]
        for how, timer in (("call by call", lambda f: cuda_median_ms(f, warmup=3, iters=20)),
                           ("back to back", _chain_ms)):
            times = {who: [] for who in calls}
            for who in order:
                times[who].append(timer(calls[who]))
            rows[f"{name}, {how}"] = times
            print(f"  {name}, {how}: " + ", ".join(f"{who} {t} ms" for who, t in times.items())
                  + f" (order {', '.join(order)})")

    if only != "score":
        _ab_main_kernels(record, other, device, stream)
    mine = dict(zip(LAUNCHERS["score_nn"], exp_knn._kernels()))
    _ab_score(record, {"parent": other, "this": mine}, device, stream)
    if only != "score":
        rows.update(_ab_paths(parent))
    summary = {"card": card, "parent": str(parent),
               "ms": {name: {who: statistics.median(t) for who, t in times.items()}
                      for name, times in rows.items()}, "runs": rows}
    print(f"card: {card}")
    print(json.dumps(summary))


def _ab_main_kernels(record, other: dict, device, stream) -> None:
    """K1, K2, K5, K3 and K4 of the parent and this checkout, at the main
    paths' shapes."""
    sources, targets, _ = scene_pairs(np.random.default_rng(SEED), B, N_SRC, M_TGT)
    x = to_torch(sources, device, torch.float32).contiguous()
    y = to_torch(targets[..., :3], device, torch.float32).contiguous()
    nb, n, m = x.shape[0], x.shape[1], y.shape[1]
    out = {who: (torch.empty(nb, n, dtype=torch.int32, device=device),
                 torch.empty(nb, n, device=device)) for who in ("parent", "this")}

    def k1(fn, who):
        return lambda: fn(x.data_ptr(), y.data_ptr(), nb, n, m, out[who][0].data_ptr(),
                          out[who][1].data_ptr(), 0, stream)

    def k1_check():
        ref = tiled_knn.nn_distances_plain(x, y)
        for who in ("parent", "this"):
            _check(all(torch.equal(a, b) for a, b in zip(out[who], ref)),
                   f"K1 ({who}) equals the plain version")

    record(f"K1 ({nb}, {n}, {m})", {"parent": k1(other["tiled_nn"], "parent"),
                                    "this": k1(tiled_knn._kernel(), "this")}, k1_check)

    mp, scan, _ = raw_scan_pair(np.random.default_rng(SEED + 8), M_MAP)
    raw_sources, raw_targets, _ = scene_pairs(np.random.default_rng(SEED + 9), B_RAW, N_RAW,
                                              M_RAW)
    shapes = {f"{len(scan)} -> {len(mp)}": (mp[:, :3], scan),
              f"{B_RAW} x {N_RAW} -> {M_RAW}": (raw_targets[..., :3], raw_sources)}
    for label, (y_np, x_np) in shapes.items():
        ix, xb, bsel = _search_inputs(to_torch(y_np, device), to_torch(x_np, device))
        args = [t.contiguous() for t in (ix.points, ix.centers, ix.radius, xb, bsel)]
        Bq, nbq, Qs = xb.shape[:3]
        G, g, P = ix.points.shape[1], ix.points.shape[2], bsel.shape[-1]
        for with_bound, kname in ((1, "K2"), (0, "K5")):
            res = {who: [torch.empty(Bq, nbq, Qs, device=device),
                         torch.empty(Bq, nbq, Qs, dtype=torch.int32, device=device),
                         torch.empty(Bq, nbq, Qs, device=device)] for who in ("parent", "this")}

            def k2(fn, who, with_bound=with_bound, res=res, args=args):
                ptrs = [t.data_ptr() for t in args]
                outs = [t.data_ptr() for t in res[who]]
                return lambda: fn(*ptrs, Bq, G, g, nbq, Qs, P, with_bound, *outs, 0, stream)

            def k2_check(with_bound=with_bound, res=res, args=args, kname=kname):
                if with_bound:
                    ref = cluster_search.fused_search_plain(*args)
                else:
                    ref = cluster_search.block_search_plain(args[0], args[3], args[4])
                for who in ("parent", "this"):
                    _check(all(torch.equal(a, b) for a, b in zip(res[who], ref)),
                           f"{kname} ({who}) equals the plain version ({label})")

            record(f"{kname} {label}", {"parent": k2(other["cluster_search"], "parent"),
                                        "this": k2(cluster_search._search_kernel(), "this")},
                   k2_check)
        k = 16
        res3 = {who: [torch.empty(Bq, nbq, Qs, k, device=device),
                      torch.empty(Bq, nbq, Qs, k, dtype=torch.int32, device=device),
                      torch.empty(Bq, nbq, Qs, device=device)] for who in ("parent", "this")}

        def k3(fn, who, res=res3, args=args):
            ptrs = [t.data_ptr() for t in args]
            outs = [t.data_ptr() for t in res[who]]
            return lambda: fn(*ptrs, Bq, G, g, nbq, Qs, P, k, *outs, 0, stream)

        def k3_check(res=res3, args=args):
            ref = cluster_search.fused_topk_plain(*args, k)
            for who in ("parent", "this"):
                _check(all(torch.equal(a, b) for a, b in zip(res[who], ref)),
                       f"K3 ({who}) equals the plain version ({label}, k = {k})")

        record(f"K3 {label}, k = {k}", {"parent": k3(other["cluster_topk"], "parent"),
                                        "this": k3(cluster_search._topk_kernel(), "this")},
               k3_check)

    for label, (cfg, inputs) in _k4_main_inputs(device).items():
        kargs = _k4_args(cfg, *inputs)
        source, target = kargs[0], kargs[1]
        nbk, n, m = source.shape[0], source.shape[1], target.shape[1]
        tcols = 6 if cfg.icp_type == "pt2pl" else 3
        ins = [t.detach().float().contiguous()
               for t in (source, target[..., :tcols], kargs[2], kargs[3], kargs[4])]
        res4 = {who: [torch.empty(nbk, 3, 3, device=device), torch.empty(nbk, 3, device=device)]
                + [torch.empty(nbk, device=device) for _ in range(3)]
                + [torch.empty(nbk, n, device=device), torch.empty(nbk, device=device)]
                for who in ("parent", "this")}

        def k4(fn, who, res=res4, ins=ins, cfg=cfg, shape=(nbk, n, m)):
            ptrs = [t.data_ptr() for t in ins] + [t.data_ptr() for t in res[who]]
            flags = (int(cfg.icp_type == "pt2pl"), cfg.dim, fused_gn._LOSS_CODES[cfg.loss_name],
                     int(cfg.differentiable), int(cfg.trim_dist is not None),
                     int(cfg.tikhonov is not None))
            values = (0.0 if cfg.trim_dist is None else cfg.trim_dist, cfg.loss_metric,
                      cfg.tanh_steepness, cfg.tolerance, cfg.match_ratio_thresh,
                      0.0 if cfg.tikhonov is None else cfg.tikhonov)
            return lambda: fn(*ptrs, *shape, *flags, *values, cfg.max_iterations, 0, stream)

        def k4_check(res=res4, kargs=kargs, cfg=cfg, label=label):
            ref = fused_gn.fused_gn_solve_plain(*kargs, cfg)
            for who in ("parent", "this"):
                C, r, conv, iters, ratio = res[who][:5]
                _check(torch.equal(conv > 0, ref[2]) and torch.equal(iters, ref[3])
                       and torch.equal(ratio, ref[4])
                       and float((C - ref[0]).abs().max()) < 1e-5
                       and float((r - ref[1]).abs().max()) < 1e-5,
                       f"K4 ({who}) matches the plain version ({label})")

        record(f"K4 {label}", {"parent": k4(other["fused_gn"], "parent"),
                               "this": k4(fused_gn._kernel(), "this")}, k4_check)


def _ab_score(record, contenders: dict, device, stream) -> None:
    """K6 and K7 of each contender ({who: {"score_nn_v1": launcher,
    "score_nn_v2": launcher}}) at 100k x 100k for 256 x 2048 and 512 x 4096,
    after holding each to the plain versions, bit for bit."""
    rng = np.random.default_rng(SEED + 13)
    x, y = (to_torch(rng.uniform(-50, 50, (N_SCORE, 3)).astype(np.float32), device)
            for _ in range(2))
    n = N_SCORE
    for tq, tm in SCORE_TILES[:2]:
        m_pad = -(-n // tm) * tm
        y4 = exp_knn._pack_y8(y, m_pad)[:4].contiguous()
        for kname, label, plain_fn in (("score_nn_v1", "K6", exp_knn.nn_v1_plain),
                                       ("score_nn_v2", "K7", exp_knn.nn_v2_plain)):
            res = {who: (torch.full((n,), -1, dtype=torch.int32, device=device),
                         torch.full((n,), float("nan"), device=device),
                         torch.empty((m_pad // tm, n), device=device),
                         torch.empty((m_pad // tm, n), dtype=torch.int32, device=device))
                   for who in contenders}

            def call(who, kname=kname, res=res, m_pad=m_pad, y4=y4, tq=tq, tm=tm):
                fn = contenders[who][kname]
                idx, s, part_s, part_i = (t.data_ptr() for t in res[who])
                args = (part_s, part_i, idx, s) if kname == "score_nn_v1" else (idx, s)
                what = f"{kname} ({who}) launched at {tq} x {tm}"

                def launch():
                    _check(fn(x.data_ptr(), y4.data_ptr(), n, m_pad, tq, tm, *args, 0,
                              stream) == 0, what)
                return launch

            def check(res=res, plain_fn=plain_fn, tq=tq, tm=tm, label=label):
                ref = plain_fn(x, y, tq=tq, tm=tm)
                for who in contenders:
                    _check(torch.equal(res[who][0], ref[0]) and torch.equal(res[who][1], ref[1]),
                           f"{label} ({who}) equals the plain version ({tq} x {tm})")

            record(f"{label} {n} x {n}, {tq} x {tm}", {who: call(who) for who in contenders},
                   check)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        main_ab(Path(sys.argv[2]).resolve())
    elif sys.argv[1:2] == ["--ab"] and sys.argv[3:] == ["--only", "score"]:
        main_ab(Path(sys.argv[2]).resolve(), only="score")
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--ab DIR [--only score]]")
    else:
        main()
