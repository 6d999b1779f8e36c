"""Closed-loop SLAM: the scan-to-map front end, keyframe loop closures and a
robust pose-graph back end; the counterpart of ``dicp_tpu/slam.py``.

1. **Front end**: :func:`mapping.map_step` against a capacity-bounded
   sliding voxel map, from an EMA-damped constant-velocity prediction.
2. **Keyframe anchors and loop-closure detection**: every ``anchor_every``
   scans the posed scan (points and estimated normals, world frame) is
   frozen as a keyframe snapshot with its pose estimate.  A revisit is
   declared when the predicted position comes within ``detect_radius`` of
   an anchor stored at least ``closure_gap`` scans before; the scan is then
   registered against that one snapshot.
3. **Back end**: a pose graph of consecutive odometry edges and one relative
   edge (j -> k) per accepted closure, refined by Huber-IRLS around
   :func:`odometry.pose_graph_optimize` (dense) or, given a device mesh,
   :func:`parallel.pose_graph.pose_graph_optimize_partitioned` (the
   keyframe-partitioned Schur solve over the mesh's ranks).

Why relative edges: registering scan k against anchor j's snapshot posed at
T_j_est measures T_rel = T_j_est^-1 T_k_meas, in which the anchor's own pose
error cancels, leaving the sensor-frame alignment of the two scans; the
graph then spreads the accumulated loop error along the trajectory (the JAX
module's docstring has the measured history).

On the card a 60,000-point scan against the default 8,192-row map runs the
front end on the tiled tier (kernel K1), and a closure against a 60,000-row
anchor on the cluster tier (K2).  As JAX jits them, the front end's
:func:`mapping.map_step`, :func:`_closure_solve`, :func:`_make_anchor`,
:func:`_edge_residual_norms`, :func:`rebuild_map`'s merges and the dense
back end's :func:`odometry.pose_graph_optimize` (its GN iterations unrolled;
the second IRLS pass replays the first pass's program) run as captured
programs on the card (:mod:`dicp_tpu_torch.jit`; each solve's loop a WHILE
node), eagerly on the CPU.  The host reads inside the stream are
JAX's: one predicted position (3 floats) per detection check, one anchor
position per stored keyframe, and the convergence flag and matched ratio of
each closure attempt.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.api import _resolve_device
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.jit import jit
from dicp_tpu_torch.mapping import LocalMap, empty_map, map_merge, map_step
from dicp_tpu_torch.odometry import PoseGraph, pose_graph_optimize
from dicp_tpu_torch.ops.normals import _median, estimate_normals_weighted
from dicp_tpu_torch.parallel.pose_graph import pose_graph_optimize_partitioned
from dicp_tpu_torch.pipeline import _prefetched, _Uploader
from dicp_tpu_torch.registration import _register_program


class Closure(NamedTuple):
    """One accepted loop closure: a relative pose-graph edge j -> k."""
    anchor_idx: int           # scan index j of the keyframe anchor
    scan_idx: int             # scan index k that re-registered against it
    T_rel: torch.Tensor       # (4, 4) measured T_j^-1 T_k (drift-free)
    matched_ratio: float      # tight-solve overlap ratio


class SlamResult(NamedTuple):
    poses_front: torch.Tensor    # (S, 4, 4) raw scan-to-map trajectory
    poses: torch.Tensor          # (S, 4, 4) pose-graph-refined trajectory
    closures: List[Closure]
    converged: torch.Tensor      # (S,) front-end solve convergence
    iterations: torch.Tensor     # (S,)


@functools.partial(jit, static_argnames=("cfg_coarse", "cfg_tight"), name="closure_solve")
def _closure_solve(anchor_tgt: torch.Tensor, t_anchor: torch.Tensor, scan: torch.Tensor,
                   t_pred: torch.Tensor, cfg_coarse: ICPConfig, cfg_tight: ICPConfig):
    """Register ``scan`` against one keyframe snapshot; returns (T_rel (4, 4)
    = T_anchor^-1 T_meas, converged (), matched_ratio ()), on the device.

    Two stages: coarse with a wide trim (the drift at a revisit exceeds the
    front end's gate), then tight with the front end's own trim from the
    coarse pose.  The ratio is the tight solve's: under a wide trim it reads
    ~1 even when only a sliver of the anchor overlaps the scan."""
    res_c = _register_program(scan[None, :, :3], anchor_tgt[None], t_pred[None], None,
                              cfg_coarse)
    res_t = _register_program(scan[None, :, :3], anchor_tgt[None], res_c.T, None, cfg_tight)
    t_rel = se3.compose(se3.tran_inv(t_anchor), res_t.T[0])
    return t_rel, res_c.converged[0] & res_t.converged[0], res_t.matched_ratio[0]


@functools.partial(jit, static_argnames=("with_normals",), name="make_anchor")
def _make_anchor(scan: torch.Tensor, pose: torch.Tensor, with_normals: bool) -> torch.Tensor:
    """World-frame keyframe snapshot (n, 6): posed points and posed normals
    (estimated in the sensor frame, then rotated; the pt2pl residual does
    not see their sign), or zero normals."""
    pts = scan[:, :3]
    rot_t = pose[:3, :3].transpose(0, 1)
    world = pts @ rot_t + pose[:3, 3]
    if with_normals:
        nrm = estimate_normals_weighted(pts) @ rot_t
    else:
        nrm = torch.zeros_like(pts)
    return torch.cat([world, nrm], dim=1)


def rebuild_map(scans, poses: torch.Tensor, capacity: int, voxel: float,
                with_normals: bool = True, merge_mode: str = "mean") -> LocalMap:
    """Re-merge the stored scans at (refined) poses into a fresh map on the
    poses' device, the step that follows a refinement.  ``scans``: (n, >=3)
    arrays or tensors; the map starts as ``empty_map(capacity)`` (f32) and
    takes the wider dtype of what is merged into it, as in JAX."""
    device = poses.device
    m = empty_map(capacity, device=device)
    for k, s in enumerate(scans):
        pose = poses[k]
        pts = torch.as_tensor(s, device=device)[:, :3]
        dt = torch.promote_types(pts.dtype, pose.dtype)
        pts, pose = pts.to(dt), pose.to(dt)
        world = pts @ pose[:3, :3].transpose(0, 1) + pose[:3, 3]
        m = map_merge(m, world, voxel, with_normals=with_normals, mode=merge_mode)
    return m


def build_pose_graph(poses_front: torch.Tensor, closures: List[Closure],
                     closure_info: float = 10.0, converged=None,
                     nonconverged_info: float = 0.1) -> PoseGraph:
    """Odometry edges between consecutive front-end poses and one relative
    edge (anchor_idx -> scan_idx, measurement T_rel) per closure; vertex 0
    is gauge-fixed by the back end.

    ``converged`` (S,): the front end's own convergence flags.  An odometry
    edge k -> k+1 where either solve did not converge gets information
    ``nonconverged_info`` instead of 1, so that a brief tracking loss does
    not enter at full weight."""
    S = poses_front.shape[0]
    device = poses_front.device
    rel = se3.compose(se3.tran_inv(poses_front[:-1]), poses_front[1:])
    i_odo = np.arange(S - 1, dtype=np.int32)
    edges_i, edges_j, t_meas = [i_odo], [i_odo + 1], [rel]
    # the weights are f32 on the host, then cast, as JAX builds them
    w_odo = np.ones((S - 1,), np.float32)
    if converged is not None:
        conv = torch.as_tensor(converged).cpu().numpy().astype(bool)
        # edge k -> k+1 measures solve k+1 and rides on solve k's pose
        bad = ~conv[1:] | ~conv[:-1]
        w_odo = np.where(bad, np.float32(nonconverged_info), w_odo)
    info = [w_odo]
    for c in closures:
        edges_i.append(np.asarray([c.anchor_idx], np.int32))
        edges_j.append(np.asarray([c.scan_idx], np.int32))
        t_meas.append(c.T_rel[None].to(device))
        info.append(np.asarray([closure_info], np.float32))
    return PoseGraph(torch.as_tensor(np.concatenate(edges_i), device=device),
                     torch.as_tensor(np.concatenate(edges_j), device=device),
                     torch.cat(t_meas).to(poses_front.dtype),
                     torch.as_tensor(np.concatenate(info), device=device)
                     .to(poses_front.dtype))


def slam_odometry(
    scans: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    cfg: ICPConfig = ICPConfig(icp_type="pt2pl", differentiable=False,
                               collect_histories=False),
    capacity: int = 8192,
    voxel: float = 0.25,
    warm_start: bool = True,
    merge_mode: str = "mean",
    pred_alpha: float = 0.3,
    closure_cfg: Optional[ICPConfig] = None,
    anchor_every: int = 4,
    max_anchors: int = 64,
    closure_gap: int = 20,
    detect_every: int = 2,
    detect_radius: float = 5.0,
    accept_ratio: float = 0.5,
    max_closures: int = 16,
    closure_info: float = 10.0,
    refine_iterations: int = 10,
    irls_passes: int = 2,
    mesh=None,
    device=None,
) -> SlamResult:
    """Streaming SLAM over (points (n, >=3), weight (n,) or None) numpy pairs.

    The front end is :func:`mapping.scan_to_map_odometry`'s (EMA-damped
    prediction, a capacity-bounded sliding map).  Every ``anchor_every``-th
    scan becomes a keyframe snapshot (:func:`_make_anchor`).  Every
    ``detect_every``-th scan, if the predicted position lies within
    ``detect_radius`` of an anchor stored at least ``closure_gap`` scans
    before, the scan is registered against the nearest such anchor in two
    stages (:func:`_closure_solve`; ``closure_cfg``, by default ``cfg`` with
    4x its trim distance, is the coarse stage).  A closure is accepted when
    both stages converge and the tight matched ratio is at least
    ``accept_ratio``; it adds a relative edge of information
    ``closure_info``.  The graph is refined by :func:`refine_robust` when a
    closure was accepted.  Returns both trajectories; call
    :func:`rebuild_map` with the scans and the refined poses for the
    corrected map.

    Each scan crosses to ``device`` (default the card; ``"cpu"`` runs on the
    CPU) in one pinned copy, its host preparation in a prefetch thread.
    ``mesh``: refine over its ranks (:func:`refine_robust`); every rank runs
    the same stream."""
    if closure_cfg is None:
        closure_cfg = cfg.with_(trim_dist=cfg.trim_dist * 4.0)
    device = _resolve_device(device)
    upload = _Uploader(device, slots=4)
    with_normals = cfg.icp_type != "pt2pt"

    def prep(stream):
        for pts_np, w_np in stream:
            yield [np.asarray(pts_np)] + ([] if w_np is None else [np.asarray(w_np)])

    m = None
    poses, convs, iters = [], [], []
    closures: List[Closure] = []
    anchors: List[Tuple[int, torch.Tensor, torch.Tensor]] = []  # (j, snapshot, T_j)
    anchor_pos_np: List[np.ndarray] = []
    prev_pose = xi_ema = None
    for k, views in enumerate(map(upload, _prefetched(prep(scans)))):
        scan = views[0]
        w = views[1] if len(views) > 1 else None
        if m is None:
            dtype = scan.dtype
            # a one-shot shape: the seed merge runs uncaptured
            m = map_merge.fn(empty_map(capacity, dtype, device), scan[:, :3], voxel,
                             with_normals=with_normals, mode=merge_mode)
            pose = torch.eye(4, dtype=dtype, device=device)
            conv = torch.ones((), dtype=torch.bool, device=device)
            it = torch.zeros((), dtype=dtype, device=device)
            xi_ema = torch.zeros((6,), dtype=dtype, device=device)
        else:
            t_pred = se3.compose(prev_pose, se3.vec2tran(xi_ema)) if warm_start else prev_pose
            if k % detect_every == 0 and len(closures) < max_closures and anchors:
                p_pred = t_pred[:3, 3].cpu().numpy()            # the 3-float fetch
                best_j, best_d = -1, detect_radius
                for a_i, (j, _, _) in enumerate(anchors):
                    if j > k - closure_gap:
                        continue
                    d = float(np.linalg.norm(anchor_pos_np[a_i] - p_pred))
                    if d < best_d:
                        best_j, best_d = a_i, d
                if best_j >= 0:
                    j, tgt_a, t_a = anchors[best_j]
                    T_rel, c_ok, ratio = _closure_solve(tgt_a, t_a, scan, t_pred,
                                                        closure_cfg, cfg)
                    if bool(c_ok) and float(ratio) >= accept_ratio:
                        closures.append(Closure(j, k, T_rel, float(ratio)))
            pose, conv, it, m = map_step(m, scan, t_pred, w, cfg, voxel, insert=True,
                                         merge_mode=merge_mode)
            rel = se3.compose(se3.tran_inv(prev_pose), pose)
            xi_ema = (1.0 - pred_alpha) * xi_ema + pred_alpha * se3.tran2vec(rel)
        if k % anchor_every == 0 and len(anchors) < max_anchors:
            anchors.append((k, _make_anchor(scan, pose, with_normals), pose))
            anchor_pos_np.append(pose[:3, 3].cpu().numpy())     # the anchor's fetch
        poses.append(pose)
        convs.append(conv)
        iters.append(it.to(pose.dtype))
        prev_pose = pose
    if len(poses) < 2:
        raise ValueError("slam_odometry needs at least two scans")

    poses_front = torch.stack(poses)
    converged = torch.stack(convs)
    graph = build_pose_graph(poses_front, closures, closure_info, converged=converged)
    if closures:
        refined = refine_robust(poses_front, graph, mesh=mesh, iterations=refine_iterations,
                                irls_passes=irls_passes)
    else:
        refined = poses_front     # a chain without closures is already GN-optimal
    return SlamResult(poses_front=poses_front, poses=refined, closures=closures,
                      converged=converged, iterations=torch.stack(iters))


@functools.partial(jit, name="edge_residual_norms")
def _edge_residual_norms(poses: torch.Tensor, edges_i: torch.Tensor, edges_j: torch.Tensor,
                         t_meas: torch.Tensor) -> torch.Tensor:
    """(E,) se(3) residual norms of every edge at the given poses."""
    ti, tj = poses[edges_i.long()], poses[edges_j.long()]
    res = se3.tran2vec(se3.tran_inv(t_meas) @ se3.tran_inv(ti) @ tj)
    return torch.sqrt(torch.sum(res * res, dim=-1))


def refine_robust(poses: torch.Tensor, graph: PoseGraph, mesh=None, iterations: int = 10,
                  irls_passes: int = 2, delta_scale: float = 3.0) -> torch.Tensor:
    """Pose-graph refinement with Huber-IRLS edge reweighting.

    Each pass runs the GN solve, dense (:func:`odometry.pose_graph_optimize`)
    or, given ``mesh``, partitioned over its ``map`` axis
    (:func:`parallel.pose_graph.pose_graph_optimize_partitioned`), then
    scales every edge's information by the Huber weight
    min(1, delta / r) of its residual at the current solution, delta =
    ``delta_scale`` times the median residual norm (``jnp.median``'s: the
    mean of the two middle values).  Edges of a tracking loss that converged
    into a wrong basin are extreme outliers against the closure-consistent
    solution, and one reweighting removes their influence."""

    def solve(g):
        if mesh is not None:
            return pose_graph_optimize_partitioned(poses, g, mesh, iterations=iterations)
        return pose_graph_optimize(poses, g, iterations=iterations)[0]

    g = graph
    refined = solve(g)
    for _ in range(max(0, irls_passes - 1)):
        r = _edge_residual_norms(refined, g.edges_i, g.edges_j, g.t_meas)
        delta = delta_scale * _median(r)
        w = torch.clamp(delta / torch.clamp(r, min=1e-12), max=1.0)
        g = g._replace(info=graph.info * w.to(graph.info.dtype))
        refined = solve(g)
    return refined
