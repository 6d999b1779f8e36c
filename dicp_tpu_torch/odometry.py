"""Chained LiDAR odometry and pose-graph optimisation: the counterpart of
``dicp_tpu/odometry.py``.

* all consecutive scan pairs are registered in one batched
  :func:`registration.register` call (the cluster tier's K2 on the card for
  raw scans);
* pose composition along the chain is a log-depth prefix product
  (:func:`compose_chain`: ceil(log2 K) batched 4x4 matmuls, where JAX uses
  ``lax.associative_scan``);
* the pose-graph back end is Gauss-Newton on se(3) residuals
  log(T_meas^-1 T_i^-1 T_j) with ``torch.func.jacfwd`` Jacobians, a dense
  normal-equation build and an LU solve, a fixed number of iterations (JAX's
  ``lax.scan``).

As JAX jits them, :func:`odometry` and :func:`pose_graph_optimize` are thin
wrappers (the inputs to tensors on one device) around compiled programs
(:mod:`dicp_tpu_torch.jit`): ``_odometry_program`` (the batched solve, its
loop exiting on the device, then the prefix product) and
``_pose_graph_program`` (the unrolled GN iterations and the final cost).
On the card each is a captured CUDA graph per static arguments and input
shapes; on the CPU it runs eagerly.  :func:`odometry_pose_graph`'s loop
closures and :func:`resumable_odometry`'s chunks stay eager: their shapes are
one-shot.

Matmuls run in full f32 on the card (TF32 off, PyTorch's default): a deep
prefix chain would amplify TF32's truncation into visible pose drift.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.api import _as_tensor, _resolve_device
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.jit import jit
from dicp_tpu_torch.registration import _register_program, register
from dicp_tpu_torch.svd_icp import _kabsch
from dicp_tpu_torch.utils.checkpoint import load_odometry_state, save_odometry_state


class OdometryResult(NamedTuple):
    poses: torch.Tensor           # (S, 4, 4) world-from-scan_i (first = identity)
    rel_transforms: torch.Tensor  # (S-1, 4, 4) T_{i, i+1} scan-to-scan
    converged: torch.Tensor       # (S-1,) bool per pair
    iterations: torch.Tensor      # (S-1,)


def _tensors(device, *arrays):
    """Tensors keep their device; numpy inputs go to ``device`` (default the
    card, see :mod:`dicp_tpu_torch.api`)."""
    device = _resolve_device(device, *arrays)
    return [None if a is None else _as_tensor(a, device) for a in arrays]


def compose_chain(rel) -> torch.Tensor:
    """Prefix-compose relative transforms into absolute poses.

    rel (K, 4, 4) with rel[i] = T_{frame_i <- frame_{i+1}}; returns
    (K+1, 4, 4) absolute poses, pose[0] = I, pose[i+1] = pose[i] @ rel[i].
    A log-depth prefix (Hillis-Steele doubling): step d multiplies every
    prefix from d on by the one d before it, ceil(log2 K) batched matmuls.
    """
    (prefix,) = _tensors(None, rel)
    K = prefix.shape[0]
    d = 1
    while d < K:
        prefix = torch.cat([prefix[:d], se3.compose(prefix[:-d], prefix[d:])])
        d *= 2
    eye = torch.eye(4, dtype=prefix.dtype, device=prefix.device)[None]
    return torch.cat([eye, prefix], dim=0)


def _src_cols(cfg: ICPConfig) -> int:
    # symmetric ICP reads source normals: keep 6 columns for it
    return 6 if cfg.icp_type == "symmetric" else 3


def _eyes(count: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(count, 4, 4)


def odometry(scans, cfg: ICPConfig = ICPConfig(), rel_init=None,
             device=None) -> OdometryResult:
    """Scan-to-scan odometry over a sequence.

    scans (S, n, 3|6): consecutive clouds in their own frames (pt2pl needs
    normal columns).  Registers scan i+1 (source) against scan i (target)
    for all i in one batched solve, then prefix-composes.  On the card one
    captured program (``_odometry_program``).
    """
    scans, rel_init = _tensors(device, scans, rel_init)
    return _odometry_program(scans, rel_init, cfg)


@functools.partial(jit, static_argnames=("cfg",), name="odometry")
def _odometry_program(scans: torch.Tensor, rel_init: Optional[torch.Tensor],
                      cfg: ICPConfig) -> OdometryResult:
    S = scans.shape[0]
    source = scans[1:, :, :_src_cols(cfg)]
    target = scans[:-1]
    if rel_init is None:
        rel_init = _eyes(S - 1, scans)
    res = _register_program(source, target, rel_init, None, cfg)
    poses = compose_chain(res.T)
    return OdometryResult(poses=poses, rel_transforms=res.T,
                          converged=res.converged, iterations=res.iterations)


def ate(poses_pred, poses_true, align: bool = True) -> torch.Tensor:
    """Absolute trajectory error (RMSE over translations).

    With ``align=True`` the predicted trajectory is first rigidly aligned to
    the ground truth (closed-form Kabsch over the position sets), the
    standard ATE protocol.
    """
    poses_pred, poses_true = _tensors(None, poses_pred, poses_true)
    p = poses_pred[:, :3, 3]
    q = poses_true[:, :3, 3].to(p.dtype)
    if align:
        w = torch.ones((1, p.shape[0]), dtype=p.dtype, device=p.device)
        C, r = _kabsch(p[None], q[None], w)
        p = p @ C[0].T + r[0]
    return torch.sqrt(torch.mean(torch.sum((p - q) ** 2, dim=-1)))


class PoseGraph(NamedTuple):
    """Relative-pose graph: edge k constrains poses[i[k]], poses[j[k]] with
    measurement T_meas[k] ~ T_i^-1 T_j and scalar information weight."""
    edges_i: torch.Tensor  # (E,) int
    edges_j: torch.Tensor  # (E,) int
    t_meas: torch.Tensor   # (E, 4, 4)
    info: torch.Tensor     # (E,) weight per edge


def _edge_residual(t_i, t_j, t_meas):
    """se(3) residual log(T_meas^-1 · T_i^-1 · T_j): (6,)"""
    return se3.tran2vec(se3.tran_inv(t_meas) @ se3.tran_inv(t_i) @ t_j)


def edge_residual_and_jac(t_i, t_j, t_meas, dtype):
    """(residual (6,), J_i (6,6), J_j (6,6)) of one pose-graph edge with
    respect to right-multiplied se(3) perturbations of its endpoints, by
    forward-mode AD at zero.  One function for every pose-graph back end, so
    that their linearisations agree exactly."""
    # perturbations of shape (1, 6): forward-mode AD gives the tangent of a
    # 0-dim f32 tensor divided by a Python float the dtype f64, so no
    # intermediate may be 0-dim (per edge under vmap, the angles would be)
    def res_fn(xi_i, xi_j):
        return _edge_residual(t_i @ se3.vec2tran(xi_i),
                              t_j @ se3.vec2tran(xi_j), t_meas)

    zero = torch.zeros((1, 6), dtype=dtype, device=t_i.device)
    r = res_fn(zero, zero)
    J_i, J_j = torch.func.jacfwd(res_fn, argnums=(0, 1))(zero, zero)
    return r[0], J_i[0, :, 0], J_j[0, :, 0]


def pose_graph_optimize(poses, graph: PoseGraph, iterations: int = 10,
                        damping: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Gauss-Newton pose-graph optimisation.

    poses (V, 4, 4) initial guesses (pose 0 is gauge-fixed), graph edges with
    relative measurements.  The Jacobians of each edge come from
    :func:`edge_residual_and_jac`, vmapped over edges, and are assembled
    into dense (6V x 6V) normal equations.  Returns (optimised poses, final
    cost at the returned poses).  On the card one captured program
    (``_pose_graph_program``) per (V, E, iterations).
    """
    (poses,) = _tensors(None, poses)
    dtype, device = poses.dtype, poses.device
    edges_i = _as_tensor(graph.edges_i, device).to(device=device, dtype=torch.int64)
    edges_j = _as_tensor(graph.edges_j, device).to(device=device, dtype=torch.int64)
    t_meas = _as_tensor(graph.t_meas, device, dtype).to(device)
    info = _as_tensor(graph.info, device, dtype).to(device)
    return _pose_graph_program(poses, edges_i, edges_j, t_meas, info, iterations,
                               float(damping))


@functools.partial(jit, static_argnames=("iterations",), name="pose_graph_optimize")
def _pose_graph_program(poses: torch.Tensor, edges_i: torch.Tensor, edges_j: torch.Tensor,
                        t_meas: torch.Tensor, info: torch.Tensor, iterations: int,
                        damping: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-trip GN loop (JAX's ``lax.scan``) and the final cost, on
    (V, 4, 4) poses and the graph's int64 edges, (E, 4, 4) measurements and
    (E,) information in the poses' dtype."""
    V = poses.shape[0]
    dtype, device = poses.dtype, poses.device
    batched_rj = torch.func.vmap(
        lambda ti, tj, tm: edge_residual_and_jac(ti, tj, tm, dtype))

    # gauge fix of pose 0: its rows and columns are replaced by the
    # identity so that delta_0 = 0 (a large prior would square the
    # condition number and break float32); the mask is built on the device
    m = (torch.arange(V * 6, device=device) < 6).to(dtype)
    keep = 1.0 - m
    eye = torch.eye(V * 6, dtype=dtype, device=device)
    w = info[:, None, None]
    for _ in range(iterations):
        r, J_i, J_j = batched_rj(poses[edges_i], poses[edges_j], t_meas)
        # H[rows[e], cols[e]] += blk[e] in edge order: an accumulating
        # index_put_ adds duplicates in order on the CPU and, by its sorted
        # kernel, on the card, so every call gives the same bits
        H = torch.zeros((V, V, 6, 6), dtype=dtype, device=device)
        b = torch.zeros((V, 6), dtype=dtype, device=device)
        for rows, J_row, J_col, cols in ((edges_i, J_i, J_i, edges_i),
                                         (edges_i, J_i, J_j, edges_j),
                                         (edges_j, J_j, J_i, edges_i),
                                         (edges_j, J_j, J_j, edges_j)):
            H.index_put_((rows, cols), torch.einsum("eab,eac->ebc", J_row * w, J_col),
                         accumulate=True)
        b.index_put_((edges_i,), torch.einsum("eab,ea->eb", J_i * w, r), accumulate=True)
        b.index_put_((edges_j,), torch.einsum("eab,ea->eb", J_j * w, r), accumulate=True)

        Hd = H.permute(0, 2, 1, 3).reshape(V * 6, V * 6) + damping * eye
        Hd = Hd * keep[:, None] * keep[None, :] + torch.diag(m)
        bd = b.reshape(V * 6) * keep
        # solve_ex: linalg.solve's LU without its host check of ``info``
        delta = -torch.linalg.solve_ex(Hd, bd, check_errors=False)[0].reshape(V, 6)
        poses = poses @ se3.vec2tran(delta)

    # the final cost evaluated at the returned poses
    r_fin, _, _ = batched_rj(poses[edges_i], poses[edges_j], t_meas)
    cost = torch.sum(info * torch.sum(r_fin * r_fin, dim=-1))
    return poses, cost


def odometry_pose_graph(scans, cfg: ICPConfig = ICPConfig(),
                        loop_closures=None, pg_iterations: int = 10,
                        device=None) -> OdometryResult:
    """Odometry + optional loop-closure pose-graph refinement.

    loop_closures: (idx_i (L,), idx_j (L,)) pairs of scan indices to register
    against each other as extra pose-graph edges.
    """
    (scans,) = _tensors(device, scans)
    odo = odometry(scans, cfg)
    S = scans.shape[0]
    i_odo = torch.arange(S - 1, dtype=torch.int64, device=scans.device)
    edges_i, edges_j = i_odo, i_odo + 1
    t_meas = odo.rel_transforms
    info = torch.ones((S - 1,), dtype=scans.dtype, device=scans.device)

    if loop_closures is not None:
        li, lj = (_as_tensor(x, scans.device).to(device=scans.device, dtype=torch.int64)
                  for x in loop_closures)
        # a one-shot solve (L changes per call): eager, as a capture would
        # cost a second solve and hold its pools without a replay
        res = register(scans[lj][:, :, :_src_cols(cfg)], scans[li],
                       _eyes(li.shape[0], scans), None, cfg=cfg)
        edges_i = torch.cat([edges_i, li])
        edges_j = torch.cat([edges_j, lj])
        t_meas = torch.cat([t_meas, res.T])
        info = torch.cat([info, torch.ones((li.shape[0],), dtype=scans.dtype,
                                           device=scans.device)])

    graph = PoseGraph(edges_i, edges_j, t_meas, info)
    poses, _ = pose_graph_optimize(odo.poses, graph, iterations=pg_iterations)
    return odo._replace(poses=poses)


def resumable_odometry(scans, cfg: ICPConfig = ICPConfig(),
                       checkpoint_path: Optional[str] = None, chunk: int = 64,
                       device=None) -> OdometryResult:
    """Odometry over a long sequence with checkpoint/resume.

    Registers consecutive pairs in ``chunk``-sized batched solves and
    atomically checkpoints the accumulated relative transforms after each
    chunk.  If ``checkpoint_path`` exists, completed chunks are skipped: a
    killed run resumes where it left off and produces the same trajectory.
    """
    (scans,) = _tensors(device, scans)
    S = scans.shape[0]
    n_pairs = S - 1
    host_dtype = torch.empty((0,), dtype=scans.dtype).numpy().dtype
    done = 0
    rels = np.zeros((n_pairs, 4, 4), host_dtype)
    conv = np.zeros((n_pairs,), bool)
    iters = np.zeros((n_pairs,), host_dtype)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = load_odometry_state(checkpoint_path)
        done = int(state["step"])
        rels[:done] = state["rel_transforms"][:done]
        conv[:done] = state["converged"][:done]
        iters[:done] = state["iterations"][:done]

    def on_device(a):
        return torch.as_tensor(a, device=scans.device)

    while done < n_pairs:
        hi = min(done + chunk, n_pairs)
        # sources are scans[done+1 : hi+1], targets scans[done : hi]
        # eager: the tail chunk's shape is one-shot, and a chunk's solve is
        # fetched to the host at once
        res = register(scans[done + 1:hi + 1, :, :_src_cols(cfg)], scans[done:hi],
                       _eyes(hi - done, scans), None, cfg=cfg)
        rels[done:hi] = res.T.detach().cpu().numpy()
        conv[done:hi] = res.converged.cpu().numpy()
        iters[done:hi] = res.iterations.cpu().numpy()
        done = hi
        if checkpoint_path is not None:
            save_odometry_state(checkpoint_path, poses=compose_chain(on_device(rels[:done])),
                                rel_transforms=rels, step=done,
                                converged=conv, iterations=iters)

    rel = on_device(rels)
    return OdometryResult(poses=compose_chain(rel), rel_transforms=rel,
                          converged=on_device(conv), iterations=on_device(iters))
