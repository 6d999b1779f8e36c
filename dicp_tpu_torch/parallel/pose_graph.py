"""Multi-rank pose-graph optimisation by keyframe partitioning and
Schur-complement reduction: the counterpart of
``dicp_tpu/parallel/pose_graph.py``.

The dense back end (:func:`dicp_tpu_torch.odometry.pose_graph_optimize`)
solves the full (6V, 6V) normal equations on one device.  Here one
Gauss-Newton step is spread over the ``axis`` mesh axis:

1. **Partition** (host, :func:`partition_graph`, a numpy copy of JAX's): the
   V keyframes split contiguously over the ranks.  Poses incident to any
   cross-partition edge become *separators* (replicated); the rest are
   *interiors*, each owned by one rank.
2. **Local elimination**: each rank assembles the normal-equation blocks of
   its own edges and eliminates its interiors with one local dense solve,
   X = H_II^-1 [H_IS | b_I].
3. **Schur reduction**: the ranks' separator systems S_k = H_SS^k - H_SI X
   and rhs_k = b_S^k - H_SI x_b travel in ONE all-reduce per GN step.
4. **Back-substitution**: every rank solves the reduced separator system and
   recovers its interior updates; the (V, 6) update is reassembled with one
   more all-reduce (the interiors are disjoint, so the sum concatenates).

With identical damping this is exact block elimination of the damped dense
system, except that the separator diagonal receives K copies of the
Tikhonov term (K * damping), as in JAX.  The edges are linearised by
:func:`odometry.edge_residual_and_jac`, as the dense back end's are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.api import _as_tensor
from dicp_tpu_torch.odometry import PoseGraph, edge_residual_and_jac
from dicp_tpu_torch.parallel._comm import psum, psum_many
from dicp_tpu_torch.parallel.sharding import _axis


class Partition(NamedTuple):
    """Host-side partitioning artifacts (numpy, static shapes)."""
    int_ids: np.ndarray    # (K, I_max) global pose id per local interior, -1 pad
    sep_ids: np.ndarray    # (S,) global pose ids of separators (replicated)
    eg_i: np.ndarray       # (K, E_max) global pose id of edge endpoint i (0 pad)
    eg_j: np.ndarray       # (K, E_max)
    loc_i: np.ndarray      # (K, E_max) unified local index in [0, I_max + S)
    loc_j: np.ndarray      # (K, E_max)
    e_idx: np.ndarray      # (K, E_max) index into the global edge list (0 pad)
    e_valid: np.ndarray    # (K, E_max) 1.0 for real edges, 0.0 for padding
    gauge_dev: int         # rank whose interior block holds pose 0, or -1
    gauge_loc: int         # local interior slot of pose 0 (interior case)
    gauge_sep: int         # separator index of pose 0, or -1


def partition_graph(n_poses: int, edges_i: np.ndarray, edges_j: np.ndarray,
                    n_parts: int) -> Partition:
    """Contiguous keyframe partition and separator extraction (host-side)."""
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    part = np.minimum(np.arange(n_poses) * n_parts // n_poses, n_parts - 1)

    cross = part[edges_i] != part[edges_j]
    is_sep = np.zeros(n_poses, bool)
    is_sep[edges_i[cross]] = True
    is_sep[edges_j[cross]] = True
    sep_ids = np.flatnonzero(is_sep)
    if sep_ids.size == 0:
        # keep the separator system non-empty (degenerate: no cross edges)
        sep_ids = np.array([n_poses - 1])
        is_sep[n_poses - 1] = True
    S = sep_ids.size
    sep_index = -np.ones(n_poses, np.int64)
    sep_index[sep_ids] = np.arange(S)

    interiors = [np.flatnonzero((part == k) & ~is_sep) for k in range(n_parts)]
    I_max = max(1, max(len(ii) for ii in interiors))
    int_ids = -np.ones((n_parts, I_max), np.int32)
    int_index = -np.ones(n_poses, np.int64)   # local interior slot of each pose
    for k, ii in enumerate(interiors):
        int_ids[k, :len(ii)] = ii
        int_index[ii] = np.arange(len(ii))

    # each edge goes to the part owning its interior endpoint(s); edges
    # between two separators go to the part of endpoint i
    e_part = np.where(~is_sep[edges_i], part[edges_i],
                      np.where(~is_sep[edges_j], part[edges_j], part[edges_i]))
    per_part = [np.flatnonzero(e_part == k) for k in range(n_parts)]
    E_max = max(1, max(len(ee) for ee in per_part))

    eg_i = np.zeros((n_parts, E_max), np.int32)
    eg_j = np.zeros((n_parts, E_max), np.int32)
    # padding rows scatter into separator slot 0 with zero weight
    loc_i = np.full((n_parts, E_max), I_max, np.int32)
    loc_j = np.full((n_parts, E_max), I_max, np.int32)
    e_idx = np.zeros((n_parts, E_max), np.int32)
    e_valid = np.zeros((n_parts, E_max), np.float64)

    def unified(pose, k):
        # interiors -> [0, I_max); separators -> [I_max, I_max + S)
        if is_sep[pose]:
            return I_max + sep_index[pose]
        if part[pose] != k:
            raise AssertionError("edge assigned to a part not owning its interior")
        return int_index[pose]

    for k, ee in enumerate(per_part):
        for s, e in enumerate(ee):
            eg_i[k, s] = edges_i[e]
            eg_j[k, s] = edges_j[e]
            loc_i[k, s] = unified(edges_i[e], k)
            loc_j[k, s] = unified(edges_j[e], k)
            e_idx[k, s] = e
            e_valid[k, s] = 1.0

    if is_sep[0]:
        gauge_dev, gauge_loc, gauge_sep = -1, -1, int(sep_index[0])
    else:
        gauge_dev, gauge_loc, gauge_sep = int(part[0]), int(int_index[0]), -1

    return Partition(int_ids, sep_ids.astype(np.int32), eg_i, eg_j,
                     loc_i, loc_j, e_idx, e_valid,
                     gauge_dev, gauge_loc, gauge_sep)


def pose_graph_optimize_partitioned(
    poses,
    graph: PoseGraph,
    mesh,
    iterations: int = 10,
    damping: float = 1e-6,
    axis: str = "map",
) -> torch.Tensor:
    """Distributed Gauss-Newton pose-graph solve over the ``axis`` mesh axis.

    Every rank passes the whole graph and takes its own part of the
    partition.  Returns the optimised poses (V, 4, 4), the same on every
    rank.  Matches :func:`dicp_tpu_torch.odometry.pose_graph_optimize` (pose
    0 gauge-fixed, the same damping up to the K-fold separator-diagonal
    term)."""
    group, rank, K = _axis(mesh, axis)
    poses = torch.as_tensor(poses)
    dtype, device = poses.dtype, poses.device
    V = poses.shape[0]

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    part = partition_graph(V, host(graph.edges_i), host(graph.edges_j), K)
    I_max = part.int_ids.shape[1]
    S = part.sep_ids.shape[0]
    L, nI, nS = I_max + S, I_max * 6, S * 6

    def local(a, dt=torch.int64):
        return torch.as_tensor(a[rank], device=device).to(dt)

    e_idx = local(part.e_idx)
    t_meas = _as_tensor(graph.t_meas, device, dtype).to(device)[e_idx]
    w_edge = (_as_tensor(graph.info, device, dtype).to(device)[e_idx]
              * local(part.e_valid, dtype))[:, None, None]
    eg_i, eg_j = local(part.eg_i), local(part.eg_j)
    loc_i, loc_j = local(part.loc_i), local(part.loc_j)
    int_ids = local(part.int_ids)
    sep_ids = torch.as_tensor(part.sep_ids, device=device).long()
    # gauge fix of pose 0 by exact row/column elimination (identity block,
    # zero rhs), in this rank's interiors or, after the reduction, among the
    # separators; damping everywhere makes padded interior blocks damping * I
    m = torch.zeros((L * 6,), dtype=dtype, device=device)
    if part.gauge_dev == rank:
        m[part.gauge_loc * 6:(part.gauge_loc + 1) * 6] = 1.0
    keep = 1.0 - m
    ms = torch.zeros((nS,), dtype=dtype, device=device)
    if part.gauge_sep >= 0:
        ms[part.gauge_sep * 6:(part.gauge_sep + 1) * 6] = 1.0
    eye = torch.eye(L * 6, dtype=dtype, device=device)

    batched_rj = torch.func.vmap(lambda ti, tj, tm: edge_residual_and_jac(ti, tj, tm, dtype))
    for _ in range(iterations):
        r, J_i, J_j = batched_rj(poses[eg_i], poses[eg_j], t_meas)
        # H[rows[e], cols[e]] += blk[e] in edge order (index_put_ adds
        # duplicates in order), in JAX's order of the four blocks
        H = torch.zeros((L, L, 6, 6), dtype=dtype, device=device)
        b = torch.zeros((L, 6), dtype=dtype, device=device)
        for rows, J_r in ((loc_i, J_i), (loc_j, J_j)):
            for cols, J_c in ((loc_i, J_i), (loc_j, J_j)):
                H.index_put_((rows, cols), torch.einsum("eab,eac->ebc", J_r * w_edge, J_c),
                             accumulate=True)
            b.index_put_((rows,), torch.einsum("eab,ea->eb", J_r * w_edge, r), accumulate=True)

        Hd = H.permute(0, 2, 1, 3).reshape(L * 6, L * 6) + damping * eye
        Hd = Hd * keep[:, None] * keep[None, :] + torch.diag(m)
        bv = b.reshape(-1) * keep
        H_II, H_IS, H_SS = Hd[:nI, :nI], Hd[:nI, nI:], Hd[nI:, nI:]
        b_I, b_S = bv[:nI], bv[nI:]

        # local elimination of the interiors
        X = torch.linalg.solve(H_II, torch.cat([H_IS, b_I[:, None]], dim=1))
        X_IS, x_b = X[:, :nS], X[:, nS]

        # the Schur-reduced separator system: one all-reduce
        S_red, rhs_red = psum_many([H_SS - H_IS.T @ X_IS, b_S - H_IS.T @ x_b], group)
        if part.gauge_sep >= 0:
            S_red = S_red * (1.0 - ms)[:, None] * (1.0 - ms)[None, :] + torch.diag(ms)
            rhs_red = rhs_red * (1.0 - ms)
        d_S = -torch.linalg.solve(S_red, rhs_red[:, None])[:, 0]
        d_I = -(x_b + X_IS @ d_S)

        # the (V, 6) update: interiors are disjoint across ranks (the sum
        # concatenates); separators are the same on every rank, added once
        upd = torch.zeros((V, 6), dtype=dtype, device=device)
        valid = (int_ids >= 0)[:, None]
        upd.index_put_((torch.clamp(int_ids, 0, V - 1),),
                       torch.where(valid, d_I.reshape(I_max, 6), 0.0), accumulate=True)
        upd = psum(upd, group)
        upd = upd.index_put((sep_ids,), d_S.reshape(S, 6), accumulate=True)
        poses = poses @ se3.vec2tran(upd)
    return poses
