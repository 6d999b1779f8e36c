"""Implicit-function-theorem gradients for the map-sharded solver: the
counterpart of ``dicp_tpu/parallel/ift_sharded.py``.

The single-pair IFT (:mod:`dicp_tpu_torch.ift`) replaces the unrolled
backward with one k x k solve at the fixed point.  For the SPMD map-sharded
solver (:func:`parallel.sharding.register_map_sharded`) the stationarity
condition is a sum over ranks,

    G(theta*) = sum_ranks G_local(theta*) = J^T W e = 0,

so dG/dtheta is the all-reduced sum of the local Jacobians (k JVPs, one
(k, k) all-reduce) and the input cotangents are -lambda^T dG_local/dx (local
VJPs; the replicated target's cotangent is all-reduced, as JAX's shard_map
autodiff sums it).  The backward adds a CONSTANT number of collectives, never
one per iteration: the (k, k) all-reduce, the target's, the source's and the
weight's (``_comm.replicated``), and the certificate gate's count on the
cluster tier.

Weighting matches the sharded solver: prior, trim and loss weights apply
LINEARLY, not through the single-pair driver's sqrt(w + 1e-10) - 1e-5 row
scaling, so this G is not ``ift``'s and each IFT linearises its own solver.
"""

from __future__ import annotations

import torch
from torch.func import jvp, vjp, vmap

from dicp_tpu_torch import knn, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops import tiled_knn
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn, query_order
from dicp_tpu_torch.parallel._comm import psum
from dicp_tpu_torch.parallel.sharding import (MapShardedResult, _axis, _global_inputs,
                                              _linearize, _map_sharded_solve, _pad_rows)
from dicp_tpu_torch.registration import _certified_gate, _damping


def _xi_embed(cfg: ICPConfig, xi):
    """(k,) update -> (6,) [omega, rho] (dim 2 optimizes slots 2:5)."""
    if cfg.dim == 2:
        z = xi.new_zeros((1,))
        return torch.cat([z, z, xi, z])
    return xi


def _retract(cfg: ICPConfig, xi, C_star, r_star):
    """(C, r) at theta* [+] xi, the solver's retraction.  The rotation takes
    a (1, 3) vector: forward-mode AD gives the tangent of a 0-dim f32 tensor
    divided by a Python float the dtype f64 (``odometry.edge_residual_and_jac``)."""
    xi6 = _xi_embed(cfg, xi)
    return se3.exp_so3(xi6[None, :3])[0].T @ C_star, r_star - xi6[3:]


def _stationarity_local(cfg: ICPConfig, xi, C_star, r_star, src_s, tgt, idx, w_prior):
    """This rank's stationarity term G_local(xi) = J^T W e (k,): the sharded
    GN step's terms (``sharding._linearize``, smooth weights) with the
    correspondences ``idx`` FIXED at theta* (hard-NN semantics)."""
    C, r = _retract(cfg, xi, C_star, r_star)
    cp = src_s[:, :3] @ C.T
    src_nrm = src_s[:, 3:6] if cfg.icp_type == "symmetric" else None
    J, res, w = _linearize(cfg, C, cp, cp + r, src_nrm, tgt[idx], w_prior, True)
    return J.T @ (w * res)


def _local_nn_idx(cfg: ICPConfig, ps_t, tgt, group=None, ps_init=None):
    """Correspondence indices at theta* and the certificate gate (None for
    the exact tiers), by the sharded forward's tier routing, except that the
    tiled tier runs its kernel (K1) here where the forward demotes it to
    dense, as in JAX.  The cluster tier searches with the group scan
    (``fused=False``, as JAX pins it in this backward; its selections are
    K2's) in the forward's query order, taken at the initial source points
    ``ps_init``, and gates on the GLOBAL certified fraction over ``group``.
    JAX re-sorts the queries at theta*: other blocks select other groups,
    and the certificates, and with them the gated stationarity, are not the
    forward's (at 100,000 points the gradient's cosine with the unrolled one
    fell from 0.995 to 0.954)."""
    method = cfg.resolved_nn_method(ps_t.shape[0], tgt.shape[0], ps_t.device)
    tgt_pts = tgt[:, :3].detach()
    q = ps_t.detach()
    if method == "cluster":
        index = build_cluster_index(tgt_pts, cfg.cluster_group)
        order = None if ps_init is None else query_order(index, ps_init.detach())
        idx, _, cert = cluster_nn(index, q, probes=cfg.cluster_probes, use_pallas=False,
                                  fused=False, order=order,
                                  fixup=cfg.resolved_cluster_fixup(q.shape[0]))
        return idx.long(), _certified_gate(cert, q.dtype, group=group)
    if method == "pallas":
        return tiled_knn.nn_indices(q, tgt_pts).long(), None
    return knn.nn_indices(q, tgt_pts).long(), None


def _pose_vjp_xi_bar(cfg: ICPConfig, T_star, T_bar):
    """Cotangent on xi (at xi = 0) from the cotangent on T, through the
    retraction T(xi) = [exp(omega)^T C* | r* - rho]."""
    k = 3 if cfg.dim == 2 else 6
    C_star, r_star = T_star[:3, :3], T_star[:3, 3]

    def pose(xi):
        return se3._homogeneous(*_retract(cfg, xi, C_star, r_star))

    _, pose_vjp = vjp(pose, T_star.new_zeros((k,)))
    return pose_vjp(T_bar)[0]


class _ShardedFixedPoint(torch.autograd.Function):
    """(T, converged, iterations, cost) of one early-exit map-sharded solve
    from this rank's (source rows, weight rows), the target and T_init; only
    T carries a gradient, and the backward is the IFT adjoint."""

    @staticmethod
    def forward(ctx, cfg, group, src, w, tgt, t_init):
        # smooth weight forms (the backward linearises the smooth
        # stationarity), the early-exit loop, no gradient through it
        with torch.no_grad():
            T, done, it, cost = _map_sharded_solve(
                cfg.with_(differentiable=True, driver="while"), src, w, tgt, t_init, group)
        ctx.cfg, ctx.group = cfg, group
        ctx.save_for_backward(src, w, tgt, t_init, T)
        ctx.mark_non_differentiable(done, it, cost)
        return T, done, it, cost

    @staticmethod
    def backward(ctx, T_bar, *_):
        cfg, group = ctx.cfg, ctx.group
        src, w, tgt, t_init, T_star = ctx.saved_tensors
        dtype = src.dtype
        k = 3 if cfg.dim == 2 else 6
        xi_bar = _pose_vjp_xi_bar(cfg, T_star, T_bar)
        C_star, r_star = T_star[:3, :3], T_star[:3, 3]
        with torch.no_grad():
            idx, gate = _local_nn_idx(cfg, src[:, :3] @ C_star.T + r_star, tgt, group,
                                      src[:, :3] @ t_init[:3, :3].T + t_init[:3, 3])

        def G_loc(xi, s, t, wp):
            # the forward gated the weights by the certificate: gating inside
            # G keeps d/dwp consistent
            return _stationarity_local(cfg, xi, C_star, r_star, s, t, idx,
                                       wp if gate is None else wp * gate)

        zero = src.new_zeros((k,))
        basis = torch.eye(k, dtype=dtype, device=src.device)
        cols = vmap(lambda t: jvp(lambda xi: G_loc(xi, src, tgt, w), (zero,), (t,))[1])(basis)
        A = psum(cols.T, group)                       # A[i, j] = dG_i / dxi_j
        A = A + _damping(cfg, A[None], use_abs=True)[0] * torch.eye(k, dtype=dtype,
                                                                    device=src.device)
        lam = torch.linalg.solve(A.T, xi_bar[:, None])[:, 0]
        _, g_vjp = vjp(lambda s, t, wp: G_loc(zero, s, t, wp), src, tgt, w)
        src_bar, tgt_bar, w_bar = g_vjp(-lam)
        # every rank uses the target whole: its cotangent is the group's sum
        # (every rank asks for it or none does); the fixed point forgets its
        # initialisation
        if ctx.needs_input_grad[4]:
            tgt_bar = psum(tgt_bar, group)
        return None, None, src_bar, w_bar, tgt_bar, torch.zeros_like(T_star)


def register_map_sharded_ift(
    mesh,
    source,
    target,
    T_init=None,
    weight=None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Map-sharded registration with implicit fixed-point gradients.

    The forward of :func:`~dicp_tpu_torch.parallel.sharding.register_map_sharded`
    (the early-exit loop, smooth weights; as in JAX, without its input rules
    and pad exclusion); a gradient through the returned ``T`` costs one k x k
    solve and one stationarity VJP instead of the unrolled loop.  Requires
    convergence for exactness (check ``.converged``)."""
    if cfg.use_gumbel:
        raise ValueError("IFT gradients require hard (deterministic) NN")
    group, rank, n_dev = _axis(mesh, axis)
    source, target, T_init, weight = _global_inputs(mesh, axis, cfg, source, target, T_init,
                                                    weight)
    n = source.shape[0]
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    pad = (-n) % n_dev
    source, weight = _pad_rows(source, pad), _pad_rows(weight, pad)
    n_loc = (n + pad) // n_dev
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    return MapShardedResult(*_ShardedFixedPoint.apply(
        cfg, group, source[rows, :src_cols], weight[rows], target, T_init))
