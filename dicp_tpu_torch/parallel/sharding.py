"""Multi-rank registration over a ``torch.distributed`` device mesh: the
counterpart of ``dicp_tpu/parallel/sharding.py``.

The code is SPMD, as JAX's ``shard_map`` bodies are: every rank calls the
same function with the same global arguments, takes its own rows by its
coordinate on a mesh axis (``mesh.get_local_rank(axis)``) and runs the
collectives of :mod:`dicp_tpu_torch.parallel._comm` on that axis's group
(``mesh.get_group(axis)``).  The mesh is a ``DeviceMesh`` with the dims
``("batch", "map")``, where JAX has a ``jax.sharding.Mesh``.

* **batch parallelism**: scan pairs split over the ``batch`` axis; each rank
  solves its own rows with :func:`registration.register` and returns their
  ``ICPResult``, the counterpart of the addressable shard of JAX's
  batch-sharded output.  No collective at all.
* **point-level parallelism**: the source points of one large registration
  split over the ``map`` axis.  Each rank finds correspondences for its
  points against the replicated target and forms its partial normal
  equations; the ONLY collective per Gauss-Newton step is one all-reduce of
  the (k, k) block, the (k,) vector and the cost (43 elements at k = 6,
  twice that plus one with the cluster certificate gate).
* **ring**: the target split too; correspondences from :func:`ring_nn`,
  whose target shards travel around the ring (send/recv), whose backward
  sends the rows' cotangents back around it (JAX's transpose of
  ``ppermute``), and whose double backward gathers them forward again.

Programs.  :func:`map_sharded_fn` is the counterpart of JAX's jitted
``shard_map``: a program of :mod:`dicp_tpu_torch.jit` per (mesh, cfg, axis,
target_sharded, n_real), captured on the card with its collectives inside.
CUDA refuses NCCL's kernels in a conditional node's body, so the captured
loop is a fixed trip (JAX's scan driver, :mod:`dicp_tpu_torch.fixed_trip`)
whose steps are split at their all-reduce: the local terms and the update
are run-once nodes, skipped past the exit, and the all-reduce between them
runs in every step; every rank reads the same all-reduced step norm, so the
ranks' steps and collectives pair up.  Autograd records the trip where an
input requires grad, so a call that differentiates runs jit's program pair
(or is part of a program that calls ``torch.autograd.grad``): the
counterpart of ``jax.jit(jax.grad(f))`` over the scan driver.
``register_batch_sharded`` runs ``register_jit`` on its rows.

Gradients.  A global input that each rank slices or uses whole goes through
``_comm.replicated`` (the backward sums the ranks' partial cotangents), and
so does the pose where each iteration's local terms consume it: the
counterpart of JAX's implicit broadcast of an unvarying value into a varying
computation, whose transpose is a psum.  ``_comm.psum`` passes cotangents
through.  Every rank then holds JAX's gradient of the global arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dicp_tpu_torch import fixed_trip, knn, losses, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.jit import capturing, jit
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn, query_order
from dicp_tpu_torch.ops.smallsolve import solve_spd
from dicp_tpu_torch.parallel._comm import psum, replicated, ring_shift
from dicp_tpu_torch.registration import ICPResult, _damping, _register_captured, _zmask


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("batch", "map"),
              devices=None) -> DeviceMesh:
    """A 2-D mesh over the ranks of the default process group.  Default: all
    ranks on the batch axis.

    ``devices``: None (the card) or ``"cpu"``.  With no process group
    initialized, a world of one is initialized here, NCCL on the card and
    gloo on the CPU (``parallel.multihost.initialize_distributed`` joins
    several processes).  ``shape`` must multiply to the world size."""
    device_type = "cuda" if devices is None else torch.device(devices).type
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh builds a mesh on the card by default, and no CUDA "
                               "device is available: pass devices='cpu'")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def _axis(mesh: DeviceMesh, axis: str):
    """(process group, this rank's coordinate, size) of a mesh axis."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh: DeviceMesh, *arrays, axis: str = "batch"):
    """This rank's rows of each array's leading (batch) dim on ``axis``, on
    the mesh's device."""
    _, rank, size = _axis(mesh, axis)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % size:
            raise ValueError(f"batch {a.shape[0]} not divisible by mesh axis {size}")
        per = a.shape[0] // size
        out.append(a[rank * per:(rank + 1) * per].to(_device(mesh)))
    return tuple(out)


def register_batch_sharded(
    mesh: DeviceMesh,
    source,
    target,
    T_init,
    weight=None,
    cfg: ICPConfig = ICPConfig(),
    key=None,
) -> ICPResult:
    """Batch-data-parallel registration: N scan pairs split over 'batch'.

    Each rank runs ``register_jit`` (JAX: ``jax.jit(register)``) on its own
    rows and returns their ``ICPResult`` (a world of one returns every
    row); no collective.  N must be divisible by the batch axis size.
    Gumbel noise streams are named by global batch index (the rank's first
    row is a static of its program), so the rows equal an unsharded solve."""
    _, rank, n_batch = _axis(mesh, "batch")
    if source.shape[0] % n_batch != 0:
        raise ValueError(f"batch {source.shape[0]} not divisible by mesh axis {n_batch}")
    arrays = shard_batch(mesh, source, target, T_init,
                         *(() if weight is None else (weight,)))
    src, tgt, ti = arrays[:3]
    return _register_captured(src, tgt, ti, arrays[3] if weight is not None else None, cfg,
                              key, pair_offset=rank * (source.shape[0] // n_batch))


class MapShardedResult(NamedTuple):
    """Result of a map-sharded single-cloud registration."""
    T: torch.Tensor           # (4, 4)
    converged: torch.Tensor   # () bool
    iterations: torch.Tensor  # () int32
    cost: torch.Tensor        # () final weighted squared cost


def _ring_fold(x, y_cur, step: int, best_d, best_row, won_at, won_row) -> None:
    """Fold the visiting shard ``y_cur`` (the ring's ``step``) into the
    running (best distance, best row) of the queries ``x``, in place, and
    note for each query whose row it replaces the step and the row's local
    index (int32): where the backward sends that row's cotangent."""
    with torch.no_grad():
        d2 = knn.pairwise_sq_dist(x, y_cur[:, :3])
        idx = torch.argmin(d2, dim=-1)
        dmin = torch.gather(d2, 1, idx[:, None])[:, 0]
        better = dmin < best_d
        best_d.copy_(torch.where(better, dmin, best_d))
        best_row.copy_(torch.where(better[:, None], y_cur[idx], best_row))
        won_at.masked_fill_(better, step)
        won_row.copy_(torch.where(better, idx.to(torch.int32), won_row))


def _unfold(buf, grad, won_at, won_row, step: int) -> None:
    """Add the cotangents of the rows found at the ring's ``step`` into
    ``buf`` (m_loc + 1, c) at their local indices; the other queries' go to
    the last row, which is no row of the shard."""
    with torch.no_grad():
        rows = torch.where(won_at == step, won_row, buf.shape[0] - 1).long()
        buf.index_put_((rows,), grad, accumulate=True)


def _refold(out, shard, won_at, won_row, step: int) -> None:
    """The transpose of :func:`_unfold`: the queries whose row was found at
    the ring's ``step`` take that row of ``shard`` (the visiting (m_loc, c)
    cotangent), in place in ``out`` (n, c)."""
    with torch.no_grad():
        out.copy_(torch.where((won_at == step)[:, None], shard[won_row.long()], out))


class _Ring(torch.autograd.Function):
    """The rows that :func:`ring_nn` finds, differentiable in the target
    shard: the one description of the ring that the eager call, the host
    loop and the captured trip share.

    The forward folds each visiting shard (:func:`_ring_fold`) and shifts it
    on (K - 1 shifts on K ranks), saving for each query the step at which
    its final row was found and that row's local index.  The backward is the
    transpose of JAX's ring, :class:`_RingScatter`.  The queries get none
    (the rows come from an argmin), as in JAX.

    ``run``: None, or a 0-dim bool under which each fold and each step's
    additions are run-once nodes (:func:`fixed_trip.when`), skipped where it
    does not hold: the rows are then zeros, no query has won, and the step
    adds nothing.  The shifts run in any case, forward and backward (CUDA
    refuses NCCL's kernels in a conditional node's body), so the ranks'
    collectives pair up."""

    @staticmethod
    def forward(ctx, x, y_shard, group, run):
        k_dev = dist.get_world_size(group)
        n, device = x.shape[0], x.device
        x, y_cur = x.detach(), y_shard.detach()
        best_d = torch.full((n,), torch.inf, dtype=x.dtype, device=device)
        best_row = y_cur.new_zeros((n, y_cur.shape[1]))
        won_at = torch.full((n,), -1, dtype=torch.int32, device=device)
        won_row = torch.zeros((n,), dtype=torch.int32, device=device)
        for step in range(k_dev):
            fixed_trip.when(run, functools.partial(_ring_fold, x, y_cur, step, best_d,
                                                   best_row, won_at, won_row))
            if step + 1 < k_dev:
                y_cur = ring_shift(y_cur, group)
        ctx.group, ctx.run, ctx.m_loc = group, run, y_shard.shape[0]
        ctx.save_for_backward(won_at, won_row)
        return best_row

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        won_at, won_row = ctx.saved_tensors
        return None, _RingScatter.apply(grad, won_at, won_row, ctx.group, ctx.run,
                                        ctx.m_loc), None, None


class _RingScatter(torch.autograd.Function):
    """:class:`_Ring`'s backward, linear in the rows' cotangent ``grad`` (n,
    c): from the last step to the first it adds the cotangents of the step's
    winners into an (m_loc, c) buffer (:func:`_unfold`) and shifts the
    buffer back to the previous visitor (K - 1 reverse shifts); at step 0
    the buffer is the gradient of this rank's own shard.  Its backward (a
    double backward through the ring) is its transpose, :class:`_RingGather`;
    ``run`` as in :class:`_Ring`."""

    @staticmethod
    def forward(ctx, grad, won_at, won_row, group, run, m_loc: int):
        buf = grad.new_zeros((m_loc + 1, grad.shape[1]))
        for step in reversed(range(dist.get_world_size(group))):
            fixed_trip.when(run, functools.partial(_unfold, buf, grad, won_at, won_row, step))
            if step:
                buf[:m_loc].copy_(ring_shift(buf[:m_loc], group, reverse=True))
        ctx.group, ctx.run = group, run
        ctx.save_for_backward(won_at, won_row)
        return buf[:m_loc]

    @staticmethod
    def backward(ctx, shard_bar):
        won_at, won_row = ctx.saved_tensors
        return (_RingGather.apply(shard_bar, won_at, won_row, ctx.group, ctx.run),
                None, None, None, None, None)


class _RingGather(torch.autograd.Function):
    """The transpose of :class:`_RingScatter`, linear in the shard's
    cotangent ``shard`` (m_loc, c): the forward ring again, gathering rows
    instead of searching them; each step's winners take their row of the
    visiting shard (:func:`_refold`), and the shard shifts on (K - 1 shifts,
    counted as ``"ring_shift_gather"``).  Its backward is
    :class:`_RingScatter`."""

    @staticmethod
    def forward(ctx, shard, won_at, won_row, group, run):
        k_dev = dist.get_world_size(group)
        out = shard.new_zeros((won_at.shape[0], shard.shape[1]))
        cur = shard.contiguous()
        for step in range(k_dev):
            fixed_trip.when(run, functools.partial(_refold, out, cur, won_at, won_row, step))
            if step + 1 < k_dev:
                cur = ring_shift(cur, group, kind="ring_shift_gather")
        ctx.group, ctx.run, ctx.m_loc = group, run, shard.shape[0]
        ctx.save_for_backward(won_at, won_row)
        return out

    @staticmethod
    def backward(ctx, grad):
        won_at, won_row = ctx.saved_tensors
        return (_RingScatter.apply(grad, won_at, won_row, ctx.group, ctx.run, ctx.m_loc),
                None, None, None, None)


def ring_nn(x: torch.Tensor, y_shard: torch.Tensor, group) -> torch.Tensor:
    """1-NN of local queries against a RING-SHARDED target.

    x (n_loc, 3) this rank's queries; y_shard (m_loc, c) this rank's shard of
    the target map.  The shards rotate around the group's ring (K steps on K
    ranks, K - 1 shifts); each step folds the visiting shard into a running
    (best distance, best row) accumulator.  Ties across shards resolve by
    ring order (this rank's own shard first), not by global index, as in
    JAX.  Differentiable in ``y_shard`` as JAX's is: the backward sends the
    rows' cotangents back around the ring (K - 1 reverse shifts, counted as
    ``"ring_shift_reverse"``); ``x`` gets no gradient (:class:`_Ring`)."""
    return _Ring.apply(x, y_shard, group, None)


def _preshard(cfg: ICPConfig, source, target, weight):
    """``registration._preprocess``'s input rules for the sharded wrappers:
    the pt2pl normal requirement, the pt2pt normal strip, dim-2 z zeroing and
    the source_zeroes_are_pad weight rule."""
    if cfg.icp_type == "pt2pl" and target.shape[-1] != 6:
        raise ValueError("pt2pl requires target normals: (m, 6)")
    if cfg.icp_type == "pt2pt":
        target = target[..., :3]
    if cfg.dim == 2:
        source = source * _zmask(source.shape[-1], source.dtype, source.device)
        target = target * _zmask(target.shape[-1], target.dtype, target.device)
    if cfg.source_zeroes_are_pad:
        nonzero = torch.linalg.vector_norm(source[..., :3], dim=-1) != 0.0
        weight = weight * nonzero.to(source.dtype)
    return source, target, weight


def _linearize(cfg: ICPConfig, C, cp, ps_t, src_nrm, nn6, w, smooth: bool):
    """(J (P, k), residuals (P,), weights (P,)) of the map-sharded solver's
    terms on one rank: the source points rotated (``cp``) and moved
    (``ps_t``) by the pose (C, r), the matched target rows ``nn6`` (normals
    ride along) and the prior weight ``w``; trim and loss weights apply
    LINEARLY, in their smooth forms where ``smooth``.  P = n (pt2pl,
    symmetric: one residual along the normal) or 3n (pt2pt: the point error,
    each weight repeated)."""
    n_loc = cp.shape[0]
    nn_err = ps_t - nn6[:, :3]
    if cfg.trim_dist is not None:
        w = w * losses.trim_weight(nn_err, cfg.trim_dist, smooth, cfg.tanh_steepness)
    if cfg.icp_type in ("pt2pl", "symmetric"):
        if cfg.icp_type == "symmetric":
            cnp = src_nrm @ C.T
            nrm = nn6[:, 3:6] + cnp
        else:
            nrm = nn6[:, 3:6]
        res = torch.sum(nn_err * nrm, dim=-1)
        if cfg.loss_name is not None:
            w = w * losses.robust_weight(cfg.loss_name, res[:, None], cfg.loss_metric, smooth,
                                         cfg.tanh_steepness)
        J_C = torch.linalg.cross(nrm, cp, dim=-1)
        if cfg.icp_type == "symmetric":
            J_C = J_C + torch.linalg.cross(nn_err, cnp, dim=-1)
        J = torch.cat([J_C, -nrm], dim=-1)
    else:
        if cfg.loss_name is not None:
            w = w * losses.robust_weight(cfg.loss_name, nn_err, cfg.loss_metric, smooth,
                                         cfg.tanh_steepness)
        eye = torch.eye(3, dtype=cp.dtype, device=cp.device).expand(n_loc, 3, 3)
        J = torch.cat([se3.skew(cp).reshape(3 * n_loc, 3), -eye.reshape(3 * n_loc, 3)], dim=-1)
        res = nn_err.reshape(3 * n_loc)
        w = torch.repeat_interleave(w, 3)
    if cfg.dim == 2:
        J = J[:, 2:5]
    return J, res, w


def _moved(source, pose):
    """(C, cp, ps_t): the rotation of the flat pose (12,), and this rank's
    source points rotated and moved by the pose."""
    C_l = pose[:9].reshape(3, 3)
    cp = source[:, :3] @ C_l.T
    return C_l, cp, cp + pose[9:]


class _Terms(fixed_trip.Trip):
    """The first part of a map-sharded Gauss-Newton step: this rank's
    summands of the step's one all-reduce, flat.  Inputs: the source shard
    (n_loc, 3|6), its weight, the target, the replicated pose (12,) and, on
    the ring, the matched rows (found around the ring's shifts, outside the
    step).  The carry is the summands' buffer, 0 where the step is skipped.
    The search: the int32 nearest rows and, on the cluster tier, the
    certificate."""

    n_grad = 1

    def __init__(self, cfg: ICPConfig, method: str, rank: int, n_real: Optional[int],
                 cl_index=None, qord=None, fixup: int = 0):
        self.cfg, self.method, self.rank, self.n_real = cfg, method, rank, n_real
        self.cl_index, self.qord, self.fixup = cl_index, qord, fixup
        self.n_inputs = 5 if method == "ring" else 4

    def found(self, inputs):
        if self.method == "ring":
            return []
        source = inputs[0]
        idx = torch.zeros((source.shape[0],), dtype=torch.int32, device=source.device)
        return [idx] + ([source.new_zeros((source.shape[0],))] if self.method == "cluster" else [])

    def search(self, ps_t, tgt_pts):
        if self.method == "cluster":
            # fused=cfg.sharded_fused (None: K2 on CUDA queries, the group
            # scan on the CPU); the certificate gate is applied on the GLOBAL
            # fraction, after the all-reduce
            idx, _, cert = cluster_nn(self.cl_index, ps_t, probes=self.cfg.cluster_probes,
                                      use_pallas=False, fused=self.cfg.sharded_fused,
                                      order=self.qord, fixup=self.fixup)
            return idx, cert.to(ps_t.dtype)
        return (knn.nn_indices(ps_t, tgt_pts),)

    def step(self, inputs, carry, it, search):
        source, weight, target, pose = inputs[:4]
        C_l, cp, ps_t = _moved(source, pose)
        valid = None
        if self.method == "ring":
            nn6 = inputs[4]
        else:
            got = search(ps_t, target[:, :3])
            nn6 = target[got[0].long()]
            if self.method == "cluster":
                valid = got[1]
        return (self.terms(source, weight, C_l, cp, ps_t, nn6, valid),), ()

    def terms(self, source, weight, C_l, cp, ps_t, nn6, valid):
        """The summands, flat, from the matched rows ``nn6``: (A, b, cost),
        or with the certificate ``valid`` (the cluster tier) the gated and
        ungated equations and the certified count (the 50% certification
        fallback must fire on the GLOBAL fraction, or shards diverge near
        the threshold)."""
        cfg, n_loc = self.cfg, source.shape[0]
        src_nrm = source[:, 3:6] if cfg.icp_type == "symmetric" else None
        J, res, w = _linearize(cfg, C_l, cp, ps_t, src_nrm, nn6, weight, cfg.differentiable)

        def ne(wv):
            return [J.T @ (wv[:, None] * J), J.T @ (wv * res), torch.sum(wv * res * res)]

        if valid is None:
            parts = ne(w)
        else:
            if cfg.icp_type == "pt2pt":
                valid = torch.repeat_interleave(valid, 3)
            rep = valid.shape[0] // n_loc
            if self.n_real is not None:
                # the wrapper's zero-weight pads leave the fraction
                rows = self.rank * n_loc + torch.arange(n_loc, device=source.device)
                cnt_local = torch.sum(valid[::rep] * (rows < self.n_real).to(source.dtype))
            else:
                cnt_local = torch.sum(valid) / rep
            parts = ne(w * valid) + ne(w) + [cnt_local]
        return torch.cat([p.reshape(-1) for p in parts])


class _Update(fixed_trip.Trip):
    """The second part of a map-sharded step: the update from the
    all-reduced summands (the input); the carry (C, r, done), C and r
    differentiable."""

    n_inputs, n_grad = 1, 2

    def __init__(self, cfg: ICPConfig, method: str, denom: float):
        self.cfg, self.method, self.denom = cfg, method, denom

    def finish(self, C, r, total):
        """The step from the all-reduced summands ``total``: (C, r)
        updated, the step norm, the cost."""
        cfg, dtype, device = self.cfg, total.dtype, total.device
        k = 3 if cfg.dim == 2 else 6
        n_ne = k * k + k + 1
        A, b, cost = total[:k * k].reshape(k, k), total[k * k:k * k + k], total[n_ne - 1]
        if self.method == "cluster":
            A_f, b_f = total[n_ne:n_ne + k * k].reshape(k, k), total[n_ne + k * k:2 * n_ne - 1]
            use = total[2 * n_ne] / self.denom >= 0.5
            A = torch.where(use, A, A_f)
            b = torch.where(use, b, b_f)
            cost = torch.where(use, cost, total[2 * n_ne - 1])
        A = A + _damping(cfg, A) * torch.eye(k, dtype=dtype, device=device)
        if cfg.solve_method == "closed":
            delta_k = -solve_spd(A, b)
        else:
            # solve_ex: linalg.solve's LU without its host check of ``info``
            delta_k = -torch.linalg.solve_ex(A, b[:, None], check_errors=False)[0][:, 0]
        if cfg.dim == 2:
            z = delta_k.new_zeros((1,))
            delta6 = torch.cat([z, z, delta_k, z])
        else:
            delta6 = delta_k
        C_new = se3.exp_so3(delta6[:3]).T @ C
        r_new = r - delta6[3:]
        return C_new, r_new, torch.linalg.vector_norm(delta6), cost

    def step(self, inputs, carry, it, search):
        C, r, step_norm, _ = self.finish(carry[0], carry[1], inputs[0])
        return (C, r, step_norm < self.cfg.tolerance), ()


def _map_sharded_solve(cfg: ICPConfig, source_shard, weight_shard, target, T_init, group,
                       target_sharded: bool = False, n_real: Optional[int] = None):
    """This rank's part of the map-sharded Gauss-Newton solve; returns (T,
    converged, iterations, cost), the same on every rank of ``group``.

    Weights apply LINEARLY (not through the single-pair driver's sqrt row
    scaling), as in JAX's sharded solver, and its fixed point is the same.
    A step: the pose through ``replicated``, this rank's summands
    (:class:`_Terms`), their all-reduce, the update (:class:`_Update`).
    Every rank reads the same reduced step norm, so all stop together.  With
    ``target_sharded`` the target is this rank's shard and correspondences
    come from the ring (:class:`_Ring`), whose rows enter the summands with
    their gradient: a backward runs K - 1 reverse shifts per ring call.

    Under capture the loop is JAX's ``lax.scan`` driver, a fixed trip of
    ``max_iterations`` steps, each part a run-once node
    (:func:`fixed_trip.step`) skipped once a step has converged, and the
    all-reduce between the parts run in every step: CUDA refuses NCCL's
    kernels inside a conditional node's body, so the exit cannot be a WHILE
    node.  On the ring the folds are run-once nodes of their own and the
    shifts run in every step.  Where an input requires grad autograd records
    the trip: each part's backward is a run-once node (the terms recomputed
    from the saved correspondences, no new search), and the pose's
    cotangent is all-reduced in every step, outside them; on the ring each
    step's additions into the target's cotangent are run-once nodes and its
    reverse shifts run in every step, a skipped step's adding nothing.
    Otherwise the loop runs on the host, reads the step norm once per
    iteration, and autograd records its ops.  Both give the same bits."""
    dtype, device = source_shard.dtype, source_shard.device
    rank, k_dev = dist.get_rank(group), dist.get_world_size(group)
    n_loc = source_shard.shape[0]
    C0, r0 = T_init[:3, :3], T_init[:3, 3]
    if target_sharded:
        method = "ring"
    else:
        method = cfg.resolved_nn_method(n_loc, target.shape[0], device)
        if method == "pallas":
            # JAX demotes the tiled tier inside its shard_map body; the
            # (n/K, m) dense tile is K times smaller per rank
            method = "dense"
    cluster = {}
    if method == "cluster":
        # the index over the replicated target and the query order, once per
        # solve at T_init (rigid motion keeps neighbourhoods)
        with torch.no_grad():
            cl_index = build_cluster_index(target[:, :3].detach(), cfg.cluster_group)
            qord = query_order(cl_index, (source_shard[:, :3] @ C0.T + r0).detach())
        cluster = dict(cl_index=cl_index, qord=qord, fixup=cfg.resolved_cluster_fixup(n_loc))
    terms = _Terms(cfg, method, rank, n_real, **cluster)
    update = _Update(cfg, method, float(n_real) if n_real is not None else n_loc * k_dev)
    # on the ring the target reaches the summands only through the rows
    # that _Ring finds, and its gradient only through _Ring's backward
    inputs = (source_shard, weight_shard, target.detach() if method == "ring" else target)

    def pose(C, r):
        # the replicated pose enters this rank's local terms: its cotangent
        # from them is summed over the group
        return replicated(torch.cat([C.reshape(-1), r]), group)

    def ring(Cr, run=None):
        """The rows that the ring finds for the pose ``Cr`` (none off the
        ring); the queries carry no gradient into them."""
        if method != "ring":
            return ()
        return (_Ring.apply(_moved(source_shard, Cr)[2].detach(), target, group, run),)

    def iteration(C, r):
        """One step, uncaptured: (C, r, step norm, cost)."""
        Cr = pose(C, r)
        (total,), _ = terms.step((*inputs, Cr, *ring(Cr)), (), None, terms.search)
        return update.finish(C, r, psum(total, group))

    if capturing(C0):
        k = 3 if cfg.dim == 2 else 6
        n_ne = k * k + k + 1
        zero = torch.zeros((2 * n_ne + 1 if method == "cluster" else n_ne,), dtype=dtype,
                           device=device)
        C, r = C0, r0
        done = torch.zeros((), dtype=torch.bool, device=device)
        it = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(cfg.max_iterations):
            run = ~done
            Cr = pose(C, r)
            # on the ring the shifts run in every step, the folds where it runs
            (total,), _ = fixed_trip.step(terms, it, run, (*inputs, Cr, *ring(Cr, run)),
                                          (zero,))
            (C, r, done), _ = fixed_trip.step(update, it, run, (psum(total, group),),
                                              (C, r, done))
            it = it + run.to(torch.int32)
    else:
        C, r = C0, r0
        steps, stop = 0, False
        while steps < cfg.max_iterations and not stop:
            C, r, step_norm, _ = iteration(C, r)
            steps += 1
            stop = bool(step_norm < cfg.tolerance)
        done = torch.full((), stop, dtype=torch.bool, device=device)
        it = torch.full((), steps, dtype=torch.int32, device=device)
    # the in-loop cost is taken at each iteration's INPUT pose; report the
    # cost at the returned pose (one more correspondence pass)
    _, _, _, cost = iteration(C, r)
    return se3._homogeneous(C, r), done, it, cost


def _global_inputs(mesh: DeviceMesh, axis: str, cfg: ICPConfig, source, target, T_init,
                   weight):
    """The global inputs on the mesh's device in the source's dtype, with
    their defaults; source and weight through ``replicated``."""
    group = mesh.get_group(axis)
    device = _device(mesh)
    source = torch.as_tensor(source, device=device)
    dtype = source.dtype
    if cfg.icp_type == "symmetric" and source.shape[1] < 6:
        raise ValueError("symmetric ICP requires 6-column sources (coordinates + normals)")
    target = torch.as_tensor(target, device=device).to(dtype)
    T_init = (torch.eye(4, dtype=dtype, device=device) if T_init is None
              else torch.as_tensor(T_init, device=device).to(dtype))
    weight = (torch.ones((source.shape[0],), dtype=dtype, device=device) if weight is None
              else torch.as_tensor(weight, device=device).to(dtype))
    return replicated(source, group), target, T_init, replicated(weight, group)


def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` with ``pad`` zero rows appended."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def register_map_sharded(
    mesh: DeviceMesh,
    source,
    target,
    T_init=None,
    weight=None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Register ONE large scan against a target map with the scan's points
    split over the ``axis`` mesh axis.

    source (n, 3|6), target (m, 3|6) replicated, T_init (4, 4).  n need not
    divide: the source is padded with zero-weight points, which also leave
    the certificate gate's fraction.  Per GN step the ranks exchange only the
    all-reduced normal equations."""
    group, _, n_dev = _axis(mesh, axis)
    source, target, T_init, weight = _global_inputs(mesh, axis, cfg, source, target, T_init,
                                                    weight)
    n = source.shape[0]
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    # the target's cotangent is summed over the group: every rank uses it whole
    source, target, weight = _preshard(cfg, source, replicated(target, group), weight)
    pad = (-n) % n_dev
    source, weight = _pad_rows(source, pad), _pad_rows(weight, pad)
    fn = map_sharded_fn(mesh, cfg, axis=axis, target_sharded=False, n_real=n if pad else None)
    return MapShardedResult(*fn(source[:, :src_cols], weight, target, T_init))


def map_sharded_fn(mesh: DeviceMesh, cfg: ICPConfig, axis: str = "map",
                   target_sharded: bool = False, n_real: Optional[int] = None):
    """The program behind :func:`register_map_sharded` and
    :func:`register_ring_sharded`, and the sharded IFT's forward: JAX's
    ``jax.jit(shard_map(...))`` of the same name.

    Returns ``fn(source, weight, target, T_init) -> (T, converged,
    iterations, cost)``, the same on every rank, over the padded GLOBAL
    source columns (n, 3|6) and weight (n,), the target and T_init (4, 4).
    Each rank takes its own rows of the source and weight by its coordinate
    on ``axis`` (JAX's ``P(axis)``); the target is replicated, or with
    ``target_sharded`` the sentinel-padded global target of which each rank
    takes its own rows.  ``n_real``: the real source points before the
    padding (the certificate gate's fraction).

    On the card ``fn`` is a :func:`dicp_tpu_torch.jit.jit` program: a call
    per input shape captures the solve and later calls replay it.  A
    replay runs ``cfg.max_iterations`` steps and ``cfg.max_iterations + 1``
    all-reduces (an uncaptured call, the host loop: the iterations it
    needs, plus one).  A call whose input requires grad runs a program pair
    (eagerly at its key's first call): its backward replays
    ``cfg.max_iterations`` all-reduces of the pose's cotangent, one per
    step, beside a constant few.  On a ring of K ranks a replay runs
    (K - 1)(``cfg.max_iterations`` + 1) shifts, and a backward into the
    target as many reverse shifts.  On the CPU it is the solve itself.  The
    mesh and cfg live in the closure, not in the program's key.

    lru-cached on (mesh, cfg, axis, target_sharded, n_real), as JAX's is,
    and on the axis's process group: a mesh of a new world equals the old
    world's mesh, and must not get its programs.  SPMD: every rank must take
    the same cache miss or hit, or the first call's eager run pairs its
    collectives with another rank's replay and waits forever.  Ranks that
    call with the same shapes do."""
    return _map_sharded_fn(mesh, cfg, axis, target_sharded, n_real, mesh.get_group(axis))


@functools.lru_cache(maxsize=64)
def _map_sharded_fn(mesh, cfg, axis, target_sharded, n_real, group):
    _, rank, n_dev = _axis(mesh, axis)

    def program(source, weight, target, T_init):
        n_loc = source.shape[0] // n_dev
        rows = slice(rank * n_loc, (rank + 1) * n_loc)
        if target_sharded:
            m_loc = target.shape[0] // n_dev
            target = target[rank * m_loc:(rank + 1) * m_loc]
        return _map_sharded_solve(cfg, source[rows], weight[rows], target, T_init, group,
                                  target_sharded=target_sharded, n_real=n_real)

    return jit(program, name="map_sharded_fn")


def register_ring_sharded(
    mesh: DeviceMesh,
    source,
    target,
    T_init=None,
    weight=None,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "map",
) -> MapShardedResult:
    """Register one large scan against a map TOO LARGE TO REPLICATE.

    Both the source points and the target map are split over the ``axis``
    mesh axis; correspondences come from :func:`ring_nn` (target shards sent
    around the ring), the normal equations from the same all-reduce as
    :func:`register_map_sharded`.  Per-rank memory is O(n/K + m/K).

    Target padding uses far-away sentinel rows (coordinates 1e15) that never
    win a distance comparison.  Ties across shards resolve by ring order, not
    by the lowest global index (see :func:`ring_nn`).

    Differentiable in the source, the target and the weight, as JAX's is:
    the rows that the ring finds carry the target's gradient back around
    the ring (:class:`_Ring`; per ring call K - 1 reverse shifts of an
    (m/K, c) buffer), and the target's cotangent is then all-reduced (one
    all-reduce of m x c elements), so every rank holds JAX's gradient of the
    global target, as of the source and the weight.  The sentinel rows'
    share is dropped."""
    group, _, n_dev = _axis(mesh, axis)
    source, target, T_init, weight = _global_inputs(mesh, axis, cfg, source, target, T_init,
                                                    weight)
    n, m = source.shape[0], target.shape[0]
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    # each rank takes its shard of the target: its cotangent is summed over the group
    source, target, weight = _preshard(cfg, source, replicated(target, group), weight)
    pad_n, pad_m = (-n) % n_dev, (-m) % n_dev
    source, weight = _pad_rows(source, pad_n), _pad_rows(weight, pad_n)
    if pad_m:
        sentinel = target.new_zeros((pad_m, target.shape[1]))
        sentinel[:, :3] = 1e15
        target = torch.cat([target, sentinel])
    fn = map_sharded_fn(mesh, cfg, axis=axis, target_sharded=True)
    return MapShardedResult(*fn(source[:, :src_cols], weight, target, T_init))
