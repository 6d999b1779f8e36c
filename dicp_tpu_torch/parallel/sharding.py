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
  whose target shards travel around the ring (send/recv).

Gradients.  A global input that each rank slices or uses whole goes through
``_comm.replicated`` (the backward sums the ranks' partial cotangents), and
so does the pose where each iteration's local terms consume it: the
counterpart of JAX's implicit broadcast of an unvarying value into a varying
computation, whose transpose is a psum.  ``_comm.psum`` passes cotangents
through.  Every rank then holds JAX's gradient of the global arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dicp_tpu_torch import knn, losses, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn, query_order
from dicp_tpu_torch.ops.smallsolve import solve_spd
from dicp_tpu_torch.parallel._comm import psum_many, replicated, ring_shift
from dicp_tpu_torch.registration import ICPResult, _damping, register


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


class _OffsetNoise:
    """A Gumbel noise source whose streams are named by global batch index:
    this rank's rows start at ``offset``."""

    def __init__(self, noise, offset: int):
        self.noise, self.offset = noise, offset

    def uniform(self, pair_ids, *args):
        if pair_ids is not None:
            pair_ids = [p + self.offset for p in pair_ids]
        return self.noise.uniform(pair_ids, *args)


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

    Each rank runs :func:`registration.register` on its own rows and returns
    their ``ICPResult`` (a world of one returns every row); no collective.
    N must be divisible by the batch axis size.  Gumbel noise streams are
    named by global batch index, so the rows equal an unsharded solve."""
    _, rank, n_batch = _axis(mesh, "batch")
    if source.shape[0] % n_batch != 0:
        raise ValueError(f"batch {source.shape[0]} not divisible by mesh axis {n_batch}")
    arrays = shard_batch(mesh, source, target, T_init,
                         *(() if weight is None else (weight,)))
    if cfg.differentiable and cfg.use_gumbel and key is not None:
        key = _OffsetNoise(knn.gumbel_noise(key), rank * (source.shape[0] // n_batch))
    src, tgt, ti = arrays[:3]
    return register(src, tgt, ti, arrays[3] if weight is not None else None, cfg, key)


class MapShardedResult(NamedTuple):
    """Result of a map-sharded single-cloud registration."""
    T: torch.Tensor           # (4, 4)
    converged: torch.Tensor   # () bool
    iterations: torch.Tensor  # () int32
    cost: torch.Tensor        # () final weighted squared cost


def ring_nn(x: torch.Tensor, y_shard: torch.Tensor, group) -> torch.Tensor:
    """1-NN of local queries against a RING-SHARDED target.

    x (n_loc, 3) this rank's queries; y_shard (m_loc, c) this rank's shard of
    the target map.  The shards rotate around the group's ring (K steps on K
    ranks, K - 1 shifts); each step folds the visiting shard into a running
    (best distance, best row) accumulator.  Ties across shards resolve by
    ring order (this rank's own shard first), not by global index, as in
    JAX.  Forward only: a gradient through the shifted shards raises."""
    k_dev = dist.get_world_size(group)
    best_d = torch.full((x.shape[0],), torch.inf, dtype=x.dtype, device=x.device)
    best_row = y_shard.new_zeros((x.shape[0], y_shard.shape[1]))
    y_cur = y_shard
    for step in range(k_dev):
        with torch.no_grad():
            d2 = knn.pairwise_sq_dist(x.detach(), y_cur[:, :3].detach())
            idx = torch.argmin(d2, dim=-1)
            dmin = torch.gather(d2, 1, idx[:, None])[:, 0]
            better = dmin < best_d
            best_d = torch.where(better, dmin, best_d)
        best_row = torch.where(better[:, None], y_cur[idx], best_row)
        if step + 1 < k_dev:
            y_cur = ring_shift(y_cur, group)
    return best_row


def _preshard(cfg: ICPConfig, source, target, weight):
    """``registration._preprocess``'s input rules for the sharded wrappers:
    the pt2pl normal requirement, the pt2pt normal strip, dim-2 z zeroing and
    the source_zeroes_are_pad weight rule."""
    if cfg.icp_type == "pt2pl" and target.shape[-1] != 6:
        raise ValueError("pt2pl requires target normals: (m, 6)")
    if cfg.icp_type == "pt2pt":
        target = target[..., :3]
    if cfg.dim == 2:
        zmask = torch.tensor([1.0, 1.0, 0.0], dtype=source.dtype, device=source.device)
        zmask6 = torch.cat([zmask, zmask])
        source = source * (zmask6 if source.shape[-1] == 6 else zmask)
        target = target * (zmask6 if target.shape[-1] == 6 else zmask)
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


def _map_sharded_solve(cfg: ICPConfig, source_shard, weight_shard, target, T_init, group,
                       target_sharded: bool = False, n_real: Optional[int] = None):
    """This rank's part of the map-sharded Gauss-Newton solve; returns (T,
    converged, iterations, cost), the same on every rank of ``group``.

    Weights apply LINEARLY (not through the single-pair driver's sqrt row
    scaling), as in JAX's sharded solver, and its fixed point is the same.
    One early-exit loop serves both JAX drivers (a frozen iteration of the
    scan driver is the identity); every rank reads the same reduced step
    norm, so all stop together.  With ``target_sharded`` the target is this
    rank's shard and correspondences come from :func:`ring_nn`."""
    dtype, device = source_shard.dtype, source_shard.device
    rank, k_dev = dist.get_rank(group), dist.get_world_size(group)
    n_loc = source_shard.shape[0]
    C0, r0 = T_init[:3, :3], T_init[:3, 3]
    src_pts = source_shard[:, :3]
    src_nrm = source_shard[:, 3:6] if cfg.icp_type == "symmetric" else None
    tgt_pts = target[:, :3]
    if target_sharded:
        method = "ring"
    else:
        method = cfg.resolved_nn_method(n_loc, target.shape[0], device)
        if method == "pallas":
            # JAX demotes the tiled tier inside its shard_map body; the
            # (n/K, m) dense tile is K times smaller per rank
            method = "dense"
    if method == "cluster":
        # the index over the replicated target and the query order, once per
        # solve at T_init (rigid motion keeps neighbourhoods)
        with torch.no_grad():
            cl_index = build_cluster_index(tgt_pts.detach(), cfg.cluster_group)
            qord = query_order(cl_index, (src_pts @ C0.T + r0).detach())
        fixup = cfg.resolved_cluster_fixup(n_loc)

    def gn_iteration(C, r):
        # the replicated pose enters this rank's local terms: its cotangent
        # from them is summed over the group
        Cr = replicated(torch.cat([C.reshape(-1), r]), group)
        C_l, r_l = Cr[:9].reshape(3, 3), Cr[9:]
        cp = src_pts @ C_l.T
        ps_t = cp + r_l
        valid = None
        if method == "ring":
            nn6 = ring_nn(ps_t, target, group)
        elif method == "cluster":
            # fused=cfg.sharded_fused (None: K2 on CUDA queries, the group
            # scan on the CPU); the certificate gate is applied on the GLOBAL
            # fraction below, inside the normal equations' all-reduce
            idx, _, cert = cluster_nn(cl_index, ps_t, probes=cfg.cluster_probes,
                                      use_pallas=False, fused=cfg.sharded_fused, order=qord,
                                      fixup=fixup)
            nn6 = target[idx.long()]
            valid = cert.to(dtype)
        else:
            nn6 = target[knn.nn_indices(ps_t, tgt_pts).long()]
        J, res, w = _linearize(cfg, C_l, cp, ps_t, src_nrm, nn6, weight_shard,
                               cfg.differentiable)
        if valid is not None and cfg.icp_type == "pt2pt":
            valid = torch.repeat_interleave(valid, 3)
        k = J.shape[-1]

        def ne(wv):
            return [J.T @ (wv[:, None] * J), J.T @ (wv * res), torch.sum(wv * res * res)]

        if valid is None:
            A, b, cost = psum_many(ne(w), group)
        else:
            # the 50% certification fallback must fire on the GLOBAL fraction,
            # or shards diverge near the threshold: the gated and ungated
            # equations and the certified count share the one all-reduce
            rep = valid.shape[0] // n_loc
            if n_real is not None:
                # the wrapper's zero-weight pads leave the fraction
                real = (rank * n_loc + torch.arange(n_loc, device=device)) < n_real
                cnt_local = torch.sum(valid[::rep] * real.to(dtype))
                denom = float(n_real)
            else:
                cnt_local = torch.sum(valid) / rep
                denom = n_loc * k_dev
            A_g, b_g, c_g, A_f, b_f, c_f, cnt = psum_many(ne(w * valid) + ne(w) + [cnt_local],
                                                          group)
            use = cnt / denom >= 0.5
            A = torch.where(use, A_g, A_f)
            b = torch.where(use, b_g, b_f)
            cost = torch.where(use, c_g, c_f)
        A = A + _damping(cfg, A) * torch.eye(k, dtype=dtype, device=device)
        if cfg.solve_method == "closed":
            delta_k = -solve_spd(A, b)
        else:
            delta_k = -torch.linalg.solve(A, b[:, None])[:, 0]
        if cfg.dim == 2:
            z = delta_k.new_zeros((1,))
            delta6 = torch.cat([z, z, delta_k, z])
        else:
            delta6 = delta_k
        C_new = se3.exp_so3(delta6[:3]).T @ C
        r_new = r - delta6[3:]
        return C_new, r_new, torch.linalg.vector_norm(delta6), cost

    C, r = C0, r0
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        C, r, step_norm, _ = gn_iteration(C, r)
        it += 1
        done = bool(step_norm < cfg.tolerance)
    # the in-loop cost is taken at each iteration's INPUT pose; report the
    # cost at the returned pose (one more correspondence pass)
    _, _, _, cost = gn_iteration(C, r)
    return (se3._homogeneous(C, r), torch.tensor(done, device=device),
            torch.tensor(it, dtype=torch.int32, device=device), cost)


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
    group, rank, n_dev = _axis(mesh, axis)
    source, target, T_init, weight = _global_inputs(mesh, axis, cfg, source, target, T_init,
                                                    weight)
    n = source.shape[0]
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    # the target's cotangent is summed over the group: every rank uses it whole
    source, target, weight = _preshard(cfg, source, replicated(target, group), weight)
    pad = (-n) % n_dev
    source, weight = _pad_rows(source, pad), _pad_rows(weight, pad)
    n_loc = (n + pad) // n_dev
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    return MapShardedResult(*_map_sharded_solve(
        cfg, source[rows, :src_cols], weight[rows], target, T_init, group,
        n_real=n if pad else None))


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
    by the lowest global index (see :func:`ring_nn`).  Forward only when the
    target requires a gradient (the ring has no backward)."""
    group, rank, n_dev = _axis(mesh, axis)
    source, target, T_init, weight = _global_inputs(mesh, axis, cfg, source, target, T_init,
                                                    weight)
    n, m = source.shape[0], target.shape[0]
    src_cols = 6 if cfg.icp_type == "symmetric" else 3
    source, target, weight = _preshard(cfg, source, target, weight)
    pad_n, pad_m = (-n) % n_dev, (-m) % n_dev
    source, weight = _pad_rows(source, pad_n), _pad_rows(weight, pad_n)
    if pad_m:
        sentinel = target.new_zeros((pad_m, target.shape[1]))
        sentinel[:, :3] = 1e15
        target = torch.cat([target, sentinel])
    n_loc, m_loc = (n + pad_n) // n_dev, (m + pad_m) // n_dev
    return MapShardedResult(*_map_sharded_solve(
        cfg, source[rank * n_loc:(rank + 1) * n_loc, :src_cols],
        weight[rank * n_loc:(rank + 1) * n_loc], target[rank * m_loc:(rank + 1) * m_loc],
        T_init, group, target_sharded=True))
