"""Coarse-to-fine multiscale ICP over a voxel pyramid: the counterpart of
``dicp_tpu/multiscale.py``.

Coarse voxel centroids smooth the cost surface, so a poor ``T_init`` that
strands the full-resolution solve in a local minimum is first pulled into
the basin at low resolution, and the expensive last level starts from an
almost converged pose.

Each downsampled level has a fixed slot budget: the occupied voxels of
:func:`ops.voxel.voxel_downsample` (one call per batch element) are
re-packed into it by :func:`subsample_packed`, without a host sync.  The
user weight rides through the voxel mean as an extra column, and
mean(w) * count == sum(w) over a voxel's members, so a coarse level solves
the full-resolution weighted objective restricted to centroids.

JAX splits one PRNG key across the levels; the port takes one noise source
per level instead (what :func:`registration.register`'s ``key`` accepts),
needed only with Gumbel NN in a differentiable config.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops.voxel import voxel_downsample
from dicp_tpu_torch.registration import ICPResult, register


class ScaleLevel(NamedTuple):
    """One pyramid level.

    ``voxel_size <= 0`` means full resolution (the clouds as given; the slot
    budgets are ignored).  ``trim_dist=None`` inherits the config's value;
    coarse levels usually want it scaled up with the voxel.  ``nn_method``
    overrides the correspondence tier: a coarse level of a few thousand
    centroids should not pay for the cluster index the full level needs."""

    voxel_size: float
    n_source: int = 0
    m_target: int = 0
    max_iterations: int = 20
    tolerance: float = 1e-6
    trim_dist: Optional[float] = None
    nn_method: Optional[str] = None


class MultiscaleResult(NamedTuple):
    result: ICPResult                # final (finest) level, full contract
    level_T: torch.Tensor            # (L, N, 4, 4) pose after each level
    level_iterations: torch.Tensor   # (L, N) iterations spent per level


def subsample_packed(points: torch.Tensor, weight: torch.Tensor, count: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-pack the ``count`` valid leading rows into ``cap`` slots.

    count <= cap: the valid rows, then zero-weight copies of the last valid
    row (a real coordinate, harmless as hard-NN target padding).
    count > cap: the systematic stride (i * count) // cap over the packed
    rows, each keeping its own weight; the packing is lexicographic in the
    voxel cells, so the stride is spatially unbiased."""
    n = points.shape[0]
    i = torch.arange(cap, device=points.device)
    cnt = torch.clamp(count.to(torch.int64), min=1)
    idx_over = (i * cnt) // cap
    idx_under = torch.minimum(i, cnt - 1)
    over = cnt > cap
    idx = torch.clamp(torch.where(over, idx_over, idx_under), 0, n - 1)
    valid = over | (i < cnt)
    return points[idx], weight[idx] * valid.to(weight.dtype)


def _renormalize_normals(cloud: torch.Tensor) -> torch.Tensor:
    """Voxel-averaged normals (columns 3:6) back to unit length; a voxel
    whose member normals cancel keeps the zero normal (a no-op pt2pl row)."""
    nrm = cloud[:, 3:6]
    length = torch.linalg.vector_norm(nrm, dim=1, keepdim=True)   # jnp.linalg.norm's bits
    unit = nrm / torch.clamp(length, min=1e-12)
    unit = torch.where(length > 1e-6, unit, 0.0)
    return torch.cat([cloud[:, :3], unit, cloud[:, 6:]], dim=1)


def _downsample_cloud(cloud: torch.Tensor, weight: Optional[torch.Tensor], voxel_size: float,
                      cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unbatched cloud -> (cap, d) centroids and (cap,) summed weights.

    The weight is averaged as an extra column, so a voxel's weight is
    exactly the sum of its members' weights."""
    d = cloud.shape[1]
    if weight is None:
        weight = torch.ones((cloud.shape[0],), dtype=cloud.dtype, device=cloud.device)
    vr = voxel_downsample(torch.cat([cloud, weight[:, None].to(cloud.dtype)], dim=1),
                          voxel_size)
    pts, mean_w = vr.points[:, :d], vr.points[:, d]
    w = mean_w * vr.weight        # mean * count == sum of the members' weights
    if d >= 6:
        pts = _renormalize_normals(pts)
    return subsample_packed(pts, w, vr.count, cap)


def _downsample_batch(clouds: torch.Tensor, weight: Optional[torch.Tensor],
                      voxel_size: float, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    out = [_downsample_cloud(c, None if weight is None else weight[b], voxel_size, cap)
           for b, c in enumerate(clouds)]
    return torch.stack([p for p, _ in out]), torch.stack([w for _, w in out])


def register_multiscale(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    cfg: ICPConfig = ICPConfig(),
    levels: Sequence[ScaleLevel] = (),
    key=None,
    warmup_stop_gradient: bool = True,
) -> MultiscaleResult:
    """Coarse-to-fine batched registration over a level pyramid, coarsest
    first; the last level is conventionally full resolution.

    The batched contract of :func:`registration.register` ((N, n, 3|6),
    (N, m, 3|6), (N, 4, 4) tensors on one device).  Each level runs ``cfg``
    with its own iteration budget, tolerance and optional trim and tier;
    coarse levels run with ``collect_histories=False``, the last one with
    ``cfg`` as given, so ``result`` keeps the full results contract.

    ``warmup_stop_gradient`` (default) detaches the pose handed from level
    to level: gradients are the last level's alone, which at a fixed point
    loses nothing.  ``key``: with Gumbel NN in a differentiable ``cfg``, a
    sequence of one noise source per level (see :func:`registration.register`);
    ignored otherwise."""
    if not levels:
        raise ValueError("levels must be a non-empty static sequence of "
                         "ScaleLevel (coarsest first)")
    for lv in levels:
        if lv.voxel_size > 0 and (lv.n_source <= 0 or lv.m_target <= 0):
            raise ValueError(f"level {lv}: downsampled levels need positive static slot "
                             f"budgets n_source/m_target")
    if cfg.use_gumbel and cfg.differentiable:
        if key is None:
            raise ValueError("Gumbel NN requires an explicit PRNG key: a sequence of one "
                             "noise source per level")
        keys = list(key)
        if len(keys) != len(levels):
            raise ValueError(f"key holds {len(keys)} noise sources for {len(levels)} levels")
    else:
        keys = [None] * len(levels)

    T = T_init
    level_T, level_iters = [], []
    result = None
    for li, lv in enumerate(levels):
        last = li == len(levels) - 1
        over = {}
        if lv.trim_dist is not None:
            over["trim_dist"] = lv.trim_dist
        if lv.nn_method is not None:
            over["nn_method"] = lv.nn_method
        lcfg = cfg.with_(max_iterations=lv.max_iterations, tolerance=lv.tolerance, **over)
        if not last:
            lcfg = lcfg.with_(collect_histories=False)
        if lv.voxel_size > 0:
            src, w = _downsample_batch(source, weight, lv.voxel_size, lv.n_source)
            tgt, _ = _downsample_batch(target, None, lv.voxel_size, lv.m_target)
        else:
            src, w, tgt = source, weight, target
        result = register(src, tgt, T, w, lcfg, keys[li])
        T = result.T
        level_T.append(T)
        level_iters.append(result.iterations)
        if warmup_stop_gradient and not last:
            T = T.detach()
    return MultiscaleResult(result=result, level_T=torch.stack(level_T),
                            level_iterations=torch.stack(level_iters))
