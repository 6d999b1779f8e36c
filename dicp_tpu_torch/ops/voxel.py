"""Static-shape voxel-grid downsampling: the counterpart of
``dicp_tpu/ops/voxel.py``.

Fixed output shape (n, c) with a validity weight instead of a dynamic
compaction: one centroid per occupied voxel in the leading slots, zeros
after.  Zero rows with zero weight are the solver's padding convention, so
the result feeds a solve directly.

A lexicographic sort of the int32 cell coordinates, then a sum per run of
equal cells.  Both steps fix their order, so a call gives the same bits on
every run and on every device, and the same bits as JAX's:

* three stable argsorts, least significant key first, are ``jnp.lexsort``
  (a linearised key would overflow int32 for a 200 m extent at 5 cm);
* ``torch.segment_reduce`` over the sorted rows sums each segment in row
  order, as ``segment_sum(indices_are_sorted=True)`` does, where
  ``index_add_`` would use atomics on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelResult(NamedTuple):
    points: torch.Tensor  # (n, c) voxel centroids in leading slots, zeros after
    weight: torch.Tensor  # (n,) points-per-voxel count (0 for padding slots)
    count: torch.Tensor   # () int32 number of occupied voxels


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def voxel_downsample(points: torch.Tensor, voxel_size: float,
                     origin: float = 0.0) -> VoxelResult:
    """Average all points falling in each (voxel_size)^3 cell.

    points (n, >=3) on any device: extra columns (e.g. normals) are averaged
    too.  Returns fixed-shape output; use ``weight > 0`` as the validity mask
    or feed ``points``/``weight`` straight into the solver.  No host sync.
    """
    n = points.shape[0]
    dtype = points.dtype
    cell = torch.floor((points[:, :3] - origin) / voxel_size).to(torch.int32)
    order = _lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    cell_s = cell[order]
    pts_s = points[order]

    new_seg = torch.cat([torch.ones((1,), dtype=torch.bool, device=points.device),
                         torch.any(cell_s[1:] != cell_s[:-1], dim=1)])
    seg_idx = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1   # (n,) segment per point
    num_seg = seg_idx[-1] + 1

    # one pass for sums and counts (a ones column), n segments of which the
    # ones past num_seg are empty
    aug = torch.cat([pts_s, torch.ones((n, 1), dtype=dtype, device=points.device)], dim=1)
    # the segments' lengths from their ends in the sorted ids: a fixed shape
    # and no host sync (bincount and segment_reduce's own checks would sync)
    ends = torch.searchsorted(seg_idx, torch.arange(n, device=points.device), right=True)
    lengths = torch.diff(ends, prepend=ends.new_zeros((1,)))
    agg = torch.segment_reduce(aug, "sum", lengths=lengths, axis=0, initial=0, unsafe=True)
    sums, counts = agg[:, :-1], agg[:, -1]
    centroids = sums / torch.where(counts[:, None] == 0, 1.0, counts[:, None])

    valid = torch.arange(n, device=points.device) < num_seg
    return VoxelResult(
        points=torch.where(valid[:, None], centroids, 0.0),
        weight=torch.where(valid, counts, 0.0),
        count=num_seg.to(torch.int32),
    )
