"""Scan-to-map odometry: each scan registered against a persistent local map,
the counterpart of ``dicp_tpu/mapping.py``.

Registering against an accumulated world-frame map anchors every scan to
geometry posed many frames ago, so per-pair errors stop compounding into
drift.  The design is the JAX module's (its docstring has the measured
history):

* **a fused voxel map** (:class:`LocalMap`): a fixed-capacity row buffer,
  one row per occupied world voxel, holding the count-weighted mean position
  and the mean of the normals' outer products n n^T (orientation-free
  fusion).  Merging a scan re-buckets the union of the map's rows and the
  scan's points into voxels in one lexsort and one segment reduction;
* **LRU eviction**: every row carries the scan index that last observed it;
  beyond capacity the stalest rows go;
* **a bounded sentinel**: empty rows sit just beyond the occupied bounding
  box (hi + 2 extent + 1), which keeps the cluster index's Hilbert frame
  meaningful;
* **an absolute-pose solve from an EMA-damped motion prediction**
  (:func:`scan_to_map_odometry`).

What must match the JAX code bit for bit, because it decides which rows
share a voxel and which survive:

* the cells are floor(pos * (1 / voxel)) in the map's dtype: XLA's CPU
  compilation of the jitted ``map_merge`` rewrites the division by the
  static voxel as a product with its reciprocal (the two floor differently
  on cell boundaries for a voxel such as 0.35 in f64 or 0.3 in f32; 0.25 is
  exact either way);
* ``jnp.lexsort`` (stable, c0 most significant) is three stable argsorts
  from the least significant key (:func:`ops.voxel._lexsort`): the cells are
  not packed into one key, which the park cell does not bound;
* the segment sums run in row order (``torch.segment_reduce`` with lengths
  from ``searchsorted``, never ``index_add_``, whose atomics on the card
  would make two calls differ); the LRU keep is a stable argsort.

No step syncs with the host: the divergence guard keeps the old map through
a ``torch.where`` per field.  On the card the GN solve runs the cluster tier
(kernel K2) against the map; the SGD solve's mini-batch search is the plain
group scan (:mod:`dicp_tpu_torch.sgd_icp`).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.api import _resolve_device
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.odometry import OdometryResult
from dicp_tpu_torch.ops.normals import estimate_normals_weighted, smallest_eigvec_sym3
from dicp_tpu_torch.ops.voxel import _lexsort, segment_sum
from dicp_tpu_torch.pipeline import _prefetched, _quantize_host, _Uploader, dequantize_scan
from dicp_tpu_torch.registration import register
from dicp_tpu_torch.sgd_icp import SeededSampler, register_sgd

# Initial placeholder for empty rows (the dynamic bounded sentinel replaces
# it at the first merge).  Observation counts are deliberately uncapped: a
# capped count turns the running mean into an EMA that forgets the earliest,
# best-posed observations (dicp_tpu/mapping.py:66-76).
_MAP_PAD = 1.0e6


class LocalMap(NamedTuple):
    """Fixed-capacity fused world-frame voxel map: one row per occupied
    voxel (running-mean position, running-mean normal outer product as
    (xx, yy, zz, xy, xz, yz), observation count, scan index of the last
    observation) and the number of merges so far."""

    pos: torch.Tensor      # (cap, 3)
    m2: torch.Tensor       # (cap, 6)
    count: torch.Tensor    # (cap,) 0 = empty
    last: torch.Tensor     # (cap,) int32
    step: torch.Tensor     # () int32


def empty_map(cap: int, dtype=torch.float32, device=None) -> LocalMap:
    return LocalMap(pos=torch.full((cap, 3), _MAP_PAD, dtype=dtype, device=device),
                    m2=torch.zeros((cap, 6), dtype=dtype, device=device),
                    count=torch.zeros((cap,), dtype=dtype, device=device),
                    last=torch.full((cap,), -1, dtype=torch.int32, device=device),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _outer6(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normals -> (..., 6) unique entries of n n^T."""
    return torch.stack([n[..., 0] * n[..., 0], n[..., 1] * n[..., 1],
                        n[..., 2] * n[..., 2], n[..., 0] * n[..., 1],
                        n[..., 0] * n[..., 2], n[..., 1] * n[..., 2]], dim=-1)


def _principal_normals(m2: torch.Tensor) -> torch.Tensor:
    """(cap, 6) mean outer products -> (cap, 3) principal directions: the
    smallest eigenvector of tr(M) I - M."""
    a, b, c, d, e, f = (m2[:, 0], m2[:, 1], m2[:, 2], m2[:, 3], m2[:, 4], m2[:, 5])
    m3 = torch.stack([torch.stack([a, d, e], -1), torch.stack([d, b, f], -1),
                      torch.stack([e, f, c], -1)], -2)
    tr = (a + b + c)[:, None, None]
    eye = torch.eye(3, dtype=m2.dtype, device=m2.device).expand(m3.shape)
    return smallest_eigvec_sym3(tr * eye - m3)


def map_target(m: LocalMap, with_normals: bool = True) -> torch.Tensor:
    """Registration target (cap, 6): fused points and principal normals
    (zero normals for empty rows, or everywhere without ``with_normals``)."""
    if with_normals:
        nrm = torch.where((m.count > 0)[:, None], _principal_normals(m.m2), 0.0)
    else:
        nrm = torch.zeros_like(m.pos)
    return torch.cat([m.pos, nrm], dim=1)


def map_merge(m: LocalMap, scan_world: torch.Tensor, voxel: float,
              with_normals: bool = True, mode: str = "freeze") -> LocalMap:
    """Fuse a world-frame scan (n, >=3) into the map; voxels beyond capacity
    are evicted stalest-first (LRU).

    ``mode``: ``"mean"`` (count-weighted running means) or ``"freeze"`` (a
    voxel keeps its first observation's position and normal; later scans
    refresh its count and recency, and new voxels are appended).

    The union, its cells and the returned ``pos``, ``m2`` and ``count`` take
    the wider of the map's and the scan's dtypes, as JAX promotes them: an
    f32 map merged with an f64 scan becomes an f64 map.  The scan's normals
    are estimated in the scan's own dtype."""
    if mode not in ("freeze", "mean"):
        raise ValueError(f"mode must be freeze|mean, got {mode}")
    cap = m.pos.shape[0]
    dtype, device = torch.promote_types(m.pos.dtype, scan_world.dtype), m.pos.device
    pts = scan_world[:, :3]
    n = pts.shape[0]
    if with_normals:
        u_new = _outer6(estimate_normals_weighted(pts)).to(dtype)
    else:
        u_new = torch.zeros((n, 6), dtype=dtype, device=device)
    pts = pts.to(dtype)
    map_pos, map_count = m.pos.to(dtype), m.count.to(dtype)

    big = torch.finfo(m.pos.dtype).max
    old_valid = m.count > 0
    # invalid old rows: zero weight, parked just beyond the union's bounding
    # box, so that they share one cell and evict first
    lo_u = torch.minimum(torch.amin(torch.where(old_valid[:, None], map_pos, big), dim=0),
                         torch.amin(pts, dim=0))
    hi_u = torch.maximum(torch.amax(torch.where(old_valid[:, None], map_pos, -big), dim=0),
                         torch.amax(pts, dim=0))
    park = hi_u + 4.0 * (hi_u - lo_u) + 1.0
    old_pos = torch.where(old_valid[:, None], map_pos, park[None, :])
    all_pos = torch.cat([old_pos, pts])
    all_u = torch.cat([m.m2.to(dtype), u_new])
    ones = torch.ones((n,), dtype=dtype, device=device)
    all_w = torch.where(torch.cat([old_valid, ones > 0]), torch.cat([map_count, ones]), 0.0)
    all_last = torch.cat([m.last, (m.step + 1).to(torch.int32).expand(n)])
    all_last = torch.where(all_w > 0, all_last, -1)

    # XLA's rewrite of the division by the static voxel: x * (1 / voxel), the
    # reciprocal rounded to the union's dtype (on the host: no device copy)
    inv_voxel = (torch.ones((), dtype=dtype) / voxel).item()
    cell = torch.floor(all_pos * inv_voxel).to(torch.int32)
    order = _lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))
    cell_s, pos_s, u_s = cell[order], all_pos[order], all_u[order]
    w_s, last_s = all_w[order], all_last[order]
    is_old = (order < cap).to(dtype)          # the union row came from the map

    new_seg = torch.cat([torch.ones((1,), dtype=torch.bool, device=device),
                         torch.any(cell_s[1:] != cell_s[:-1], dim=1)])
    seg_idx = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    R = all_pos.shape[0]
    # weighted sums per voxel, the map's rows and the scan's points apart (a
    # voxel holds at most one map row)
    wo = (w_s * is_old)[:, None]
    wn = (w_s * (1.0 - is_old))[:, None]
    aug = torch.cat([pos_s * wo, u_s * wo, wo, pos_s * wn, u_s * wn, wn], dim=1)
    agg = segment_sum(aug, seg_idx, R)
    w_old, w_new = agg[:, 9], agg[:, 19]
    d_old = torch.where(w_old > 0, w_old, 1.0)[:, None]
    d_new = torch.where(w_new > 0, w_new, 1.0)[:, None]
    pos_old, u_old = agg[:, 0:3] / d_old, agg[:, 3:9] / d_old
    pos_new, u_new_seg = agg[:, 10:13] / d_new, agg[:, 13:19] / d_new
    w_seg = w_old + w_new
    if mode == "freeze":
        take_old = (w_old > 0)[:, None]
        pos_seg = torch.where(take_old, pos_old, pos_new)
        u_seg = torch.where(take_old, u_old, u_new_seg)
    else:
        denom = torch.where(w_seg > 0, w_seg, 1.0)[:, None]
        pos_seg = (pos_old * w_old[:, None] + pos_new * w_new[:, None]) / denom
        u_seg = (u_old * w_old[:, None] + u_new_seg * w_new[:, None]) / denom
    # segment max of the recency (exact in any order); empty segments are
    # masked below
    last_seg = torch.full((R,), -1, dtype=torch.int32, device=device).scatter_reduce(
        0, seg_idx, last_s, "amax", include_self=False)

    # keep the cap most recent voxels: a stable sort by -last, the empty
    # segments (w == 0) forced stalest
    last_key = torch.where(w_seg > 0, last_seg, -2).to(torch.int32)
    keep = torch.argsort(-last_key, stable=True)[:cap]
    pos_k, u_k = pos_seg[keep], u_seg[keep]
    w_k, last_k = w_seg[keep], last_seg[keep]
    valid = w_k > 0

    # the bounded dynamic sentinel for empty rows, just beyond the valid box
    lo = torch.amin(torch.where(valid[:, None], pos_k, big), dim=0)
    hi = torch.amax(torch.where(valid[:, None], pos_k, -big), dim=0)
    pad = hi + 2.0 * (hi - lo) + 1.0
    return LocalMap(pos=torch.where(valid[:, None], pos_k, pad[None, :]),
                    m2=torch.where(valid[:, None], u_k, 0.0),
                    count=torch.where(valid, w_k, 0.0),
                    last=torch.where(valid, last_k, -1),
                    step=m.step + 1)


def map_step(m: LocalMap, scan, t_pred: torch.Tensor, weight: Optional[torch.Tensor],
             cfg: ICPConfig, voxel: float, insert: bool = True, merge_mode: str = "freeze",
             solver: str = "gn", key=None, sgd_minibatch: int = 2048,
             sgd_iterations: int = 40, sgd_max_correction: float = 0.5,
             merge_subsample: Optional[int] = None, deq: Optional[torch.Tensor] = None):
    """One scan-to-map odometry step on the map's device.

    Solves scan -> map from the predicted world pose ``t_pred`` (the result
    is the world pose), then (``insert``) fuses the posed scan into the map.
    Returns (pose (4, 4), converged (), iterations (), new map).

    ``solver``: ``"gn"`` (:func:`registration.register` over every scan
    point) or ``"sgd"`` (:func:`sgd_icp.register_sgd` with the mini-batch
    source ``key``, required).  For ``"sgd"`` the returned ``converged`` and
    the merge guard are the pose-consistency gate: a finite pose whose
    correction log(t_pred^-1 pose) has norm <= ``sgd_max_correction`` (one
    norm over the mixed-unit 6-vector, as in JAX).  A solve that fails its
    gate is not merged; the map's ``step`` still advances.
    ``merge_subsample``: merge a strided subset of about that many posed
    points (the solve uses every point).  ``deq``: ``scan`` is the pipeline's
    packed quantized tuple, decoded by :func:`pipeline.dequantize_scan`."""
    if solver not in ("gn", "sgd"):
        raise ValueError(f"solver must be gn|sgd, got {solver}")
    if solver == "sgd" and key is None:
        raise ValueError("solver='sgd' needs an explicit PRNG key (the mini-batch sampler "
                         "must be reproducible): an int seed, a torch.Generator or a sampler")
    if deq is not None:
        scan = dequantize_scan(scan, deq)
    with_normals = cfg.icp_type != "pt2pt"
    target = map_target(m, with_normals)
    w = None if weight is None else weight[None]
    if solver == "sgd":
        res = register_sgd(
            scan[None, :, :3], target[None], t_pred[None], key, w,
            icp_type=cfg.icp_type, minibatch=sgd_minibatch, iterations=sgd_iterations,
            optimizer="gn", loss_name=cfg.loss_name, loss_metric=cfg.loss_metric,
            trim_dist=cfg.trim_dist, tolerance=cfg.tolerance, nn_method=cfg.nn_method)
        pose = res.T[0]
        corr = se3.tran2vec(se3.compose(se3.tran_inv(t_pred), pose))
        ok = (torch.all(torch.isfinite(pose))
              & (torch.linalg.vector_norm(corr) <= sgd_max_correction))
    else:
        res = register(scan[None, :, :3], target[None], t_pred[None], w, cfg)
        pose = res.T[0]
        ok = res.converged[0]
    if insert:
        scan_world = scan[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        if merge_subsample is not None and merge_subsample < scan.shape[0]:
            stride = -(-scan.shape[0] // merge_subsample)
            scan_world = scan_world[::stride]
        merged = map_merge(m, scan_world, voxel, with_normals=with_normals, mode=merge_mode)
        kept = m._replace(step=m.step + 1)
        new_map = LocalMap(*(torch.where(ok.reshape((1,) * a.dim()), a, b)
                             for a, b in zip(merged, kept)))
    else:
        new_map = m
    return pose, ok, res.iterations[0], new_map


def _scan_key(seed, k: int):
    """The mini-batch source of scan ``k``: an int seed derives its own
    stream per scan (JAX: ``fold_in(key(seed), k)``); a callable is asked."""
    if callable(seed):
        return seed(k)
    return SeededSampler(seed).fold_in(k)


def scan_to_map_odometry(
    scans: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    cfg: ICPConfig = ICPConfig(icp_type="pt2pl", differentiable=False,
                               collect_histories=False),
    capacity: int = 65536,
    voxel: float = 0.25,
    warm_start: bool = True,
    insert_every: int = 1,
    merge_mode: str = "mean",
    pred_alpha: float = 0.3,
    solver: str = "gn",
    sgd_minibatch: int = 2048,
    sgd_iterations: int = 40,
    sgd_max_correction: float = 0.5,
    merge_subsample: Optional[int] = None,
    quantize: bool = False,
    seed=0,
    device=None,
) -> OdometryResult:
    """Streaming scan-to-map odometry over (points (n, >=3), weight (n,) or
    None) numpy pairs.

    The first scan seeds the map at identity; every later scan is solved
    against the map from a predicted world pose and merged into it
    (:func:`map_step`).  Nothing is fetched to the host inside the stream:
    the poses stay device tensors.  ``device`` defaults to the card;
    ``"cpu"`` runs on the CPU.

    The motion prediction is EMA-damped (``pred_alpha``): t_pred = prev_pose
    @ exp(xi_ema), xi_ema an EMA of the relative-motion logs (a raw
    last-motion extrapolation ratchets into divergence against a noisy map,
    dicp_tpu/mapping.py:399-414); ``warm_start=False`` predicts prev_pose.
    ``insert_every``: merge every k-th scan only.  ``merge_mode``: "mean"
    or "freeze" (:func:`map_merge`).  ``solver="sgd"``: the stochastic
    front end; the source of scan k is derived from ``seed`` (an int), or
    ``seed(k)`` when ``seed`` is callable.

    Each scan crosses to the device in one pinned copy (on the card, on a
    copy stream), its host preparation in a prefetch thread.  ``quantize``:
    scans after the first cross as the pipeline's packed (n, 4) uint16
    transfer and are decoded inside the step (weightless scans only); the
    first scan seeds the map from its f32 points."""
    if cfg.icp_type not in ("pt2pt", "pt2pl"):
        raise ValueError("scan_to_map_odometry supports icp_type pt2pt|pt2pl "
                         "(the map stores fused points+normals); got %r" % cfg.icp_type)
    device = _resolve_device(device)
    upload = _Uploader(device, slots=4)
    with_normals = cfg.icp_type != "pt2pt"

    def prep(stream):
        """Host work per scan, in the prefetch thread."""
        first = True
        for pts_np, w_np in stream:
            if quantize and w_np is not None:
                raise ValueError("quantize=True requires weightless scans (weight transfer "
                                 "would defeat the byte budget; pass weight=None)")
            if quantize and not first:
                parts, deq_np = _quantize_host(pts_np)
                yield list(parts) + [deq_np], len(parts)
            else:
                pts = np.asarray(pts_np)
                pts = pts[:, :3] if quantize else pts   # the seed map's f32 points
                yield [pts.astype(np.float32) if quantize else pts] + (
                    [] if w_np is None else [np.asarray(w_np)]), None
            first = False

    m = None
    poses, convs, iters = [], [], []
    prev_pose = xi_ema = None
    for k, (arrays, n_parts) in enumerate(_prefetched(prep(scans))):
        views = upload(arrays)
        if m is None:
            seed_scan = views[0][:, :3]
            dtype = seed_scan.dtype
            m = map_merge(empty_map(capacity, dtype, device), seed_scan, voxel,
                          with_normals=with_normals, mode=merge_mode)
            pose = torch.eye(4, dtype=dtype, device=device)
            conv = torch.ones((), dtype=torch.bool, device=device)
            it = torch.zeros((), dtype=dtype, device=device)
            xi_ema = torch.zeros((6,), dtype=dtype, device=device)
        else:
            if n_parts is not None:
                scan, w, deq = tuple(views[:n_parts]), None, views[n_parts]
            else:
                scan, w, deq = views[0], (views[1] if len(views) > 1 else None), None
            t_pred = se3.compose(prev_pose, se3.vec2tran(xi_ema)) if warm_start else prev_pose
            pose, conv, it, m = map_step(
                m, scan, t_pred, w, cfg, voxel, insert=(k % insert_every == 0),
                merge_mode=merge_mode, solver=solver,
                key=_scan_key(seed, k) if solver == "sgd" else None,
                sgd_minibatch=sgd_minibatch, sgd_iterations=sgd_iterations,
                sgd_max_correction=sgd_max_correction, merge_subsample=merge_subsample,
                deq=deq)
            rel = se3.compose(se3.tran_inv(prev_pose), pose)
            xi_ema = (1.0 - pred_alpha) * xi_ema + pred_alpha * se3.tran2vec(rel)
        poses.append(pose)
        convs.append(conv)
        iters.append(it.to(dtype))
        prev_pose = pose
    if len(poses) < 2:
        raise ValueError("scan_to_map_odometry needs at least two scans")
    poses = torch.stack(poses)
    rel = se3.compose(se3.tran_inv(poses[:-1]), poses[1:])
    return OdometryResult(poses=poses, rel_transforms=rel, converged=torch.stack(convs),
                          iterations=torch.stack(iters))
