"""Surface normals from raw point clouds: the counterpart of
``dicp_tpu/ops/normals.py``.

PCA normals: the normal at p is the smallest-eigenvalue eigenvector of the
covariance of its neighbourhood.  As in JAX:

* three neighbourhood backends: a dense distance matrix and a stable top-k
  (small clouds), the exact cluster k-NN (:func:`cluster_knn.cluster_knn`,
  kernel K3 on CUDA), and :func:`estimate_normals_weighted`, which needs no
  k-NN: an Epanechnikov-weighted covariance over the cluster candidates;
* the 3x3 symmetric eigenproblem in closed form (trigonometric eigenvalues
  and an eigenspace projector), not ``torch.linalg.eigh``;
* 2-D scans get a 2x2 path (the in-plane contour normal).

Two rules of the JAX code that PyTorch does not share by default: ``lax.top_k``
returns the lowest index first on ties (here a stable ascending sort), and
``jnp.median`` of an even count is the mean of the two middle values (here
``(lo + hi) * 0.5`` of a sort; ``torch.median`` returns the lower one).  The
covariance and moment products are f32 matmuls on the card and need full f32
precision (TF32 off, as ``chip_smoke.py`` asserts).  Batch dimensions are
written out where JAX used ``vmap``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dicp_tpu_torch.knn import pairwise_sq_dist
from dicp_tpu_torch.ops import cluster_knn as ck


def smallest_eigvec_sym3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Smith's trigonometric eigenvalues lam1 >= lam2 >= lam3, then the lam3
    eigenspace as the column space of (A - lam1 I)(A - lam2 I), its largest
    column taken.  The matrix is first normalised by its largest entry, so the
    degeneracy guards are scale-free.  Isotropic neighbourhoods fall back to
    +z."""
    dtype = a.dtype
    scale = torch.clamp(torch.amax(torch.abs(a), dim=(-2, -1)), min=torch.finfo(dtype).tiny)
    a = a / scale[..., None, None]
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0 = a[..., 0, 0] - q
    d1 = a[..., 1, 1] - q
    d2 = a[..., 2, 2] - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    eps = torch.finfo(dtype).eps
    # relative degeneracy scale: isotropic if the spread << mean eigenvalue
    tol = eps * (1.0 + torch.abs(q))
    degenerate = p2 < tol * tol
    p = torch.sqrt(torch.where(degenerate, torch.ones_like(p2), p2) / 6.0)

    eye = torch.eye(3, dtype=dtype, device=a.device).expand(a.shape)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    det_b = (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
             - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
             + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0]))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3

    # (A - lam1)(A - lam2) projects onto the lam3 eigenspace
    m = (a - lam1[..., None, None] * eye) @ (a - lam2[..., None, None] * eye)
    norms2 = torch.sum(m * m, dim=-2)                      # (..., 3) column norms
    best = torch.argmax(norms2, dim=-1)                    # first on ties
    v = torch.gather(m, -1, best[..., None, None].expand(m.shape[:-1] + (1,)))[..., 0]
    vnorm = torch.sqrt(ck._sq3(v))[..., None]
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    bad = degenerate[..., None] | (vnorm < tol[..., None])
    safe = torch.where(bad, torch.ones_like(vnorm), vnorm)
    return torch.where(bad, ez, v / safe)


def _flat(x: torch.Tensor):
    """(..., n, c) -> ((B, n, c), leading shape)."""
    return x.reshape((-1,) + x.shape[-2:]), x.shape[:-2]


def knn_indices(points: torch.Tensor, k: int,
                query: Optional[torch.Tensor] = None,
                method: str = "auto",
                cluster_group: int = 128,
                cluster_probes: int = 16) -> torch.Tensor:
    """Indices (int32) of the k nearest points, self included, for each query:
    (..., n, k), nearest first.

    ``'dense'`` builds the (n, m) distance matrix and keeps the k smallest by
    a stable sort (lowest index on ties, like ``lax.top_k``); ``'cluster'``
    uses the exact cluster k-NN; ``'auto'`` switches above 4096^2 entries."""
    q = points if query is None else query
    n, m = q.shape[-2], points.shape[-2]
    if method == "auto":
        method = "cluster" if n * m > 4096 * 4096 else "dense"
    with torch.no_grad():
        if method == "cluster":
            pts, lead = _flat(points[..., :3])
            qq, _ = _flat(q[..., :3])
            index = ck.build_cluster_index(pts, cluster_group)
            idx, _, _ = ck.cluster_knn(index, qq, k=k, probes=cluster_probes)
            return idx.reshape(lead + (n, k))
        d2 = pairwise_sq_dist(q, points)
        return torch.argsort(d2, dim=-1, stable=True)[..., :k].to(torch.int32)


def _gather_neighbours(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, n, c) points at (B, n, k) indices -> (B, n, k, c)."""
    b = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[b, idx.long()]


def _orient(nrm: torch.Tensor, points: torch.Tensor, viewpoint: torch.Tensor):
    """Flip normals to face the viewpoint: n . (vp - p) >= 0."""
    flip = torch.sum(nrm * (viewpoint - points), dim=-1, keepdim=True) < 0.0
    return torch.where(flip, -nrm, nrm)


def _normals_single(points: torch.Tensor, neighbor_idx: torch.Tensor,
                    viewpoint: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n, 3) clouds + (B, n, k) neighbour indices -> (B, n, 3) oriented
    unit normals."""
    nbrs = _gather_neighbours(points, neighbor_idx)       # (B, n, k, 3)
    c = nbrs - torch.mean(nbrs, dim=-2, keepdim=True)
    cov = torch.einsum("bnka,bnkc->bnac", c, c) / k        # (B, n, 3, 3)
    return _orient(smallest_eigvec_sym3(cov), points, viewpoint)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis (keepdim): (lo + hi) * 0.5 of the two
    middle values of a sort (NaN when the row holds a NaN)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    lo, hi = s[..., (n - 1) // 2:(n - 1) // 2 + 1], s[..., n // 2:n // 2 + 1]
    med = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1, keepdim=True), torch.nan, med)


def estimate_normals_weighted(
    points: torch.Tensor,
    viewpoint: Optional[torch.Tensor] = None,
    bandwidth_scale: float = 3.5,
    probes: int = 16,
    group_size: int = 128,
) -> torch.Tensor:
    """Kernel-weighted PCA normals, the large-cloud path: (..., n, 3) -> (..., n, 3).

    Each point's covariance is an Epanechnikov-weighted moment sum over its
    cluster-index candidates, w = max(0, 1 - d2/h2), with h = bandwidth_scale
    * max(own 1-NN distance, block-median 1-NN distance); the moment sum is
    one fat-K matmul.  No k-NN selection is needed."""
    pts, lead = _flat(points[..., :3])
    if viewpoint is None:
        viewpoint = torch.zeros((3,), dtype=pts.dtype, device=pts.device)
    index = ck.build_cluster_index(pts, group_size)
    xb, inv, n = ck._sorted_blocks(index, pts)
    bsel, _ = ck._block_select(index, xb, probes)
    # the candidates are gathered from the cloud itself (sentinels at the
    # index's pads), so that gradient reaches the points as in JAX
    pos = ck._candidate_pos(bsel, index.points.shape[-2])
    real = pos < pts.shape[1]                              # (B, nb, C)
    rows = torch.gather(index.order, 1, pos.long().reshape(pos.shape[0], -1))
    cand = torch.where(real[..., None], ck._gather_rows(pts, rows).reshape(pos.shape + (3,)),
                       ck.SENTINEL)
    d2 = ck._sq3(xb[:, :, :, None, :] - cand[:, :, None, :, :])

    # adaptive bandwidth from the BLOCK-median 1-NN distance: a per-query
    # 1-NN bandwidth collapses on close pairs (rank-1 covariance)
    d2_pos = torch.where(d2 <= 0.0, torch.inf, d2)
    d2_nn = torch.amin(d2_pos, dim=-1)                     # (B, nb, Qb)
    d2_med = _median(d2_nn)[..., None]                     # (B, nb, 1, 1)
    h2 = (bandwidth_scale ** 2) * torch.maximum(d2_nn[..., None], d2_med)
    w = torch.clamp(1.0 - d2 / h2, min=0.0)                # Epanechnikov

    # center the candidates at the block mean BEFORE the moment sum: the
    # raw-moment covariance cancels catastrophically in f32 at scene-scale
    # coordinates.  Sentinel pads would poison the mean: mask them out.
    nreal = torch.clamp(torch.sum(real, dim=-1, keepdim=True).to(cand.dtype), min=1.0)
    o_b = (torch.sum(torch.where(real[..., None], cand, 0.0), dim=-2, keepdim=True)
           / nreal[..., None])                             # (B, nb, 1, 3)
    cand = cand - o_b

    # moments via ONE fat-K matmul: [S0 | S1 | S2(6)] = W @ M (C, 10)
    c0, c1, c2 = cand[..., 0:1], cand[..., 1:2], cand[..., 2:3]
    M = torch.cat([torch.ones_like(c0), cand, c0 * c0, c0 * c1, c0 * c2,
                   c1 * c1, c1 * c2, c2 * c2], dim=-1)      # (B, nb, C, 10)
    S = torch.einsum("bnqc,bncm->bnqm", w, M)              # (B, nb, Qb, 10)
    S0 = torch.clamp(S[..., 0:1], min=torch.finfo(pts.dtype).tiny)
    mu = S[..., 1:4] / S0
    m2 = S[..., 4:10] / S0
    cov = torch.stack([
        torch.stack([m2[..., 0], m2[..., 1], m2[..., 2]], dim=-1),
        torch.stack([m2[..., 1], m2[..., 3], m2[..., 4]], dim=-1),
        torch.stack([m2[..., 2], m2[..., 4], m2[..., 5]], dim=-1),
    ], dim=-2) - mu[..., :, None] * mu[..., None, :]
    nrm = ck._unsort(smallest_eigvec_sym3(cov), inv, n)
    return _orient(nrm, pts, viewpoint).reshape(lead + (n, 3))


def estimate_normals(
    points: torch.Tensor,
    k: int = 16,
    viewpoint: Optional[torch.Tensor] = None,
    neighbor_idx: Optional[torch.Tensor] = None,
    method: str = "auto",
) -> torch.Tensor:
    """PCA normals for a 3-D cloud (..., n, 3) -> unit normals (..., n, 3).

    ``viewpoint`` (3,) orients the normals to face it (default: the origin,
    the sensor frame).  ``neighbor_idx`` (..., n, k) skips the internal k-NN.
    ``method``: 'dense' / 'cluster' pick the exact k-NN backend
    (:func:`knn_indices`), 'weighted' uses :func:`estimate_normals_weighted`,
    'auto' is dense for small clouds and weighted above 4096^2 pairs."""
    pts = points[..., :3]
    if method == "auto" and neighbor_idx is None:
        n_m = pts.shape[-2] * pts.shape[-2]
        method = "weighted" if n_m > 4096 * 4096 else "dense"
    if method == "weighted" and neighbor_idx is None:
        return estimate_normals_weighted(pts, viewpoint=viewpoint)
    if neighbor_idx is None:
        neighbor_idx = knn_indices(pts, k, method=method)
    if viewpoint is None:
        viewpoint = torch.zeros((3,), dtype=pts.dtype, device=pts.device)
    flat, lead = _flat(pts)
    idx = neighbor_idx.reshape((-1,) + neighbor_idx.shape[-2:])
    out = _normals_single(flat, idx, viewpoint, k=neighbor_idx.shape[-1])
    return out.reshape(lead + out.shape[-2:])


def _normals_2d_single(xy: torch.Tensor, idx: torch.Tensor,
                       viewpoint: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) + (B, n, k) -> (B, n, 3) in-plane normals with z = 0."""
    nbrs = _gather_neighbours(xy, idx)                     # (B, n, k, 2)
    c = nbrs - torch.mean(nbrs, dim=-2, keepdim=True)
    cxx = torch.sum(c[..., 0] * c[..., 0], dim=-1)
    cyy = torch.sum(c[..., 1] * c[..., 1], dim=-1)
    cxy = torch.sum(c[..., 0] * c[..., 1], dim=-1)
    # smallest eigenvalue of [[cxx, cxy], [cxy, cyy]] (closed form)
    tr = cxx + cyy
    dxy = cxx - cyy
    gap = torch.sqrt(torch.clamp(dxy * dxy + 4.0 * cxy * cxy, min=0.0))
    lam_min = 0.5 * (tr - gap)
    # eigenvector (cxy, lam - cxx) or (lam - cyy, cxy): the better conditioned
    v1 = torch.stack([cxy, lam_min - cxx], dim=-1)
    v2 = torch.stack([lam_min - cyy, cxy], dim=-1)
    pick = torch.sum(v1 * v1, dim=-1, keepdim=True) >= torch.sum(v2 * v2, dim=-1, keepdim=True)
    v = torch.where(pick, v1, v2)
    vnorm = torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2])
    eps = torch.finfo(xy.dtype).eps * (1.0 + tr[..., None])
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    bad = vnorm < eps
    v = torch.where(bad, ex, v / torch.where(bad, torch.ones_like(vnorm), vnorm))
    v = _orient(v, xy, viewpoint[:2])
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def estimate_normals_2d(
    points: torch.Tensor,
    k: int = 8,
    viewpoint: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """In-plane contour normals for a planar scan (..., n, 2|3) -> (..., n, 3),
    z = 0 (the solver's dim=2 convention)."""
    xy = points[..., :2]
    pts3 = torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)
    idx = knn_indices(pts3, k)
    if viewpoint is None:
        viewpoint = torch.zeros((3,), dtype=xy.dtype, device=xy.device)
    flat, lead = _flat(xy)
    out = _normals_2d_single(flat, idx.reshape((-1,) + idx.shape[-2:]), viewpoint)
    return out.reshape(lead + out.shape[-2:])
