"""Exact cluster-pruned nearest-neighbour search for large clouds: the
counterpart of ``dicp_tpu/ops/cluster_knn.py``.

The design is the JAX module's (its docstring has the measured history):

1. **Build** once per target cloud: sort the m points along a Hilbert curve
   on a 1024^3 grid over the bounding box, cut the sorted order into G
   groups of ``g`` points, and keep each group's center and covering radius.
2. **Block-scattered query**: sort the queries along the same curve, cut them
   into blocks of 128, and select each block's P groups by the block-level
   lower bound ``|o - c| - r_blk - r_grp``.  Every query of a block searches
   the block's P*g candidates exactly.
3. **Certificate**: a query's answer is provably the global argmin when its
   distance is <= the lower bound minimised over the non-selected groups.
   Uncertified queries can be brute-forced (``fixup``).

Batch dimensions: where JAX ``vmap``-ed over clouds, every function here
takes an optional leading batch dimension (an index built from (B, m, 3)
points has (B, ...) fields and is queried with (B, n, 3) queries).

What must match the JAX code exactly, because it decides which groups are
built and searched:

* the keys are computed in int64 (``torch.uint32`` has no ``<<`` on the CPU),
  and equal JAX's uint32 keys (they are < 2^30);
* every sort is stable (``jnp.argsort`` is, ``torch.argsort`` is not by
  default), and ``lax.top_k`` (lowest index first on ties) becomes a stable
  ascending sort that keeps the first P;
* norms are ``sqrt((a0^2 + a1^2) + a2^2)``, summed in that order.

The searches reach the hand-written CUDA kernels of
:mod:`dicp_tpu_torch.ops.cluster_search` (K2, K5, K3) as JAX reaches its
Pallas kernels; the exactness fix-up and the rest are plain PyTorch on every
device, as JAX computed them outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dicp_tpu_torch.ops import cluster_search

SENTINEL = 1.0e15   # pad coordinate: d2 ~ 3e30, finite in f32, never wins
_QBLOCK = 128       # queries per selection block
# Query-block size of the fused kernel path; equal to _QBLOCK, so the fused
# and the plain paths select identical groups (cluster_knn.py:394-399).
FUSED_QBLOCK = 128
_EPS8 = 8.0 * float(torch.finfo(torch.float32).eps)
_INT32_MAX = 2**31 - 1


class ClusterIndex(NamedTuple):
    """Hilbert-grouped search structure over one target cloud (or a batch of
    them, with a leading batch dimension on every field).

    points  (G, g, 3)  sorted, grouped coordinates (pads = 1e15 sentinel)
    centers (G, 3)     per-group mean of the real points
    radius  (G,)       covering radius over the real points (ulp-inflated)
    order   (G*g,)     int32, sorted position -> original row (pads -> 0)
    frame   (2, 3)     f32 [bbox lo; bbox extent]: queries are curve-sorted
                       in this same quantization frame
    """

    points: torch.Tensor
    centers: torch.Tensor
    radius: torch.Tensor
    order: torch.Tensor
    frame: torch.Tensor


def _sq3(v: torch.Tensor) -> torch.Tensor:
    """(v0^2 + v1^2) + v2^2 over the last axis, in that order."""
    s = v[..., 0] * v[..., 0]
    s = s + v[..., 1] * v[..., 1]
    return s + v[..., 2] * v[..., 2]


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sq3(v))


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so they occupy every 3rd bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _bbox_frame(points: torch.Tensor) -> torch.Tensor:
    p = points[..., :3].to(torch.float32)
    lo = torch.amin(p, dim=-2)
    extent = torch.clamp(torch.amax(p, dim=-2) - lo, min=1e-30)
    return torch.stack([lo, extent], dim=-2)


def _quantize(points: torch.Tensor, frame: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """f32 ((p - lo) / extent) * 2^bits, clipped, then truncated (int64)."""
    p = points[..., :3].to(torch.float32)
    n = float(1 << bits)
    q = (p - frame[..., 0:1, :]) / frame[..., 1:2, :] * n
    return torch.clamp(q, 0.0, n - 1.0).to(torch.int64)


def morton_keys(points: torch.Tensor) -> torch.Tensor:
    """(..., m, 3) -> (..., m) int64 Morton codes on a 1024^3 grid over the
    bounding box (kept for comparison; the index uses :func:`hilbert_keys`)."""
    q = _quantize(points, _bbox_frame(points))
    return (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))


def hilbert_keys(points: torch.Tensor, bits: int = 10,
                 frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., m, 3) -> (..., m) int32 Hilbert-curve indices on a 1024^3 grid.

    Skilling's transpose algorithm ("Programming the Hilbert curve", 2004),
    vectorised over the cloud, in int64.  ``frame`` fixes the quantization
    box (queries reuse the index's frame)."""
    if frame is None:
        frame = _bbox_frame(points)
    q = _quantize(points, frame, bits)
    X = [q[..., 0], q[..., 1], q[..., 2]]

    # inverse undo excess work
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            hit = (X[i] & Q) != 0
            # bit set: invert the low bits of X[0]; else swap them with X[i]'s
            t = torch.where(hit, 0, (X[0] ^ X[i]) & P)
            x0_new = torch.where(hit, X[0] ^ P, X[0] ^ t)
            X[i] = torch.where(hit, X[i], X[i] ^ t)
            X[0] = x0_new
        Q >>= 1

    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]

    # transpose -> one index: X[0] holds the most significant bit of each level
    key = (_part1by2(X[0]) << 2) | (_part1by2(X[1]) << 1) | _part1by2(X[2])
    return key.to(torch.int32)


def _gather_rows(a: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """a (B, M, c) at rows (B, n) -> (B, n, c)."""
    rows = rows.long()
    return torch.gather(a, 1, rows[..., None].expand(rows.shape + a.shape[-1:]))


def build_cluster_index(points: torch.Tensor, group_size: int = 128) -> ClusterIndex:
    """Build the search structure for an (m, 3) cloud, or for each cloud of a
    (B, m, 3) batch.  No gradient flows through the index."""
    pts = points[..., :3].detach()
    batched = pts.dim() == 3
    if not batched:
        pts = pts[None]
    B, m = pts.shape[0], pts.shape[1]
    g = int(group_size)
    G = -(-m // g)
    pad = G * g - m
    dtype, device = pts.dtype, pts.device

    frame = _bbox_frame(pts)                                       # (B, 2, 3)
    keys = hilbert_keys(pts, frame=frame)
    order = torch.argsort(keys, dim=-1, stable=True).to(torch.int32)
    sorted_pts = _gather_rows(pts, order)
    if pad:
        sorted_pts = torch.cat(
            [sorted_pts, torch.full((B, pad, 3), SENTINEL, dtype=dtype, device=device)], 1)
        order = torch.cat(
            [order, torch.zeros((B, pad), dtype=torch.int32, device=device)], 1)
    grouped = sorted_pts.reshape(B, G, g, 3)

    valid = torch.arange(G * g, device=device).reshape(G, g) < m  # (G, g)
    nreal = torch.sum(valid, dim=1).to(dtype)                      # >= 1 always
    centers = (torch.sum(torch.where(valid[..., None], grouped, 0.0), dim=2)
               / nreal[:, None])
    d = _norm3(grouped - centers[:, :, None, :])
    # ulp-inflate, so f32 rounding can never shrink the covering ball
    radius = torch.amax(torch.where(valid, d, 0.0), dim=-1) * (1.0 + _EPS8)
    index = ClusterIndex(points=grouped, centers=centers, radius=radius,
                         order=order, frame=frame)
    return index if batched else _unbatch(index)


def _batch(index: ClusterIndex) -> ClusterIndex:
    return ClusterIndex(*(f[None] for f in index))


def _unbatch(index: ClusterIndex) -> ClusterIndex:
    return ClusterIndex(*(f[0] for f in index))


def query_order(index: ClusterIndex, x: torch.Tensor) -> torch.Tensor:
    """Curve-sort permutation (int32 (..., n)) of a query cloud in the
    index's frame.  Only a locality hint: it decides how queries are grouped
    into selection blocks, never which answers are valid."""
    return torch.argsort(hilbert_keys(x, frame=index.frame), dim=-1,
                         stable=True).to(torch.int32)


def _sorted_blocks(index: ClusterIndex, x: torch.Tensor, order=None,
                   qblock: int = _QBLOCK):
    """Sort (B, n, 3) queries along the index's curve and cut them into
    ``qblock`` blocks (the last padded by repeating the last query).

    Returns (xb (B, nb, Qb, 3), inv (B, n) unsort permutation, n)."""
    B, n = x.shape[0], x.shape[1]
    qord = query_order(index, x) if order is None else order
    xs = _gather_rows(x, qord)
    Qb = min(qblock, n)
    nb = -(-n // Qb)
    pad = nb * Qb - n
    if pad:
        xs = torch.cat([xs, xs[:, -1:].expand(B, pad, 3)], dim=1)
    # invert the permutation by a scatter (O(n)): a sort would re-sort
    inv = torch.zeros((B, n), dtype=torch.int32, device=x.device).scatter_(
        1, qord.long(), torch.arange(n, dtype=torch.int32, device=x.device).expand(B, n))
    return xs.reshape(B, nb, Qb, 3), inv, n


def _block_select(index: ClusterIndex, xb: torch.Tensor, probes: int):
    """Top-P groups per query block by the block-level lower bound, ranked by
    the unclamped margin |o - c| - r_blk - r_grp (clamped bounds tie at 0
    when the block cover overlaps many groups).  Returns (bsel (B, nb, P)
    int32, P)."""
    G = index.points.shape[-3]
    P = min(int(probes), G)
    B, nb = xb.shape[0], xb.shape[1]
    o = torch.mean(xb, dim=2)                                      # (B, nb, 3)
    rb = torch.amax(_norm3(xb - o[:, :, None, :]), dim=2)          # (B, nb)
    doc = _norm3(o[:, :, None, :] - index.centers[:, None].to(o.dtype))  # (B, nb, G)
    lbb = doc - rb[..., None] - index.radius[:, None].to(o.dtype)
    if P < G:
        # lax.top_k(-lbb, P): the P smallest margins, lowest group on ties
        bsel = torch.argsort(lbb, dim=-1, stable=True)[..., :P]
    else:
        bsel = torch.arange(G, device=xb.device).expand(B, nb, G)
    return bsel.to(torch.int32), P


def _group_lower_bounds(index: ClusterIndex, xb: torch.Tensor) -> torch.Tensor:
    """max(|x - c|(1 - 8 eps) - r, 0)^2 per (query, group), (B, nb, Qb, G)."""
    c = index.centers.to(xb.dtype)
    dc = _norm3(xb[:, :, :, None, :] - c[:, None, None, :, :])
    lb = torch.clamp(dc * (1.0 - _EPS8) - index.radius[:, None, None, :].to(xb.dtype),
                     min=0.0)
    return lb * lb


def _query_bounds(index: ClusterIndex, xb: torch.Tensor, bsel: torch.Tensor):
    """Per-query exactness bound: the min group lower bound over the
    NON-selected groups, (B, nb, Qb) in xb's dtype (inf when every group is
    selected).  Conservative under f32 rounding: |x - c| is deflated a few
    ulps, the radii are inflated at build time."""
    G = index.points.shape[-3]
    lb = _group_lower_bounds(index, xb)
    mask = torch.zeros(bsel.shape[:2] + (G,), dtype=xb.dtype, device=xb.device)
    mask.scatter_(-1, bsel.long(), torch.inf)
    return torch.amin(lb + mask[:, :, None, :], dim=-1)


def _gather_groups(index: ClusterIndex, bsel: torch.Tensor) -> torch.Tensor:
    """index.points (B, G, g, 3) at bsel (B, nb[, P]) -> (B, nb[, P], g, 3)."""
    b = torch.arange(bsel.shape[0], device=bsel.device)
    b = b.reshape((-1,) + (1,) * (bsel.dim() - 1))
    return index.points[b, bsel.long()]


def _candidate_pos(bsel: torch.Tensor, g: int) -> torch.Tensor:
    """Sorted-cloud row of each candidate column, (B, nb, P*g) int32."""
    B, nb, P = bsel.shape
    return (bsel[..., None] * g
            + torch.arange(g, dtype=torch.int32, device=bsel.device)).reshape(B, nb, P * g)


def _candidate_d2(index: ClusterIndex, xb: torch.Tensor, bsel: torch.Tensor,
                  return_cand: bool = False):
    """Exact squared distances to each block's P*g candidates.

    Returns (d2 (B, nb, Qb, P*g), pos (B, nb, P*g) sorted-cloud row of each
    candidate[, cand (B, nb, P*g, 3) when ``return_cand``])."""
    g = index.points.shape[-2]
    B, nb, P = bsel.shape
    cand = _gather_groups(index, bsel).to(xb.dtype).reshape(B, nb, P * g, 3)
    d2 = _sq3(xb[:, :, :, None, :] - cand[:, :, None, :, :])
    pos = _candidate_pos(bsel, g)
    if return_cand:
        return d2, pos, cand
    return d2, pos


def _candidate_argmin_scan(index: ClusterIndex, xb: torch.Tensor, bsel: torch.Tensor):
    """Running (best d2, sorted-cloud row) over the P groups, one group at a
    time: never materialises the (nb, Qb, P*g) matrix.  A strict '<' keeps the
    earlier group and argmin the lowest offset on ties."""
    g = index.points.shape[-2]
    best = torch.full(xb.shape[:3], torch.inf, dtype=xb.dtype, device=xb.device)
    brow = torch.zeros(xb.shape[:3], dtype=torch.int32, device=xb.device)
    for j in range(bsel.shape[-1]):
        grp = bsel[..., j]                                         # (B, nb)
        cand = _gather_groups(index, grp).to(xb.dtype)             # (B, nb, g, 3)
        d2 = _sq3(xb[:, :, :, None, :] - cand[:, :, None, :, :])   # (B, nb, Qb, g)
        larg = torch.argmin(d2, dim=-1, keepdim=True)
        lmin = torch.gather(d2, -1, larg)[..., 0]
        row = grp[..., None] * g + larg[..., 0].to(torch.int32)
        better = lmin < best
        best = torch.where(better, lmin, best)
        brow = torch.where(better, row, brow)
    return best, brow


def _unsort(arr: torch.Tensor, inv: torch.Tensor, n: int) -> torch.Tensor:
    """(B, nb, Qb, ...) block layout -> (B, n, ...) in the original query order."""
    flat = arr.reshape((arr.shape[0], -1) + arr.shape[3:])[:, :n]
    rows = inv.long().reshape(inv.shape + (1,) * (flat.dim() - 2))
    return torch.gather(flat, 1, rows.expand(inv.shape + flat.shape[2:]))


def _dense_argmin_stream(xs: torch.Tensor, pts: torch.Tensor, chunk: int = 4096,
                         ids: Optional[torch.Tensor] = None):
    """Exact brute-force argmin of ``xs`` (B, U, 3) against ``pts`` (B, M, 3),
    streaming target chunks through a running (d2, id) argmin.  ``ids``
    (B, M) labels each target row (the ORIGINAL rows of a Hilbert-sorted
    cloud); exact ties resolve to the lowest id.  Returns (id, d2) (B, U)."""
    B, M = pts.shape[0], pts.shape[1]
    if ids is None:
        ids = torch.arange(M, dtype=torch.int32, device=pts.device).expand(B, M)
    ids = ids.to(torch.int32)
    best = torch.full(xs.shape[:2], torch.inf, dtype=xs.dtype, device=xs.device)
    bid = torch.full(xs.shape[:2], _INT32_MAX, dtype=torch.int32, device=xs.device)
    for j0 in range(0, M, chunk):
        yc = pts[:, j0:j0 + chunk].to(xs.dtype)
        idc = ids[:, j0:j0 + chunk]
        d2 = _sq3(xs[:, :, None, :] - yc[:, None, :, :])          # (B, U, chunk)
        lmin = torch.amin(d2, dim=-1)
        # lowest id among the chunk's tied minima
        lid = torch.amin(torch.where(d2 == lmin[..., None], idc[:, None, :], _INT32_MAX),
                         dim=-1)
        better = (lmin < best) | ((lmin == best) & (lid < bid))
        best = torch.where(better, lmin, best)
        bid = torch.where(better, lid, bid)
    return bid, best


def _fixup_uncertified(index: ClusterIndex, x: torch.Tensor, idx, d2, cert,
                       budget: int):
    """Brute-force up to ``budget`` uncertified queries against the full cloud.

    Fixed shapes, as in JAX: the uncertified queries are compacted by their
    running count into U slots (certified queries and the overflow beyond U
    are written into a U+1-th slot that is then dropped, the counterpart of
    ``mode="drop"``); unwritten slots point at query 0 and rewrite its own
    values.  Queries beyond the budget keep ``certified=False``."""
    B, n = x.shape[0], x.shape[1]
    U = min(int(budget), n)
    unc = torch.logical_not(cert)
    slot = torch.cumsum(unc.to(torch.int64), dim=-1) - 1           # (B, n)
    dest = torch.clamp(torch.where(unc, slot, U), max=U)
    sel = torch.zeros((B, U + 1), dtype=torch.int64, device=x.device).scatter_(
        1, dest, torch.arange(n, device=x.device).expand(B, n))[:, :U]
    xs = _gather_rows(x, sel)
    # stream over the sorted cloud but tie-break by ORIGINAL row (ids =
    # index.order): the exact brute-force rule on duplicate points
    G, g = index.points.shape[1], index.points.shape[2]
    bf_idx, bf_d2 = _dense_argmin_stream(xs, index.points.reshape(B, G * g, 3),
                                         ids=index.order)
    take = torch.gather(unc, 1, sel)
    new_idx = idx.scatter(1, sel, torch.where(take, bf_idx, torch.gather(idx, 1, sel)))
    new_d2 = d2.scatter(1, sel, torch.where(take, bf_d2.to(d2.dtype),
                                            torch.gather(d2, 1, sel)))
    new_cert = cert.scatter(1, sel, True)  # brute force is exact by definition
    return new_idx, new_d2, new_cert


def _with_batch(index: ClusterIndex, x: torch.Tensor):
    """(index, x) with a leading batch dimension, and whether one was added."""
    if index.points.dim() == 4:
        if x.dim() != 3 or x.shape[0] != index.points.shape[0]:
            raise ValueError(f"a batched index of {index.points.shape[0]} clouds "
                             f"takes (B, n, 3) queries, got {tuple(x.shape)}")
        return index, x, False
    if x.dim() != 2:
        raise ValueError(f"an index of one cloud takes (n, 3) queries, got {tuple(x.shape)}")
    return _batch(index), x[None], True


def cluster_nn(index: ClusterIndex, x: torch.Tensor, probes: int = 16,
               use_pallas: Optional[bool] = None,
               order: Optional[torch.Tensor] = None,
               fixup: int = 0,
               fused: Optional[bool] = None,
               fused_qblock: int = FUSED_QBLOCK,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-certified 1-NN: (n, 3) queries -> (idx (n,) int32, d2 (n,),
    certified (n,) bool); with a batched index, (B, n, 3) -> (B, n).

    ``idx`` indexes the ORIGINAL target rows; ``certified`` is True where the
    answer is provably the global argmin.  Backends, as in JAX with "cuda" in
    the place of "not a CPU":

    * ``fused`` (None = on for CUDA queries unless ``use_pallas``): K2,
      :func:`cluster_search.fused_search` (its plain version on CPU tensors);
    * ``use_pallas=True``: K5, :func:`cluster_search.block_search`, with the
      bound computed in PyTorch;
    * otherwise the scan over groups (:func:`_candidate_argmin_scan`) in the
      queries' dtype.

    ``order``: a precomputed :func:`query_order` permutation.  ``fixup`` > 0:
    brute-force up to that many uncertified queries (:func:`_fixup_uncertified`).
    """
    ix, xq, added = _with_batch(index, x)
    ordq = order if order is None or not added else order[None]
    if fused is None:
        fused = x.is_cuda and not use_pallas
    with torch.no_grad():
        xq = xq[..., :3].detach()
        if fused:
            xb, inv, n = _sorted_blocks(ix, xq, ordq, qblock=fused_qblock)
            bsel, _ = _block_select(ix, xb, probes)
            best, rows, bound = cluster_search.fused_search(
                ix.points, ix.centers, ix.radius, xb, bsel)
            best, bound = best.to(xb.dtype), bound.to(xb.dtype)
        else:
            xb, inv, n = _sorted_blocks(ix, xq, ordq)
            bsel, _ = _block_select(ix, xb, probes)
            if use_pallas:
                best, rows = cluster_search.block_search(ix.points, xb, bsel)
                best = best.to(xb.dtype)
            else:
                best, rows = _candidate_argmin_scan(ix, xb, bsel)
            bound = _query_bounds(ix, xb, bsel)
        idx = _gather_rows(ix.order[..., None], rows.reshape(rows.shape[0], -1))[..., 0]
        idx = _unsort(idx.reshape(rows.shape), inv, n)
        cert = _unsort(best <= bound, inv, n)
        best = _unsort(best, inv, n)
        if fixup > 0:
            idx, best, cert = _fixup_uncertified(ix, xq, idx, best, cert, fixup)
    if added:
        return idx[0], best[0], cert[0]
    return idx, best, cert


def _topk_small(d2: torch.Tensor, k: int):
    """Ascending top-k by k argmin-and-mask passes: lowest column on ties,
    duplicates kept for later ranks (JAX's ``_topk_small``)."""
    cur = d2.clone()
    vals, cols = [], []
    for _ in range(k):
        j = torch.argmin(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, j))
        cols.append(j)
        cur.scatter_(-1, j, torch.inf)
    return torch.cat(vals, dim=-1), torch.cat(cols, dim=-1)


def cluster_knn(index: ClusterIndex, x: torch.Tensor, k: int, probes: int = 16,
                fused: Optional[bool] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-certified k-NN: -> (idx (n, k) int32, d2 (n, k), certified (n,)),
    neighbours in ascending distance; batched like :func:`cluster_nn`.

    ``certified`` requires the k-th distance to beat the best non-selected
    group's lower bound.  ``fused`` (None = on for CUDA queries with k <= 32):
    K3, :func:`cluster_search.fused_topk` (its plain version on CPU tensors);
    otherwise the candidate matrix and k extraction passes (a stable sort for
    k > 32) in the queries' dtype.  k larger than the P*g candidates of a
    block raises ``ValueError``."""
    ix, xq, added = _with_batch(index, x)
    G, g = ix.points.shape[1], ix.points.shape[2]
    if k > min(int(probes), G) * g:
        raise ValueError(f"k={k} exceeds the {min(int(probes), G) * g} candidates per block")
    if fused is None:
        fused = x.is_cuda and k <= 32
    with torch.no_grad():
        xq = xq[..., :3].detach()
        if fused:
            xb, inv, n = _sorted_blocks(ix, xq, qblock=FUSED_QBLOCK)
            bsel, _ = _block_select(ix, xb, probes)
            d2k, rows, bound = cluster_search.fused_topk(
                ix.points, ix.centers, ix.radius, xb, bsel, k)
            d2k, bound = d2k.to(xb.dtype), bound.to(xb.dtype)
        else:
            xb, inv, n = _sorted_blocks(ix, xq)
            bsel, _ = _block_select(ix, xb, probes)
            d2, pos = _candidate_d2(ix, xb, bsel)
            if k <= 32:
                d2k, j = _topk_small(d2, k)
            else:
                j = torch.argsort(d2, dim=-1, stable=True)[..., :k]
                d2k = torch.gather(d2, -1, j)
            rows = torch.gather(pos[:, :, None, :].expand(d2.shape), -1, j)
            bound = _query_bounds(ix, xb, bsel)
        B = rows.shape[0]
        idx = _gather_rows(ix.order[..., None], rows.reshape(B, -1))[..., 0]
        idx = _unsort(idx.reshape(rows.shape), inv, n)
        cert = _unsort(d2k[..., -1] <= bound, inv, n)
        d2k = _unsort(d2k, inv, n)
    if added:
        return idx[0], d2k[0], cert[0]
    return idx, d2k, cert


def cluster_nn_verified(points_target: torch.Tensor, x: torch.Tensor,
                        group_size: int = 128, probes: int = 16,
                        max_probes: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-driven fully exact 1-NN: doubles ``probes`` until every query is
    certified (offline use and tests; the solver uses a fixed ``probes`` and
    the fix-up).  Returns (idx, d2); raises if ``max_probes`` is not enough."""
    index = build_cluster_index(points_target, group_size)
    p = probes
    idx, d2, cert = cluster_nn(index, x, probes=p)
    while not bool(torch.all(cert)) and p < max_probes:
        p *= 2
        idx, d2, cert = cluster_nn(index, x, probes=p)
    if not bool(torch.all(cert)):
        raise RuntimeError(
            f"cluster_nn not certified at probes={p}; pathological geometry "
            "(use the brute-force kernel)")
    return idx, d2
