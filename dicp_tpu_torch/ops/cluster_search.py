"""Cluster-index block search kernels: the counterpart of
``dicp_tpu/ops/pallas_cluster.py``.

Three wrappers with the arguments and results of the Pallas functions:

* :func:`fused_search` (K2, ``fused_search_pallas``): each query's best d2
  and sorted-cloud row over its block's P*g candidates, plus the
  certification bound (the min over the NON-selected groups of
  ``max(|x - c|(1 - 8 eps) - r, 0)^2``);
* :func:`block_search` (K5, ``block_search_pallas``): the same argmin
  without the bound;
* :func:`fused_topk` (K3, ``fused_topk_pallas``): the k best (ascending,
  lowest candidate column on ties, duplicates kept) and the same bound.

Inputs: grouped points (G, g, 3), centers (G, 3), radii (G,), query blocks
xb (nb, Qs, 3) and the selected groups bsel (nb, P) int32, each with an
optional leading batch dimension.  Rows index the sorted cloud
(``bsel[j] * g + offset``).  The arithmetic is f32 whatever the inputs'
dtype, as in the Pallas kernels: d2 = ((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2
summed in that order, the first candidate column in (probe, offset) order
wins ties, and when every distance is inf the row is candidate column 0's
(K2, K3) or 0 (K5), like the Pallas initial values.

One deviation from Pallas: it pads the centers to a multiple of 128 with
1e15 sentinels, so when every real group is selected (P = G) its bound is
about 3e30; here the bound is the min over the G real groups only and is inf
then, like the XLA path (``cluster_knn._query_bounds``).  The certificate is
the same.  A group whose center or radius is NaN (from a NaN point) makes
the plain versions' bound NaN for every query; the kernels' bound is 0 for a
block that did not select the group (and for a NaN query), and leaves the
group out where it was selected and searched.  Neither certifies past it.

Routing is by device only: CPU tensors go to the ``*_plain`` versions, CUDA
tensors launch the hand-written kernels ``csrc/cluster_search.cu`` (K2, K5)
and ``csrc/cluster_topk.cu`` (K3) or raise.  A group id outside [0, G)
stops either kernel (``__trap``), so the CUDA routes never synchronise with
the host.  Each wrapper counts its kernel launches in a plain integer
attribute, ``fused_search.launches`` etc.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dicp_tpu_torch.ops import _build

_EPS8 = 8.0 * float(torch.finfo(torch.float32).eps)
# Elements of one (blocks, Qs, P*g) candidate tile in the plain versions.
_PLAIN_BLOCK = 1 << 24
# Kernel limits (csrc/cluster_search.cu, csrc/cluster_topk.cu): up to 1024
# queries per block (K3: one thread per query with a 32-entry list in
# registers, hence fewer), the selected-group bitmap in shared memory.
MAX_QS = 1024
MAX_QS_TOPK = 256
MAX_GROUPS = 1 << 20
MAX_K = 32
_MAX_BATCH = 65535  # gridDim.y
# K2/K5's schedule (csrc/cluster_search.cu): LANE_Q queries per lane, so a
# warp holds GROUP_Q queries; a block of at most WARPS warps splits the
# staged candidate columns into S = WARPS // ceil(Qs / GROUP_Q) slices; the
# selected slabs are staged MAX_SLAB_BYTES at a time (one pass at P = 32,
# g = 128), so a group holds at most MAX_GROUP_SIZE points; a slice keeps a
# running minimum per CHUNK columns.
LANE_Q = 4
CHUNK = 32
GROUP_Q = 32 * LANE_Q
WARPS = 8
MAX_SLAB_BYTES = 64 * 1024
MAX_GROUP_SIZE = MAX_SLAB_BYTES // 12


def _prepare(points, centers, radius, xb, bsel):
    """Check shapes and devices; return f32/int32 tensors with a batch
    dimension, and whether it was added."""
    batched = points.dim() == 4
    lead = 1 if batched else 0
    if points.dim() != 3 + lead or points.shape[-1] != 3:
        raise ValueError(f"points must be ([B,] G, g, 3), got {tuple(points.shape)}")
    G, g = points.shape[-3], points.shape[-2]
    if xb.dim() != 3 + lead or xb.shape[-1] != 3:
        raise ValueError(f"xb must be ([B,] nb, Qs, 3), got {tuple(xb.shape)}")
    if bsel.dim() != 2 + lead or bsel.shape[-2] != xb.shape[-3] or bsel.shape[-1] < 1:
        raise ValueError(f"bsel must be ([B,] nb, P >= 1) with nb = {xb.shape[-3]}, "
                         f"got {tuple(bsel.shape)}")
    if centers is not None and (tuple(centers.shape[-2:]) != (G, 3)
                                or tuple(radius.shape[-1:]) != (G,)):
        raise ValueError(f"centers ({G}, 3) and radius ({G},) expected, got "
                         f"{tuple(centers.shape)} and {tuple(radius.shape)}")
    if batched and not (points.shape[0] == xb.shape[0] == bsel.shape[0]
                        and (centers is None or centers.shape[0] == radius.shape[0]
                             == points.shape[0])):
        raise ValueError("batch dimensions differ")
    tensors = [t for t in (points, centers, radius, xb, bsel) if t is not None]
    if len({t.device for t in tensors}) > 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if bsel.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"bsel must be int32 or int64, got {bsel.dtype}")

    def f32(t):
        if t is None:
            return None
        t = t.detach().to(torch.float32)
        return t if batched else t[None]

    bsel = bsel.detach().to(torch.int32)
    return (f32(points), f32(centers), f32(radius), f32(xb),
            bsel if batched else bsel[None], batched)


def _rows(sel: torch.Tensor, cols: torch.Tensor, g: int) -> torch.Tensor:
    """Candidate column (c, ...) -> sorted-cloud row sel[col // g] * g + col % g."""
    grp = torch.gather(sel, 1, torch.div(cols, g, rounding_mode="floor").long()
                       .reshape(cols.shape[0], -1)).reshape(cols.shape)
    return grp * g + torch.remainder(cols, g)


def _chunks(B: int, nb: int, Qs: int, width: int):
    """(b, block slice) pieces of at most ``_PLAIN_BLOCK`` distance entries."""
    step = max(1, _PLAIN_BLOCK // max(1, Qs * width))
    for b in range(B):
        for lo in range(0, nb, step):
            yield b, slice(lo, min(nb, lo + step))


def _candidate_d2_f32(points, x, sel):
    """Pallas-order f32 d2 of queries x (c, Qs, 3) to their candidates
    points[sel] (c, P*g, 3): (c, Qs, P*g)."""
    cand = points[sel.long()].reshape(sel.shape[0], -1, 3)        # (c, P*g, 3)
    diff = x[:, :, None, 0] - cand[:, None, :, 0]
    d2 = diff * diff
    for c in (1, 2):
        diff = x[:, :, None, c] - cand[:, None, :, c]
        d2 = d2 + diff * diff
    return d2


def _bound_f32(centers, radius, x, sel):
    """min over the non-selected groups of max(|x-c|(1-8eps) - r, 0)^2, in
    the kernels' f32 order: x (c, Qs, 3), sel (c, P) -> (c, Qs)."""
    diff = x[:, :, None, 0] - centers[None, None, :, 0]
    dc2 = diff * diff
    for c in (1, 2):
        diff = x[:, :, None, c] - centers[None, None, :, c]
        dc2 = dc2 + diff * diff
    lb = torch.clamp(torch.sqrt(dc2) * (1.0 - _EPS8) - radius[None, None, :], min=0.0)
    lb = lb * lb
    pen = torch.zeros(sel.shape[0], centers.shape[0], dtype=torch.float32,
                      device=x.device).scatter_(-1, sel.long(), torch.inf)
    return torch.amin(lb + pen[:, None, :], dim=-1)


def _search_plain(points, centers, radius, xb, bsel, with_bound: bool):
    B, nb, Qs, _ = xb.shape
    g, P = points.shape[-2], bsel.shape[-1]
    best = torch.empty((B, nb, Qs), dtype=torch.float32, device=xb.device)
    row = torch.empty((B, nb, Qs), dtype=torch.int32, device=xb.device)
    bound = torch.empty((B, nb, Qs), dtype=torch.float32, device=xb.device) \
        if with_bound else None
    for b, blk in _chunks(B, nb, Qs, P * g):
        x, sel = xb[b, blk], bsel[b, blk]
        d2 = _candidate_d2_f32(points[b], x, sel)
        col = torch.argmin(d2, dim=-1)                             # first on ties
        best[b, blk] = torch.gather(d2, -1, col[..., None])[..., 0]
        row[b, blk] = _rows(sel, col.to(torch.int32), g)
        if with_bound:
            bound[b, blk] = _bound_f32(centers[b], radius[b], x, sel)
    if not with_bound:
        # the Pallas K5 starts from row 0 where K2 starts from column 0
        row = torch.where(best < torch.inf, row, torch.zeros_like(row))
    return best, row, bound


def fused_search_plain(points, centers, radius, xb, bsel):
    """Plain PyTorch version of K2, on any device: (best d2 (…, nb, Qs) f32,
    sorted-cloud row (…, nb, Qs) int32, bound (…, nb, Qs) f32)."""
    *t, batched = _prepare(points, centers, radius, xb, bsel)
    out = _search_plain(*t, with_bound=True)
    return out if batched else tuple(o[0] for o in out)


def block_search_plain(points, xb, bsel):
    """Plain PyTorch version of K5, on any device: (best d2, row)."""
    p, _, _, x, s, batched = _prepare(points, None, None, xb, bsel)
    best, row, _ = _search_plain(p, None, None, x, s, with_bound=False)
    return (best, row) if batched else (best[0], row[0])


def fused_topk_plain(points, centers, radius, xb, bsel, k: int):
    """Plain PyTorch version of K3, on any device: the Pallas kernel's k
    argmin-and-mask passes over the candidate tile.  Returns (d2 (…, nb,
    Qs, k) f32 ascending, rows (…, nb, Qs, k) int32, bound (…, nb, Qs))."""
    p, c, r, x, s, batched = _prepare(points, centers, radius, xb, bsel)
    g, P = p.shape[-2], s.shape[-1]
    _check_k(k, P * g)
    B, nb, Qs, _ = x.shape
    d2k = torch.empty((B, nb, Qs, k), dtype=torch.float32, device=x.device)
    rows = torch.empty((B, nb, Qs, k), dtype=torch.int32, device=x.device)
    bound = torch.empty((B, nb, Qs), dtype=torch.float32, device=x.device)
    for b, blk in _chunks(B, nb, Qs, P * g):
        xq, sel = x[b, blk], s[b, blk]
        cur = _candidate_d2_f32(p[b], xq, sel)
        for j in range(k):
            col = torch.argmin(cur, dim=-1, keepdim=True)          # lowest column
            d2k[b, blk, :, j] = torch.gather(cur, -1, col)[..., 0]
            rows[b, blk, :, j] = _rows(sel, col[..., 0].to(torch.int32), g)
            cur.scatter_(-1, col, torch.inf)                       # only the winner
        bound[b, blk] = _bound_f32(c[b], r[b], xq, sel)
    out = (d2k, rows, bound)
    return out if batched else tuple(o[0] for o in out)


def _check_k(k: int, candidates: int) -> None:
    if not 1 <= k <= candidates:
        raise ValueError(f"k={k} must be in [1, {candidates}] (the P*g candidates "
                         "per block)")


# ---------------------------------------------------------------- CUDA kernels

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _search_kernel():
    fn = _build.load("cluster_search").cluster_search_launch
    fn.argtypes = [_PTR] * 5 + [_INT] * 7 + [_PTR] * 3 + [_INT, _PTR]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _topk_kernel():
    fn = _build.load("cluster_topk").cluster_topk_launch
    fn.argtypes = [_PTR] * 5 + [_INT] * 7 + [_PTR] * 3 + [_INT, _PTR]
    fn.restype = ctypes.c_int
    return fn


def search_plan(Qs: int, g: int, P: int):
    """K2/K5's schedule, as ``cluster_search_launch`` computes it: (query
    groups of GROUP_Q, column slices, selected groups staged per pass).
    Raises on a group the kernel cannot stage."""
    if g > MAX_GROUP_SIZE:
        raise ValueError(f"cluster_search stages whole (g, 3) f32 groups of at most "
                         f"{MAX_SLAB_BYTES} bytes: g = {g} > {MAX_GROUP_SIZE}")
    qg = -(-Qs // GROUP_Q)
    return qg, WARPS // qg, min(P, MAX_SLAB_BYTES // (12 * g))


def topk_plan(Qs: int, k: int) -> dict:
    """K3's schedule, as ``cluster_topk_launch`` computes it: one thread per
    query keeps a sorted list of K = next power of two >= k (d2, column)
    entries over all the block's candidates, in a block of Qs threads.
    Raises on what the kernel cannot take."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"cluster_topk takes 1 <= k <= {MAX_K} on CUDA, got {k}")
    if not 1 <= Qs <= MAX_QS_TOPK:
        raise ValueError(f"cluster_topk takes 1 <= Qs <= {MAX_QS_TOPK} queries per block, "
                         f"got {Qs}")
    return {"K": 1 << (k - 1).bit_length(), "threads": Qs}


def _check_cuda(points, xb, name: str, max_qs: int = MAX_QS) -> None:
    """Limits of the kernels, checked before any pointer is passed.  No
    device-to-host synchronisation: the group ids are checked in the
    kernels."""
    B, G, g = points.shape[0], points.shape[1], points.shape[2]
    nb, Qs = xb.shape[1], xb.shape[2]
    if not 1 <= Qs <= max_qs:
        raise ValueError(f"{name} takes 1 <= Qs <= {max_qs} queries per block, got {Qs}")
    if G > MAX_GROUPS:
        raise ValueError(f"{name} takes at most {MAX_GROUPS} groups, got {G}")
    if B > _MAX_BATCH or B * G * g * 3 >= 2**31 or B * nb * Qs * MAX_K >= 2**31:
        raise ValueError(f"{name}: batch {B} or sizes beyond the kernel's 32-bit grid")


def _check_range(bsel, G: int, name: str) -> None:
    """Group ids in [0, G), for the CPU routes (the kernels check in the
    kernel)."""
    if bool(((bsel < 0) | (bsel >= G)).any()):
        raise ValueError(f"{name}: bsel holds group ids outside [0, {G})")


def _launch(kernel, name, tensors, width: int, out) -> bool:
    """Launch on the tensors' device and current stream (``tensors`` are
    contiguous: points, centers, radius, xb, bsel, None where unused); raise
    on an error.  Returns whether a kernel was launched."""
    points, xb, bsel = tensors[0], tensors[3], tensors[4]
    B, G, g = points.shape[0], points.shape[1], points.shape[2]
    nb, Qs, P = xb.shape[1], xb.shape[2], bsel.shape[2]
    if B == 0 or nb == 0:
        return False
    err = kernel(*(None if t is None else t.data_ptr() for t in tensors),
                 B, G, g, nb, Qs, P, width,
                 *(None if o is None else o.data_ptr() for o in out),
                 xb.device.index, torch.cuda.current_stream(xb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return True


def _cuda_search(points, centers, radius, xb, bsel, with_bound: bool):
    """A group id outside [0, G) stops the kernel (``__trap``): the stream
    reports a CUDA error at its next synchronisation."""
    name = "cluster_search" if with_bound else "cluster_block_search"
    _check_cuda(points, xb, name)
    search_plan(xb.shape[2], points.shape[2], bsel.shape[2])
    B, nb, Qs = xb.shape[:3]
    best = torch.empty((B, nb, Qs), dtype=torch.float32, device=xb.device)
    row = torch.empty((B, nb, Qs), dtype=torch.int32, device=xb.device)
    bound = torch.empty((B, nb, Qs), dtype=torch.float32, device=xb.device) \
        if with_bound else None
    tensors = [None if t is None else t.contiguous()
               for t in (points, centers, radius, xb, bsel)]
    launched = _launch(_search_kernel(), name, tensors, int(with_bound), (best, row, bound))
    return best, row, bound, launched


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"cluster search runs on cpu or cuda tensors, got {x.device}")


def fused_search(points, centers, radius, xb, bsel):
    """K2: (best d2 (…, nb, Qs) f32, sorted-cloud row (…, nb, Qs) int32,
    bound (…, nb, Qs) f32).  No gradient."""
    if _route(xb) == "cpu":
        _check_range(bsel, points.shape[-3], "cluster_search")
        return fused_search_plain(points, centers, radius, xb, bsel)
    *t, batched = _prepare(points, centers, radius, xb, bsel)
    best, row, bound, launched = _cuda_search(*t, with_bound=True)
    fused_search.launches += int(launched)
    out = (best, row, bound)
    return out if batched else tuple(o[0] for o in out)


def block_search(points, xb, bsel):
    """K5: (best d2 (…, nb, Qs) f32, sorted-cloud row (…, nb, Qs) int32), K2's
    kernel with the bound phase off.  No gradient."""
    if _route(xb) == "cpu":
        _check_range(bsel, points.shape[-3], "cluster_block_search")
        return block_search_plain(points, xb, bsel)
    p, _, _, x, s, batched = _prepare(points, None, None, xb, bsel)
    best, row, _, launched = _cuda_search(p, None, None, x, s, with_bound=False)
    block_search.launches += int(launched)
    return (best, row) if batched else (best[0], row[0])


def fused_topk(points, centers, radius, xb, bsel, k: int):
    """K3: (d2 (…, nb, Qs, k) f32 ascending, rows (…, nb, Qs, k) int32,
    bound (…, nb, Qs) f32), k <= 32 on CUDA.  No gradient.  A group id
    outside [0, G) stops the kernel (``__trap``): the stream reports a CUDA
    error at its next synchronisation."""
    if _route(xb) == "cpu":
        return fused_topk_plain(points, centers, radius, xb, bsel, k)
    p, c, r, x, s, batched = _prepare(points, centers, radius, xb, bsel)
    _check_k(k, p.shape[2] * s.shape[2])
    _check_cuda(p, x, "cluster_topk", MAX_QS_TOPK)
    topk_plan(x.shape[2], k)
    B, nb, Qs = x.shape[:3]
    d2k = torch.empty((B, nb, Qs, k), dtype=torch.float32, device=x.device)
    rows = torch.empty((B, nb, Qs, k), dtype=torch.int32, device=x.device)
    bound = torch.empty((B, nb, Qs), dtype=torch.float32, device=x.device)
    tensors = [t.contiguous() for t in (p, c, r, x, s)]
    fused_topk.launches += int(_launch(_topk_kernel(), "cluster_topk", tensors, k,
                                       (d2k, rows, bound)))
    out = (d2k, rows, bound)
    return out if batched else tuple(o[0] for o in out)


fused_search.launches = 0
block_search.launches = 0
fused_topk.launches = 0
