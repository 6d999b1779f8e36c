"""The schedules of the CUDA kernels K1 (``csrc/tiled_nn.cu``), K2/K5
(``csrc/cluster_search.cu``), K3 (``csrc/cluster_topk.cu``) and K4's
lane-split 1-NN (``csrc/fused_gn.cu``) and K6/K7's scoring core
(``csrc/score_nn.cu``), emulated on the CPU (in PyTorch; K3's 64-bit keys
in numpy) and held bit for bit against the plain versions they must equal.

The kernels cannot run here, but the orders they visit and merge candidates
in can: both keep a running minimum per CHUNK candidates and the first
chunk that attains a slice's minimum (a strict '<'), merge the slices, and
find the first index of the minimum again inside the winning chunk.  K1
cuts each block's targets into SLICES contiguous slices and merges them in
order; K2/K5 cut the staged candidate columns into S slices of a multiple of
4 columns, pass by pass, merge the slices by the lexicographic minimum of
(d2, chunk start) and take the bound's minimum over groups split across the
slices.  K3 gives each query a warp: the groups in order of their boxes'
lower bounds, skipped past the list's k-th d2, lanes over the columns, a
(d2, column) key below the k-th into the lane's queue, queues flushed into
a warp-wide list of K keys by a shuffle network or key by key, the first
group seeded from the lanes' minima, the fill (inf, column 0).  K4 splits
each point's targets over L lanes in chunks of 4 and merges the lanes'
(d2, index) pairs lexicographically.  K6 and K7 run K1's schedule over the
score columns: K6 per target tile, its partials carried in tile order, K7
over every column; where a target point is NaN they lose only its column,
and the plain versions its whole tile.  The emulations
read the schedule's constants from the wrapper modules, and a test holds
those to the ``constexpr`` values of the ``.cu`` sources.  No JAX is needed.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dicp_tpu_torch.benchmarks import exp_knn  # noqa: E402
from dicp_tpu_torch.ops import cluster_search, fused_gn, tiled_knn  # noqa: E402

CSRC = Path(tiled_knn.__file__).resolve().parent.parent / "csrc"
INF = math.inf


def _f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _d2(x, y):
    """((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2 of x (..., n, 3) against y (..., k, 3)."""
    diff = x[..., :, None, 0] - y[..., None, :, 0]
    d2 = diff * diff
    for c in (1, 2):
        diff = x[..., :, None, c] - y[..., None, :, c]
        d2 = d2 + diff * diff
    return d2


def _carry(best, arg, b2, a2):
    """Fold a later part into the running (best, arg) with a strict '<'."""
    better = b2 < best
    return torch.where(better, b2, best), torch.where(better, a2, arg)


def _chunk_minima(d2, chunk):
    """A running minimum per chunk of the last axis (a slice's columns in
    order) and a strict '<' between chunks: (best, first column of the first
    chunk that attains it), (inf, 0) when no distance is below inf."""
    d2 = torch.where(torch.isnan(d2), INF, d2)  # fminf and '<' skip a NaN
    best = torch.full(d2.shape[:-1], INF)
    start = torch.zeros(d2.shape[:-1], dtype=torch.int64)
    for c0 in range(0, d2.shape[-1], chunk):
        best, start = _carry(best, start, d2[..., c0:c0 + chunk].amin(-1),
                             torch.full_like(start, c0))
    return best, start


def _first_in_chunk(d2, best, start, chunk):
    """The re-scan: the first column of [start, start + chunk) whose d2
    equals best, or 0 when best is inf."""
    cols = torch.arange(d2.shape[-1])
    inside = (cols >= start[..., None]) & (cols < start[..., None] + chunk)
    first = torch.where(inside & (d2 == best[..., None]), cols, d2.shape[-1]).amin(-1)
    return torch.where(best < INF, first, torch.zeros_like(first))


# ---------------------------------------------------------------- K1

def emulate_k1(x, y):
    """csrc/tiled_nn.cu's schedule: slice s of slice_width(m) targets per
    warp, walked in TILE-target stages of CHUNK-target running minima,
    slices merged in order, the first index re-found in the winning chunk."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    m = y.shape[-2]
    assert tiled_knn.TILE % tiled_knn.CHUNK == 0  # chunks never straddle stages
    d2 = _d2(x, y)
    width = tiled_knn.slice_width(m)
    merged = None
    for s in range(tiled_knn.SLICES):
        lo = min(m, s * width)
        best, start = _chunk_minima(d2[..., lo:min(m, lo + width)], tiled_knn.CHUNK)
        merged = (best, start + lo) if merged is None else _carry(*merged, best, start + lo)
    best, start = merged
    return _first_in_chunk(d2, best, start, tiled_knn.CHUNK).to(torch.int32), best


def _k1_cases():
    rng = np.random.default_rng(50)
    cases = {}
    # the nearest target duplicated at 251 | 252, a slice boundary of m = 1000
    # (slices of 252), and at 127 | 128, a stage boundary inside slice 0
    y = rng.normal(size=(1, 1000, 3))
    y[0, 252] = y[0, 251]
    y[0, 128] = y[0, 127]
    cases["duplicates across a slice and a stage boundary"] = (
        y[0, [251, 127]][None] + 1e-3, y)
    cases["all targets equidistant"] = (np.zeros((1, 9, 3)), np.ones((1, 700, 3)))
    cases["far query"] = (np.full((1, 1, 3), 1e4), rng.uniform(-1, 1, (1, 900, 3)))
    cases["all distances inf"] = (np.zeros((1, 4, 3)), np.full((1, 600, 3), 1e20))
    cases["m and n ragged: 130 x 1001"] = (rng.normal(size=(2, 130, 3)),
                                           rng.normal(size=(2, 1001, 3)))
    cases["n = 1"] = (rng.normal(size=(1, 1, 3)), rng.normal(size=(1, 517, 3)))
    cases["m = 3 < slices"] = (rng.normal(size=(1, 40, 3)), rng.normal(size=(1, 3, 3)))
    cases["m = 13: the last slice empty"] = (rng.normal(size=(1, 70, 3)),
                                             rng.normal(size=(1, 13, 3)))
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        cases[f"random clouds, seed {seed}"] = (r.normal(size=(3, 150, 3)) * 5,
                                                r.normal(size=(3, 640, 3)) * 5)
    return cases


K1_CASES = _k1_cases()


@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_schedule_equals_plain(name):
    x, y = (_f32(a) for a in K1_CASES[name])
    idx, d2 = emulate_k1(x, y)
    idx_p, d2_p = tiled_knn.nn_distances_plain(x, y)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2, d2_p)
    if name.startswith("duplicates"):
        assert idx[0].tolist() == [251, 127]
    if name in ("all targets equidistant", "all distances inf"):
        assert bool((idx == 0).all())


@pytest.mark.parametrize("m", [1, 3, 13, 1000, 1001, 16000])
def test_k1_slices_start_on_16_byte_boundaries(m):
    width = tiled_knn.slice_width(m)
    assert width % 4 == 0 and tiled_knn.TILE % 4 == 0  # 12-byte rows: 48-byte runs
    assert tiled_knn.SLICES * width >= m > (tiled_knn.SLICES - 1) * (width - 4)


def test_k1_sizes_that_raise_and_cpu_launches():
    tiled_knn._check_sizes(65535, 12288, 16000)
    with pytest.raises(ValueError, match="batch"):
        tiled_knn._check_sizes(65536, 10, 10)
    with pytest.raises(ValueError, match="points"):
        tiled_knn._check_sizes(1, 10, 2**30)
    before = tiled_knn.launches
    tiled_knn.nn_distances(torch.randn(2, 5, 3), torch.randn(2, 7, 3))
    assert tiled_knn.launches == before


# ---------------------------------------------------------------- K2 / K5

def emulate_k2(points, centers, radius, xb, bsel, with_bound):
    """csrc/cluster_search.cu's schedule on (B, G, g, 3) points, (B, nb, Qs,
    3) query blocks and (B, nb, P) groups: per slice s, columns
    [s w, s w + w) of each pass of gpass groups (w a multiple of 4), in
    CHUNK-column running minima, passes carried with a strict '<'; the S
    partials merged by the lexicographic minimum of (d2, chunk start), the
    first column re-found in the winning chunk; the bound's groups s, s + S,
    ... per slice, min of max(sqrt(dc2) (1 - 8 eps) - r, 0) (fmaxf: a NaN
    term gives 0) merged by min, then squared."""
    B, G, g = points.shape[:3]
    nb, Qs, P = xb.shape[1], xb.shape[2], bsel.shape[2]
    _, slices, gpass = cluster_search.search_plan(Qs, g, P)
    sel = bsel.long()
    cand = torch.stack([points[b][sel[b]] for b in range(B)]).reshape(B, nb, P * g, 3)
    d2 = _d2(xb, cand)                                              # (B, nb, Qs, P g)
    parts = []
    for s in range(slices):
        best = torch.full(xb.shape[:-1], INF)
        col = torch.zeros(xb.shape[:-1], dtype=torch.int64)
        for j0 in range(0, P, gpass):
            cols = min(gpass, P - j0) * g
            width = (-(-cols // slices) + 3) // 4 * 4
            lo = min(cols, s * width)
            hi = min(cols, lo + width)
            if hi > lo:
                tb, tc = _chunk_minima(d2[..., j0 * g + lo:j0 * g + hi], cluster_search.CHUNK)
                best, col = _carry(best, col, tb, tc + j0 * g + lo)
        parts.append((best, col))
    d = torch.stack([p[0] for p in parts])
    c = torch.stack([p[1] for p in parts])
    best = d.amin(0)
    start = torch.where(d == best, c, torch.full_like(c, P * g)).amin(0)
    col = _first_in_chunk(d2, best, start, cluster_search.CHUNK)
    grp = torch.gather(sel, 2, torch.div(col, g, rounding_mode="floor").reshape(B, nb, -1))
    row = (grp.reshape(col.shape) * g + col % g).to(torch.int32)
    if not with_bound:
        return best, torch.where(best < INF, row, torch.zeros_like(row))
    return best, row, emulate_bound(centers, radius, xb, sel, slices)


def emulate_bound(centers, radius, xb, sel, slices):
    """csrc/cluster_search.cu's bound (K3's too): the groups s, s + S, ... per slice,
    min of max(sqrt(dc2) (1 - 8 eps) - r, 0) (fmaxf: a NaN term gives 0)
    merged by min over the slices, then squared."""
    B, G = centers.shape[:2]
    nb = xb.shape[1]
    diff = xb[..., None, 0] - centers[:, None, None, :, 0]
    dc2 = diff * diff
    for k in (1, 2):
        diff = xb[..., None, k] - centers[:, None, None, :, k]
        dc2 = dc2 + diff * diff
    a = torch.sqrt(dc2) * (1.0 - cluster_search._EPS8) - radius[:, None, None, :]
    a = torch.where(torch.isnan(a), 0.0, torch.clamp(a, min=0.0))
    chosen = torch.zeros(B, nb, G, dtype=torch.bool).scatter_(-1, sel.long(), True)
    a = torch.where(chosen[:, :, None, :], INF, a)
    amin = torch.stack([a[..., s::slices].amin(-1) if s < G else torch.full(xb.shape[:-1], INF)
                        for s in range(slices)]).amin(0)
    return amin * amin


def _groups(rng, G, g, scale=5.0):
    points = rng.uniform(-scale, scale, (G, g, 3))
    centers = points.mean(axis=1)
    radius = np.linalg.norm(points - centers[:, None], axis=-1).max(axis=1)
    return points, centers, radius


def _k2_cases():
    rng = np.random.default_rng(60)
    cases = {}

    def case(name, points, centers, radius, xb, bsel):
        cases[name] = tuple(_f32(a) for a in (points, centers, radius, xb)) + (
            torch.as_tensor(np.asarray(bsel, dtype=np.int32)),)

    # P = 8, g = 64: 512 columns, slices of 64; one point duplicated at
    # columns 63 | 64, the boundary of slices 0 and 1, and the query on it
    p, c, r = _groups(rng, 20, 64)
    sel = rng.permutation(20)[:8]
    p[sel[1], 0] = p[sel[0], 63]
    xb = rng.uniform(-5, 5, (1, 128, 3))
    xb[0, :4] = p[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    case("duplicates across a slice boundary", p, c, r, xb, [sel])
    p = np.ones((6, 128, 3))
    case("all candidates equidistant", p, p.mean(1), np.zeros(6), np.zeros((2, 128, 3)),
         [[4, 1, 2, 0]] * 2)
    p, c, r = _groups(rng, 12, 128, 1.0)
    case("far query", p, c, r, np.full((1, 1, 3), 1e4), [[3, 7, 0, 11]])
    p = np.full((5, 64, 3), 1e20)
    case("all distances inf", p, p.mean(1), np.zeros(5), np.zeros((1, 5, 3)), [[2, 0, 4]])
    p, c, r = _groups(rng, 9, 7)
    case("P g = 21 not a multiple of the slice width, g = 7", p, c, r,
         rng.uniform(-5, 5, (3, 128, 3)), [rng.permutation(9)[:3] for _ in range(3)])
    p, c, r = _groups(rng, 10, 64)
    case("one query", p, c, r, rng.uniform(-5, 5, (1, 1, 3)), [[5, 2, 9]])
    p, c, r = _groups(rng, 7, 2000)
    case("three passes: g = 2000, P = 5", p, c, r, rng.uniform(-5, 5, (2, 128, 3)),
         [rng.permutation(7)[:5] for _ in range(2)])
    p, c, r = _groups(rng, 30, 16)
    case("Qs = 300: 3 query groups, 2 slices", p, c, r, rng.uniform(-5, 5, (2, 300, 3)),
         [rng.permutation(30)[:6] for _ in range(2)])
    p, c, r = _groups(rng, 6, 32)
    case("every group selected (P = G)", p, c, r, rng.uniform(-5, 5, (2, 128, 3)),
         [rng.permutation(6) for _ in range(2)])
    for seed in (1, 2):
        r_ = np.random.default_rng(seed)
        grouped = [_groups(r_, 40, 32) for _ in range(2)]
        p, c, r = (np.stack(a) for a in zip(*grouped))
        case(f"batched random groups, seed {seed}", p, c, r,
             r_.uniform(-5, 5, (2, 3, 128, 3)),
             [[r_.permutation(40)[:12] for _ in range(3)] for _ in range(2)])
    return cases


K2_CASES = _k2_cases()


def _batched(args):
    points, centers, radius, xb, bsel = args
    if points.dim() == 4:
        return args
    return points[None], centers[None], radius[None], xb[None], bsel[None]


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_k5_schedule_equals_plain(name):
    args = K2_CASES[name]
    batched = _batched(args)
    best, row, bound = emulate_k2(*batched, with_bound=True)
    best5, row5 = emulate_k2(*batched, with_bound=False)
    plain = [o if args[0].dim() == 4 else o[None]
             for o in cluster_search.fused_search_plain(*args)]
    plain5 = [o if args[0].dim() == 4 else o[None]
              for o in cluster_search.block_search_plain(args[0], args[3], args[4])]
    for a, b in zip((best, row, bound, best5, row5), plain + plain5):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name.startswith("duplicates"):
        sel0 = int(args[4][0, 0])
        assert bool((row[0, 0, :4] == sel0 * 64 + 63).all())
    if name.startswith("all"):
        assert torch.equal(row, batched[4][..., :1].expand_as(row) * args[0].shape[-2])
    if name == "all distances inf":
        assert bool((row5 == 0).all())
    if name.startswith("every group"):
        assert bool(torch.isinf(bound).all())


@pytest.mark.parametrize("where", ["target", "query"])
def test_k2_nan_point_stays_uncertified(where):
    """A NaN point makes its group's center and radius NaN (as the cluster
    index computes them), and the plain version's bound NaN for every query.
    The kernels skip a NaN distance as they skip inf, and clamp a NaN bound
    term to 0: bound 0 where the NaN group is not selected or the query is
    NaN, so no query is certified past it; where the group is selected it is
    searched and leaves the bound alone."""
    rng = np.random.default_rng(70)
    points = rng.uniform(-0.5, 0.5, (20, 64, 3)) + rng.uniform(-5, 5, (20, 1, 3))
    xb = rng.uniform(-5, 5, (3, 128, 3))
    if where == "target":
        points[3, 5] = np.nan
        xb[0, :8] = points[3, 6] + 1e-3  # nearest to the NaN point's group
    else:
        xb[1, 7] = np.nan
    centers = points.mean(axis=1)
    radius = np.linalg.norm(points - centers[:, None], axis=-1).max(axis=1)
    bsel = torch.as_tensor(np.array([[3, 1, 2, 0], [4, 5, 6, 7], [8, 3, 9, 10]], np.int32))
    args = tuple(_f32(a) for a in (points, centers, radius, xb)) + (bsel,)
    best, row, bound = emulate_k2(*_batched(args), with_bound=True)
    best5, row5 = emulate_k2(*_batched(args), with_bound=False)
    # best and row: a NaN candidate loses like an inf one; a NaN query finds
    # no candidate (best inf, column 0's row, or 0 for K5)
    finite = args[0].clone()
    finite[torch.isnan(finite)] = INF
    ref = cluster_search.fused_search_plain(finite, *args[1:])
    ref5 = cluster_search.block_search_plain(finite, args[3], args[4])
    real = ~torch.isnan(args[3]).any(-1)
    for a, b in zip((best[0], row[0], best5[0], row5[0]), ref[:2] + ref5):
        assert torch.equal(a[real], b[real])
    assert bool(torch.isinf(best[0][~real]).all()) and bool((row5[0][~real] == 0).all())
    assert torch.equal(row[0][~real], (bsel[:, :1] * 64).expand(3, 128)[~real])
    # the bound: a NaN group as one of radius inf (a term of 0 unless
    # selected), then 0 for a NaN query
    lost = torch.isnan(args[1]).any(-1) | torch.isnan(args[2])
    ref = cluster_search.fused_search_plain(finite, torch.where(lost[:, None], 0.0, args[1]),
                                            torch.where(lost, INF, args[2]), *args[3:])[2]
    assert torch.equal(bound[0], torch.where(torch.isnan(ref), 0.0, ref))
    plain = cluster_search.fused_search_plain(*args)[2]
    if where == "target":
        assert bool(torch.isnan(plain).all())  # the NaN group selected or not
        past = (bsel != 3).all(-1)[:, None].expand(3, 128)  # block 1 left it out
    else:
        past = ~real
        assert torch.equal(torch.isnan(plain), past)
    assert bool((bound[0][past] == 0).all())
    assert not bool((best[0] <= bound[0])[past].any())  # none certified
    assert bool((bound[0][~past] > 0).any())  # elsewhere the bound still certifies


def test_k2_plan_and_wrapper_checks():
    assert cluster_search.search_plan(128, 128, 32) == (1, 8, 32)
    assert cluster_search.search_plan(300, 16, 6) == (3, 2, 6)
    assert cluster_search.search_plan(128, 2000, 5)[2] == 2
    with pytest.raises(ValueError, match="g = 5462"):
        cluster_search.search_plan(128, cluster_search.MAX_GROUP_SIZE + 1, 4)
    points, centers, radius, xb, bsel = K2_CASES["one query"]
    before = (cluster_search.fused_search.launches, cluster_search.block_search.launches)
    cluster_search.fused_search(points, centers, radius, xb, bsel)
    cluster_search.block_search(points, xb, bsel)
    assert (cluster_search.fused_search.launches,
            cluster_search.block_search.launches) == before
    for bad in (-1, points.shape[0]):
        wrong = bsel.clone()
        wrong[0, 1] = bad
        with pytest.raises(ValueError, match="outside"):
            cluster_search.fused_search(points, centers, radius, xb, wrong)
        with pytest.raises(ValueError, match="outside"):
            cluster_search.block_search(points, xb, wrong)


# ---------------------------------------------------------------- K3

LANES = np.arange(32)
FILL = np.uint64(0x7f800000) << np.uint64(32)    # (inf, column 0)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)             # an empty queue


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _exchange(v, m, lower):
    """csrc/cluster_topk.cu's compare-exchange of each lane with lane ^ m, on
    (n, 32) lanes: the smaller key where ``lower``, else the larger."""
    o = v[:, LANES ^ m]
    return np.where(lower == (o < v), o, v)


def _merge_up(v, S):
    """A bitonic sequence in each segment of S lanes, sorted ascending."""
    m = S // 2
    while m:
        v = _exchange(v, m, (LANES & m) == 0)
        m //= 2
    return v


def _sort_segments(v, S):
    size = 2
    while size <= S:
        up = (size == S) | ((LANES & size) == 0)
        m = size // 2
        while m:
            v = _exchange(v, m, ((LANES & m) == 0) == up)
            m //= 2
        size *= 2
    return v


def warp_lowest(v, K):
    """lowest<K>: the K smallest of the warp's 32 keys, sorted, in every
    segment of K lanes, by the kernel's shuffle network."""
    v = _sort_segments(v, K)
    h = K
    while h < 32:
        v = _merge_up(np.minimum(v, v[:, LANES ^ (h | (K - 1))]), K)
        h *= 2
    return v


def warp_merge(lst, v, K):
    """merge_into<K>: the K smallest of the list (sorted in every segment of
    K lanes) and the warp's 32 keys v."""
    return _merge_up(np.minimum(lst, warp_lowest(v, K)[:, LANES ^ (K - 1)]), K)


def warp_insert(lst, key, K):
    """insert<K>: one key (n,) into the list, by the kernel's ballot, popc
    and shuffle up within segments of K lanes."""
    below = (lst < key[:, None]) & (LANES < K)[None]
    pos = below.sum(1)[:, None]
    i = LANES & (K - 1)
    up = lst[:, np.where(i > 0, LANES - 1, LANES)]
    return np.where(i < pos, lst, np.where(i == pos, key[:, None], up))


def emulate_k3(points, centers, radius, xb, bsel, k, events=None):
    """csrc/cluster_topk.cu's schedule on (B, G, g, 3) points, every warp's
    query at once: per chunk of 32 selected groups the boxes' lower bounds
    sorted by the kernel's network, groups visited nearest first and skipped
    (the rest of the chunk too) past the list's k-th d2; lane l takes offsets
    l, l + 32, ...; a (d2, column) key below the k-th key goes to the lane's
    queue of one key; a full queue in any lane, and the end, flush the
    queues: through warp_merge, or key by key through warp_insert where at
    most TOPK_INSERT_MAX keys are queued.  The bound is K2's.  ``events``
    (a dict) counts flushes, flushes with every lane's queue full, passes
    that tie the k-th d2 (a lower column), skipped groups, chunk breaks and
    keys inserted one by one."""
    B, G, g = points.shape[:3]
    nb, Qs, P = xb.shape[1], xb.shape[2], bsel.shape[2]
    plan = cluster_search.topk_plan(Qs, k, g, P)
    K, nbox = plan["K"], plan["boxes"]
    F = cluster_search.TOPK_FIRST
    ev = {"flushes": 0, "all lanes full": 0, "tie passes": 0, "skipped": 0, "breaks": 0,
          "inserted": 0}
    sel = bsel.numpy().astype(np.int64).reshape(B * nb, P)
    pts = points.numpy().astype(np.float32)
    cand = np.stack([pts[b][sel[b * nb + i]] for b in range(B) for i in range(nb)])
    x = xb.numpy().astype(np.float32).reshape(B * nb, Qs, 3)
    with np.errstate(invalid="ignore", over="ignore"):
        d2 = _d2(torch.as_tensor(x), torch.as_tensor(cand.reshape(B * nb, P * g, 3))).numpy()
        d2 = d2.reshape(B * nb * Qs, P, g)
        lo = np.fmin.reduce(cand, axis=2, initial=np.inf)          # (blocks, P, 3)
        hi = np.fmax.reduce(cand, axis=2, initial=-np.inf)
        q = x[:, :, None, :]
        e = np.where(q < lo[:, None], q - lo[:, None],
                     np.where(q > hi[:, None], q - hi[:, None], np.float32(0)))
        e = e * e
        lb = ((e[..., 0] + e[..., 1]) + e[..., 2]).reshape(B * nb * Qs, P)
    lb[:, nbox:] = 0.0
    Q, steps = B * nb * Qs, max(-(-g // 32), F)
    d2 = np.concatenate([d2, np.full((Q, P, 32 * steps - g), np.nan, np.float32)], -1)
    rows = np.arange(Q)
    lst = np.full((Q, 32), FILL)
    thr = np.full(Q, FILL)
    queue = np.full((Q, 32), EMPTY)
    queued = np.zeros((Q, 32), bool)

    def flush(mask):
        ev["flushes"] += int(mask.sum())
        ev["all lanes full"] += int((mask & queued.all(1)).sum())
        count = queued.sum(1)
        m = mask & (count > cluster_search.TOPK_INSERT_MAX)
        lst[m] = warp_merge(lst[m], np.where(queued, queue, EMPTY)[m], K)
        for lane in range(32):  # a few keys one by one, in lane order
            m = mask & (count <= cluster_search.TOPK_INSERT_MAX) & queued[:, lane]
            lst[m] = warp_insert(lst[m], queue[m, lane], K)
            ev["inserted"] += int(m.sum())
        queued[mask] = False
        thr[mask] = lst[mask, k - 1]

    for c0 in range(0, P, 32):
        j = c0 + LANES
        lbc = np.full((Q, 32), np.inf, np.float32)
        lbc[:, j < P] = lb[:, j[j < P]]
        order = np.where(j < P, (_bits(lbc) & np.uint32(~31 & 0xFFFFFFFF)) | LANES,
                         np.uint32(0xFFFFFFFF)).astype(np.uint32)
        order = _sort_segments(order, 32)
        active = np.ones(Q, bool)
        for i in range(min(32, P - c0)):
            gk = order[:, i]
            dk = (thr >> np.uint64(32)).astype(np.uint32).view(np.float32)
            stop = active & ((gk & np.uint32(~31 & 0xFFFFFFFF)).view(np.float32) > dk)
            ev["breaks"] += int(stop.sum())
            active &= ~stop
            jl = (gk & 31).astype(np.int64)
            skip = active & (lbc[rows, jl] > dk)
            ev["skipped"] += int(skip.sum())
            visit = active & ~skip
            jj = c0 + jl
            dg = d2[rows, jj]                                          # (Q, 32 * steps)

            def keys(o0):
                o = o0 + LANES
                key = (_bits(dg[:, o]).astype(np.uint64) << np.uint64(32)) | (
                    jj[:, None] * g + o).astype(np.uint64)
                return np.where(o < g, key, EMPTY)

            def push(key, passed):
                ev["tie passes"] += int((passed & ((key >> np.uint64(32)) ==
                                                   (thr[:, None] >> np.uint64(32)))).sum())
                queue[...] = np.where(passed, key, queue)
                queued[...] |= passed
                full = queued.any(1)
                if full.any():
                    flush(full)

            first = 0
            if c0 == 0 and i == 0:  # every query's first group: never skipped
                first = min(g, 32 * F)
                chunk = [keys(o0) for o0 in range(0, 32 * F, 32)]
                least = np.minimum.reduce(chunk)
                lst[...] = np.minimum(warp_lowest(least, K), FILL)
                thr[...] = lst[:, k - 1]
                for key in chunk:
                    push(key, (key != least) & (key < thr[:, None]))
            for o0 in range(32 * F if first else 0, g, 32):
                key = keys(o0)
                push(key, visit[:, None] & (key < thr[:, None]))
    last = queued.any(1)
    if last.any():
        flush(last)
    if events is not None:
        events.update(ev)
    top = lst[:, :k]
    d = (top >> np.uint64(32)).astype(np.uint32).view(np.float32).reshape(B, nb, Qs, k)
    col = (top & np.uint64(0xFFFFFFFF)).astype(np.int64).reshape(B * nb, Qs * k)
    grp = np.take_along_axis(sel, col // g, axis=1)
    row = (grp * g + col % g).reshape(B, nb, Qs, k).astype(np.int32)
    return (torch.as_tensor(d.copy()), torch.as_tensor(row),
            emulate_bound(centers, radius, xb, bsel.long(), 1))


def _k3_cases():
    rng = np.random.default_rng(80)
    cases = {}

    def case(name, points, centers, radius, xb, bsel, ks):
        t = tuple(_f32(a) for a in (points, centers, radius, xb)) + (
            torch.as_tensor(np.asarray(bsel, dtype=np.int32)),)
        for k in ks:
            cases[f"{name}, k = {k}"] = t + (k,)

    # P = 8, g = 64: one point duplicated at columns 63 | 64 (groups 0 and 1)
    # and one at 127 | 128, and queries on them
    p, c, r = _groups(rng, 20, 64)
    sel = rng.permutation(20)[:8]
    p[sel[1], 0] = p[sel[0], 63]
    p[sel[2], 0] = p[sel[1], 63]
    xb = rng.uniform(-5, 5, (1, 128, 3))
    xb[0, :4] = p[sel[0], 63] + rng.normal(scale=1e-4, size=(4, 3))
    xb[0, 4:8] = p[sel[1], 63] + rng.normal(scale=1e-4, size=(4, 3))
    case("duplicates across group boundaries", p, c, r, xb, [sel], (5, 16, 2))
    # few finite candidates: the column-0 fill past them
    p, c, r = _groups(rng, 6, 32)
    p[:, 3:] = 1e20
    case("k beyond the finite candidates", p, c, r, rng.uniform(-5, 5, (2, 128, 3)),
         [rng.permutation(6)[:3] for _ in range(2)], (16, 32))
    p = np.full((5, 64, 3), 1e20)
    case("all distances inf", p, p.mean(1), np.zeros(5), np.zeros((1, 5, 3)), [[2, 0, 4]], (1, 8))
    p, c, r = _groups(rng, 9, 7)
    case("g = 7", p, c, r, rng.uniform(-5, 5, (3, 128, 3)),
         [rng.permutation(9)[:3] for _ in range(3)], (1, 5, 21))
    p, c, r = _groups(rng, 7, 2000)
    case("g = 2000, P = 5: slabs read from global memory", p, c, r,
         rng.uniform(-5, 5, (1, 128, 3)),
         [rng.permutation(7)[:5]], (32,))
    p, c, r = _groups(rng, 40, 32)
    case("Qs = 256", p, c, r, rng.uniform(-5, 5, (2, 256, 3)),
         [rng.permutation(40)[:12] for _ in range(2)], (1, 16, 32))
    p, c, r = _groups(rng, 12, 128, 1.0)
    case("one query", p, c, r, rng.uniform(-1, 1, (1, 1, 3)), [[3, 7, 0, 11]], (4,))
    base = rng.uniform(-10, 10, (64, 3))
    p = np.concatenate([base, base, base, base])[rng.permutation(256)].reshape(8, 32, 3)
    c = p.mean(axis=1)
    r = np.linalg.norm(p - c[:, None], axis=-1).max(axis=1)
    case("every point four times", p, c, r, base[None, :50] + 1e-3, [rng.permutation(8)[:6]],
         (5, 16))
    for name, args, ks in _k3_schedule_cases(rng):
        case(name, *args, ks)
    return cases


def k3_tie_case(rng):
    """(points, centers, radius, xb, bsel) with g = 64: the group at bsel
    position 1, visited first (its box holds the queries), holds the queries'
    k = 8 nearest points, the 8th at d2 = 1 exactly, and fills every queue in
    two steps, so the list's k-th key is (1, column 71) before the group at
    position 0 is visited (its box is farther): that group holds a copy of
    the 8th point in column 0.  Only a lexicographic filter against the k-th
    key keeps it."""
    near = rng.uniform(2, 3, (64, 3))
    near[:7] = rng.uniform(-0.4, 0.4, (7, 3)) * [1, 1, 0]
    near[7] = (1.0, 0.0, 0.0)
    far = rng.uniform(3, 4, (64, 3))
    far[:, 0] = rng.uniform(1.0, 4.0, 64)
    far[0] = near[7]
    pts = np.stack([far, near, rng.uniform(6, 8, (64, 3))])
    centers = pts.mean(axis=1)
    radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
    return pts, centers, radius, np.zeros((1, 4, 3)), [[0, 1, 2]]


def k3_full_case(rng):
    """(points, centers, radius, xb, bsel): queries near the origin; the group
    visited first (its box holds them) lies on a sphere of radius 5, so the
    list's k-th d2 is ~25; the next, a cluster at d2 3 to 6.75, then passes
    the filter in all 32 lanes of one step, filling every lane's queue."""
    shell = rng.normal(size=(64, 3))
    shell = 5.0 * shell / np.linalg.norm(shell, axis=1, keepdims=True)
    pts = np.stack([rng.uniform(1.0, 1.5, (64, 3)), shell])
    centers = pts.mean(axis=1)
    radius = np.linalg.norm(pts - centers[:, None], axis=-1).max(axis=1)
    return pts, centers, radius, rng.normal(scale=1e-3, size=(1, 8, 3)), [[0, 1]]


def _k3_schedule_cases(rng):
    """Cases that only the warp schedule can get wrong: (name, args, ks)."""
    out = [("a tie with the k-th entry reached later in a lower column", k3_tie_case(rng),
            (8,))]
    out.append(("every lane's queue full in the same step", k3_full_case(rng), (1, 16, 32)))
    p, c, r = _groups(rng, 5, 7)
    out.append(("fewer candidates than lanes: P g = 14", (p, c, r,
                rng.uniform(-5, 5, (1, 64, 3)), [[4, 1]]), (1, 5, 14)))
    p, c, r = _groups(rng, 11, 37)
    out.append(("g = 37, not a multiple of 4 or 32", (p, c, r,
                rng.uniform(-5, 5, (2, 128, 3)), [rng.permutation(11)[:6] for _ in range(2)]),
                (2, 16)))
    p, c, r = _groups(rng, 8, 16)
    p[:, 4:] = 1e20                                 # 4 finite points per group
    out.append(("k = 32 with exactly 32 finite candidates", (p, c, r,
                rng.uniform(-5, 5, (1, 128, 3)), [rng.permutation(8)]), (32,)))
    p, c, r = _groups(rng, 70, 4, 20.0)
    out.append(("P = 40 > 32: two chunks of groups", (p, c, r,
                rng.uniform(-20, 20, (1, 128, 3)), [rng.permutation(70)[:40]]), (3, 16)))
    return out


K3_CASES = _k3_cases()


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_schedule_equals_plain(name):
    *args, k = K3_CASES[name]
    events = {}
    out = emulate_k3(*_batched(tuple(args)), k, events)
    plain = [o[None] for o in cluster_search.fused_topk_plain(*args, k)]
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name.startswith("duplicates"):
        d = out[0][0, 0]
        assert bool((d[:4, 0] == d[:4, 1]).all()) and bool((d[4:8, 0] == d[4:8, 1]).all())
    if name.startswith("k beyond") or name.startswith("all distances"):
        fill = ~torch.isfinite(out[0])
        first = (args[4][:, :1] * args[0].shape[-2])[None, :, :, None].expand_as(out[1])
        assert bool(fill.any()) and torch.equal(out[1][fill], first[fill])
    if name.startswith("a tie"):
        assert events["tie passes"] > 0
        assert bool((out[1][..., -1] == 0).all())   # the copy in group 0, column 0
    if name.startswith("every lane's queue"):
        assert events["all lanes full"] > 0
    if name.startswith("k = 32 with exactly"):
        assert bool(torch.isfinite(out[0]).all())
    if name.startswith("P = 40"):
        assert events["skipped"] + events["breaks"] > 0


@pytest.mark.parametrize("K", [1, 2, 4, 8, 16, 32])
def test_k3_warp_merge_keeps_the_stable_order(K):
    """The kernel's merge network, fed a stream of keys 32 at a time (empty
    slots, NaN and inf d2 among them), and its key-by-key insertion keep the
    K smallest in (d2, column) order, ties in column order, NaN and inf never
    listed past the fill."""
    rng = np.random.default_rng(81 + K)
    d = rng.integers(0, 6, (4, 320)).astype(np.float32)
    d[:, rng.integers(0, 320, 30)] = np.nan
    d[:, rng.integers(0, 320, 30)] = np.inf
    keys = (_bits(d).astype(np.uint64) << np.uint64(32)) | np.arange(320, dtype=np.uint64)
    keys[:, rng.integers(0, 320, 40)] = EMPTY
    lst = np.full((4, 32), FILL)
    one = np.full((4, 32), FILL)
    for s in range(0, 320, 32):
        lst = warp_merge(lst, keys[:, s:s + 32], K)
        for c in range(s, s + 32):
            if keys[0, c] != EMPTY:
                one = warp_insert(one, keys[:, c], K)
    want = np.sort(np.concatenate([keys, np.full((4, K), FILL)], 1), axis=1)[:, :K]
    for seg in range(0, 32, K):
        assert np.array_equal(lst[:, seg:seg + K], want)
        assert np.array_equal(one[:, seg:seg + K], want)
    dd = np.where(np.isnan(d) | (keys == EMPTY), np.inf, d)
    for row in range(4):
        order = np.argsort(dd[row], kind="stable")[:K]
        finite = dd[row][order] < np.inf
        got = lst[row, :K]
        assert np.array_equal(got[finite] & np.uint64(0xFFFFFFFF), order[finite])
        assert (got[~finite] == FILL).all()


@pytest.mark.parametrize("where", ["target", "query"])
def test_k3_nan_point_stays_uncertified(where):
    """As K2: a NaN candidate is never listed, a NaN query lists nothing
    (d2 inf, column 0's row) and gets the bound 0; the bound is 0 past a NaN
    group.  Held to the plain version with the NaN point at inf and the NaN
    group at radius inf, as phase 7 of chip_smoke.py holds the kernel."""
    rng = np.random.default_rng(82)
    points = rng.uniform(-0.5, 0.5, (20, 64, 3)) + rng.uniform(-5, 5, (20, 1, 3))
    xb = rng.uniform(-5, 5, (3, 128, 3))
    if where == "target":
        points[3, 5] = np.nan
        xb[0, :8] = points[3, 6] + 1e-3
    else:
        xb[1, 7] = np.nan
    centers = points.mean(axis=1)
    radius = np.linalg.norm(points - centers[:, None], axis=-1).max(axis=1)
    bsel = torch.as_tensor(np.array([[3, 1, 2, 0], [4, 5, 6, 7], [8, 3, 9, 10]], np.int32))
    args = tuple(_f32(a) for a in (points, centers, radius, xb)) + (bsel,)
    d, rows, bound = (o[0] for o in emulate_k3(*_batched(args), 16))
    finite = torch.where(torch.isnan(args[0]), INF, args[0])
    lost = torch.isnan(args[1]).any(-1) | torch.isnan(args[2])
    ref = cluster_search.fused_topk_plain(finite, torch.where(lost[:, None], 0.0, args[1]),
                                          torch.where(lost, INF, args[2]), *args[3:], 16)
    nanq = torch.isnan(args[3]).any(-1)
    first = (bsel[:, :1] * 64)[:, :, None].expand(3, 128, 16)
    assert torch.equal(d, torch.where(nanq[..., None], INF, ref[0]))
    assert torch.equal(rows, torch.where(nanq[..., None], first, ref[1]))
    assert torch.equal(bound, torch.where(nanq | torch.isnan(ref[2]), 0.0, ref[2]))
    past = (bsel != 3).all(-1)[:, None].expand(3, 128) if where == "target" else nanq
    assert bool((bound[past] == 0).all()) and not bool((d[..., -1] <= bound)[past].any())


def test_k3_plan_and_wrapper_checks():
    assert [cluster_search.topk_plan(128, k, 128, 32)["K"] for k in (1, 2, 5, 16, 17, 32)] \
        == [1, 2, 8, 16, 32, 32]
    assert cluster_search.topk_plan(128, 16, 128, 32) == {
        "K": 16, "warps": 16, "threads": 512, "queries_per_warp": 8,
        "bound_slices": 16, "staged": True, "boxes": 32}
    plan = cluster_search.topk_plan(256, 32, 2000, 5)
    assert (plan["bound_slices"], plan["staged"], plan["queries_per_warp"]) == (8, False, 16)
    assert cluster_search.topk_plan(1, 1, 1, 5000)["boxes"] == cluster_search.TOPK_MAX_BOXES
    for bad in (dict(Qs=257, k=4), dict(Qs=128, k=33), dict(Qs=128, k=0)):
        with pytest.raises(ValueError):
            cluster_search.topk_plan(bad["Qs"], bad["k"], 128, 32)
    *args, k = K3_CASES["one query, k = 4"]
    before = cluster_search.fused_topk.launches
    cluster_search.fused_topk(*args, k)
    assert cluster_search.fused_topk.launches == before


def test_k3_cuda_route_does_not_synchronise():
    """fused_topk's CUDA route checks shapes only: no host range check and
    nothing that reads a device tensor on the host."""
    import inspect

    code = "".join(inspect.getsource(f) for f in (
        cluster_search.fused_topk, cluster_search._prepare, cluster_search._check_cuda,
        cluster_search.topk_plan, cluster_search._launch))
    cuda_route = code[code.index('if _route(xb) == "cpu":'):]
    cuda_route = cuda_route[cuda_route.index("\n", cuda_route.index("fused_topk_plain")):]
    for sync in ("_check_range", ".item(", "bool(", ".tolist(", ".cpu(", "synchronize",
                 ".numpy("):
        assert sync not in cuda_route, sync


# ---------------------------------------------------------------- K6 / K7

def _scores(x, y, tm):
    """csrc/score_nn.cu's scores (n, m_pad): ((x0 a0 + x1 a1) + x2 a2) + |y|^2
    over the packed targets, pad columns included."""
    x8, y8, m_pad = exp_knn._packed(x, y, tm)
    s = x8[:, 0:1] * y8[0]
    s = s + x8[:, 1:2] * y8[1]
    s = s + x8[:, 2:3] * y8[2]
    return s + y8[3], m_pad


def _score_block(s, lo, hi, slices):
    """score_nn.cu's block_argmin over columns [lo, hi): S slices of a
    multiple of 4 columns, CHUNK-column running minima in each, the slices
    merged in order with a strict '<', the first column of the minimum
    re-found in the winning chunk, inside [lo, hi)."""
    span = hi - lo
    width = (-(-span // slices) + 3) // 4 * 4
    merged = None
    for k in range(slices):
        a, b = lo + min(span, k * width), lo + min(span, k * width + width)
        best, start = _chunk_minima(s[:, a:b], exp_knn.CHUNK)
        merged = (best, start + a) if merged is None else _carry(*merged, best, start + a)
    best, start = merged
    return _first_in_chunk(s[:, :hi], best, start, exp_knn.CHUNK), best


def emulate_k6(x, y, tq, tm):
    """K6: block (i, t) runs the core over target tile t into a (tiles, n)
    partial buffer; score_reduce_kernel carries the partials in tile order."""
    s, m_pad = _scores(x, y, tm)
    slices = exp_knn.score_plan(tq)["slices"]
    best = torch.full(s.shape[:1], INF)
    arg = torch.zeros(s.shape[:1], dtype=torch.int64)
    for t in range(m_pad // tm):
        part_i, part_s = _score_block(s, t * tm, t * tm + tm, slices)
        best, arg = _carry(best, arg, part_s, part_i)
    return arg.to(torch.int32), best


def emulate_k7(x, y, tq, tm):
    """K7: one block per query tile runs the core over all m_pad columns."""
    s, m_pad = _scores(x, y, tm)
    idx, best = _score_block(s, 0, m_pad, exp_knn.score_plan(tq)["slices"])
    return idx.to(torch.int32), best


def _score_cases():
    rng = np.random.default_rng(100)

    def cloud(n):
        return rng.uniform(-50, 50, (n, 3)).astype(np.float32)

    cases = {f"300 x 5000 at {tq} x {tm}": (cloud(300), cloud(5000), tq, tm)
             for tq, tm in SCORE_TILES}
    # the nearest target duplicated at 511 | 512 (K6's slices of 512 at
    # 256 x 2048), 2047 | 2048 (a target tile) and 1535 | 1536 (K7's slices
    # of 1536 over m_pad = 6144), and a query on each
    y = cloud(4100)
    for j in (511, 2047, 1535):
        y[j + 1] = y[j]
    cases["duplicates across a slice and a tile boundary"] = (
        y[[511, 2047, 1535]] + 1e-3, y, 256, 2048)
    cases["tm = 1001, not a multiple of 4"] = (cloud(200), cloud(3001), 256, 1001)
    cases["tm = 7"] = (cloud(70), cloud(30), 64, 7)
    cases["m = 3 < slices"] = (cloud(50), cloud(3), 256, 2048)
    cases["n = 1"] = (cloud(1), cloud(900), 256, 256)
    cases["n = 200: a ragged query group"] = (cloud(200), cloud(1500), 256, 512)
    cases["tq = 1024: 8 query groups"] = (cloud(1100), cloud(700), 1024, 256)
    cases["all targets at 1e20: |y|^2 inf, a pad column wins"] = (
        cloud(5), np.full((600, 3), 1e20, np.float32), 64, 256)
    return cases


SCORE_TILES = ((256, 2048), (512, 4096), (256, 4096), (512, 2048))  # chip_smoke.py's
SCORE_CASES = _score_cases()


@pytest.mark.parametrize("name", list(SCORE_CASES))
def test_k6_k7_schedule_equals_plain(name):
    x, y, tq, tm = SCORE_CASES[name]
    x, y = _f32(x), _f32(y)
    runs = [(emulate_k6, exp_knn.nn_v1_plain)]
    if tm % 4 == 0:  # K7 takes tm a multiple of 4
        runs.append((emulate_k7, exp_knn.nn_v2_plain))
    for emulate, plain in runs:
        idx, s = emulate(x, y, tq, tm)
        idx_p, s_p = plain(x, y, tq=tq, tm=tm)
        assert idx.dtype == idx_p.dtype and torch.equal(idx, idx_p)
        assert torch.equal(s, s_p)
        if name.startswith("duplicates"):
            assert idx.tolist() == [511, 2047, 1535]
        if name.startswith("all targets"):
            assert bool((idx == 600).all())


@pytest.mark.parametrize("tq, tm", [(256, 2048), (64, 256), (128, 999)])
def test_k6_k7_nan_target_loses_only_its_column(tq, tm):
    """The kernels skip a NaN score, as K1 and K2 skip a NaN distance: they
    equal the plain versions on the same targets with the NaN point moved
    out of reach.  The plain versions, like the TPU kernels, drop the NaN
    point's whole target tile (its minimum is NaN and fails the strict
    '<'): the recorded deviation.  A NaN query gives (inf, 0) on both."""
    rng = np.random.default_rng(101)
    y = rng.uniform(-50, 50, (3000, 3)).astype(np.float32)
    x = rng.uniform(-50, 50, (400, 3)).astype(np.float32)
    x[:3] = y[11:14] + 1e-3
    y[10, 1] = np.nan
    x[5, 0] = np.nan
    far = y.copy()
    far[10] = 1e30  # |y|^2 overflows: its score is inf and never wins
    x, y, far = _f32(x), _f32(y), _f32(far)
    runs = [(emulate_k6, exp_knn.nn_v1_plain)]
    if tm % 4 == 0:
        runs.append((emulate_k7, exp_knn.nn_v2_plain))
    for emulate, plain in runs:
        idx, s = emulate(x, y, tq, tm)
        idx_f, s_f = plain(x, far, tq=tq, tm=tm)
        assert torch.equal(idx, idx_f) and torch.equal(s, s_f)
        assert idx[5] == 0 and s[5] == INF
        assert idx[:3].tolist() == [11, 12, 13]
        idx_p, s_p = plain(x, y, tq=tq, tm=tm)
        assert idx_p[5] == 0 and s_p[5] == INF
        dropped = idx_p != idx  # tile 0 (columns [0, tm)) lost in the plain version
        assert bool(dropped.any()) and bool((idx[dropped] < tm).all())
        assert bool((s_p[dropped] > s[dropped]).all())


def test_score_plan():
    assert exp_knn.score_plan(256) == {"groups": 2, "slices": 4, "warps": 8, "smem": 32768}
    assert exp_knn.score_plan(64)["warps"] == 4
    assert exp_knn.score_plan(exp_knn.MAX_TQ) == {"groups": 8, "slices": 4, "warps": 32,
                                                  "smem": 131072}
    assert exp_knn.MAX_TQ == 1024
    for tq in range(1, exp_knn.MAX_TQ + 1, 37):
        plan = exp_knn.score_plan(tq)
        assert plan["warps"] <= exp_knn.MAX_WARPS and 32 * plan["slices"] >= 32 * exp_knn.LANE_Q


# ---------------------------------------------------------------- K4's 1-NN

def emulate_k4_nn(ps, tgt):
    """csrc/fused_gn.cu's lane-split 1-NN of points ps (n, 3) over targets
    (m, 3): lanes_for(n, m) lanes per point, lane l walks chunks l, l + L,
    ... of CHUNK targets (the targets padded with +inf to a multiple of
    CHUNK) with a strict '<' in index order, then the lanes' (d2, index)
    pairs are merged by xor-shuffle rounds of the lexicographic minimum."""
    n, m = ps.shape[0], tgt.shape[0]
    L, ch = fused_gn.lanes_for(n, m), fused_gn.CHUNK
    mp = -(-m // ch) * ch
    pad = torch.cat([tgt, torch.full((mp - m, 3), INF)])
    d2 = _d2(ps, pad)
    best = torch.full((n, L), INF)
    arg = torch.zeros((n, L), dtype=torch.int64)
    for lane in range(L):
        for c0 in range(lane * ch, mp, L * ch):
            for j in range(c0, c0 + ch):
                better = d2[:, j] < best[:, lane]
                best[:, lane] = torch.where(better, d2[:, j], best[:, lane])
                arg[:, lane] = torch.where(better, j, arg[:, lane])
    off = 1
    while off < L:
        partner = torch.arange(L) ^ off
        ob, oa = best[:, partner], arg[:, partner]
        take = (ob < best) | ((ob == best) & (oa < arg))
        best, arg = torch.where(take, ob, best), torch.where(take, oa, arg)
        off *= 2
    assert bool((best == best[:, :1]).all()) and bool((arg == arg[:, :1]).all())
    return arg[:, 0], best[:, 0]


@pytest.mark.parametrize("n, m", [(65, 65), (256, 512), (37, 43), (1, 1), (3, 8), (40, 13)])
def test_k4_lane_merge_is_the_first_index_argmin(n, m):
    rng = np.random.default_rng(90 + n + m)
    tgt = rng.integers(-3, 4, (m, 3)).astype(np.float32)  # many exact ties
    if m > 4:
        tgt[m // 2] = np.nan
        tgt[m // 3] = np.inf
    ps = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    ps[0] = np.nan if n > 2 else ps[0]
    idx, best = emulate_k4_nn(_f32(ps), _f32(tgt))
    d2 = _d2(_f32(ps), _f32(tgt))
    d2 = torch.where(torch.isnan(d2), INF, d2)  # a NaN d2 is never taken
    assert torch.equal(idx, torch.argmin(d2, dim=-1))  # the first index on ties
    assert torch.equal(best, d2.amin(-1))


def test_k4_launch_plan():
    assert fused_gn.launch_plan(65, 65) == {"lanes": 2, "threads": 160}
    assert fused_gn.launch_plan(40, 48) == {"lanes": 4, "threads": 160}
    assert fused_gn.launch_plan(256, 512) == {"lanes": 1, "threads": 256}
    assert fused_gn.launch_plan(1, 1) == {"lanes": 1, "threads": 32}
    for n in range(1, fused_gn.MAX_N + 1, 17):
        for m in (1, 5, 64, 511, 512):
            plan = fused_gn.launch_plan(n, m)
            assert plan["threads"] <= fused_gn.MAX_THREADS
            assert plan["lanes"] <= -(-m // fused_gn.CHUNK)


@pytest.mark.parametrize("source, constants", [
    ("tiled_nn.cu", {"kLaneQ": tiled_knn.LANE_Q, "kSlices": tiled_knn.SLICES,
                     "kTile": tiled_knn.TILE, "kChunk": tiled_knn.CHUNK}),
    ("cluster_search.cu", {"kLaneQ": cluster_search.LANE_Q, "kWarps": cluster_search.WARPS,
                           "kMaxSlabBytes": cluster_search.MAX_SLAB_BYTES,
                           "kChunk": cluster_search.CHUNK}),
    ("cluster_topk.cu", {"kMaxQs": cluster_search.MAX_QS_TOPK,
                         "kWarps": cluster_search.TOPK_WARPS,
                         "kFirst": cluster_search.TOPK_FIRST,
                         "kInsertMax": cluster_search.TOPK_INSERT_MAX,
                         "kMaxBoxes": cluster_search.TOPK_MAX_BOXES,
                         "kLaneQ": cluster_search.LANE_Q,
                         "kMaxSlabBytes": cluster_search.MAX_SLAB_BYTES}),
    ("fused_gn.cu", {"kMaxLanes": fused_gn.MAX_LANES, "kMaxThreads": fused_gn.MAX_THREADS,
                     "kMaxN": fused_gn.MAX_N, "kMaxM": fused_gn.MAX_M}),
    ("score_nn.cu", {"kLaneQ": exp_knn.LANE_Q, "kSlices": exp_knn.SLICES,
                     "kMaxWarps": exp_knn.MAX_WARPS, "kTile": exp_knn.TILE,
                     "kChunk": exp_knn.CHUNK}),
])
def test_schedule_constants_mirror_the_sources(source, constants):
    text = (CSRC / source).read_text()
    for name, value in constants.items():
        found = re.search(rf"constexpr int {name} = ([0-9* ]+);", text)
        assert found, name
        assert math.prod(int(f) for f in found.group(1).split("*")) == value, name
