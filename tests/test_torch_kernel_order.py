"""The schedules of the CUDA kernels K1 (``csrc/tiled_nn.cu``), K2/K5
(``csrc/cluster_search.cu``), K3 (``csrc/cluster_topk.cu``) and K4's
lane-split 1-NN (``csrc/fused_gn.cu``) and K6/K7's scoring core
(``csrc/score_nn.cu``), emulated in PyTorch on the CPU and held bit for bit
against the plain versions they must equal.

The kernels cannot run here, but the orders they visit and merge candidates
in can: both keep a running minimum per CHUNK candidates and the first
chunk that attains a slice's minimum (a strict '<'), merge the slices, and
find the first index of the minimum again inside the winning chunk.  K1
cuts each block's targets into SLICES contiguous slices and merges them in
order; K2/K5 cut the staged candidate columns into S slices of a multiple of
4 columns, pass by pass, merge the slices by the lexicographic minimum of
(d2, chunk start) and take the bound's minimum over groups split across the
slices.  K3 keeps, per query, a register list of the first K candidates in
(d2, column) order by stable insertion, then fills with column 0.  K4 splits
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
    """csrc/cluster_common.cuh's bound: the groups s, s + S, ... per slice,
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

def emulate_k3(points, centers, radius, xb, bsel, k):
    """csrc/cluster_topk.cu's schedule on (B, G, g, 3) points: one list per
    query of K = next power of two >= k entries over the block's candidates
    in column order, each candidate below the last entry inserted after the
    entries of equal d2 (a NaN or inf d2 is never listed: the list starts as
    (inf, column 0)), the first k entries written out, past the finite ones
    (inf, column 0's row); the bound as K2's, over one walk of the groups."""
    B, G, g = points.shape[:3]
    nb, Qs, P = xb.shape[1], xb.shape[2], bsel.shape[2]
    K = cluster_search.topk_plan(Qs, k)["K"]
    sel = bsel.long()
    cand = torch.stack([points[b][sel[b]] for b in range(B)]).reshape(B, nb, P * g, 3)
    d2 = _d2(xb, cand)
    d2 = torch.where(torch.isnan(d2), INF, d2)
    order = torch.argsort(d2, dim=-1, stable=True)[..., :K]  # (d2, column) order
    d = torch.gather(d2, -1, order)[..., :k]
    c = torch.where(d < INF, order[..., :k], torch.zeros_like(order[..., :k]))
    grp = torch.gather(sel, 2, torch.div(c, g, rounding_mode="floor").reshape(B, nb, -1))
    rows = (grp.reshape(c.shape) * g + c % g).to(torch.int32)
    return d, rows, emulate_bound(centers, radius, xb, sel, 1)


def insert_stable(vals, cols, d, col):
    """The kernel's register insertion, entry by entry: d goes to the last
    slot and moves ahead only of strictly larger entries."""
    if not d < vals[-1]:
        return
    vals[-1], cols[-1] = d, col
    for i in range(len(vals) - 1, 0, -1):
        if vals[i] < vals[i - 1]:
            vals[i], vals[i - 1] = vals[i - 1], vals[i]
            cols[i], cols[i - 1] = cols[i - 1], cols[i]


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
    case("g = 2000, P = 5: staging tiles within groups", p, c, r,
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
    return cases


K3_CASES = _k3_cases()


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_schedule_equals_plain(name):
    *args, k = K3_CASES[name]
    out = emulate_k3(*_batched(tuple(args)), k)
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


def test_k3_register_insertion_is_the_stable_order():
    """The kernel's insertion, candidate by candidate, keeps a slice's first
    K candidates in (d2, column) order, ties in column order, NaN and inf
    never listed."""
    rng = np.random.default_rng(81)
    d = rng.integers(0, 6, 200).astype(np.float32)
    d[rng.integers(0, 200, 10)] = np.nan
    d[rng.integers(0, 200, 10)] = np.inf
    for K in (1, 2, 4, 8, 16, 32):
        vals, cols = [INF] * K, [0] * K
        for col, x in enumerate(d):
            insert_stable(vals, cols, float(x), col)
        dd = torch.as_tensor(np.where(np.isnan(d), np.inf, d))
        want = torch.argsort(dd, stable=True)[:K]
        want_d = dd[want]
        assert vals == [float(x) if x < INF else INF for x in want_d.tolist()]
        assert cols == [int(c) if x < INF else 0 for c, x in zip(want.tolist(), want_d.tolist())]


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
    assert [cluster_search.topk_plan(128, k)["K"] for k in (1, 2, 5, 16, 17, 32)] \
        == [1, 2, 8, 16, 32, 32]
    assert cluster_search.topk_plan(256, 32) == {"K": 32, "threads": 256}
    for bad in (dict(Qs=257, k=4), dict(Qs=128, k=33), dict(Qs=128, k=0)):
        with pytest.raises(ValueError):
            cluster_search.topk_plan(bad["Qs"], bad["k"])
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
    ("cluster_topk.cu", {"kMaxQs": cluster_search.MAX_QS_TOPK}),
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
