"""A/B of the exact 1-NN kernels on the card: the counterpart of
``benchmarks/exp_knn.py``.

Variants (all exact on the winner):

  v0    K1, the production kernel (``ops/tiled_knn``, difference form)
  v1    K6 (``csrc/score_nn.cu``), the score form s = |y|^2 - 2 x.y with
        |x|^2 dropped (it cannot change a row's argmin), split over target
        tiles: grid (query tiles, target tiles), then a reduction in tile order
  v2    K7 (``csrc/score_nn.cu``), the same function with one block per
        query tile streaming every target tile
  v1b   v1 with ``semantics=True``: Mosaic's grid-dimension annotation,
        which has no counterpart on the card (the same launch as v1)

Both kernels run one scoring core, K1's warp schedule: a warp holds 128
queries (4 per lane) and streams a contiguous column slice through its own
two-stage cp.async ring, with a running fminf per 32-column chunk, the
slices merged in order and the winning chunk re-scanned (:func:`score_plan`
gives a block's groups, slices and shared memory).  A NaN target point
loses only its own column there, where the plain versions, like the TPU
kernels, drop its whole target tile.

v1 and v2 return the score s, not a squared distance.  Their function is
defined once, by :func:`_pack_x8`, :func:`_pack_y8` and the plain versions
:func:`nn_v1_plain` / :func:`nn_v2_plain`: inputs cast to f32; target pads
are columns whose |y|^2 is 1e30; s = ((x0 a0 + x1 a1) + x2 a2) + |y|^2 with
a = -2 y and |y|^2 = (y0 y0 + y1 y1) + y2 y2, in that order; the first column
wins ties inside a target tile, and a strict '<' keeps the earlier tile,
from a carry that starts at (inf, 0).  The kernels, built ``--fmad=false``,
agree with the plain versions bit for bit where no target point is NaN.  No
tensor core and no TF32 take part: a one-pass low-precision score flips real
argmins at R = 50.

Routing is by device: CPU tensors take the plain versions, CUDA tensors
launch the kernels or raise.  ``nn_v1.launches`` and ``nn_v2.launches``
count the wrappers' launches.

Run on the card (prints the card's name and power limit with the times):

    python -m dicp_tpu_torch.benchmarks.exp_knn

Times come from CUDA events (:func:`dicp_tpu_torch.utils.timing.cuda_median_ms`).
A variant that fails raises: there is no report-and-continue.
"""

from __future__ import annotations

import ctypes
import functools
import math
import subprocess

import numpy as np
import torch

from dicp_tpu_torch.ops import _build, tiled_knn
from dicp_tpu_torch.utils.timing import cuda_median_ms

_PAD_VAL = 1e30
# Elements of one (queries, columns) score block in the plain versions.
_PLAIN_BLOCK = 1 << 24
# The kernels' schedule and limits (csrc/score_nn.cu): a block holds
# ceil(tq / 128) query groups of 128 queries (LANE_Q per lane of a warp), and
# each group's columns are cut into min(SLICES, MAX_WARPS / groups) slices,
# one warp each, so tq <= 1024 keeps a block at 32 warps.  A warp streams its
# slice through a two-stage ring of TILE columns x 4 rows, 32 TILE bytes of
# shared memory, with a running minimum per CHUNK columns.  K6's grid has at
# most 65535 target tiles.
LANE_Q, SLICES, MAX_WARPS, TILE, CHUNK = 4, 4, 32, 128, 32
MAX_TQ = MAX_WARPS // 4 * 32 * LANE_Q
_MAX_TILES = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def score_plan(tq: int) -> dict:
    """The block of a query tile of ``tq``: query groups, column slices per
    group, warps, and bytes of dynamic shared memory (one ring per warp)."""
    groups = _cdiv(tq, 32 * LANE_Q)
    slices = min(SLICES, MAX_WARPS // groups)
    return {"groups": groups, "slices": slices, "warps": groups * slices,
            "smem": 32 * TILE * groups * slices}


def _pack_x8(x: torch.Tensor) -> torch.Tensor:
    """(n, 3) -> (n, 8): columns [x0, x1, x2, 1, 0, 0, 0, 0]."""
    n = x.shape[0]
    return torch.cat([x, x.new_ones((n, 1)), x.new_zeros((n, 4))], dim=1)


def _pack_y8(y: torch.Tensor, m_pad: int) -> torch.Tensor:
    """(m, 3) -> (8, m_pad): rows [-2 y0, -2 y1, -2 y2, |y|^2, 0, 0, 0, 0];
    padded columns get |y|^2 = 1e30 so their score never wins.  The four
    zero rows only pad the TPU's matrix unit; the kernels read rows 0-3."""
    m = y.shape[0]
    norm2 = (y[:, 0] * y[:, 0] + y[:, 1] * y[:, 1]) + y[:, 2] * y[:, 2]
    packed = torch.cat([-2.0 * y.T, norm2[None], y.new_zeros((4, m))], dim=0)
    if m_pad > m:
        pad = y.new_zeros((8, m_pad - m))
        pad[3] = _PAD_VAL
        packed = torch.cat([packed, pad], dim=1)
    return packed


def _check(x: torch.Tensor, y: torch.Tensor, tq: int, tm: int) -> None:
    for name, t in (("queries", x), ("targets", y)):
        if t.dim() != 2 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (n, 3), got {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if y.shape[0] == 0:
        raise ValueError("1-NN needs at least one target point")
    if x.device != y.device:
        raise ValueError(f"queries on {x.device} but targets on {y.device}")
    if tq < 1 or tm < 1:
        raise ValueError(f"tiles must be positive, got tq={tq}, tm={tm}")


def _packed(x: torch.Tensor, y: torch.Tensor, tm: int):
    """(x8 (n, 8), y8 (8, m_pad), m_pad) in f32."""
    m_pad = _cdiv(y.shape[0], tm) * tm
    return (_pack_x8(x.detach().to(torch.float32)),
            _pack_y8(y.detach().to(torch.float32), m_pad), m_pad)


def _tile_min(x8: torch.Tensor, y8: torch.Tensor, lo: int, hi: int):
    """(min score (n,), its first column (n,) int32) over columns [lo, hi),
    the queries taken in blocks of about ``_PLAIN_BLOCK`` scores.  Unfused
    elementwise ops round like the kernels built with --fmad=false."""
    a = y8[:4, lo:hi]
    n = x8.shape[0]
    rows = max(1, _PLAIN_BLOCK // (hi - lo))
    best = torch.empty(n, dtype=torch.float32, device=x8.device)
    arg = torch.empty(n, dtype=torch.int32, device=x8.device)
    for q0 in range(0, n, rows):
        xq = x8[q0:q0 + rows]
        s = xq[:, 0:1] * a[0]
        s = s + xq[:, 1:2] * a[1]
        s = s + xq[:, 2:3] * a[2]
        s = s + xq[:, 3:4] * a[3]  # x8's column 3 is 1: exactly |y|^2
        local = torch.argmin(s, dim=1)  # first column on ties
        best[q0:q0 + rows] = torch.gather(s, 1, local[:, None])[:, 0]
        arg[q0:q0 + rows] = local.to(torch.int32) + lo
    return best, arg


def _carry(best, arg, tile_s, tile_i):
    """One step of the sequential carry: a strict '<' keeps the earlier tile."""
    better = tile_s < best
    return torch.where(better, tile_s, best), torch.where(better, tile_i, arg)


def nn_v1_plain(x: torch.Tensor, y: torch.Tensor, tq: int = 256, tm: int = 2048,
                semantics: bool = False):
    """Plain version of K6 on any device: every target tile's (min score,
    first column) per query into a (tiles, n) partial buffer, then the carry
    over the partials in tile order.  ``tq`` and ``semantics`` change no
    result."""
    _check(x, y, tq, tm)
    x8, y8, m_pad = _packed(x, y, tm)
    n, nt = x8.shape[0], m_pad // tm
    part_s = torch.empty((nt, n), dtype=torch.float32, device=x8.device)
    part_i = torch.empty((nt, n), dtype=torch.int32, device=x8.device)
    for t in range(nt):
        part_s[t], part_i[t] = _tile_min(x8, y8, t * tm, (t + 1) * tm)
    best = torch.full((n,), math.inf, dtype=torch.float32, device=x8.device)
    arg = torch.zeros((n,), dtype=torch.int32, device=x8.device)
    for t in range(nt):
        best, arg = _carry(best, arg, part_s[t], part_i[t])
    return arg, best


def nn_v2_plain(x: torch.Tensor, y: torch.Tensor, tq: int = 256, tm: int = 2048):
    """Plain version of K7 on any device: the carry runs as the target tiles
    stream past.  ``tq`` changes no result."""
    _check(x, y, tq, tm)
    x8, y8, m_pad = _packed(x, y, tm)
    n = x8.shape[0]
    best = torch.full((n,), math.inf, dtype=torch.float32, device=x8.device)
    arg = torch.zeros((n,), dtype=torch.int32, device=x8.device)
    for lo in range(0, m_pad, tm):
        best, arg = _carry(best, arg, *_tile_min(x8, y8, lo, lo + tm))
    return arg, best


# ---------------------------------------------------------------- CUDA kernels

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("score_nn")
    lib.score_nn_v1_launch.argtypes = [_PTR, _PTR] + [_INT] * 4 + [_PTR] * 4 + [_INT, _PTR]
    lib.score_nn_v2_launch.argtypes = [_PTR, _PTR] + [_INT] * 4 + [_PTR] * 2 + [_INT, _PTR]
    lib.score_nn_v1_launch.restype = ctypes.c_int
    lib.score_nn_v2_launch.restype = ctypes.c_int
    return lib.score_nn_v1_launch, lib.score_nn_v2_launch


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"score-form 1-NN runs on cpu or cuda tensors, got {x.device}")


def _cuda_inputs(name: str, x, y, tq: int, tm: int, smem: int):
    """Check the kernel's limits, then return (x (n, 3), y4 (4, m_pad)) f32
    contiguous on the card.  A tile that needs more shared memory than the
    card gives one block raises; no tile is shrunk."""
    n, m = x.shape[0], y.shape[0]
    m_pad = _cdiv(m, tm) * tm
    if tq > MAX_TQ:
        raise ValueError(f"{name} takes tq <= {MAX_TQ} ({MAX_WARPS} warps: 8 query groups of "
                         f"128 x 4 slices), got {tq}")
    if m_pad // tm > _MAX_TILES or 3 * max(n, 1) >= 2**31 or 4 * m_pad >= 2**31:
        raise ValueError(f"{name}: n={n}, m={m}, tm={tm} exceed the kernel's 32-bit grid")
    allowed = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > allowed:
        raise ValueError(f"{name} needs {smem} bytes of shared memory per block at "
                         f"tq={tq}, tm={tm}; the card allows {allowed}")
    xc = x.detach().to(torch.float32).contiguous()
    y4 = _pack_y8(y.detach().to(torch.float32), m_pad)[:4].contiguous()
    return xc, y4, m_pad


def _raise_on(err: int, name: str, n: int, m_pad: int, tq: int, tm: int, smem: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} (n={n}, "
                           f"m_pad={m_pad}, tq={tq}, tm={tm}, {smem} bytes of shared memory)")


def nn_v1(x: torch.Tensor, y: torch.Tensor, tq: int = 256, tm: int = 2048,
          semantics: bool = False):
    """K6: (idx (n,) int32, s (n,) f32), the first column of each query's
    minimum score.  ``semantics`` is Mosaic's grid-dimension annotation in
    the TPU script; CUDA has no counterpart and it has no effect here."""
    _check(x, y, tq, tm)
    if _route(x) == "cpu":
        return nn_v1_plain(x, y, tq, tm, semantics)
    smem = score_plan(tq)["smem"]  # each warp's ring; tm sets only the grid
    xc, y4, m_pad = _cuda_inputs("score_nn_v1", x, y, tq, tm, smem)
    n, nt = xc.shape[0], m_pad // tm
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    s = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        part_s = torch.empty((nt, n), dtype=torch.float32, device=x.device)
        part_i = torch.empty((nt, n), dtype=torch.int32, device=x.device)
        err = _kernels()[0](xc.data_ptr(), y4.data_ptr(), n, m_pad, tq, tm,
                            part_s.data_ptr(), part_i.data_ptr(), idx.data_ptr(),
                            s.data_ptr(), x.device.index,
                            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "score_nn_v1", n, m_pad, tq, tm, smem)
        nn_v1.launches += 1
    return idx, s


def nn_v2(x: torch.Tensor, y: torch.Tensor, tq: int = 256, tm: int = 2048):
    """K7: the function of :func:`nn_v1`, one block per query tile whose
    warps stream every column through their cp.async rings (tm a multiple
    of 4; it sets only the padding)."""
    _check(x, y, tq, tm)
    if _route(x) == "cpu":
        return nn_v2_plain(x, y, tq, tm)
    if tm % 4:
        raise ValueError(f"score_nn_v2 copies 16-byte chunks: tm must be a multiple of 4, "
                         f"got {tm}")
    smem = score_plan(tq)["smem"]  # each warp's ring; tm sets only m_pad
    xc, y4, m_pad = _cuda_inputs("score_nn_v2", x, y, tq, tm, smem)
    n = xc.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    s = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        err = _kernels()[1](xc.data_ptr(), y4.data_ptr(), n, m_pad, tq, tm,
                            idx.data_ptr(), s.data_ptr(), x.device.index,
                            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, "score_nn_v2", n, m_pad, tq, tm, smem)
        nn_v2.launches += 1
    return idx, s


nn_v1.launches = 0
nn_v2.launches = 0


# ----------------------------------------------------------------- harness

def check(name: str, fn, x, y) -> bool:
    """Correctness against an f64 dense argmin, tie-aware: a flip is
    accepted iff the true (f64) squared distances of the two candidates
    differ by less than the f32 score-form rounding bound 64 eps R^2
    (a genuine numerical tie)."""
    idx, _ = fn(x, y)
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    xh = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
    yh = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y, np.float64)
    d2 = np.sum((xh[:, None, :] - yh[None, :, :]) ** 2, axis=-1)
    ref = np.argmin(d2, axis=1)
    r2 = max(np.abs(xh).max(), np.abs(yh).max()) ** 2
    tie_tol = 64 * np.finfo(np.float32).eps * r2
    bad = idx != ref
    n_bad = int(bad.sum())
    if n_bad:
        rows = np.nonzero(bad)[0]
        gaps = np.abs(d2[rows, idx[rows]] - d2[rows, ref[rows]])
        worst = float(gaps.max())
        print(f"  {name}: {n_bad}/{len(idx)} argmin flips, worst true-d2 gap "
              f"{worst:.2e} (tie tol {tie_tol:.2e}) "
              f"{'(ties only)' if worst < tie_tol else '(REAL ERROR)'}")
        return worst < tie_tol
    print(f"  {name}: exact match ({len(idx)} rows)")
    return True


# (name, fn(x, y) -> (idx, value)): the seven rows of the TPU script's table
VARIANTS = [
    ("v0 K1 (difference form)", lambda a, b: tiled_knn.nn_distances(a, b)),
    ("v1 K6 split-m 256x2048", lambda a, b: nn_v1(a, b)),
    ("v1 K6 split-m 512x4096", lambda a, b: nn_v1(a, b, tq=512, tm=4096)),
    ("v1b semantics=True (no effect on the card)", lambda a, b: nn_v1(a, b, semantics=True)),
    ("v2 K7 cp.async 256x2048", lambda a, b: nn_v2(a, b)),
    ("v2 K7 cp.async 256x4096", lambda a, b: nn_v2(a, b, tm=4096)),
    ("v2 K7 cp.async 512x2048", lambda a, b: nn_v2(a, b, tq=512)),
]
CHECKED = [("v0", VARIANTS[0][1]), ("v1", nn_v1), ("v2", nn_v2)]


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(check_n: int = 4096, time_n: int = 100_000, seed: int = 0,
         warmup: int = 2, iters: int = 10) -> dict:
    """Correctness of v0/v1/v2 at check_n x check_n (two target tiles of
    2048: the carry runs), then every variant timed at time_n x time_n.
    Returns {"card", "correct": {name: bool}, "ms": {name: ms}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_knn times the kernels on a CUDA device, and none is available")
    device = torch.device("cuda", 0)
    card = card_name()
    print(f"device: {torch.cuda.get_device_name(device)} ({card})", flush=True)
    rng = np.random.default_rng(seed)

    xs = torch.as_tensor(rng.uniform(-50, 50, size=(check_n, 3)).astype(np.float32), device=device)
    ys = torch.as_tensor(rng.uniform(-50, 50, size=(check_n, 3)).astype(np.float32), device=device)
    print(f"correctness ({check_n}x{check_n}):", flush=True)
    correct = {name: check(name, fn, xs, ys) for name, fn in CHECKED}
    if not all(correct.values()):
        raise AssertionError(f"correctness failure beyond tie tolerance: {correct}")

    x = torch.as_tensor(rng.uniform(-50, 50, size=(time_n, 3)).astype(np.float32), device=device)
    y = torch.as_tensor(rng.uniform(-50, 50, size=(time_n, 3)).astype(np.float32), device=device)
    ms = {}
    for name, fn in VARIANTS:
        ms[name] = cuda_median_ms(lambda: fn(x, y), warmup=warmup, iters=iters)
        print(f"{name}: {ms[name]:.4f} ms at {time_n}x{time_n} (median of {iters}, CUDA "
              f"events; {card})", flush=True)
    return {"card": card, "correct": correct, "ms": ms}


if __name__ == "__main__":
    main()
