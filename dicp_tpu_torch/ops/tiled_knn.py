"""Exact batched 1-NN: the counterpart of ``dicp_tpu/ops/pallas_knn.py``.

``nn_distances(x, y)`` returns, for queries ``x (..., n, 3)`` and targets
``y (..., m, 3)``, the index (int32) and squared distance (f32) of each
query's nearest target, the same contract as ``nn_distances_pallas``:

* inputs are cast to f32 even when the caller holds f64 (pallas_knn.py:95-96);
* d2 is the difference form ((x0-y0)^2 + (x1-y1)^2) + (x2-y2)^2, summed in
  that order (pallas_knn.py:65-68; the module docstring there describes an
  |y|^2 - 2 x.y form, the code is what counts);
* the index is the FIRST index of the minimum.

Routing is by the device of the tensors and nothing else: a CPU tensor is
served by :func:`nn_distances_plain`, a CUDA tensor by the hand-written kernel
``dicp_tpu_torch/csrc/tiled_nn.cu``, built at first use by
:mod:`dicp_tpu_torch.ops._build`.  A CUDA call launches the kernel or raises;
it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dicp_tpu_torch.ops import _build

# Kernel launches by this wrapper (CUDA tensors only).
launches = 0

# Elements of one (batch, n, chunk) distance block in the plain version.
_PLAIN_BLOCK = 1 << 24
_MAX_BATCH = 65535  # gridDim.y of the kernel
# The kernel's schedule (csrc/tiled_nn.cu): LANE_Q queries per lane, one warp
# per contiguous target slice (:func:`slice_width`), SLICES slices per block,
# TILE targets per cp.async stage, a running minimum per CHUNK targets; the
# block's 32 * LANE_Q queries share the slices.
LANE_Q = 4
SLICES = 4
TILE = 128
CHUNK = 32


def slice_width(m: int) -> int:
    """Targets per warp slice: ceil(m / SLICES) rounded up to a multiple of
    4, so that every staged tile starts on a 16-byte boundary."""
    return (-(-m // SLICES) + 3) // 4 * 4


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() < 2 or x.shape[-1] != 3:
        raise ValueError(f"queries must be (..., n, 3), got {tuple(x.shape)}")
    if y.dim() < 2 or y.shape[-1] != 3:
        raise ValueError(f"targets must be (..., m, 3), got {tuple(y.shape)}")
    if x.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"batch shapes differ: {tuple(x.shape[:-2])} vs "
                         f"{tuple(y.shape[:-2])}")
    if y.shape[-2] == 0:
        raise ValueError("1-NN needs at least one target point")
    if x.device != y.device:
        raise ValueError(f"queries on {x.device} but targets on {y.device}")
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError(f"1-NN takes floating-point clouds, got {x.dtype} "
                        f"and {y.dtype}")


def nn_distances_plain(x: torch.Tensor, y: torch.Tensor,
                       chunk: int | None = None):
    """Plain PyTorch version of the kernel, on any device.

    Streams the targets in chunks of ``chunk`` rows (auto: a block of about
    ``_PLAIN_BLOCK`` distances): the first argmin inside a chunk, and a strict
    ``<`` across chunks, give the first index of the global minimum whatever
    the chunking.  Unfused elementwise ops round like the kernel built with
    ``--fmad=false``, so the two agree bit for bit."""
    _check(x, y)
    x = x.detach().to(torch.float32)
    y = y.detach().to(torch.float32)
    batch, n, m = x.shape[:-2], x.shape[-2], y.shape[-2]
    if chunk is None:
        chunk = max(1, min(m, _PLAIN_BLOCK // max(1, math.prod(batch) * n)))
    best = torch.full(batch + (n,), math.inf, dtype=torch.float32, device=x.device)
    arg = torch.zeros(batch + (n,), dtype=torch.int32, device=x.device)
    for j0 in range(0, m, chunk):
        yc = y[..., j0:j0 + chunk, :]
        diff = x[..., :, None, 0] - yc[..., None, :, 0]
        d2 = diff * diff
        for c in (1, 2):
            diff = x[..., :, None, c] - yc[..., None, :, c]
            d2 = d2 + diff * diff
        local_arg = torch.argmin(d2, dim=-1)            # first index on ties
        local_min = torch.gather(d2, -1, local_arg[..., None])[..., 0]
        better = local_min < best
        best = torch.where(better, local_min, best)
        arg = torch.where(better, local_arg.to(torch.int32) + j0, arg)
    return arg, best


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("tiled_nn").tiled_nn_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_sizes(nb: int, n: int, m: int) -> None:
    """The kernel's limits: gridDim.y and 32-bit element offsets."""
    if nb > _MAX_BATCH or max(n, m) >= 2**31 // 3:
        raise ValueError(f"tiled_nn takes batch <= {_MAX_BATCH} and fewer "
                         f"than {2**31 // 3} points, got batch {nb}, n {n}, m {m}")


def _nn_distances_cuda(x: torch.Tensor, y: torch.Tensor):
    global launches
    batch, n, m = x.shape[:-2], x.shape[-2], y.shape[-2]
    nb = math.prod(batch)
    _check_sizes(nb, n, m)
    # the kernel reads contiguous (batch, n|m, 3) f32, aligned or not
    xc = x.detach().to(torch.float32).contiguous().reshape(nb, n, 3)
    yc = y.detach().to(torch.float32).contiguous().reshape(nb, m, 3)
    idx = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    d2 = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    if nb and n:
        err = _kernel()(xc.data_ptr(), yc.data_ptr(), nb, n, m, idx.data_ptr(),
                        d2.data_ptr(), x.device.index,
                        torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"tiled_nn kernel launch failed: CUDA error {err}")
        launches += 1
    return idx.reshape(batch + (n,)), d2.reshape(batch + (n,))


def nn_distances(x: torch.Tensor, y: torch.Tensor):
    """(indices int32, squared distances f32) of each query's nearest target.

    x (..., n, 3), y (..., m, 3) with equal batch shapes; no gradient."""
    _check(x, y)
    if x.device.type == "cpu":
        return nn_distances_plain(x, y)
    if x.device.type == "cuda":
        return _nn_distances_cuda(x, y)
    raise ValueError(f"tiled 1-NN runs on cpu or cuda tensors, got {x.device}")


def nn_indices(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-target index (..., n) int32; see :func:`nn_distances`."""
    return nn_distances(x, y)[0]
