"""Streaming scan dataset with background prefetch: a copy of
``dicp_tpu/io/dataset.py`` (numpy only, no framework).

The host pipeline (disk read -> range filter -> voxel downsample -> pad to a
static shape) runs in a worker thread pool via the native runtime
(:mod:`dicp_tpu_torch.io.native`), keeping the card fed: while the card
registers scan pair k, the host prepares pair k+1.

Static shapes: every scan is padded (zero rows, zero weights — the solver's
padding convention) or truncated to ``max_points``, so every scan of a stream
has the shape the windowed solve stacks.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dicp_tpu_torch.io import native


def preprocess_scan(
    points: np.ndarray,
    max_points: int,
    voxel: Optional[float] = None,
    min_range: float = 0.0,
    max_range: float = np.inf,
) -> Tuple[np.ndarray, np.ndarray]:
    """Filter + downsample + pad one scan to (max_points, c) with weights.

    Returns (points, weight); weight is 0 on padding rows and the voxel
    point count on real rows (prior weight for the solver).
    """
    pts = np.ascontiguousarray(points, np.float32)
    if min_range > 0.0 or np.isfinite(max_range):
        pts = native.range_filter(pts, min_range, max_range)
    if voxel is not None:
        pts, w = native.voxel_downsample_host(pts, voxel, return_weight=True)
    else:
        w = np.ones((pts.shape[0],), np.float32)
    n, c = pts.shape
    if n >= max_points:
        # even index-stride subsample, NOT head truncation: scan files are
        # often ordered by beam/surface, so the head is one region of the
        # scene and registering it is a degenerate (unobservable) problem
        idx = np.linspace(0, n - 1, max_points).astype(np.int64)
        return pts[idx], w[idx]
    out = np.zeros((max_points, c), np.float32)
    ow = np.zeros((max_points,), np.float32)
    out[:n] = pts
    ow[:n] = w
    return out, ow


class ScanDataset:
    """Directory of ``.bin``/``.npy`` scans, prefetched and preprocessed.

    Iterating yields (points (max_points, c), weight (max_points,)) numpy
    pairs ready for :func:`dicp_tpu_torch.pipeline.stream_registrations`; ``prefetch`` scans
    are prepared ahead by ``workers`` threads.
    """

    def __init__(self, paths: Sequence[str], max_points: int = 8192,
                 voxel: Optional[float] = None, min_range: float = 0.0,
                 max_range: float = np.inf, stride: int = 4,
                 workers: int = 2, prefetch: int = 4):
        self.paths: List[str] = list(paths)
        self.max_points = max_points
        self.voxel = voxel
        self.min_range = min_range
        self.max_range = max_range
        self.stride = stride
        self.workers = workers
        self.prefetch = prefetch

    @classmethod
    def from_dir(cls, directory: str, pattern_exts=(".bin", ".npy"), **kw):
        paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith(tuple(pattern_exts)))
        return cls(paths, **kw)

    def _load(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        if path.endswith(".npy"):
            pts = np.load(path).astype(np.float32)
        else:
            pts = native.load_bin(path, stride=self.stride)
        return preprocess_scan(pts, self.max_points, self.voxel,
                               self.min_range, self.max_range)

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = []
            it = iter(self.paths)
            # at least one future, or prefetch=0 would yield nothing (the
            # while-pending loop never starts)
            for _ in range(min(max(self.prefetch, 1), len(self.paths))):
                pending.append(pool.submit(self._load, next(it)))
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    pass
                yield fut.result()

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield stacked (B, max_points, c), (B, max_points) batches (the last
        partial batch is dropped — static shapes for the compiled solver)."""
        buf_p, buf_w = [], []
        for pts, w in self:
            buf_p.append(pts)
            buf_w.append(w)
            if len(buf_p) == batch_size:
                yield np.stack(buf_p), np.stack(buf_w)
                buf_p, buf_w = [], []
