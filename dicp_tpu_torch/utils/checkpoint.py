"""Checkpoint / resume for long odometry runs: the counterpart of
``dicp_tpu/utils/checkpoint.py``.

The odometry layer has real state: accumulated poses, relative transforms
and pose-graph edges.  It is stored as one ``.npz`` written to a temporary
file and renamed over the target, so a crash never leaves a half-written
checkpoint.  Arrays may be numpy arrays or tensors on any device; tensors
are brought to the host first (``np.asarray`` of a CUDA tensor fails).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_odometry_state(path: str, poses, rel_transforms=None,
                        edges_i=None, edges_j=None, t_meas=None, info=None,
                        step: Optional[int] = None, **extra) -> None:
    """Atomically persist odometry/pose-graph state (plus any extra arrays)."""
    arrays = {"poses": _host(poses)}
    arrays.update({k: _host(v) for k, v in extra.items()})
    if rel_transforms is not None:
        arrays["rel_transforms"] = _host(rel_transforms)
    if edges_i is not None:
        if edges_j is None or t_meas is None or info is None:
            # np.asarray(None) is a pickled object array: np.savez accepts it,
            # the rename destroys the previous good checkpoint, and loading
            # (allow_pickle=False) then raises; fail before writing instead
            raise ValueError("edges_i requires edges_j, t_meas and info "
                             "(got None) — refusing to write an unloadable "
                             "checkpoint")
        arrays["edges_i"] = _host(edges_i)
        arrays["edges_j"] = _host(edges_j)
        arrays["t_meas"] = _host(t_meas)
        arrays["info"] = _host(info)
    if step is not None:
        arrays["step"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # write through a file object: np.savez appends '.npz' to bare paths
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_odometry_state(path: str) -> dict:
    """Load a checkpoint saved by :func:`save_odometry_state` (numpy arrays)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
