"""Point-cloud plotting helpers: the counterpart of
``dicp_tpu/visualization.py`` (parity with dICP/visualization.py:5-43).

Clouds may be numpy arrays or tensors on any device.  matplotlib is
imported lazily, so headless runs that never plot do not pay the import.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(pc):
    if isinstance(pc, torch.Tensor):
        return pc.detach().cpu().numpy()
    return np.asarray(pc)


def plot_overlay(pc1, pc2, c1="b", c2="r", file_name="overlay.png"):
    """2-D scatter overlay of two clouds saved to PNG (dICP/visualization.py:5-15)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pc1 = _to_numpy(pc1)
    pc2 = _to_numpy(pc2)
    plt.figure()
    plt.scatter(pc1[:, 0], pc1[:, 1], s=0.5, c=c1)
    plt.scatter(pc2[:, 0], pc2[:, 1], s=0.5, c=c2)
    plt.savefig(file_name)
    plt.close()


def plot_map(points, color="b", map=None, file_name=None):
    """Map scatter plot (dICP/visualization.py:17-43); saves instead of
    plt.show() when ``file_name`` is given (headless-safe)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = _to_numpy(points)
    plt.scatter(points[:, 0], points[:, 1], marker="o", color=color)
    if map is not None:
        xlim, ylim = map.get_boundingbox()
        plt.xlim(*xlim)
        plt.ylim(*ylim)
    else:
        plt.xlim(-4, 6)
        plt.ylim(-2, 10)
    if file_name:
        plt.savefig(file_name)
        plt.close()
