"""Carry state across from the JAX package.

The system has no learned weights: its state is the solver configuration,
the point clouds and the cluster index built from a cloud.  These functions
carry them across without importing JAX: a JAX ``ICPConfig`` travels as
``dataclasses.asdict(cfg)``, arrays and the five arrays of a JAX
``ClusterIndex`` as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops.cluster_knn import ClusterIndex
from dicp_tpu_torch.registration import ICPResult


def config_from_dict(d: dict) -> ICPConfig:
    """The port's :class:`ICPConfig` from ``dataclasses.asdict`` of a JAX
    ``ICPConfig``; an unknown field raises."""
    names = {f.name for f in dataclasses.fields(ICPConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"fields unknown to dicp_tpu_torch.ICPConfig: {unknown}")
    return ICPConfig(**d)


def to_torch(np_array, device="cpu", dtype=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(np_array), dtype=dtype, device=device)


def result_to_numpy(result: ICPResult) -> ICPResult:
    """Every field of an :class:`ICPResult` as a host numpy array."""
    return ICPResult(*(t.detach().cpu().numpy() for t in result))


def cluster_index_from_numpy(fields, device="cpu") -> ClusterIndex:
    """A :class:`ClusterIndex` on ``device`` from the five arrays of a JAX
    ``ClusterIndex`` (points, centers, radius, order, frame), one cloud's or
    a ``vmap``-built batch's.  Dtypes are kept (``order`` as int32), so a
    search of the carried index selects the same groups as JAX's."""
    points, centers, radius, order, frame = (np.asarray(f) for f in fields)
    batch = points.shape[:-3]
    G, g = points.shape[-3], points.shape[-2]
    expected = {"points": (points.shape, batch + (G, g, 3)),
                "centers": (centers.shape, batch + (G, 3)),
                "radius": (radius.shape, batch + (G,)),
                "order": (order.shape, batch + (G * g,)),
                "frame": (frame.shape, batch + (2, 3))}
    for name, (got, want) in expected.items():
        if got != want:
            raise ValueError(f"ClusterIndex field {name} has shape {got}, expected {want}")
    return ClusterIndex(points=to_torch(points, device), centers=to_torch(centers, device),
                        radius=to_torch(radius, device),
                        order=to_torch(order.astype(np.int32), device),
                        frame=to_torch(frame, device))


def cluster_index_to_numpy(index: ClusterIndex) -> ClusterIndex:
    """Every field of a :class:`ClusterIndex` as a host numpy array."""
    return ClusterIndex(*(t.detach().cpu().numpy() for t in index))
