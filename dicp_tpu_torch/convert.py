"""Carry state across from the JAX package.

The system has no learned weights: its state is the solver configuration
and the point clouds.  These three functions carry them across without
importing JAX: a JAX ``ICPConfig`` travels as ``dataclasses.asdict(cfg)``,
arrays as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dicp_tpu_torch.config import ICPConfig
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
