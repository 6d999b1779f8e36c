"""Compat shim: the class-based loss interface of ``dICP.loss.loss`` on top
of the functional :mod:`dicp_tpu_torch.losses` (mirrors ``dicp_tpu/loss.py``)."""

from __future__ import annotations

from dicp_tpu_torch import losses as _losses


class loss:
    def __init__(self, name: str = "huber", metric: float = 1.0,
                 differentiable: bool = False, tanh_steepness: float = 10.0):
        self.name = name
        self.metric = metric
        self.differentiable = differentiable
        self.tanh_steepness = tanh_steepness

    def get_weight(self, err):
        return _losses.robust_weight(
            self.name, err, self.metric, self.differentiable, self.tanh_steepness)
