"""Robust-loss IRLS weights: the counterpart of ``dicp_tpu/losses.py``.

Every function takes ``err`` of shape (..., d), reduces over the last axis
and returns weights of shape (...,).
"""

from __future__ import annotations

import torch

VALID_LOSSES = ("huber", "cauchy", "welsch", "gm", "trim")


def _err_norm(err: torch.Tensor) -> torch.Tensor:
    """|err| over the last axis with a zero subgradient at 0.

    Exact zeros occur (the test clouds are exact transforms of each other),
    and d sqrt at 0 would put NaN into the whole backward pass."""
    sq = torch.sum(err * err, dim=-1)
    zero = sq == 0.0
    safe = torch.where(zero, torch.ones_like(sq), sq)
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(safe))


def huber_weight(err: torch.Tensor, metric: float, differentiable: bool = True) -> torch.Tensor:
    """Pseudo-Huber k^2/(k^2 + |e|^2) when differentiable, else min(1, k/|e|)."""
    if differentiable:
        m2 = metric * metric
        return m2 / (m2 + torch.sum(err * err, dim=-1))
    err_norm = _err_norm(err)
    # safe denominator: metric/err_norm at err_norm == 0 would give 0 * inf
    safe = torch.where(err_norm > metric, err_norm, torch.ones_like(err_norm))
    return torch.where(err_norm > metric, metric / safe, torch.ones_like(err_norm))


def cauchy_weight(err: torch.Tensor, metric: float, differentiable: bool = True) -> torch.Tensor:
    """Cauchy 1/(1 + (|e|/k)^2); the same expression in both modes."""
    del differentiable
    return 1.0 / (1.0 + torch.sum(err * err, dim=-1) / (metric * metric))


def welsch_weight(err: torch.Tensor, metric: float, differentiable: bool = True) -> torch.Tensor:
    """Welsch exp(-|e|^2 / k^2); the same expression in both modes."""
    del differentiable
    return torch.exp(-torch.sum(err * err, dim=-1) / (metric * metric))


def gm_weight(err: torch.Tensor, metric: float, differentiable: bool = True) -> torch.Tensor:
    """Geman-McClure k^4/(k^2 + |e|^2)^2; the same expression in both modes."""
    del differentiable
    m2 = metric * metric
    d = m2 + torch.sum(err * err, dim=-1)
    return (m2 / d) ** 2


def trim_weight(err: torch.Tensor, metric: float, differentiable: bool = True,
                tanh_steepness: float = 5.0) -> torch.Tensor:
    """Soft gate 0.5*tanh(s*(k - |e|) - 3) + 0.5 when differentiable, else
    the hard indicator |e| < k."""
    err_norm = _err_norm(err)
    if differentiable:
        return 0.5 * torch.tanh(tanh_steepness * (metric - err_norm) - 3.0) + 0.5
    return torch.where(err_norm < metric, torch.ones_like(err_norm),
                       torch.zeros_like(err_norm))


def robust_weight(name: str, err: torch.Tensor, metric: float,
                  differentiable: bool = True, tanh_steepness: float = 5.0) -> torch.Tensor:
    """Dispatch by loss name."""
    if name == "huber":
        return huber_weight(err, metric, differentiable)
    if name == "cauchy":
        return cauchy_weight(err, metric, differentiable)
    if name == "welsch":
        return welsch_weight(err, metric, differentiable)
    if name == "gm":
        return gm_weight(err, metric, differentiable)
    if name == "trim":
        return trim_weight(err, metric, differentiable, tanh_steepness)
    raise ValueError(f"Invalid loss name: {name}")
