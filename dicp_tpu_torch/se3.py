"""SE(3) / SO(3) Lie-group math: the counterpart of ``dicp_tpu/se3.py``.

Closed-form Rodrigues and Jacobian expressions, convention
T = [[exp(phi^), J(phi) rho], [0, 1]] for xi = [rho, phi].  Every function is
dtype-preserving, broadcasts over leading batch dimensions and is safe under
autograd: small-angle branches use ``torch.where`` on safe operands, so no
inf or NaN reaches a gradient.
"""

from __future__ import annotations

import torch


def _small(dtype: torch.dtype) -> float:
    """Angle below which Taylor series replace the exact trig expressions.

    Dtype-aware (dicp_tpu/se3.py:30): with the f64 threshold in float32,
    ``1 - cos`` underflows to 0 and ``arccos`` is evaluated at exactly 1.0
    with a live tangent.  At 0.1 the dropped Taylor terms are O(theta^6),
    below f32 resolution."""
    return 1e-6 if torch.finfo(dtype).bits >= 64 else 0.1


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with ``skew(v) @ u == cross(v, u)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`skew`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _safe_theta(theta2: torch.Tensor):
    """(small_mask, theta) with theta = 1 where small, so sqrt never sees 0."""
    small = theta2 < _small(theta2.dtype) ** 2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return small, theta


def _sin_theta_over_theta(theta2: torch.Tensor) -> torch.Tensor:
    small, theta = _safe_theta(theta2)
    exact = torch.sin(theta) / theta
    taylor = 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0
    return torch.where(small, taylor, exact)


def _one_minus_cos_over_theta2(theta2: torch.Tensor) -> torch.Tensor:
    small, theta = _safe_theta(theta2)
    exact = (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2), theta2)
    taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    return torch.where(small, taylor, exact)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: exp(phi^) for phi (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    a = _sin_theta_over_theta(theta2)
    b = _one_minus_cos_over_theta2(theta2)
    k = skew(phi)
    return _eye3(phi) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log_so3(rot: torch.Tensor) -> torch.Tensor:
    """Rotation log map (..., 3, 3) -> (..., 3); robust near identity, with
    the symmetric-part fallback near pi."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - _small(cos_theta.dtype) ** 2 / 2.0
    # arccos has infinite slope at 1: mask its input so no NaN gradient leaks
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))

    # generic branch: phi = theta / (2 sin(theta)) * vee(R - R^T)
    w = vee(rot - rot.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_theta = torch.sin(theta)
    near_pi = (sin_theta < 1e-6) & ~small
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    factor_exact = theta / (2.0 * safe_sin)
    # small branch: arcsin(s)/(2s) expanded in s^2 = sin^2(theta)
    t2s = 0.25 * torch.sum(w * w, dim=-1)
    factor_taylor = 0.5 + t2s / 12.0 + 27.0 * t2s * t2s / 720.0
    factor = torch.where(small, factor_taylor, factor_exact)
    phi_generic = factor[..., None] * w

    # near-pi branch: axis from the dominant diagonal of (R + I) / 2
    rr = (rot + _eye3(rot)) * 0.5
    diag = torch.stack([rr[..., 0, 0], rr[..., 1, 1], rr[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(diag, min=0.0)
    k = torch.argmax(axis_sq, dim=-1, keepdim=True)
    axis_k = torch.sqrt(torch.clamp(torch.gather(axis_sq, -1, k)[..., 0], min=1e-12))
    col = torch.gather(rr, -1, k[..., None, :].expand(rr.shape[:-1] + (1,)))[..., 0]
    axis = col / axis_k[..., None]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    sign = torch.where(torch.sum(axis * w, dim=-1) < 0.0, -1.0, 1.0).to(rot.dtype)
    phi_pi = (sign * theta)[..., None] * axis

    return torch.where(near_pi[..., None] & ~small[..., None], phi_pi, phi_generic)


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J(phi): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small, theta = _safe_theta(theta2)
    b = _one_minus_cos_over_theta2(theta2)
    safe3 = torch.where(small, torch.ones_like(theta2), theta2 * theta)
    c_exact = (theta - torch.sin(theta)) / safe3
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0
    c = torch.where(small, c_taylor, c_exact)
    k = skew(phi)
    return _eye3(phi) + b[..., None, None] * k + c[..., None, None] * (k @ k)


def left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small, theta = _safe_theta(theta2)
    half = 0.5 * theta
    cot = torch.where(small, 1.0 - theta2 / 12.0 - theta2 * theta2 / 720.0,
                      half / torch.tan(half))
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    d_exact = (1.0 - cot) / safe_t2
    d_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    d = torch.where(small, d_taylor, d_exact)
    k = skew(phi)
    return _eye3(phi) - 0.5 * k + d[..., None, None] * (k @ k)


def _homogeneous(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[rot, t], [0, 1]] from rot (..., 3, 3) and t (..., 3)."""
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def vec2tran(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential, xi = [rho, phi] (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return _homogeneous(exp_so3(phi), (left_jacobian(phi) @ rho[..., None])[..., 0])


def tran2vec(tran: torch.Tensor) -> torch.Tensor:
    """SE(3) log map (..., 4, 4) -> (..., 6), inverse of :func:`vec2tran`."""
    phi = log_so3(tran[..., :3, :3])
    rho = (left_jacobian_inv(phi) @ tran[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def tran_inv(tran: torch.Tensor) -> torch.Tensor:
    """Fast SE(3) inverse: [[C, r], [0, 1]]^-1 = [[C^T, -C^T r], [0, 1]]."""
    rot_t = tran[..., :3, :3].transpose(-1, -2)
    return _homogeneous(rot_t, -(rot_t @ tran[..., :3, 3:])[..., 0])


def compose(t_ab: torch.Tensor, t_bc: torch.Tensor) -> torch.Tensor:
    """Compose transforms: T_ac = T_ab @ T_bc (broadcasting matmul)."""
    return t_ab @ t_bc
