"""Closed-form batched solves of the tiny SPD normal equations: the
counterpart of ``dicp_tpu/ops/smallsolve.py``.

k = 3 (dim=2) by Cramer's rule; k = 6 (dim=3) by 2x2 block elimination on
the Schur complement of the leading 3x3 block.  No LU and no pivoting: the
solver always hands over J^T W J + lambda I with lambda > 0, whose principal
blocks and Schur complement are SPD.  Everything broadcasts over leading
batch dims and is plain differentiable arithmetic.
"""

from __future__ import annotations

import torch


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (a @ v[..., None])[..., 0]


def solve3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b for (..., 3, 3) SPD a and (..., 3) b (Cramer)."""
    return _matvec(inv3(a), b)


def solve6_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b for (..., 6, 6) SPD a and (..., 6) b.

        [P  Q] [x1]   [b1]          M = S - Qt P^-1 Q        (SPD)
        [Qt S] [x2] = [b2]   =>     x2 = M^-1 (b2 - Qt P^-1 b1)
                                    x1 = P^-1 (b1 - Q x2)
    """
    p, q = a[..., :3, :3], a[..., :3, 3:]
    qt, s = a[..., 3:, :3], a[..., 3:, 3:]
    b1, b2 = b[..., :3], b[..., 3:]

    p_inv = inv3(p)
    p_inv_q = p_inv @ q
    m = s - qt @ p_inv_q
    p_inv_b1 = _matvec(p_inv, b1)
    x2 = solve3(m, b2 - _matvec(qt, p_inv_b1))
    x1 = p_inv_b1 - _matvec(p_inv_q, x2)
    return torch.cat([x1, x2], dim=-1)


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the (..., k, k) SPD system for k in (3, 6); b is (..., k).

    Jacobi equilibration first: the rotation block scales with radius^2 * n
    and the translation block with n, a disparity that makes the f32 Schur
    complement cancel; D = diag(A)^-1/2 gives a unit diagonal."""
    k = a.shape[-1]
    if k not in (3, 6):
        raise ValueError(f"closed-form solve takes 3x3 or 6x6 systems, got {k}x{k}")
    d = torch.sqrt(torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), min=1e-30))
    dinv = 1.0 / d
    a_eq = a * dinv[..., :, None] * dinv[..., None, :]
    b_eq = b * dinv
    y = solve3(a_eq, b_eq) if k == 3 else solve6_spd(a_eq, b_eq)
    return y * dinv
