"""Batched closed-form (Kabsch) point-to-point ICP: the counterpart of
``dicp_tpu/svd_icp.py``.

Dense brute-force NN (:func:`knn.hard_nn`, as in JAX), weighted centroids
and cross-covariance, and the optimal rotation by Horn's quaternion method:
a fixed-count power iteration on a batched symmetric 4x4 from four seeds
(:func:`_kabsch`), not ``torch.linalg.svd`` or ``eigh``.  The seeds are what
recover 180-degree alignments, including those about axes with
ux + uy + uz = 0.

``differentiable=True`` runs ``max_iterations`` steps with autograd through
them (JAX's ``lax.scan``); ``False`` is an early-exit loop that tests
convergence on the host once per iteration (JAX's ``lax.while_loop``).
Converged elements stay frozen, so a batch equals its elements solved one
by one.  The convergence test is the reference's: the sum of squared
residuals to the current correspondences below ``tolerance``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dicp_tpu_torch import knn, se3
from dicp_tpu_torch.api import _as_tensor, _resolve_device


class SVDICPResult(NamedTuple):
    pc: torch.Tensor          # (N, n, 3) aligned source
    T: torch.Tensor           # (N, 4, 4) transform source -> target
    converged: torch.Tensor   # (N,) bool
    iterations: torch.Tensor  # (N,) int32 (first iteration at which converged)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (N, 4) [w, x, y, z] -> rotation matrix (N, 3, 3)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, keepdim, summed in index order."""
    sq = v * v
    total = sq[..., 0]
    for i in range(1, v.shape[-1]):
        total = total + sq[..., i]
    return torch.sqrt(total)[..., None]


def _kabsch(ps: torch.Tensor, qs: torch.Tensor, w: torch.Tensor,
            power_iters: int = 32):
    """Weighted optimal rigid alignment of ps onto qs, both (N, n, 3), w (N, n).

    Returns (C (N,3,3), r (N,3)) minimizing sum_i w_i |C p_i + r - q_i|^2.
    The rotation is the top eigenvector of Horn's symmetric 4x4, found by
    ``power_iters`` unrolled power-iteration steps from four seeds, the
    winner picked by Rayleigh quotient; proper (det +1) by construction.
    """
    dtype = ps.dtype
    tiny = torch.finfo(dtype).tiny * 1e6
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wsafe = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    wn = w / wsafe
    mean_p = torch.einsum("np,npi->ni", wn, ps)
    mean_q = torch.einsum("np,npi->ni", wn, qs)
    pc = ps - mean_p[:, None, :]
    qc = qs - mean_q[:, None, :]
    # cross-covariance S[a, b] = sum w p_a q_b (source x target)
    S = torch.einsum("np,npa,npb->nab", wn, pc, qc)

    sxx, sxy, sxz = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    syx, syy, syz = S[:, 1, 0], S[:, 1, 1], S[:, 1, 2]
    szx, szy, szz = S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]
    K = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)  # (N, 4, 4) symmetric

    # degenerate cross-covariance (all weights zero, coincident points): no
    # rotation information, so the identity; without this the power
    # iteration underflows q to 0 and 0/0 = NaN
    s_norm2 = torch.sum(S * S, dim=(-2, -1))
    degenerate = s_norm2 < tiny

    # shift so that the top eigenvalue dominates in magnitude, then iterate
    shift = 2.0 * torch.sqrt(torch.where(degenerate, torch.ones_like(s_norm2), s_norm2))
    Ks = K + shift[:, None, None] * torch.eye(4, dtype=dtype, device=ps.device)

    # Four seeds: the identity quaternion is orthogonal to the eigenvector of
    # every 180-degree alignment (w = cos(theta/2) = 0), and a power
    # iteration never recovers a component its seed lacks; the three
    # vector-part seeds span {w = 0} x R^3, so every unit quaternion overlaps
    # one of them (two seeds leave axes with ux + uy + uz = 0 blind).
    seeds = torch.tensor([[1.0, 0.0, 0.0, 0.0],
                          [0.0, 1.0, 1.0, 1.0],
                          [0.0, 1.0, -1.0, 0.0],
                          [0.0, 1.0, 0.0, -1.0]], dtype=dtype, device=ps.device)
    seeds = seeds / _norm(seeds)
    q = seeds.expand(ps.shape[0], 4, 4)
    # normalise every step with a zero guard: repeated tiny-eigenvalue
    # matvecs underflow f32 otherwise
    for _ in range(power_iters):
        q = torch.einsum("nij,nsj->nsi", Ks, q)
        norm = _norm(q)
        bad = norm < tiny
        q = torch.where(bad, seeds, q / torch.where(bad, torch.ones_like(norm), norm))
    rayleigh = torch.einsum("nsi,nij,nsj->ns", q, K, q)      # (N, 4)
    pick = torch.argmax(rayleigh, dim=-1)
    q = torch.gather(q, 1, pick[:, None, None].expand(-1, 1, 4))[:, 0]
    C = _quat_to_rot(q)
    eye = torch.eye(3, dtype=dtype, device=ps.device).expand(C.shape)
    C = torch.where(degenerate[:, None, None], eye, C)
    r = mean_q - torch.einsum("nij,nj->ni", C, mean_p)
    return C, r


def pt2pt_svd_icp(
    source,
    target,
    T_init=None,
    weight=None,
    max_iterations: int = 100,
    tolerance: float = 1e-12,
    trim_dist: Optional[float] = None,
    differentiable: bool = True,
    device=None,
) -> SVDICPResult:
    """Batched closed-form pt2pt ICP.

    source (N|_, n, 3), target (N|_, m, >=3), T_init (N|_, 4, 4) or None.
    Unbatched inputs get a leading batch axis added (and lose it in the
    result).  ``trim_dist`` applies a hard residual gate re-evaluated each
    iteration; a negative one is ignored.  Tensors keep their device; numpy
    inputs go to ``device``, by default the card (see
    :mod:`dicp_tpu_torch.api`).
    """
    device = _resolve_device(device, source, target, T_init, weight)
    source = _as_tensor(source, device)
    dtype = source.dtype
    target = _as_tensor(target, device, dtype)
    T_init = None if T_init is None else _as_tensor(T_init, device, dtype)
    weight = None if weight is None else _as_tensor(weight, device, dtype)

    squeeze = source.dim() == 2
    if squeeze:
        source = source[None]
        target = target[None]
        if T_init is not None and T_init.dim() == 2:
            T_init = T_init[None]
        if weight is not None and weight.dim() == 1:
            weight = weight[None]
    N, n = source.shape[0], source.shape[1]
    source = source[..., :3]
    target = target[..., :3]
    if T_init is None:
        T_init = torch.eye(4, dtype=dtype, device=device).expand(N, 4, 4)
    if weight is None:
        weight = torch.ones((N, n), dtype=dtype, device=device)

    C = T_init[:, :3, :3]
    r = T_init[:, :3, 3]
    converged = torch.zeros((N,), dtype=torch.bool, device=device)
    iters = torch.zeros((N,), dtype=torch.int32, device=device)

    for it in range(max_iterations):
        if not differentiable and bool(torch.all(converged)):
            break
        ps_t = torch.einsum("nij,npj->npi", C, source) + r[:, None, :]
        nn_t = knn.hard_nn(ps_t, target)
        w = weight
        if trim_dist is not None and trim_dist >= 0.0:
            # a negative trim is ignored here only: an all-zero weight vector
            # would NaN the Kabsch centroids (the GN path follows the
            # reference's negative gate semantics)
            resid = _norm(ps_t - nn_t)[..., 0]
            w = w * (resid < trim_dist).to(dtype)
        dC, dr = _kabsch(ps_t, nn_t, w)
        C_new = dC @ C
        r_new = torch.einsum("nij,nj->ni", dC, r) + dr
        ps_new = torch.einsum("nij,npj->npi", C_new, source) + r_new[:, None, :]
        sq = torch.sum(w * torch.sum((ps_new - nn_t) ** 2, dim=-1), dim=-1)
        below = sq < tolerance
        iters = torch.where(below & ~converged, torch.full_like(iters, it + 1), iters)
        # freeze converged elements (batch == serial)
        C = torch.where(converged[:, None, None], C, C_new)
        r = torch.where(converged[:, None], r, r_new)
        converged = converged | below

    iters = torch.where(converged, iters, torch.full_like(iters, max_iterations))
    pc = torch.einsum("nij,npj->npi", C, source) + r[:, None, :]
    T = se3._homogeneous(C, r)
    if squeeze:
        return SVDICPResult(pc[0], T[0], converged[0], iters[0])
    return SVDICPResult(pc, T, converged, iters)
