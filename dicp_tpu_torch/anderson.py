"""Anderson-accelerated ICP, the counterpart of ``dicp_tpu/anderson.py``.

The Gauss-Newton update is a fixed-point map on SE(3); type-II Anderson
mixing over the last ``m`` iterates, in [log C | r] coordinates, with the
energy safeguard of AA-ICP (arXiv:1709.05479) and Fast-and-Robust-ICP
(arXiv:2007.07627): an accelerated iterate whose ICP energy exceeds the last
accepted one is discarded for the plain GN step, so the worst case is
ordinary ICP with one wasted evaluation per rejection.  Batch elements
accelerate, reject and converge independently (batch == serial).

The JAX ``lax.while_loop`` is a Python loop here over the same
:func:`registration._gn_step` and correspondence closure, so every tier,
with its kernels on the card, serves it; it checks convergence on the host
once per iteration.  It runs without autograd, as JAX's while loop admits
no reverse-mode AD: gradients come from :mod:`dicp_tpu_torch.ift`, whose
forward this driver can be (``anderson_m > 0``).

Measured in the JAX package (CPU f64, tolerance 1e-10): pt2pt 25 -> 10
iterations on the reference pair; pt2pl is near-quadratic already and pays
1-3 extra evaluations.
"""

from __future__ import annotations

from typing import Optional

import torch

from dicp_tpu_torch import se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.registration import (ICPResult, _gn_step, _make_corr_fn,
                                         _preprocess)


def _encode(C, r):
    """(N, 3, 3), (N, 3) -> (N, 6) coordinates [log C | r]."""
    return torch.cat([se3.log_so3(C), r], dim=-1)


def _decode(u):
    return se3.exp_so3(u[..., :3]), u[..., 3:]


def _aa_mix(dU, dF, f, valid, eps_rel, cap):
    """Type-II Anderson mixing correction.

    dU, dF (N, m, 6): histories of iterate and residual differences; f
    (N, 6): the current residual g(u) - u; valid (N, m): 1 for filled slots.
    Returns sum_j gamma_j (dU_j + dF_j), capped at ``cap * |f|``: ICP's
    energy is only piecewise smooth, and uncapped extrapolations overshoot
    and are rejected every few steps."""
    dFm = dF * valid[..., None]
    A = torch.einsum("nme,nke->nmk", dFm, dFm)
    b = torch.einsum("nme,ne->nm", dFm, f)
    # relative Tikhonov: empty or ill-conditioned histories stay harmless
    m = A.shape[-1]
    diag_max = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1,
                          keepdim=True)
    lam = eps_rel * diag_max + torch.finfo(A.dtype).tiny
    A = A + lam[..., None] * torch.eye(m, dtype=A.dtype, device=A.device)
    gamma = torch.linalg.solve(A, b[..., None])[..., 0] * valid
    corr = torch.einsum("nm,nme->ne", gamma, dU + dF)
    cn = torch.linalg.vector_norm(corr, dim=-1, keepdim=True)
    fn = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    tiny = torch.finfo(corr.dtype).tiny
    return corr * torch.clamp(cap * fn / torch.clamp(cn, min=tiny), max=1.0)


def register_anderson(source: torch.Tensor, target: torch.Tensor, T_init: torch.Tensor,
                      weight: Optional[torch.Tensor] = None, cfg: ICPConfig = ICPConfig(),
                      m: int = 4, eps_rel: float = 1e-8, cap: float = 5.0) -> ICPResult:
    """Batched ICP with Anderson-accelerated fixed-point iteration.

    Inputs and outputs as :func:`dicp_tpu_torch.registration.register` with
    ``collect_histories=False`` semantics; inference only."""
    if cfg.differentiable:
        raise ValueError("register_anderson is an inference driver; for "
                         "gradients use dicp_tpu_torch.ift (IFT backward) or the "
                         "unrolled loop")
    if source.dim() != 3 or target.dim() != 3 or T_init.dim() != 3:
        raise ValueError("register_anderson expects batched (N, n, 3), "
                         "(N, m, 3|6), (N, 4, 4)")
    return _anderson_impl(source, target, T_init, weight, cfg, int(m), float(eps_rel),
                          float(cap))


# The JAX package's ``register_anderson_jit`` is ``jax.jit(register_anderson)``.
# PyTorch runs eagerly, so the port's is :func:`register_anderson` itself: the
# same signature and results, no compilation.
register_anderson_jit = register_anderson


@torch.no_grad()
def _anderson_impl(source, target, T_init, weight, cfg, m, eps_rel, cap):
    source, target, weight, C0, r0 = _preprocess(cfg, source, target, T_init, weight)
    corr_fn = _make_corr_fn(cfg, source, target, C0, r0)
    dtype, device = source.dtype, source.device
    N = source.shape[0]
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=device)

    u = _encode(C0, r0)
    g_safe, u_acc = u, u                       # plain-GN fallback, last accepted
    f_acc = source.new_zeros((N, 6))           # residual at the last accepted
    cost_acc = big.expand(N).clone()           # energy at the last accepted
    cost_last = torch.full((N,), float("inf"), dtype=dtype, device=device)
    dU = source.new_zeros((N, m, 6))
    dF = source.new_zeros((N, m, 6))
    hist_n = torch.zeros((N,), dtype=torch.int32, device=device)
    converged = torch.zeros((N,), dtype=torch.bool, device=device)
    num_iters = source.new_zeros((N,))
    match_ratio = source.new_zeros((N,))
    w_last = torch.zeros_like(weight)
    slots = torch.arange(m, device=device)[None, :]
    num_start = torch.sum(weight > cfg.match_ratio_thresh, dim=-1).to(dtype)
    num_start = torch.where(num_start == 0, torch.ones_like(num_start), num_start)

    it = 0
    while it < cfg.max_iterations and not bool(torch.all(converged)):
        C, r = _decode(u)
        # one plain GN evaluation at u: its cost is the energy AT u, its
        # output the fixed-point map image g(u)
        C1, r1, delta6, w, cost = _gn_step(cfg, source, target, weight, C, r, corr_fn)
        g = _encode(C1, r1)
        f = g - u

        # safeguard: an AA extrapolation must not raise the energy;
        # convergence is judged on accepted plain-GN steps only
        accepted = cost <= cost_acc
        below = accepted & (torch.linalg.vector_norm(delta6, dim=-1) < cfg.tolerance)
        was_converged = converged
        converged = converged | below
        num_iters = torch.where(below & (num_iters == 0),
                                torch.full_like(num_iters, float(it + 1)), num_iters)
        num_curr = torch.sum(w > cfg.match_ratio_thresh, dim=-1).to(dtype)
        match_ratio = torch.where(below & (match_ratio == 0), num_curr / num_start,
                                  match_ratio)

        # history update (accepted elements only)
        first = hist_n == 0
        push = (accepted & ~first)[:, None, None]
        dU = torch.where(push, torch.cat([dU[:, 1:], (u - u_acc)[:, None]], dim=1), dU)
        dF = torch.where(push, torch.cat([dF[:, 1:], (f - f_acc)[:, None]], dim=1), dF)
        hist_n = torch.where(accepted, torch.clamp(hist_n + 1, max=m + 1), hist_n)
        k = torch.clamp(hist_n - 1, max=m)
        valid = (slots >= (m - k[:, None])).to(dtype)

        # next iterate: AA-mixed where accepted, the plain fallback where not;
        # newly converged elements take the converging plain step (as the
        # plain driver applies it before freezing); converged ones stay put
        acc = accepted[:, None]
        u_next = torch.where(acc, g - _aa_mix(dU, dF, f, valid, eps_rel, cap), g_safe)
        u_next = torch.where(below[:, None], g, u_next)
        u_next = torch.where(was_converged[:, None], u, u_next)

        # rejected elements take the plain step and accept it unconditionally
        # next time (cost_acc = max)
        g_safe = torch.where(acc, g, g_safe)
        u_acc = torch.where(acc, u, u_acc)
        f_acc = torch.where(acc, f, f_acc)
        cost_acc = torch.where(accepted, cost, big)
        hist_n = torch.where(accepted, hist_n, torch.zeros_like(hist_n))
        # the energy actually evaluated, never the rejection sentinel
        cost_last = torch.where(was_converged, cost_last, cost)
        w_last = torch.where(acc, w, w_last)
        u = u_next
        it += 1

    C, r = _decode(u)
    num_iters = torch.where(num_iters == 0, torch.full_like(num_iters, float(it)), num_iters)
    num_curr = torch.sum(w_last > cfg.match_ratio_thresh, dim=-1).to(dtype)
    match_ratio = torch.where(match_ratio == 0, num_curr / num_start, match_ratio)
    P = weight.shape[-1]
    return ICPResult(
        pc=torch.einsum("nij,npj->npi", C, source[..., :3]) + r[:, None, :],
        T=se3._homogeneous(C, r),
        costs=cost_last[:, None, None],
        deltas=source.new_zeros((N, 1, 6, 1)),
        weights=w_last.reshape(N, 1, P, 1),
        converged=converged,
        iterations=num_iters,
        matched_ratio=match_ratio,
    )
