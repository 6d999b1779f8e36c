"""Anderson-accelerated ICP, the counterpart of ``dicp_tpu/anderson.py``.

The Gauss-Newton update is a fixed-point map on SE(3); type-II Anderson
mixing over the last ``m`` iterates, in [log C | r] coordinates, with the
energy safeguard of AA-ICP (arXiv:1709.05479) and Fast-and-Robust-ICP
(arXiv:2007.07627): an accelerated iterate whose ICP energy exceeds the last
accepted one is discarded for the plain GN step, so the worst case is
ordinary ICP with one wasted evaluation per rejection.  Batch elements
accelerate, reject and converge independently (batch == serial).

The JAX ``lax.while_loop`` is a body over a state held in tensors, run by
:func:`jit.device_while` over the same :func:`registration._gn_step` and
correspondence closure, so every tier, with its kernels on the card, serves
it.  The body is exact under masking (``where(flag, new, old)`` on every
field), so the loop is a CUDA graph WHILE node wherever the solve is
captured (:data:`register_anderson_jit`, ``register_jit``, ``ICP.icp``,
``register_ift_jit``) and a host loop that reads the flag once per
iteration otherwise.  It runs without autograd, as JAX's while loop admits
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
from dicp_tpu_torch.jit import device_while, jit
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
    # solve_ex: solve's LU without its host check of ``info``
    gamma = torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0] * valid
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


# The JAX package's ``register_anderson_jit`` is ``jax.jit(register_anderson)``:
# on the card the port's is a captured CUDA graph whose loop is a WHILE node
# (see dicp_tpu_torch.jit); on the CPU it is register_anderson itself.
register_anderson_jit = jit(register_anderson, static_argnames=("cfg", "m", "eps_rel", "cap"),
                            name="register_anderson_jit")


@torch.no_grad()
def _anderson_impl(source, target, T_init, weight, cfg, m, eps_rel, cap):
    source, target, weight, C0, r0 = _preprocess(cfg, source, target, T_init, weight)
    corr_fn = _make_corr_fn(cfg, source, target, C0, r0)
    dtype, device = source.dtype, source.device
    N, T = source.shape[0], cfg.max_iterations
    big = torch.finfo(dtype).max

    u0 = _encode(C0, r0)
    # every field owns its storage: the body overwrites them in place
    s = dict(
        u=u0.clone(),
        g_safe=u0.clone(),                     # plain-GN fallback iterate
        u_acc=u0.clone(),                      # last accepted iterate
        f_acc=source.new_zeros((N, 6)),        # residual at the last accepted
        cost_acc=torch.full((N,), big, dtype=dtype, device=device),  # its energy
        cost_last=torch.full((N,), float("inf"), dtype=dtype, device=device),
        dU=source.new_zeros((N, m, 6)),
        dF=source.new_zeros((N, m, 6)),
        hist_n=torch.zeros((N,), dtype=torch.int32, device=device),
        converged=torch.zeros((N,), dtype=torch.bool, device=device),
        num_iters=source.new_zeros((N,)),
        match_ratio=source.new_zeros((N,)),
        w_last=torch.zeros_like(weight),
    )
    it = torch.zeros((), dtype=torch.int32, device=device)
    flag = (it < T) & ~torch.all(s["converged"])
    slots = torch.arange(m, device=device)[None, :]
    num_start = torch.sum(weight > cfg.match_ratio_thresh, dim=-1).to(dtype)
    num_start = torch.where(num_start == 0, torch.ones_like(num_start), num_start)

    def body():
        u = s["u"]
        C, r = _decode(u)
        # one plain GN evaluation at u: its cost is the energy AT u, its
        # output the fixed-point map image g(u)
        C1, r1, delta6, w, cost = _gn_step(cfg, source, target, weight, C, r, corr_fn)
        g = _encode(C1, r1)
        f = g - u

        # safeguard: an AA extrapolation must not raise the energy;
        # convergence is judged on accepted plain-GN steps only
        accepted = cost <= s["cost_acc"]
        below = accepted & (torch.linalg.vector_norm(delta6, dim=-1) < cfg.tolerance)
        was_converged = s["converged"]
        num_iters = torch.where(below & (s["num_iters"] == 0), (it + 1).to(dtype),
                                s["num_iters"])
        num_curr = torch.sum(w > cfg.match_ratio_thresh, dim=-1).to(dtype)
        match_ratio = torch.where(below & (s["match_ratio"] == 0), num_curr / num_start,
                                  s["match_ratio"])

        # history update (accepted elements only)
        first = s["hist_n"] == 0
        push = (accepted & ~first)[:, None, None]
        dU = torch.where(push, torch.cat([s["dU"][:, 1:], (u - s["u_acc"])[:, None]], dim=1),
                         s["dU"])
        dF = torch.where(push, torch.cat([s["dF"][:, 1:], (f - s["f_acc"])[:, None]], dim=1),
                         s["dF"])
        hist_n = torch.where(accepted, torch.clamp(s["hist_n"] + 1, max=m + 1), s["hist_n"])
        k = torch.clamp(hist_n - 1, max=m)
        valid = (slots >= (m - k[:, None])).to(dtype)

        # next iterate: AA-mixed where accepted, the plain fallback where not;
        # newly converged elements take the converging plain step (as the
        # plain driver applies it before freezing); converged ones stay put
        acc = accepted[:, None]
        u_next = torch.where(acc, g - _aa_mix(dU, dF, f, valid, eps_rel, cap), s["g_safe"])
        u_next = torch.where(below[:, None], g, u_next)
        u_next = torch.where(was_converged[:, None], u, u_next)

        # rejected elements take the plain step and accept it unconditionally
        # next time (cost_acc = max)
        new = dict(
            u=u_next,
            g_safe=torch.where(acc, g, s["g_safe"]),
            u_acc=torch.where(acc, u, s["u_acc"]),
            f_acc=torch.where(acc, f, s["f_acc"]),
            cost_acc=torch.where(accepted, cost, big),
            # the energy actually evaluated, never the rejection sentinel
            cost_last=torch.where(was_converged, s["cost_last"], cost),
            dU=dU, dF=dF,
            hist_n=torch.where(accepted, hist_n, torch.zeros_like(hist_n)),
            converged=was_converged | below,
            num_iters=num_iters, match_ratio=match_ratio,
            w_last=torch.where(acc, w, s["w_last"]),
        )
        # masked: a body run after the flag fell changes no bit
        for name, val in new.items():
            s[name].copy_(torch.where(flag, val, s[name]))
        it.copy_(torch.where(flag, it + 1, it))
        flag.copy_((it < T) & ~torch.all(s["converged"]))

    # autograd records nothing here (no_grad, as JAX's lax.while_loop refuses
    # jax.grad): captured or not, the body's in-place state is exact, and the
    # results carry no gradient either way
    device_while(flag, body)

    C, r = _decode(s["u"])
    num_iters = torch.where(s["num_iters"] == 0, it.to(dtype), s["num_iters"])
    num_curr = torch.sum(s["w_last"] > cfg.match_ratio_thresh, dim=-1).to(dtype)
    match_ratio = torch.where(s["match_ratio"] == 0, num_curr / num_start, s["match_ratio"])
    P = weight.shape[-1]
    return ICPResult(
        pc=torch.einsum("nij,npj->npi", C, source[..., :3]) + r[:, None, :],
        T=se3._homogeneous(C, r),
        costs=s["cost_last"][:, None, None],
        deltas=source.new_zeros((N, 1, 6, 1)),
        weights=s["w_last"].reshape(N, 1, P, 1),
        converged=s["converged"],
        iterations=num_iters,
        matched_ratio=match_ratio,
    )
