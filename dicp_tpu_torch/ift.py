"""Implicit-function-theorem gradients through the ICP fixed point: the
counterpart of ``dicp_tpu/ift.py``.

At a converged fixed point the solution satisfies the stationarity condition

    G(theta*, x) = J(theta*)^T W(theta*) e(theta*) = 0,

so d theta*/dx = -(dG/d theta)^-1 dG/dx.  The backward pass is one k x k
solve (k = 6, or 3 for dim 2) and one VJP of G, whatever the iteration
count, and the forward is one early-exit solve that nothing differentiates
through: the port's loop, the whole-solve kernel K4 (``fused_small=True``
with histories off, f32, small pairs) or the Anderson driver
(``anderson_m > 0``).  The backward is plain PyTorch (``torch.func``), as
the JAX package's is plain XLA.

Semantics match the solver's differentiable mode: correspondences are the
hard-NN indices at the fixed point, computed by the forward's own
correspondence closure (:func:`registration._make_index_fn`, so each tier,
with its kernel on the card, gives the same indices); robust and trim
weights take their smooth forms; dG/d theta is the exact Jacobian of G by
forward-mode AD, not the Gauss-Newton approximation.  If an element did not
converge the stationarity does not hold and its gradient is approximate
(check ``converged``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import jvp, vjp, vmap

from dicp_tpu_torch import knn, losses, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.jit import jit
from dicp_tpu_torch.registration import (ICPResult, _chunked_over_batch, _damping,
                                         _make_index_fn, _preprocess, _zmask, register)


def _solver_weight(w):
    """The effective IRLS weight the solver applies: (sqrt(w + 1e-10) - 1e-5)^2."""
    s = torch.sqrt(w + 1.0e-10) - 1.0e-5
    return s * s


def _retract(cfg: ICPConfig, xi, C_star, r_star):
    """(C, r) at theta* [+] xi: the dim-2 3-vector embedded into slots 2:5,
    then the solver's retraction C <- exp(omega^)^T C, r <- r - rho.  Shared
    by the cotangent pose map and the stationarity."""
    if cfg.dim == 2:
        zeros = xi.new_zeros((xi.shape[0], 1))
        xi = torch.cat([zeros, zeros, xi, zeros], dim=-1)
    C = se3.exp_so3(xi[:, :3]).transpose(-1, -2) @ C_star
    return C, r_star - xi[:, 3:]


def _pose_from_xi(cfg: ICPConfig, xi, C_star, r_star):
    """T(theta* [+] xi) as (N, 4, 4)."""
    return se3._homogeneous(*_retract(cfg, xi, C_star, r_star))


def _stationarity_weighted(cfg: ICPConfig, xi, C_star, r_star, source, target, idx,
                           w_prior):
    """G = J^T W e with the prior weight folded in (w = w_prior * trim * loss).
    ``source`` is (N, n, 3), or (N, n, 6) for symmetric ICP."""
    N, n = source.shape[0], source.shape[1]
    C, r = _retract(cfg, xi, C_star, r_star)
    cp = torch.einsum("nij,npj->npi", C, source[..., :3])
    nn6 = knn.gather_rows(target, idx)
    nn_err = cp + r[:, None, :] - nn6[..., :3]
    ones = source.new_ones((N, n))

    if cfg.trim_dist is not None:
        trim_w = losses.trim_weight(nn_err, cfg.trim_dist, True, cfg.tanh_steepness)
    else:
        trim_w = ones
    if cfg.icp_type in ("pt2pl", "symmetric"):
        if cfg.icp_type == "symmetric":
            cnp = torch.einsum("nij,npj->npi", C, source[..., 3:6])
            nrm = nn6[..., 3:6] + cnp
        else:
            nrm = nn6[..., 3:6]
        res = torch.sum(nn_err * nrm, dim=-1)
        loss_w = ones if cfg.loss_name is None else losses.robust_weight(
            cfg.loss_name, res[..., None], cfg.loss_metric, True, cfg.tanh_steepness)
        w = _solver_weight(w_prior * trim_w * loss_w)
        J_C = torch.linalg.cross(nrm, cp, dim=-1)
        if cfg.icp_type == "symmetric":
            J_C = J_C + torch.linalg.cross(nn_err, cnp, dim=-1)
        J = torch.cat([J_C, -nrm], dim=-1)
        if cfg.dim == 2:
            J = J[..., 2:5]
        return torch.einsum("npk,np->nk", J, w * res)
    loss_w = ones if cfg.loss_name is None else losses.robust_weight(
        cfg.loss_name, nn_err, cfg.loss_metric, True, cfg.tanh_steepness)
    w = _solver_weight(w_prior * trim_w * loss_w)
    eye = torch.eye(3, dtype=source.dtype, device=source.device).expand(N, n, 3, 3)
    J = torch.cat([se3.skew(cp), -eye], dim=-1)
    if cfg.dim == 2:
        J = J[..., 2:5]
    return torch.einsum("npak,npa->nk", J, w[..., None] * nn_err)


class _FixedPoint(torch.autograd.Function):
    """The full ``ICPResult`` of one early-exit forward solve; only ``T``
    carries a gradient (histories and stats are detached by contract, and
    ``pc`` is recomputed from ``T`` by the caller)."""

    @staticmethod
    def forward(ctx, cfg, source, target, weight, T_init):
        # differentiable=True keeps the smooth weight forms, whose fixed point
        # the backward linearises; 'while' lets K4's gate through; const_iter
        # keeps the fixed iteration count
        driver = "scan" if cfg.const_iter else "while"
        res = register(source, target, T_init, weight,
                       cfg.with_(differentiable=True, driver=driver))
        ctx.cfg = cfg
        ctx.save_for_backward(source, target, weight, T_init, res.T)
        ctx.mark_non_differentiable(*(f for name, f in zip(res._fields, res) if name != "T"))
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        cfg = ctx.cfg
        source, target, weight, T_init, T = ctx.saved_tensors
        T_bar = grads[ICPResult._fields.index("T")]
        if T_bar is None:
            T_bar = torch.zeros_like(T)
        source_bar, target_bar, weight_bar = _adjoint(cfg, source, target, weight, T_init,
                                                      T, T_bar)
        # the fixed point forgets its initialization
        return None, source_bar, target_bar, weight_bar, torch.zeros_like(T_init)


def _adjoint(cfg: ICPConfig, source, target, weight, T_init, T, T_bar):
    """(source, target, weight) cotangents from the cotangent on T."""
    dtype = source.dtype
    N = source.shape[0]
    k = 3 if cfg.dim == 2 else 6
    C_star, r_star = T[:, :3, :3], T[:, :3, 3]
    # the solver's preprocessing; its pt2pt x3 weight expansion is undone,
    # because the stationarity applies per-point weights to 3-vectors.  Not
    # detached: under create_graph the cotangents stay functions of the
    # inputs (and, through T, of _FixedPoint again), as JAX's traced _fp_bwd
    src, tgt, w_prior, C0, r0 = _preprocess(cfg, source, target, T_init, weight)
    if cfg.icp_type == "pt2pt":
        w_prior = w_prior[..., ::3]

    # correspondences at theta*, by the forward's own closure (each tier as
    # the forward called it, certificate gate included).  The JAX backward
    # pins fused=False on the batched cluster branch while its forward runs
    # the fused search; here the forward's call is mirrored, K2 on the card,
    # which is bit-equal to its plain version, whose selection is JAX's.
    with torch.no_grad():
        ps_t = torch.einsum("nij,npj->npi", C_star, src[..., :3]) + r_star[:, None, :]
        idx, valid = _make_index_fn(cfg, src, tgt, C0, r0)(ps_t)
    if valid is not None:
        w_prior = w_prior * valid

    zero_xi = src.new_zeros((N, k))

    def G(xi, s, t, wp):
        return _stationarity_weighted(cfg, xi, C_star, r_star, s, t, idx, wp)

    # dG/dxi is block-diagonal over the batch: k JVPs along the coordinate
    # basis, one per column, give every (k x k) block at once.  vmap runs the
    # k of them as one batched pass: forward-mode AD is bound by per-op host
    # work, not by the device
    basis = torch.eye(k, dtype=dtype, device=src.device)[:, None, :].expand(k, N, k)
    cols = vmap(lambda t: jvp(lambda xi: G(xi, src, tgt, w_prior), (zero_xi,), (t,))[1])(basis)
    A = cols.permute(1, 2, 0)  # A[n, i, j] = dG_i / dxi_j
    # damped like the solver: on gauge-degenerate problems dG/dxi is singular
    A = A + _damping(cfg, A, use_abs=True) * torch.eye(k, dtype=dtype, device=src.device)

    # cotangent on xi through the retraction, then A^T lambda = xi_bar
    _, pose_vjp = vjp(lambda xi: _pose_from_xi(cfg, xi, C_star, r_star), zero_xi)
    xi_bar = pose_vjp(T_bar.to(dtype))[0]
    # solve_ex: solve's LU without its host check of ``info`` (capturable)
    lam = torch.linalg.solve_ex(A.transpose(-1, -2), xi_bar[..., None],
                                check_errors=False)[0][..., 0]

    _, g_vjp = vjp(lambda s, t, wp: G(zero_xi, s, t, wp), src, tgt, w_prior)
    src_bar, tgt_bar, wp_bar = g_vjp(-lam)

    # transposes of the preprocessing's linear maps: the dim-2 z mask, the
    # column slices and the zero-pad rule on the weight
    if cfg.dim == 2:
        src_bar = src_bar * _zmask(src.shape[-1], dtype, src.device)
        tgt_bar = tgt_bar * _zmask(tgt.shape[-1], dtype, tgt.device)
    source_bar = torch.zeros_like(source)
    source_bar[..., :src.shape[-1]] = src_bar.to(source.dtype)
    target_bar = torch.zeros_like(target)
    target_bar[..., :tgt.shape[-1]] = tgt_bar.to(target.dtype)
    weight_bar = None
    if weight is not None:
        weight_bar = wp_bar
        if cfg.source_zeroes_are_pad:
            nonzero = torch.linalg.vector_norm(src[..., :3], dim=-1) != 0.0
            weight_bar = weight_bar * nonzero.to(dtype)
        weight_bar = weight_bar.to(weight.dtype)
    return source_bar, target_bar, weight_bar


def register_ift(source: torch.Tensor, target: torch.Tensor, T_init: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """ICP with implicit (fixed-point) gradients.

    Forward: one early-exit solve.  Backward: one k x k solve, O(1) in the
    iteration count.  Requires hard NN and convergence for exactness;
    histories and stats come from the forward, detached."""
    if cfg.use_gumbel:
        raise ValueError("IFT gradients require hard (deterministic) NN")
    if cfg.batch_chunk is not None and source.shape[0] > cfg.batch_chunk:
        sub = cfg.with_(batch_chunk=None)
        return _chunked_over_batch(lambda s, t, ti, w, _: register_ift(s, t, ti, w, sub),
                                   cfg.batch_chunk, source, target, T_init, weight)
    res = ICPResult(*_FixedPoint.apply(cfg, source, target, weight, T_init))
    # pc recomputed differentiably from T and the (z-masked) source
    src = source[..., :3]
    if cfg.dim == 2:
        src = src * _zmask(3, source.dtype, source.device)
    pc = torch.einsum("nij,npj->npi", res.T[:, :3, :3], src.to(res.T.dtype)) \
        + res.T[:, None, :3, 3]
    return res._replace(pc=pc)


# The JAX package's ``register_ift_jit`` is ``jax.jit(register_ift)``.  The
# port's captures the forward as a CUDA graph on the card (its loop a WHILE
# node; see dicp_tpu_torch.jit); with inputs that require grad it is a
# program pair, whose captured backward (the adjoint solve) .backward()
# replays; on the CPU it is register_ift itself.  A forward and backward
# captured into one program: jit over a function that calls
# torch.autograd.grad (dicp_tpu_torch.bench.fwdbwd_jit).  A Gumbel config
# raises in the first call's eager run, as register_ift does.
register_ift_jit = jit(register_ift, static_argnames=("cfg",), name="register_ift_jit")
