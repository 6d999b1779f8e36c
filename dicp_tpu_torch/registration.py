"""Functional core: batched differentiable Gauss-Newton ICP in PyTorch, the
counterpart of ``dicp_tpu/registration.py``.

The JAX core is one jitted program with two drivers: a ``lax.scan`` with a
converged-skip branch (differentiable) and a ``lax.while_loop`` with early
exit (inference), because reverse-mode AD cannot cross a while loop.  Eager
PyTorch has no such limit, so one Python loop with early exit serves both
``driver`` values.  It produces the same results as either JAX driver: once
every batch element has converged, the scan's skip branch only re-emits the
carry-forward history values, which the loop writes after it exits, and the
two drivers' iteration counts agree.  The loop checks convergence on the host
once per iteration (one device sync).

Per-element convergence freezing (zeroing the weights of converged batch
elements so that batch results equal serial results), the all-zero-weight
carry-forward of histories and the reference's stop-gradient boundaries
(histories and stats detached; only ``pc`` and ``T`` carry gradient) are
reproduced as in the JAX core.

``_register_impl`` routes as JAX does: ``anderson_m > 0`` to the Anderson
driver (:mod:`dicp_tpu_torch.anderson`); else, where
:func:`ops.fused_gn.fused_eligible` allows, to the whole-solve kernel K4;
else to the loop.

Gumbel soft NN (``differentiable`` and ``use_gumbel``) takes its noise from
the source ``register`` is given as ``key`` (:func:`knn.gumbel_noise`), with
one stream per GLOBAL batch element and iteration, as JAX derives its keys:
a ``batch_chunk`` solve equals the unchunked one, and the first rows of a
batch equal a smaller batch, bit for bit.  No hard-NN closure is built then.

Shapes (ragged and unbatched inputs are handled in :mod:`dicp_tpu_torch.api`):
  source  (N, n, 3|6)   target (N, m, 3|6)   T_init (N, 4, 4)
  weight  (N, n) or None
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed
from torch.utils.checkpoint import checkpoint

from dicp_tpu_torch import knn, losses, se3
from dicp_tpu_torch.config import ICPConfig
from dicp_tpu_torch.ops import tiled_knn
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn, query_order
from dicp_tpu_torch.ops.fused_gn import fused_eligible, fused_gn_solve
from dicp_tpu_torch.ops.smallsolve import solve_spd


class ICPResult(NamedTuple):
    """Result tuple; fields mirror the reference's results dict.  Histories
    have length ``max_iterations``; entries past the executed count repeat
    the last value (weights/costs) or are zero (deltas): use
    :func:`slice_histories`.  With ``collect_histories=False`` they are
    length-1 placeholders holding the final values (weights/costs) or zeros
    (deltas)."""

    pc: torch.Tensor             # (N, n, 3) transformed source
    T: torch.Tensor              # (N, 4, 4)
    costs: torch.Tensor          # (N, T, 1)
    deltas: torch.Tensor         # (N, T, 6, 1)
    weights: torch.Tensor        # (N, T, P, 1); P = n (pt2pl) or 3n (pt2pt)
    converged: torch.Tensor      # (N,) bool
    iterations: torch.Tensor     # (N,) float
    matched_ratio: torch.Tensor  # (N,) float


def _damping(cfg: ICPConfig, A: torch.Tensor, use_abs: bool = False) -> torch.Tensor:
    """Tikhonov damping for the normal equations A (N, k, k).

    ``cfg.tikhonov`` set -> absolute.  None -> relative to the largest
    diagonal entry (1e-12 in f64, 1e-6 in f32): scan pairs give diagonals
    from ~1e6 (rotation) down to <1 (weak translation), where any absolute
    value is too small for f32 stability and too large for the weak block.
    Damping never moves the fixed point.  ``use_abs``: take the largest
    |diagonal| (the IFT adjoint's dG/dxi need not have a positive one)."""
    if cfg.tikhonov is not None:
        return torch.tensor(cfg.tikhonov, dtype=A.dtype, device=A.device)
    rel = 1e-12 if A.dtype == torch.float64 else 1e-6
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    dmax = torch.amax(torch.abs(diag) if use_abs else diag, dim=-1)
    return (rel * torch.clamp(dmax, min=1.0))[..., None, None]


def _preprocess(cfg: ICPConfig, source, target, T_init, weight):
    """Input normalization done once before the loop; everything takes the
    source's dtype."""
    target = target.to(source.dtype)
    if cfg.icp_type == "symmetric":
        # residual along the SUM of both clouds' normals -> normals on both
        if source.shape[-1] < 6 or target.shape[-1] != 6:
            raise ValueError("symmetric ICP requires normals on BOTH clouds: "
                             "source (N, n, 6), target (N, m, 6)")
        source = source[..., :6]
    else:
        source = source[..., :3]
    if cfg.icp_type == "pt2pl":
        if target.shape[-1] != 6:
            raise ValueError("pt2pl requires target normals: (N, m, 6)")
    elif cfg.icp_type == "pt2pt":
        target = target[..., :3]

    if cfg.dim == 2:
        # zero z so it cannot influence NN or residuals; pt2pl keeps the
        # in-plane normal components
        zmask = torch.tensor([1.0, 1.0, 0.0], dtype=source.dtype, device=source.device)
        zmask6 = torch.cat([zmask, zmask])
        source = source * (zmask6 if source.shape[-1] == 6 else zmask)
        target = target * (zmask6 if target.shape[-1] == 6 else zmask)

    if weight is None:
        weight = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    weight = weight.to(source.dtype)
    T_init = T_init.to(source.dtype)
    if cfg.source_zeroes_are_pad:
        # all-zero source rows are padding -> weight 0
        nonzero = torch.linalg.vector_norm(source[..., :3], dim=-1) != 0.0
        weight = weight * nonzero.to(source.dtype)
    if cfg.icp_type == "pt2pt":
        # one weight per error component
        weight = torch.repeat_interleave(weight, 3, dim=-1)

    return source, target, weight, T_init[..., :3, :3], T_init[..., :3, 3]


def _certified_gate(cert: torch.Tensor, dtype, group=None) -> torch.Tensor:
    """Per-point validity weight from the cluster certificate.

    Uncertified correspondences (the neighbour is not provably the global
    argmin) are left out of the normal equations: near-correct but not exact,
    they bias the fixed point (measured on the TPU: 2.8e-3 transform error on
    a 100k surface scene against 2e-7 masked).  If certification collapses
    below half the points (pathological geometry) everything is kept: a
    biased estimate beats a degenerate one.

    ``group``: the process group of a map-sharded solve, whose ranks each
    hold an equal share of the cloud; the fraction is then the GLOBAL one
    (one scalar all-reduce), so every rank gates alike."""
    w = cert.to(dtype)
    if group is None:
        frac = torch.mean(w, dim=-1, keepdim=True)
    else:
        from dicp_tpu_torch.parallel._comm import psum

        total = psum(torch.sum(w, dim=-1, keepdim=True), group)
        frac = total / (w.shape[-1] * torch.distributed.get_world_size(group))
    return torch.where(frac >= 0.5, w, torch.ones_like(w))


def _make_corr_fn(cfg: ICPConfig, source, target, C0, r0):
    """Correspondence closure built once per solve: ``corr(ps_t)`` returns
    (the gathered target rows (normals ride along) for the current source
    points ``ps_t`` (N, n, 3), a per-point validity weight or None).
    Gradients keep hard-NN semantics: the indices of :func:`_make_index_fn`
    carry none, and gradient reaches the target only through
    :func:`knn.gather_rows`."""
    index_fn = _make_index_fn(cfg, source, target, C0, r0)

    def corr(ps_t):
        idx, valid = index_fn(ps_t)
        return knn.gather_rows(target, idx), valid

    return corr


def _make_index_fn(cfg: ICPConfig, source, target, C0, r0):
    """Index closure built once per solve: ``index_fn(ps_t)`` returns (the
    nearest target row (N, n) int32 of each current source point ``ps_t``
    (N, n, 3), a per-point validity weight or None), computed without
    gradient.  The IFT backward calls it at the fixed point, so its
    linearised problem is the one the forward solved.

    The cluster tier builds its index once here (the target is constant over
    the iterations) and returns the certificate gate as the validity weight.
    Its two branches must stay apart, because the query order decides the
    blocks and with them the selected groups: one target cloud
    (``target.shape[0] == 1``) curve-sorts the queries once, at ``T_init``
    (rigid motion keeps neighbourhoods, so the order stays a good locality
    hint); a batch re-sorts them on every call."""
    n, m = source.shape[-2], target.shape[-2]
    method = cfg.resolved_nn_method(n, m, source.device)
    if method == "cluster":
        return _cluster_index_fn(cfg, source, target, C0, r0)
    pts = target[..., :3].detach()

    def index_fn(ps_t):
        with torch.no_grad():
            if method == "pallas":
                return tiled_knn.nn_indices(ps_t.detach(), pts), None
            return knn.nn_indices(ps_t, pts), None

    return index_fn


def _cluster_index_fn(cfg: ICPConfig, source, target, C0, r0):
    n = source.shape[-2]
    dtype = source.dtype
    fixup = cfg.resolved_cluster_fixup(n)
    with torch.no_grad():
        if target.shape[0] == 1:
            index = build_cluster_index(target[0, :, :3], cfg.cluster_group)
            ps0 = torch.einsum("ij,pj->pi", C0[0], source[0, :, :3]) + r0[0][None, :]
            qord = query_order(index, ps0.detach())

            def index_fn(ps_t):
                idx, _, cert = cluster_nn(index, ps_t[0], probes=cfg.cluster_probes,
                                          order=qord, fixup=fixup)
                return idx[None], _certified_gate(cert[None], dtype)

            return index_fn

        index = build_cluster_index(target[..., :3], cfg.cluster_group)

    def index_fn(ps_t):
        # fused=None: K2 on CUDA queries, the group scan on the CPU
        idx, _, cert = cluster_nn(index, ps_t, probes=cfg.cluster_probes,
                                  use_pallas=False, fixup=fixup)
        return idx, _certified_gate(cert, dtype)

    return index_fn


def _normal_equations(J_w, res_w, chunk: int = 4096):
    """A = J_w^T J_w (N, k, k) and b = J_w^T res_w (N, k), accumulated in two
    levels: within chunks of ``chunk`` rows, then across chunks.

    One flat sum over P ~ 3e5 rows put ~1e-4 of f32 rounding noise into the
    Gauss-Newton step, and the solve oscillated at that floor (measured on the
    TPU with exact correspondences); chunked sums bound it ~O(sqrt)."""
    N, P, k = J_w.shape
    if P <= chunk:
        return (torch.einsum("npi,npj->nij", J_w, J_w),
                torch.einsum("npi,np->ni", J_w, res_w))
    nc = -(-P // chunk)
    pad = nc * chunk - P
    if pad:
        J_w = torch.cat([J_w, J_w.new_zeros((N, pad, k))], dim=1)
        res_w = torch.cat([res_w, res_w.new_zeros((N, pad))], dim=1)
    Jc = J_w.reshape(N, nc, chunk, k)
    rc = res_w.reshape(N, nc, chunk)
    A = torch.sum(torch.einsum("ncpi,ncpj->ncij", Jc, Jc), dim=1)
    b = torch.sum(torch.einsum("ncpi,ncp->nci", Jc, rc), dim=1)
    return A, b


def _gn_step(cfg: ICPConfig, source, target, w_init, C, r, corr_fn, noise=None,
             pair_ids=None, it=None):
    """One Gauss-Newton iteration; returns (C_new, r_new, delta6 (N, 6),
    w (N, P), cost (N,)).  With Gumbel NN the correspondences are soft, drawn
    from ``noise`` on the streams of ``pair_ids`` at iteration ``it``."""
    dtype, device = source.dtype, source.device
    N, n = source.shape[0], source.shape[1]

    cp = torch.einsum("nij,npj->npi", C, source[..., :3])  # rotated source
    ps_t = cp + r[:, None, :]
    if cfg.differentiable and cfg.use_gumbel:
        nn6 = knn.gumbel_nn(ps_t, target, noise, tau=cfg.gumbel_tau, eps=cfg.gumbel_eps,
                            pair_ids=pair_ids, iteration=it)
        valid = None
    else:
        nn6, valid = corr_fn(ps_t)
    nn_err = ps_t - nn6[..., :3]                           # (N, n, 3)

    if cfg.icp_type == "pt2pl":
        nn_norm = nn6[..., 3:6]
        err = torch.sum(nn_err * nn_norm, dim=-1)          # (N, n)
        loss_err = err[..., None]
    elif cfg.icp_type == "symmetric":
        # residual along n_q + C n_p
        cnp = torch.einsum("nij,npj->npi", C, source[..., 3:6])
        nn_norm = nn6[..., 3:6] + cnp
        err = torch.sum(nn_err * nn_norm, dim=-1)
        loss_err = err[..., None]
    else:
        loss_err = nn_err                                  # 3 components per point

    # robust weights: trim gate on the 3-D point error, loss on the residual;
    # a negative trim_dist zeroes (hard) or nearly zeroes (soft) every weight
    if cfg.trim_dist is not None:
        trim_w = losses.trim_weight(nn_err, cfg.trim_dist, cfg.differentiable,
                                    cfg.tanh_steepness)
    else:
        trim_w = torch.ones((N, n), dtype=dtype, device=device)
    if valid is not None:
        # cluster certificate gate: only provably exact (or brute-forced)
        # correspondences enter the normal equations
        trim_w = trim_w * valid
    if cfg.loss_name is not None:
        loss_w = losses.robust_weight(cfg.loss_name, loss_err, cfg.loss_metric,
                                      cfg.differentiable, cfg.tanh_steepness)
    else:
        loss_w = torch.ones((N, n), dtype=dtype, device=device)

    # residual and Jacobian of err with respect to xi = [omega, rho]
    if cfg.icp_type == "pt2pl":
        J_C = torch.linalg.cross(nn_norm, cp, dim=-1)      # n x (Cp)
        J = torch.cat([J_C, -nn_norm], dim=-1)             # (N, n, 6)
        res = err
        w = w_init * trim_w * loss_w
    elif cfg.icp_type == "symmetric":
        J_C = torch.linalg.cross(nn_norm, cp, dim=-1) + torch.linalg.cross(nn_err, cnp, dim=-1)
        J = torch.cat([J_C, -nn_norm], dim=-1)
        res = err
        w = w_init * trim_w * loss_w
    else:
        J_C = se3.skew(cp).reshape(N, 3 * n, 3)
        eye = torch.eye(3, dtype=dtype, device=device).expand(N, n, 3, 3).reshape(N, 3 * n, 3)
        J = torch.cat([J_C, -eye], dim=-1)                 # (N, 3n, 6)
        res = nn_err.reshape(N, 3 * n)                     # component-interleaved
        w = (w_init * torch.repeat_interleave(trim_w, 3, dim=-1)
             * torch.repeat_interleave(loss_w, 3, dim=-1))

    if cfg.dim == 2:
        J = J[..., 2:5]                                    # (omega_z, rho_x, rho_y)

    k = J.shape[-1]
    # row scaling instead of a diagonal weight matrix; the +-1e-5 pair keeps
    # sqrt away from 0, whose gradient is NaN
    w_sqrt = torch.sqrt(w + 1.0e-10) - 1.0e-5
    res_w = w_sqrt * res                                   # (N, P)
    J_w = w_sqrt[..., None] * J                            # (N, P, k)

    A, b = _normal_equations(J_w, res_w)
    A = A + _damping(cfg, A) * torch.eye(k, dtype=dtype, device=device)
    if cfg.solve_method == "closed":
        delta_k = -solve_spd(A, b)
    else:
        delta_k = -torch.linalg.solve(A, b[..., None])[..., 0]

    if cfg.dim == 2:
        zeros = torch.zeros((N, 1), dtype=dtype, device=device)
        delta6 = torch.cat([zeros, zeros, delta_k, zeros], dim=-1)
    else:
        delta6 = delta_k

    # retraction: C <- exp(omega^)^T C, r <- r - rho
    C_new = se3.exp_so3(delta6[:, :3]).transpose(-1, -2) @ C
    r_new = r - delta6[:, 3:]
    cost = torch.sum(res_w * res_w, dim=-1)
    return C_new, r_new, delta6, w, cost


class _Carry(NamedTuple):
    C: torch.Tensor
    r: torch.Tensor
    w_init: torch.Tensor       # freezing state (zeroed on convergence)
    converged: torch.Tensor    # (N,) bool
    num_iters: torch.Tensor    # (N,) float, 0 = not yet converged
    match_ratio: torch.Tensor  # (N,) float, 0 = not yet converged
    prev_w_save: torch.Tensor  # carry-forward weight history value
    prev_cost: torch.Tensor    # carry-forward cost history value
    w_raw: torch.Tensor        # raw w of the last executed iteration


def _apply_step(cfg: ICPConfig, source, target, carry: _Carry, it: int, corr_fn,
                noise=None, pair_ids=None):
    """One iteration plus bookkeeping; returns (carry', (delta, w_save, cost))."""
    dtype = source.dtype
    C, r, delta6, w, cost = _gn_step(cfg, source, target, carry.w_init,
                                     carry.C, carry.r, corr_fn, noise, pair_ids, it)

    # histories are detached; all-zero weights carry the previous values
    # forward, keyed on the mask and not on the cost being exactly 0.0
    delta_out = delta6.detach()
    w_save = w.detach()
    all_zero = (torch.sum(w_save, dim=-1) == 0.0)[:, None]
    w_save = torch.where(all_zero, carry.prev_w_save, w_save)
    cost_out = cost.detach()
    cost_out = torch.where((cost_out == 0.0) | all_zero[:, 0], carry.prev_cost, cost_out)

    below = torch.linalg.vector_norm(delta_out, dim=-1) < cfg.tolerance
    converged = carry.converged | below

    w_init, num_iters, match_ratio = carry.w_init, carry.num_iters, carry.match_ratio
    if not cfg.const_iter:
        # first-crossing stats, then freeze converged elements (batch == serial)
        num_iters = torch.where(below, num_iters + float(it + 1) * (num_iters == 0),
                                num_iters)
        num_curr = torch.sum(w > cfg.match_ratio_thresh, dim=-1).to(dtype)
        num_start = torch.sum(w_init > cfg.match_ratio_thresh, dim=-1).to(dtype)
        num_start = torch.where(num_start == 0, torch.ones_like(num_start), num_start)
        ratio = num_curr / num_start
        match_ratio = torch.where(below, match_ratio + ratio * (match_ratio == 0),
                                  match_ratio)
        w_init = w_init * torch.where(below, 0.0, 1.0).to(dtype)[:, None]

    new_carry = _Carry(C, r, w_init, converged, num_iters, match_ratio,
                       w_save, cost_out, w.detach())
    return new_carry, (delta_out, w_save, cost_out)


def _init_carry(source, weight, C, r) -> _Carry:
    N = source.shape[0]
    zeros_np = weight.new_zeros(weight.shape)
    zeros_n = source.new_zeros((N,))
    return _Carry(C=C, r=r, w_init=weight,
                  converged=torch.zeros((N,), dtype=torch.bool, device=source.device),
                  num_iters=zeros_n, match_ratio=zeros_n,
                  prev_w_save=zeros_np, prev_cost=zeros_n, w_raw=zeros_np)


def _run_loop(cfg: ICPConfig, source, target, weight, C, r, corr_fn, noise=None,
              pair_ids=None):
    """Early-exit Gauss-Newton loop for both drivers.

    Returns (carry, deltas (T|1, N, 6), weights (T|1, N, P), costs (T|1, N),
    executed iteration count).  Slots past the exit hold what the JAX drivers
    put there: zero deltas, and the last executed weights and costs."""
    T = cfg.max_iterations
    carry = _init_carry(source, weight, C, r)

    def step(carry, it):
        return _apply_step(cfg, source, target, carry, it, corr_fn, noise, pair_ids)

    hist = []
    it = 0
    while it < T and (cfg.const_iter or not bool(torch.all(carry.converged))):
        if cfg.remat:
            carry, out = checkpoint(step, carry, it, use_reentrant=False)
        else:
            carry, out = step(carry, it)
        if cfg.collect_histories:
            hist.append(out)
        it += 1

    if not cfg.collect_histories:
        deltas = source.new_zeros((1, source.shape[0], 6))
        return carry, deltas, carry.prev_w_save[None], carry.prev_cost[None], it

    rest = T - it
    deltas = [h[0] for h in hist] + [source.new_zeros((source.shape[0], 6))] * rest
    weights = [h[1] for h in hist] + [carry.prev_w_save] * rest
    costs = [h[2] for h in hist] + [carry.prev_cost] * rest
    return carry, torch.stack(deltas), torch.stack(weights), torch.stack(costs), it


def _finalize(cfg: ICPConfig, source, carry: _Carry, deltas, weights, costs, it_final):
    """Post-loop stats fill and result assembly."""
    dtype = source.dtype
    num_iters = torch.where(carry.num_iters == 0,
                            torch.full_like(carry.num_iters, float(it_final)),
                            carry.num_iters)
    num_curr = torch.sum(carry.w_raw > cfg.match_ratio_thresh, dim=-1).to(dtype)
    num_start = torch.sum(carry.w_init > cfg.match_ratio_thresh, dim=-1).to(dtype)
    num_start = torch.where(num_start == 0, torch.ones_like(num_start), num_start)
    match_ratio = torch.where(carry.match_ratio == 0, num_curr / num_start,
                              carry.match_ratio)

    pc = torch.einsum("nij,npj->npi", carry.C, source[..., :3]) + carry.r[:, None, :]
    return ICPResult(
        pc=pc,
        T=se3._homogeneous(carry.C, carry.r),
        costs=costs.transpose(0, 1)[..., None],
        deltas=deltas.transpose(0, 1)[..., None],
        weights=weights.transpose(0, 1)[..., None],
        converged=carry.converged,
        iterations=num_iters.detach(),
        matched_ratio=match_ratio.detach(),
    )


def _check_devices(*tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) > 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")


def register(source: torch.Tensor, target: torch.Tensor, T_init: torch.Tensor,
             weight: Optional[torch.Tensor] = None, cfg: ICPConfig = ICPConfig(),
             key=None) -> ICPResult:
    """Batched ICP registration on pre-batched inputs (N, n, 3|6),
    (N, m, 3|6), (N, 4, 4); all on one device.  ``key``: the Gumbel noise
    source (:func:`knn.gumbel_noise`), required with Gumbel NN and ignored
    otherwise."""
    if source.dim() != 3 or target.dim() != 3 or T_init.dim() != 3:
        raise ValueError("register() expects batched (N, n, 3), (N, m, 3|6), (N, 4, 4); "
                         "use dicp_tpu_torch.api.ICP for ragged/unbatched inputs")
    _check_devices(source, target, T_init, weight)
    noise = None
    if cfg.differentiable and cfg.use_gumbel:
        if key is None:
            raise ValueError("Gumbel NN requires an explicit noise source (key)")
        noise = knn.gumbel_noise(key)
    if cfg.batch_chunk is not None and source.shape[0] > cfg.batch_chunk:
        return _chunked_over_batch(
            lambda s, t, ti, w, ids: _register_impl(s, t, ti, w, cfg, noise, ids),
            cfg.batch_chunk, source, target, T_init, weight)
    return _register_impl(source, target, T_init, weight, cfg, noise)


# The JAX package's ``register_jit`` is ``jax.jit(register)``.  PyTorch runs
# eagerly, so the port's is :func:`register` itself: the same signature and
# results, no compilation.
register_jit = register


def _chunked_over_batch(call, chunk: int, source, target, T_init, weight):
    """Apply ``call(source, target, T_init, weight, pair_ids)`` to sequential
    chunks of ``chunk`` batch elements and concatenate the ``ICPResult``s;
    ``pair_ids`` lists the chunk's global batch indices (the Gumbel streams).

    Identical to one big call: batch elements are independent, and every
    chunk's histories have the same fixed length.  As in JAX the batch is
    edge-padded to a whole number of chunks (repeating its last element, and
    its index) and the results are sliced back, so every chunk has
    ``batch_chunk`` elements and takes the same correspondence branch as
    JAX's chunks."""
    N = source.shape[0]
    pad = -(-N // chunk) * chunk - N
    if weight is None:
        weight = source.new_ones(source.shape[:-1])

    def prep(a):
        return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])]) if pad else a

    source, target, T_init, weight = map(prep, (source, target, T_init, weight))
    ids = list(range(N)) + [N - 1] * pad
    parts = []
    for lo in range(0, N + pad, chunk):
        hi = lo + chunk
        parts.append(call(source[lo:hi], target[lo:hi], T_init[lo:hi], weight[lo:hi],
                          ids[lo:hi]))
    return ICPResult(*(torch.cat(field)[:N] for field in zip(*parts)))


def _register_impl(source, target, T_init, weight, cfg, noise=None, pair_ids=None):
    if cfg.anderson_m > 0:
        # the Anderson-accelerated driver (does its own preprocessing);
        # differentiable=True still selects the smooth weight forms whose
        # fixed point the IFT backward linearises
        from dicp_tpu_torch.anderson import _anderson_impl

        return _anderson_impl(source, target, T_init, weight, cfg, cfg.anderson_m,
                              1e-8, cfg.anderson_cap)

    source, target, weight, C, r = _preprocess(cfg, source, target, T_init, weight)
    if fused_eligible(cfg, source, target, noise):
        # the whole solve in one kernel launch (K4, ops/fused_gn); it takes
        # per-point weights, so the pt2pt expansion is undone and redone here
        w_pt = weight[:, ::3] if cfg.icp_type == "pt2pt" else weight
        Cv, rv, conv, iters, ratio, wsave, cost = fused_gn_solve(
            source[..., :3], target, w_pt, C, r, cfg)
        if cfg.icp_type == "pt2pt":
            wsave = torch.repeat_interleave(wsave, 3, dim=-1)
        N = source.shape[0]
        return ICPResult(
            pc=torch.einsum("nij,npj->npi", Cv, source[..., :3]) + rv[:, None, :],
            T=se3._homogeneous(Cv, rv),
            costs=cost[:, None, None],
            deltas=source.new_zeros((N, 1, 6, 1)),
            weights=wsave[:, None, :, None],
            converged=conv, iterations=iters, matched_ratio=ratio)

    if noise is not None:
        # Gumbel soft NN draws its own correspondences in _gn_step: no
        # hard-NN closure (nor a cluster index) is built
        corr_fn = None
        pair_ids = list(range(source.shape[0])) if pair_ids is None else pair_ids
    else:
        corr_fn = _make_corr_fn(cfg, source, target, C, r)
    carry, deltas, weights, costs, it_final = _run_loop(
        cfg, source, target, weight, C, r, corr_fn, noise, pair_ids)
    return _finalize(cfg, source, carry, deltas, weights, costs, it_final)


def executed_iterations(result: ICPResult) -> int:
    """Executed iteration count, for slicing the fixed-length histories (a
    device sync)."""
    return int(torch.max(result.iterations))


def slice_histories(result: ICPResult) -> ICPResult:
    """Trim histories to the executed length."""
    k = executed_iterations(result)
    return result._replace(costs=result.costs[:, :k], deltas=result.deltas[:, :k],
                           weights=result.weights[:, :k])
