"""Generalized-ICP (plane-to-plane): the counterpart of ``dicp_tpu/gicp.py``.

Every point carries a covariance of its local surface, and the residual is
weighted by the inverse of the combined covariance

    Sigma_i = C_target_i + R C_source_i R^T,   cost_i = r_i^T Sigma_i^-1 r_i.

With the (1, 1, eps) plane-to-plane regularisation of Segal, Haehnel and
Thrun (RSS 2009) each covariance is closed-form in its surface normal,
C = I + (eps - 1) n n^T, so Sigma_i is a rank-2 update of 2 I, inverted by
the closed-form adjugate (:func:`ops.smallsolve.inv3`).

The correspondences are the argmin of a score-form (n, m) distance block
|p|^2 + |t|^2 - 2 p t^T, as in JAX (an XLA matmul there, not a Pallas
kernel): GICP serves mid-size clouds, and pairs with
:mod:`dicp_tpu_torch.multiscale` for large ones.  The matmul runs in full
f32 on the card (TF32 stays off).

One loop serves both JAX drivers, as in :mod:`dicp_tpu_torch.registration`:
the ``lax.while_loop`` (early exit) and the fixed-trip ``lax.scan`` with
convergence freezing (``differentiable=True``) give the same results, since
a frozen element is carried forward unchanged.  The loop is a masked body
over a state held in tensors (``where(flag, new, old)`` on every field),
run by :func:`jit.device_while`: it stops once every element has converged
or the iterations are spent, a CUDA graph WHILE node in
:data:`register_gicp_jit`'s captured program and a host loop that reads the
flag once per iteration in :func:`register_gicp` (where autograd records
it, the state is rebound instead of overwritten).  A captured solve on
which autograd records takes JAX's scan instead, a fixed trip of
``max_iterations`` autograd steps (:mod:`dicp_tpu_torch.fixed_trip`): a
WHILE node would record one step.
:func:`register_gicp_ift` differentiates through the fixed point with one
6x6 adjoint solve (a ``torch.autograd.Function``); JAX does not jit it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jvp, vjp, vmap

from dicp_tpu_torch import fixed_trip, se3
from dicp_tpu_torch.jit import capturing, device_while, jit, records
from dicp_tpu_torch.knn import gather_rows
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.ops.smallsolve import inv3, solve_spd


class GICPResult(NamedTuple):
    T: torch.Tensor            # (N, 4, 4) source -> target
    iterations: torch.Tensor   # (N,) float
    converged: torch.Tensor    # (N,) bool
    cost: torch.Tensor         # (N,) final mean Mahalanobis cost


def _mahalanobis_ne(J, M, r, w, chunk: int = 4096):
    """H = sum_i w_i J_i^T M_i J_i (..., 6, 6), g = sum_i w_i J_i^T M_i r_i
    (..., 6) and Mr (..., n, 3), for J (..., n, 3, 6), M (..., n, 3, 3),
    r (..., n, 3), w (..., n).

    Summed in two levels above ``chunk`` rows, as JAX does: within
    zero-padded chunks, then across them (a flat f32 sum over ~3e5 rows
    puts ~1e-4 of rounding noise into the step)."""
    n = J.shape[-3]
    MJ = torch.einsum("...nij,...njk->...nik", M, J)
    Mr = torch.einsum("...nij,...nj->...ni", M, r)
    if n <= chunk:
        H = torch.einsum("...nij,...n,...nik->...jk", J, w, MJ)
        g = torch.einsum("...nij,...n,...ni->...j", J, w, Mr)
        return H, g, Mr
    nc = -(-n // chunk)
    pad = nc * chunk - n
    lead = J.shape[:-3]

    def padded(a):
        if not pad:
            return a
        zeros = a.new_zeros(lead + (pad,) + a.shape[len(lead) + 1:])
        return torch.cat([a, zeros], dim=len(lead))

    Jc = padded(J).reshape(lead + (nc, chunk, 3, 6))
    MJc = padded(MJ).reshape(lead + (nc, chunk, 3, 6))
    Mrc = padded(Mr).reshape(lead + (nc, chunk, 3))
    wc = padded(w).reshape(lead + (nc, chunk))
    H = torch.sum(torch.einsum("...cnij,...cn,...cnik->...cjk", Jc, wc, MJc), dim=-3)
    g = torch.sum(torch.einsum("...cnij,...cn,...cni->...cj", Jc, wc, Mrc), dim=-2)
    return H, g, Mr


def _sigma_inv(nt, m, epsilon: float):
    """M = (2 I + (eps - 1)(nt nt^T + m m^T))^-1 per point: (..., n, 3, 3)."""
    eye = torch.eye(3, dtype=nt.dtype, device=nt.device)
    sigma = 2.0 * eye + (epsilon - 1.0) * (nt[..., :, None] * nt[..., None, :]
                                           + m[..., :, None] * m[..., None, :])
    return inv3(sigma)


def _jacobian(p):
    """J_i = [I | -skew(p_i)]: (..., n, 3, 6)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape + (3,))
    return torch.cat([eye, -se3.skew(p)], dim=-1)


def _posed(T, src):
    """src (N, n, 3) under T (N, 4, 4)."""
    return src @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def _nearest(p, tgt):
    """Argmin of the score-form distance block |p|^2 + |t|^2 - 2 p t^T
    (first index on ties), without gradient: (N, n).  The exact product
    2 (p t^T) is subtracted in place, the bits of JAX's (2 p) t^T."""
    with torch.no_grad():
        d2 = torch.sum(p * p, dim=-1)[:, :, None] + torch.sum(tgt * tgt, dim=-1)[:, None, :]
        d2.sub_(p @ tgt.transpose(-1, -2), alpha=2.0)
        return torch.argmin(d2, dim=-1)


def _gicp_step(T, src, src_n, tgt, tgt_n, weight, epsilon: float, trim2, nearest=_nearest):
    """One GN step for the batch: correspondences (``nearest(p, tgt)``),
    Mahalanobis normal equations, se(3) update.  Returns (T_new, step norm,
    mean cost), each per element."""
    p = _posed(T, src)                                  # (N, n, 3)
    # hard NN: the gradient flows into the gathered rows (knn.py's semantics)
    idx = nearest(p, tgt)
    q = gather_rows(tgt, idx)
    nt = gather_rows(tgt_n, idx)

    r = p - q
    ns_w = src_n @ T[:, :3, :3].transpose(-1, -2)      # rotated source normals
    M = _sigma_inv(nt, ns_w, epsilon)
    w = weight * (torch.sum(r * r, dim=-1) < trim2).to(src.dtype)

    H, g, Mr = _mahalanobis_ne(_jacobian(p), M, r, w)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-10)
    # Levenberg jitter on H's scale: a defined solve when every match is
    # trimmed; solve_spd's equilibration keeps realistic radii finite in f32
    lam = 1e-9 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-30
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    delta = solve_spd(H + lam[:, None, None] * eye6, -g)
    T_new = se3.vec2tran(delta) @ T
    cost = torch.sum(w * torch.sum(r * Mr, dim=-1), dim=-1) / wsum
    return T_new, torch.sqrt(torch.sum(delta * delta, dim=-1)), cost


def _advance(s: dict, src, tgt, tgt_n, src_n, weight, epsilon: float, trim2,
             tolerance: float, nearest=_nearest) -> dict:
    """The state (T, it, done, cost) after one step: an element's pose,
    iteration count and cost freeze at the step whose norm falls below
    ``tolerance``."""
    active = ~s["done"]
    T_new, dn, cost_new = _gicp_step(s["T"], src, src_n, tgt, tgt_n, weight, epsilon, trim2,
                                     nearest)
    return dict(T=torch.where(active[:, None, None], T_new, s["T"]),
                it=torch.where(active, s["it"] + 1.0, s["it"]),
                done=s["done"] | (active & (dn < tolerance)),
                cost=torch.where(active, cost_new, s["cost"]))


class _Trip(fixed_trip.Trip):
    """GICP's steps in a fixed trip: inputs (src, tgt, tgt_n, src_n,
    weight), the carry (T, cost, it, done) with T and cost differentiable;
    the search is the argmin, saved as int32 indices."""

    n_inputs, n_grad = 5, 2

    def __init__(self, epsilon: float, trim2, tolerance: float):
        self.epsilon, self.trim2, self.tolerance = epsilon, trim2, tolerance

    def found(self, inputs):
        src = inputs[0]
        return [torch.zeros(src.shape[:2], dtype=torch.int32, device=src.device)]

    def search(self, p, tgt):
        return (_nearest(p, tgt),)

    def step(self, inputs, carry, it, search):
        src, tgt, tgt_n, src_n, weight = inputs
        T, cost, count, done = carry
        s = _advance(dict(T=T, it=count, done=done, cost=cost), src, tgt, tgt_n, src_n, weight,
                     self.epsilon, self.trim2, self.tolerance,
                     lambda p, t: search(p, t)[0])
        return (s["T"], s["cost"], s["it"], s["done"]), ()


def _solve(src, tgt, tgt_n, src_n, T0, weight, *, epsilon: float, trim2,
           max_iterations: int, tolerance: float):
    """Both JAX drivers (:func:`_advance`).  The loop runs while ``count <
    max_iterations`` and an element is active: a masked body under
    :func:`jit.device_while`, or, where autograd records a captured solve,
    a fixed trip of ``max_iterations`` steps (:mod:`dicp_tpu_torch.fixed_trip`,
    JAX's ``lax.scan`` driver), each skipped once every element is done."""
    N, device = src.shape[0], src.device
    # every field owns its storage: the body overwrites it in place, unless
    # autograd records the loop
    s = dict(T=T0.clone(), it=src.new_zeros((N,)),
             done=torch.zeros((N,), dtype=torch.bool, device=device),
             cost=torch.full((N,), torch.inf, dtype=src.dtype, device=device))
    recorded = records((src, tgt, tgt_n, src_n, T0, weight))
    if recorded and capturing(src):
        # a WHILE node would record one body: the fixed trip records each step
        trip = _Trip(epsilon, trim2, tolerance)
        (T, cost, it, done), _, _ = fixed_trip.run(
            trip, max_iterations, (src, tgt, tgt_n, src_n, weight),
            (s["T"], s["cost"], s["it"], s["done"]), lambda c: torch.any(~c[3]))
        return T, it, done, cost
    count = torch.zeros((), dtype=torch.int32, device=device)
    flag = (count < max_iterations) & torch.any(~s["done"])

    def body():
        new = _advance(s, src, tgt, tgt_n, src_n, weight, epsilon, trim2, tolerance)
        # masked: a body run after the flag fell changes no bit (the host
        # loop that autograd records runs the body only while the flag holds)
        for name, val in new.items():
            if recorded:
                s[name] = val
            else:
                s[name].copy_(torch.where(flag, val, s[name]))
        count.copy_(torch.where(flag, count + 1, count))
        flag.copy_((count < max_iterations) & torch.any(~s["done"]))

    # uncaptured, or captured with nothing recorded: a WHILE node whose body
    # overwrites the state (the recorded host loop rebinds it instead)
    device_while(flag, body)
    return s["T"], s["it"], s["done"], s["cost"]


def _prepare(source, target, T_init, weight, source_normals, k_normals: int, name: str):
    if source.dim() != 3 or target.dim() != 3 or T_init.dim() != 3:
        raise ValueError(f"{name} expects batched (N, n, 3), (N, m, 3|6), (N, 4, 4)")
    dt = source.dtype
    src = source[..., :3]
    tgt = target[..., :3]
    if target.shape[-1] >= 6:
        tgt_n = target[..., 3:6]
    else:
        tgt_n = estimate_normals(tgt, k=k_normals)
    if source_normals is None:
        src_n = estimate_normals(src, k=k_normals)
    else:
        src_n = source_normals[..., :3]
    if weight is None:
        weight = torch.ones(src.shape[:-1], dtype=dt, device=src.device)
    # JAX carries the pose in the source's dtype through its solve loop and
    # promotes every operand of a step: a wider target, normal or weight
    # widens the pose, and the loop raises.  A narrower one is promoted.
    wider = [f"{what} ({a.dtype})" for what, a in
             (("target", tgt), ("source_normals", src_n), ("weight", weight))
             if torch.promote_types(a.dtype, dt) != dt]
    if wider:
        raise TypeError(f"{name}: {', '.join(wider)} wider than the source ({dt}); "
                        "the solve carries the pose in the source's dtype")
    return src, tgt.to(dt), tgt_n.to(dt), src_n.to(dt), weight.to(dt), T_init.to(dt)


def register_gicp(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    source_normals: Optional[torch.Tensor] = None,
    epsilon: float = 1e-3,
    trim_dist: Optional[float] = None,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    differentiable: bool = False,
    k_normals: int = 16,
) -> GICPResult:
    """Batched plane-to-plane GICP: (N, n, 3), (N, m, 3|6), (N, 4, 4) tensors
    on one device.

    ``target`` columns 3:6 are the target normals when present; otherwise
    both clouds' normals are estimated (:func:`ops.normals.estimate_normals`,
    k = ``k_normals``).  ``source_normals`` (N, n, 3) skips the source's
    estimate.  ``epsilon`` is the plane-to-plane regulariser (``1`` gives
    isotropic covariances: point-to-point GN).  ``differentiable`` names
    JAX's fixed-trip driver; the results are the same, and autograd flows
    through the iterations either way (hard-NN gradient semantics)."""
    src, tgt, tgt_n, src_n, weight, T0 = _prepare(source, target, T_init, weight,
                                                  source_normals, k_normals, "register_gicp")
    trim2 = float("inf") if trim_dist is None else float(trim_dist) ** 2
    T, it, done, cost = _solve(src, tgt, tgt_n, src_n, T0, weight, epsilon=float(epsilon),
                               trim2=trim2, max_iterations=max_iterations,
                               tolerance=tolerance)
    return GICPResult(T=T, iterations=it, converged=done, cost=cost)


# The JAX package's ``register_gicp_jit`` is ``jax.jit(register_gicp)``: on
# the card the port's is a captured CUDA graph whose loop is a WHILE node (see
# dicp_tpu_torch.jit); on the CPU it is register_gicp itself.
register_gicp_jit = jit(register_gicp, static_argnames=(
    "epsilon", "trim_dist", "max_iterations", "tolerance", "differentiable", "k_normals"),
    name="register_gicp_jit")


# ---------------------------------------------------------------------------
# Implicit-function-theorem gradients: the forward is the early-exit solve;
# the backward linearises the stationarity G(xi) = sum_i w_i J_i^T M_i r_i at
# the pose exp(xi) T*, keeping the full xi-dependence of M (through the
# rotated source normals).  Correspondences and the hard trim gate are held
# at T*.
# ---------------------------------------------------------------------------


def _gicp_g_vec(xi, T_star, src, tgt, tgt_n, src_n, idx, w, epsilon: float):
    """Stationarity (N, 6) at the poses exp(xi) T* with the matches ``idx``."""
    T = se3.vec2tran(xi) @ T_star
    p = _posed(T, src)
    r = p - gather_rows(tgt, idx)
    nt = gather_rows(tgt_n, idx)
    m = src_n @ T[:, :3, :3].transpose(-1, -2)
    M = _sigma_inv(nt, m, epsilon)
    _, g, _ = _mahalanobis_ne(_jacobian(p), M, r, w)
    return g


class _GICPFixedPoint(torch.autograd.Function):
    """The early-exit solve; only ``T`` carries a gradient (iterations,
    converged and cost are detached by contract)."""

    @staticmethod
    def forward(ctx, params, src, tgt, tgt_n, src_n, weight, T_init):
        epsilon, trim2, max_iterations, tolerance = params
        T, it, done, cost = _solve(src, tgt, tgt_n, src_n, T_init, weight, epsilon=epsilon,
                                   trim2=trim2, max_iterations=max_iterations,
                                   tolerance=tolerance)
        ctx.params = params
        ctx.save_for_backward(src, tgt, tgt_n, src_n, weight, T)
        ctx.mark_non_differentiable(it, done, cost)
        return T, it, done, cost

    @staticmethod
    def backward(ctx, T_bar, *_):
        epsilon, trim2 = ctx.params[:2]
        src, tgt, tgt_n, src_n, weight, T = ctx.saved_tensors
        if T_bar is None:
            T_bar = torch.zeros_like(T)
        grads = _gicp_adjoint(src, tgt, tgt_n, src_n, weight, T, T_bar, epsilon, trim2)
        # the fixed point forgets its initialization
        return (None,) + grads + (torch.zeros_like(T),)


def _gicp_adjoint(src, tgt, tgt_n, src_n, weight, T, T_bar, epsilon: float, trim2):
    """(src, tgt, tgt_n, src_n, weight) cotangents from the cotangent on T."""
    dt = src.dtype
    N = src.shape[0]
    with torch.no_grad():
        p = _posed(T, src)
        idx = _nearest(p, tgt)
        r = p - gather_rows(tgt, idx)
        gate = (torch.sum(r * r, dim=-1) < trim2).to(dt)

    def G(xi, s, tg, tn, sn, w):
        return _gicp_g_vec(xi, T, s, tg, tn, sn, idx, w * gate, epsilon)

    zero = src.new_zeros((N, 6))
    # A[n, i, j] = dG_i / dxi_j: six JVPs along the coordinate basis, batched
    basis = torch.eye(6, dtype=dt, device=src.device)[:, None, :].expand(6, N, 6)
    cols = vmap(lambda e: jvp(lambda xi: G(xi, src, tgt, tgt_n, src_n, weight),
                              (zero,), (e,))[1])(basis)
    A = cols.permute(1, 2, 0)
    # jitter for gauge-degenerate scenes (planar data in 3-D)
    A = A + ((1e-9 * torch.diagonal(torch.abs(A), dim1=-2, dim2=-1).sum(-1) / 6.0
              + 1e-30)[:, None, None] * torch.eye(6, dtype=dt, device=src.device))

    _, pose_vjp = vjp(lambda xi: se3.vec2tran(xi) @ T, zero)
    xi_bar = pose_vjp(T_bar.to(dt))[0]
    lam = torch.linalg.solve(A.transpose(-1, -2), xi_bar[..., None])[..., 0]

    _, g_vjp = vjp(lambda s, tg, tn, sn, w: G(zero, s, tg, tn, sn, w),
                   src, tgt, tgt_n, src_n, weight)
    return g_vjp(-lam)


def register_gicp_ift(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    source_normals: Optional[torch.Tensor] = None,
    epsilon: float = 1e-3,
    trim_dist: Optional[float] = None,
    max_iterations: int = 50,
    tolerance: float = 1e-9,
    k_normals: int = 16,
) -> GICPResult:
    """GICP with implicit gradients: the early-exit forward, then one 6x6
    adjoint solve and one VJP of the stationarity, O(1) in the iteration
    count.

    The normals are estimated outside the fixed point, so autograd reaches
    the clouds through them too.  The gradients assume convergence (check
    ``converged``), hence the tight default ``tolerance``."""
    src, tgt, tgt_n, src_n, weight, T0 = _prepare(source, target, T_init, weight,
                                                  source_normals, k_normals,
                                                  "register_gicp_ift")
    trim2 = float("inf") if trim_dist is None else float(trim_dist) ** 2
    params = (float(epsilon), trim2, int(max_iterations), float(tolerance))
    return GICPResult(*_GICPFixedPoint.apply(params, src, tgt, tgt_n, src_n, weight, T0))
