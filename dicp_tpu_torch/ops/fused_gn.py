"""Whole-solve Gauss-Newton ICP for small pairs: the counterpart of
``dicp_tpu/ops/fused_gn.py`` (K4).

:func:`fused_gn_solve` runs the entire non-differentiable early-exit solve
of :func:`dicp_tpu_torch.registration.register` -- dense 1-NN, robust and
trim weights, pt2pt/pt2pl normal equations, the Jacobi-equilibrated
Schur/Cramer solve, the Rodrigues retraction, convergence freezing and the
first-crossing stats -- for histories off, in f32, with the inputs and the
7-tuple result of the Pallas function.  Inputs are the preprocessed solver
tensors: source (B, n, 3), target (B, m, 3|6), weight (B, n) per POINT (the
pt2pt expansion undone by the caller), C0 (B, 3, 3), r0 (B, 3).

Arithmetic as in the Pallas kernel: d2 in the difference form
((dx^2 + dy^2) + dz^2), the first index of the minimum, the per-point loss
and trim weights of ``_loss_w``/``_trim_w``, damping ``1e-6 * max(dmax, 1)``
or ``tikhonov``, the scalar solve of ``_solve_spd_s`` and ``_exp_so3_s``
with its ``theta^2 < 0.01`` series switch.

One deliberate deviation from Pallas, below the convergence tolerance: each
batch element leaves its loop when it converges, where the Pallas kernel
leaves per tile of 8 elements (and the XLA while driver per batch); the
converged elements of a tile there run no-op iterations that drift by
O(1e-12).  :func:`fused_gn_solve_plain` reproduces the per-element exit
exactly by holding converged elements' state.

Routing is by device only: CPU tensors take :func:`fused_gn_solve_plain`,
CUDA tensors launch the hand-written kernel ``csrc/fused_gn.cu`` or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dicp_tpu_torch.ops import _build

# Kernel launches by this wrapper (CUDA tensors only).
launches = 0

# The kernel's limits: one block per pair, the target staged in shared
# memory (dicp_tpu/ops/fused_gn.py::fused_eligible uses the same).
MAX_N = 256
MAX_M = 512
# Its schedule (csrc/fused_gn.cu): each source point gets lanes_for(n, m)
# lanes, at most MAX_LANES, in blocks of at most MAX_THREADS threads; a lane
# walks chunks of CHUNK targets.
MAX_LANES = 4
MAX_THREADS = 256
CHUNK = 4


def lanes_for(n: int, m: int) -> int:
    """Lanes per source point, as ``fused_gn_launch`` picks them: the most,
    up to MAX_LANES, with the block within MAX_THREADS threads and every lane
    given at least one chunk of targets."""
    chunks = -(-m // CHUNK)
    lanes = MAX_LANES
    while lanes > 1 and (32 * -(-(n * lanes) // 32) > MAX_THREADS or lanes > chunks):
        lanes //= 2
    return lanes


def launch_plan(n: int, m: int) -> dict:
    """K4's launch geometry for pairs of n -> m points: lanes per point and
    threads per block."""
    lanes = lanes_for(n, m)
    return {"lanes": lanes, "threads": 32 * -(-(n * lanes) // 32)}
_LOSS_CODES = {None: 0, "huber": 1, "cauchy": 2, "welsch": 3, "gm": 4, "trim": 5}


def fused_eligible(cfg, source: torch.Tensor, target: torch.Tensor, key=None) -> bool:
    """Gate for the whole-solve kernel, as ``dicp_tpu`` decides it.

    Auto (``cfg.fused_small is None``) is off, as in the JAX package: the
    H100 A/B against the port's loop is recorded in PERF.md, not acted on.
    ``True`` forces it where the kernel replicates the solve: the early-exit
    driver with histories off, pt2pt/pt2pl, no Gumbel noise source ``key``,
    f32, n <= 256, m <= 512 on the dense tier."""
    if cfg.fused_small is not True:
        return False
    n, m = source.shape[-2], target.shape[-2]
    return (cfg.resolved_driver() == "while"
            and not cfg.collect_histories
            and not cfg.const_iter
            and cfg.icp_type in ("pt2pt", "pt2pl")
            and key is None
            and source.dtype == torch.float32
            and n <= MAX_N and m <= MAX_M
            and cfg.resolved_nn_method(n, m, source.device) == "dense")


def _check(source, target, weight, C0, r0, cfg) -> int:
    """Validate shapes and devices; return the target columns read."""
    if cfg.icp_type not in ("pt2pt", "pt2pl"):
        raise ValueError(f"the fused solve takes pt2pt or pt2pl, got {cfg.icp_type}")
    tcols = 6 if cfg.icp_type == "pt2pl" else 3
    if source.dim() != 3 or source.shape[-1] != 3:
        raise ValueError(f"source must be (B, n, 3), got {tuple(source.shape)}")
    B, n = source.shape[:2]
    if target.dim() != 3 or target.shape[0] != B or target.shape[-1] < tcols:
        raise ValueError(f"target must be (B, m, >= {tcols}), got {tuple(target.shape)}")
    if target.shape[1] == 0:
        raise ValueError("the fused solve needs at least one target point")
    if (tuple(weight.shape) != (B, n) or tuple(C0.shape) != (B, 3, 3)
            or tuple(r0.shape) != (B, 3)):
        raise ValueError(f"weight (B, n), C0 (B, 3, 3), r0 (B, 3) expected with B = {B}, "
                         f"n = {n}; got {tuple(weight.shape)}, {tuple(C0.shape)}, "
                         f"{tuple(r0.shape)}")
    if len({t.device for t in (source, target, weight, C0, r0)}) > 1:
        raise ValueError("inputs lie on different devices")
    return tcols


# ---- the plain version: batched scalar algebra on (B,) tensors ----------

def _inv3s(a):
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    adj = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return [[adj[i][j] / det for j in range(3)] for i in range(3)]


def _mv3(m, v):
    return [m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2] for i in range(3)]


def _mm3(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _solve6s(a, b):
    p = [row[:3] for row in a[:3]]
    q = [row[3:] for row in a[:3]]
    qt = [row[:3] for row in a[3:]]
    s = [row[3:] for row in a[3:]]
    p_inv = _inv3s(p)
    p_inv_q = _mm3(p_inv, q)
    m_qq = _mm3(qt, p_inv_q)
    m = [[s[i][j] - m_qq[i][j] for j in range(3)] for i in range(3)]
    p_inv_b1 = _mv3(p_inv, b[:3])
    qtb = _mv3(qt, p_inv_b1)
    x2 = _mv3(_inv3s(m), [b[3 + i] - qtb[i] for i in range(3)])
    px2 = _mv3(p_inv_q, x2)
    return [p_inv_b1[i] - px2[i] for i in range(3)] + x2


def _solve_spd_s(a, b, k):
    """ops/smallsolve.solve_spd on (B,) scalars, with its equilibration."""
    dinv = [1.0 / torch.sqrt(torch.clamp(a[i][i], min=1e-30)) for i in range(k)]
    a_eq = [[a[i][j] * dinv[i] * dinv[j] for j in range(k)] for i in range(k)]
    b_eq = [b[i] * dinv[i] for i in range(k)]
    y = _mv3(_inv3s(a_eq), b_eq) if k == 3 else _solve6s(a_eq, b_eq)
    return [y[i] * dinv[i] for i in range(k)]


def _exp_so3_s(w):
    """Rodrigues on (B,) scalars with the f32 series switch at theta < 0.1."""
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta2 < 0.01
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    z = torch.zeros_like(theta2)
    kmat = [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]
    kk = _mm3(kmat, kmat)
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    return [[eye[i][j] + a * kmat[i][j] + b * kk[i][j] for j in range(3)]
            for i in range(3)]


def _safe_sqrt(sq):
    zero = sq == 0.0
    return torch.where(zero, torch.zeros_like(sq),
                       torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def _trim_w(en2, metric, differentiable, steep):
    en = _safe_sqrt(en2)
    if differentiable:
        return 0.5 * torch.tanh(steep * (metric - en) - 3.0) + 0.5
    return torch.where(en < metric, torch.ones_like(en), torch.zeros_like(en))


def _loss_w(name, le2, metric, differentiable, steep):
    """losses.robust_weight on |loss_err|^2."""
    m2 = metric * metric
    if name is None:
        return torch.ones_like(le2)
    if name == "huber":
        if differentiable:
            return m2 / (m2 + le2)
        en = _safe_sqrt(le2)
        return torch.where(en > metric, metric / torch.where(en == 0.0, 1.0, en),
                           torch.ones_like(en))
    if name == "cauchy":
        return 1.0 / (1.0 + le2 / m2)
    if name == "welsch":
        return torch.exp(-le2 / m2)
    if name == "gm":
        return (m2 / (m2 + le2)) ** 2
    if name == "trim":
        return _trim_w(le2, metric, differentiable, steep)
    raise ValueError(name)


def _f32(x: float) -> torch.Tensor:
    """A Python constant rounded to f32 once, as the kernel receives it."""
    return torch.tensor(x, dtype=torch.float32)


def fused_gn_solve_plain(source, target, weight, C0, r0, cfg):
    """Plain PyTorch version of the kernel, on any device: the same
    arithmetic batched over the elements, each element's state held once it
    has converged.  Sums over points are ``torch.sum``s, so they round
    differently from the kernel's fixed-order tree."""
    tcols = _check(source, target, weight, C0, r0, cfg)
    dtype, dev = source.dtype, source.device
    f32 = torch.float32
    src = source.detach().to(f32)
    tgt = target.detach()[..., :tcols].to(f32)
    w0 = weight.detach().to(f32)
    Cs = [[C0.detach()[:, i, j].to(f32) for j in range(3)] for i in range(3)]
    rv = [r0.detach()[:, c].to(f32) for c in range(3)]
    B, n = src.shape[:2]
    k = 3 if cfg.dim == 2 else 6
    pt2pl = cfg.icp_type == "pt2pl"
    tol, thresh = _f32(cfg.tolerance).to(dev), _f32(cfg.match_ratio_thresh).to(dev)
    metric, steep = _f32(cfg.loss_metric).to(dev), _f32(cfg.tanh_steepness).to(dev)

    zeros = torch.zeros(B, dtype=f32, device=dev)
    conv, iters, ratio_o, cost_o = zeros, zeros, zeros, zeros
    it_final = zeros
    wsave = torch.zeros_like(w0)
    wraw = torch.zeros_like(w0)
    winit = w0
    sx = [src[..., c] for c in range(3)]
    tg = [tgt[..., c] for c in range(tcols)]
    for it in range(cfg.max_iterations):
        act = conv == 0.0
        if not bool(act.any()):
            break
        cp = [sx[0] * Cs[c][0][:, None] + sx[1] * Cs[c][1][:, None]
              + sx[2] * Cs[c][2][:, None] for c in range(3)]
        ps = [cp[c] + rv[c][:, None] for c in range(3)]
        diff = ps[0][:, :, None] - tg[0][:, None, :]
        d2 = diff * diff
        for c in (1, 2):
            diff = ps[c][:, :, None] - tg[c][:, None, :]
            d2 = d2 + diff * diff                           # (B, n, m)
        idx = torch.argmin(d2, dim=-1)                      # the first minimum
        nn = [torch.gather(tg[c], 1, idx) for c in range(tcols)]
        e = [ps[c] - nn[c] for c in range(3)]
        en2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        if cfg.trim_dist is not None:
            trim = _trim_w(en2, _f32(cfg.trim_dist).to(dev), cfg.differentiable, steep)
        else:
            trim = torch.ones_like(en2)
        if pt2pl:
            nrm = nn[3:6]
            res = e[0] * nrm[0] + e[1] * nrm[1] + e[2] * nrm[2]
            le2 = res * res
        else:
            le2 = en2
        lw = _loss_w(cfg.loss_name, le2, metric, cfg.differentiable, steep)
        w = winit * trim * lw
        w_sqrt = torch.sqrt(w + 1.0e-10) - 1.0e-5
        ws2 = w_sqrt * w_sqrt

        if pt2pl:
            nxc = [nrm[1] * cp[2] - nrm[2] * cp[1], nrm[2] * cp[0] - nrm[0] * cp[2],
                   nrm[0] * cp[1] - nrm[1] * cp[0]]
            J6 = nxc + [-nrm[0], -nrm[1], -nrm[2]]
            Jc = [J6[2:5] if cfg.dim == 2 else J6]
            rs = [res]
            cost_pt = ws2 * le2
        else:
            z, one = torch.zeros_like(cp[0]), torch.ones_like(cp[0])
            rows6 = [[z, -cp[2], cp[1], -one, z, z],
                     [cp[2], z, -cp[0], z, -one, z],
                     [-cp[1], cp[0], z, z, z, -one]]
            Jc = [r_[2:5] for r_ in rows6] if cfg.dim == 2 else rows6
            rs = e
            cost_pt = ws2 * en2
        A = [[None] * k for _ in range(k)]
        b = [None] * k
        for i in range(k):
            for j in range(i, k):
                acc = Jc[0][i] * Jc[0][j]
                for c in range(1, len(Jc)):
                    acc = acc + Jc[c][i] * Jc[c][j]
                A[i][j] = A[j][i] = torch.sum(ws2 * acc, dim=1)
            bacc = Jc[0][i] * rs[0]
            for c in range(1, len(Jc)):
                bacc = bacc + Jc[c][i] * rs[c]
            b[i] = torch.sum(ws2 * bacc, dim=1)
        cost = torch.sum(cost_pt, dim=1)

        if cfg.tikhonov is not None:
            lam = _f32(cfg.tikhonov).to(dev)
        else:
            dmax = A[0][0]
            for i in range(1, k):
                dmax = torch.maximum(dmax, A[i][i])
            lam = 1e-6 * torch.clamp(dmax, min=1.0)
        for i in range(k):
            A[i][i] = A[i][i] + lam
        delta = [-d_ for d_ in _solve_spd_s(A, b, k)]
        d6 = [zeros, zeros, delta[0], delta[1], delta[2], zeros] if k == 3 else delta
        dn2 = delta[0] * delta[0]
        for d_ in delta[1:]:
            dn2 = dn2 + d_ * d_
        below = torch.sqrt(dn2) < tol

        dC = _exp_so3_s(d6[:3])
        Cn = [[dC[0][i] * Cs[0][j] + dC[1][i] * Cs[1][j] + dC[2][i] * Cs[2][j]
               for j in range(3)] for i in range(3)]
        keep = lambda new, old: torch.where(act, new, old)  # noqa: E731
        keep2 = lambda new, old: torch.where(act[:, None], new, old)  # noqa: E731
        Cs = [[keep(Cn[i][j], Cs[i][j]) for j in range(3)] for i in range(3)]
        rv = [keep(rv[c] - d6[3 + c], rv[c]) for c in range(3)]

        # bookkeeping (registration._apply_step with histories off)
        sum_w = torch.sum(w, dim=1)
        wsave = keep2(torch.where((sum_w == 0.0)[:, None], wsave, w), wsave)
        wraw = keep2(w, wraw)
        cost_o = keep(torch.where(cost == 0.0, cost_o, cost), cost_o)
        itf = float(it + 1)
        iters = keep(torch.where(below, iters + itf * (iters == 0.0), iters), iters)
        num_curr = torch.sum(w > thresh, dim=1).to(f32)
        num_start = torch.sum(winit > thresh, dim=1).to(f32)
        num_start = torch.where(num_start == 0.0, torch.ones_like(num_start), num_start)
        ratio = num_curr / num_start
        ratio_o = keep(torch.where(below, ratio_o + ratio * (ratio_o == 0.0), ratio_o),
                       ratio_o)
        winit = keep2(winit * torch.where(below, 0.0, 1.0)[:, None], winit)
        conv = keep(torch.maximum(conv, below.to(f32)), conv)
        it_final = keep(torch.full_like(it_final, itf), it_final)

    # post-loop stats fill (registration._finalize)
    iters = torch.where(iters == 0.0, it_final, iters)
    nc_ = torch.sum(wraw > thresh, dim=1).to(f32)
    ns_ = torch.sum(winit > thresh, dim=1).to(f32)
    ns_ = torch.where(ns_ == 0.0, torch.ones_like(ns_), ns_)
    ratio_o = torch.where(ratio_o == 0.0, nc_ / ns_, ratio_o)
    C = torch.stack([torch.stack(row, dim=-1) for row in Cs], dim=-2)
    r = torch.stack(rv, dim=-1)
    return (C.to(dtype), r.to(dtype), conv > 0.0, iters.to(dtype), ratio_o.to(dtype),
            wsave.to(dtype), cost_o.to(dtype))


# ---- the kernel ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("fused_gn").fused_gn_launch
    fn.argtypes = ([ctypes.c_void_p] * 5            # src, tgt, w0, C0, r0
                   + [ctypes.c_void_p] * 7          # C, r, conv, iters, ratio, wsave, cost
                   + [ctypes.c_int] * 3             # batch, n, m
                   + [ctypes.c_int] * 6             # pt2pl, dim, loss, diff, has_trim, has_tik
                   + [ctypes.c_float] * 6           # trim, metric, steep, tol, thresh, tik
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])  # iters, device, stream
    fn.restype = ctypes.c_int
    return fn


def _f32_input(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous f32 tensor, without a copy where it is one."""
    x = x.detach()
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


def _fused_gn_cuda(source, target, weight, C0, r0, cfg, tcols):
    global launches
    B, n = source.shape[:2]
    m = target.shape[1]
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"the fused kernel takes n <= {MAX_N} and m <= {MAX_M}, "
                         f"got n {n}, m {m}")
    dev = source.device
    src, w0, C0c, r0c = (_f32_input(x) for x in (source, weight, C0, r0))
    tgt = _f32_input(target if target.shape[-1] == tcols else target[..., :tcols])
    # one allocation for the seven outputs: C (B, 9), r (B, 3), conv, iters,
    # ratio, cost (B,) and wsave (B, n), each a contiguous run
    out = torch.empty(B * (16 + n), dtype=torch.float32, device=dev)
    C, r, conv, iters, ratio, cost, wsave = torch.split(out, (9 * B, 3 * B, B, B, B, B, B * n))
    if B and n:
        err = _kernel()(
            src.data_ptr(), tgt.data_ptr(), w0.data_ptr(), C0c.data_ptr(), r0c.data_ptr(),
            C.data_ptr(), r.data_ptr(), conv.data_ptr(), iters.data_ptr(), ratio.data_ptr(),
            wsave.data_ptr(), cost.data_ptr(), B, n, m,
            int(cfg.icp_type == "pt2pl"), cfg.dim, _LOSS_CODES[cfg.loss_name],
            int(cfg.differentiable), int(cfg.trim_dist is not None),
            int(cfg.tikhonov is not None),
            0.0 if cfg.trim_dist is None else cfg.trim_dist, cfg.loss_metric,
            cfg.tanh_steepness, cfg.tolerance, cfg.match_ratio_thresh,
            0.0 if cfg.tikhonov is None else cfg.tikhonov,
            cfg.max_iterations, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_gn kernel launch failed: CUDA error {err}")
        launches += 1
    outs = [C.view(B, 3, 3), r.view(B, 3), iters, ratio, wsave.view(B, n), cost]
    if source.dtype != torch.float32:
        outs = [o.to(source.dtype) for o in outs]
    C, r, iters, ratio, wsave, cost = outs
    return C, r, conv > 0.0, iters, ratio, wsave, cost


def fused_gn_solve(source, target, weight, C0, r0, cfg):
    """The whole early-exit solve: (C (B, 3, 3), r (B, 3), converged (B,)
    bool, iterations (B,), match_ratio (B,), prev_w_save (B, n), prev_cost
    (B,)), with the while driver's bookkeeping for histories off."""
    tcols = _check(source, target, weight, C0, r0, cfg)
    if source.device.type == "cpu":
        return fused_gn_solve_plain(source, target, weight, C0, r0, cfg)
    if source.device.type == "cuda":
        return _fused_gn_cuda(source, target, weight, C0, r0, cfg, tcols)
    raise ValueError(f"the fused solve runs on cpu or cuda tensors, got {source.device}")
