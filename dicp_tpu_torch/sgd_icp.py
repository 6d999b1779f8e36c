"""Stochastic mini-batch ICP (SGD-ICP): the counterpart of
``dicp_tpu/sgd_icp.py``.

Each iteration samples a mini-batch of k source points, finds their nearest
neighbours only, and takes a step on the se(3) pose ("Speeding Up Iterative
Closest Point Using Stochastic Gradient Descent", Maken, Ramos, Ott,
arXiv:1907.09133): O(k·m) per iteration instead of O(n·m).  Three update
rules on the mini-batch normal equations / gradient: ``'gn'`` (stochastic
Gauss-Newton, Levenberg-damped; the practical default), ``'sgd'``
(lr/(1 + decay·t)) and ``'adam'``.

Structure, as in JAX:

* a fixed-trip driver with convergence freezing: an element whose step
  norm stays below ``tolerance`` for ``patience`` consecutive iterations
  carries its pose, moments, streak and cost forward unchanged, so a batch
  equals its elements solved one by one.  The port stops the loop once
  every element is frozen (one host sync per iteration): frozen elements
  would only carry forward, so the results are those of the full trip;
* the mini-batch search is a dense (k, m) score-form pass
  |p|^2 + |t|^2 - 2 p·t^T, or the Hilbert cluster index built once per solve
  and queried with the plain group scan (``fused=False``, as JAX pins it:
  no kernel), uncertified queries past the fix-up dropped through the weight;
* gradients (``differentiable=True``) flow through the gathered source
  points, the smooth robust weights and the solves, never through the
  neighbour indices (hard-NN semantics).

Random draws.  torch and JAX streams differ, so the mini-batch indices come
from an explicit source ``key``: an int seed or a ``torch.Generator``
(:class:`SeededSampler`: one ``torch.Generator`` per (batch element,
iteration) stream, seeded from a hash of the stream's name and created on
the tensors' device, so draws on the card stay on the card), a sequence of
N of those (one stream per batch element, JAX's batch of keys), or any
object with

    indices(pair_ids, iteration, k, n, device) -> (len(pair_ids), k) int64

drawing uniformly from [0, n) with replacement (a test serves JAX's own
``randint(fold_in(key, it), (k,), 0, n)`` draws through it).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import torch

from dicp_tpu_torch import losses, se3
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.ops.smallsolve import solve_spd


class SGDICPResult(NamedTuple):
    T: torch.Tensor            # (N, 4, 4) source -> target
    iterations: torch.Tensor   # (N,) float: the iteration the streak crossed
    converged: torch.Tensor    # (N,) bool
    cost: torch.Tensor         # (N,) EMA of the mini-batch robust cost


class SeededSampler:
    """The port's mini-batch source: stream (element, iteration) draws from
    its own ``torch.Generator``, seeded from a hash of the base path and the
    stream's name.  ``fold_in(k)`` derives an independent source, as JAX's
    ``fold_in`` does; a ``torch.Generator`` given as the base is read once."""

    def __init__(self, seed, path: tuple = ()):
        if isinstance(seed, torch.Generator):
            seed = int(torch.randint(0, 2**62, (1,), generator=seed, device=seed.device))
        self.path = (int(seed),) + tuple(path)

    def fold_in(self, data: int) -> "SeededSampler":
        return SeededSampler(self.path[0], self.path[1:] + (int(data),))

    def _stream(self, name: tuple, k: int, n: int, device) -> torch.Tensor:
        digest = hashlib.blake2b(repr(self.path + name).encode(), digest_size=8).digest()
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(digest, "little") >> 1)
        return torch.randint(0, n, (k,), generator=gen, device=device)

    def indices(self, pair_ids, iteration, k, n, device) -> torch.Tensor:
        return torch.stack([self._stream((int(i), int(iteration)), k, n, device)
                            for i in pair_ids])


class _PerElement:
    """One source per batch element (each asked for its own element 0)."""

    def __init__(self, samplers: Sequence):
        self.samplers = list(samplers)

    def indices(self, pair_ids, iteration, k, n, device) -> torch.Tensor:
        return torch.cat([self.samplers[int(i)].indices([0], iteration, k, n, device)
                          for i in pair_ids])


def _single_sampler(key):
    if isinstance(key, (int, torch.Generator)) and not isinstance(key, bool):
        return SeededSampler(key)
    if callable(getattr(key, "indices", None)):
        return key
    return None


def minibatch_sampler(key, N: int):
    """The mini-batch source of an N-element solve from ``key`` (see the
    module docstring); a sequence must hold N keys."""
    single = _single_sampler(key)
    if single is not None:
        return single
    if isinstance(key, (list, tuple)):
        if len(key) != N:
            raise ValueError(f"key must be a single sampler key or a sequence of {N} keys; "
                             f"got {len(key)} keys")
        samplers = [_single_sampler(k) for k in key]
        if all(s is not None for s in samplers):
            return _PerElement(samplers)
    raise ValueError("key must be an int seed, a torch.Generator, an object with an "
                     "indices(pair_ids, iteration, k, n, device) method, or a sequence of "
                     f"{N} of those; got {type(key).__name__}")


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (N, n[, c]) at idx (N, k) -> (N, k[, c]); differentiable in ``a``."""
    if a.dim() == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 1, idx[..., None].expand(idx.shape + a.shape[-1:]))


def _minibatch_system(T, idx, src, tgt, tgt_n, weight, nn_fn, *, icp_type,
                      loss_name, loss_metric, trim_dist, differentiable):
    """Mini-batch residuals -> (H (N, 6, 6), g (N, 6), cost (N,)) at poses T.

    H is the mini-batch J^T W J (used by the 'gn' rule only); g is the IRLS
    gradient J^T W e shared by every rule; all three are normalised by
    max(sum w, 1e-10).  ``nn_fn(p) -> (nn_idx, valid or None)`` supplies the
    correspondences, computed without gradient."""
    dt = src.dtype
    N, k = idx.shape
    p0 = _gather(src, idx)                                # (N, k, 3)
    w0 = _gather(weight, idx)                             # (N, k)
    R, t = T[:, :3, :3], T[:, :3, 3]
    p = p0 @ R.transpose(-1, -2) + t[:, None, :]

    nn, valid = nn_fn(p)
    if valid is not None:
        w0 = w0 * valid.to(dt)
    nn = nn.long()
    q = _gather(tgt, nn)
    r3 = p - q                                            # (N, k, 3)

    if icp_type == "pt2pl":
        n_q = _gather(tgt_n, nn)
        e = torch.sum(r3 * n_q, dim=-1)                   # (N, k)
        loss_err = e[..., None]
    else:
        e = r3
        loss_err = r3

    w = w0
    if trim_dist is not None:
        w = w * losses.trim_weight(r3, trim_dist, differentiable)
    if loss_name is not None:
        w = w * losses.robust_weight(loss_name, loss_err, loss_metric, differentiable)

    if icp_type == "pt2pl":
        # J = n^T [I | -skew(p)] = [n | p x n]  ->  (N, k, 6)
        J = torch.cat([n_q, torch.linalg.cross(p, n_q, dim=-1)], dim=-1)
        He = torch.einsum("nki,nk,nkj->nij", J, w, J)
        g = torch.einsum("nki,nk->ni", J, w * e)
        cost = torch.sum(w * e * e, dim=-1)
    else:
        eye = torch.eye(3, dtype=dt, device=src.device).expand(N, k, 3, 3)
        Jr = torch.cat([eye, -se3.skew(p)], dim=-1)       # (N, k, 3, 6)
        He = torch.einsum("nkci,nk,nkcj->nij", Jr, w, Jr)
        g = torch.einsum("nkci,nkc->ni", Jr, w[..., None] * e)
        cost = torch.sum(w[..., None] * e * e, dim=(-2, -1))
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-10)
    return He / wsum[:, None, None], g / wsum[:, None], cost / wsum


def _step_delta(H, g, m1, m2, it: float, *, optimizer, lr, lr_decay, b1, b2, dt):
    """One update delta (N, 6) and the new Adam moments, for the chosen rule.
    The schedule's scalars are computed in ``dt`` on the host, as JAX does on
    its iteration counter: no device copy."""
    if optimizer == "gn":
        tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2] + H[..., 3, 3] + H[..., 4, 4] + H[..., 5, 5]
        lam = 1e-8 * tr / 6.0 + 1e-12
        eye = torch.eye(6, dtype=dt, device=H.device)
        return -solve_spd(H + lam[..., None, None] * eye, g), m1, m2
    it = torch.tensor(it, dtype=dt)
    lr_t = (lr / (1.0 + lr_decay * it)).item()
    if optimizer == "sgd":
        return -lr_t * g, m1, m2
    m1 = b1 * m1 + (1.0 - b1) * g
    m2 = b2 * m2 + (1.0 - b2) * g * g
    c1 = (1.0 - torch.pow(torch.tensor(b1, dtype=dt), it + 1.0)).item()
    c2 = (1.0 - torch.pow(torch.tensor(b2, dtype=dt), it + 1.0)).item()
    return -lr_t * (m1 / c1) / (torch.sqrt(m2 / c2) + 1e-8), m1, m2


def _dense_nn_fn(tgt):
    """Score-form 1-NN over every target point: argmin of |p|^2 + |t|^2 -
    2 p·t^T (the JAX module's form; a full-f32 matmul on the card)."""
    t = tgt.detach()
    t2 = torch.sum(t * t, dim=-1)[:, None, :]

    def nn_fn(p):
        with torch.no_grad():
            p = p.detach()
            d2 = torch.sum(p * p, dim=-1)[..., None] + t2 - 2.0 * (p @ t.transpose(-1, -2))
            return torch.argmin(d2, dim=-1), None
    return nn_fn


def _cluster_nn_fn(tgt, group, probes, fixup):
    """The cluster index built once per solve; each mini-batch is answered
    by the plain group scan (``fused=False``), uncertified queries past the
    fix-up left out through the validity weight."""
    index = build_cluster_index(tgt.detach(), group)

    def nn_fn(p):
        idx, _, cert = cluster_nn(index, p.detach(), probes=probes, use_pallas=False,
                                  fused=False, fixup=fixup)
        return idx, cert
    return nn_fn


def _solve(src, tgt, tgt_n, weight, T0, sampler, *, icp_type, loss_name, loss_metric,
           trim_dist, differentiable, minibatch, iterations, optimizer, lr, lr_decay,
           tolerance, ema_beta, patience, nn_method, cluster_group, cluster_probes,
           cluster_fixup):
    dt, device = src.dtype, src.device
    N, n = src.shape[0], src.shape[1]
    if nn_method == "cluster":
        nn_fn = _cluster_nn_fn(tgt, cluster_group, cluster_probes, cluster_fixup)
    else:
        nn_fn = _dense_nn_fn(tgt)
    pair_ids = list(range(N))

    T = T0
    m1 = torch.zeros((N, 6), dtype=dt, device=device)
    m2 = torch.zeros((N, 6), dtype=dt, device=device)
    streak = torch.zeros((N,), dtype=torch.int32, device=device)
    cost_ema = torch.full((N,), torch.inf, dtype=dt, device=device)
    done = torch.zeros((N,), dtype=torch.bool, device=device)
    num_it = torch.zeros((N,), dtype=dt, device=device)
    for it in range(iterations):
        if bool(torch.all(done)):
            break   # frozen elements would only carry forward
        # uniform with replacement, one stream per element and iteration
        idx = sampler.indices(pair_ids, it, minibatch, n, device).to(device=device,
                                                                     dtype=torch.int64)
        H, g, cost = _minibatch_system(
            T, idx, src, tgt, tgt_n, weight, nn_fn, icp_type=icp_type,
            loss_name=loss_name, loss_metric=loss_metric, trim_dist=trim_dist,
            differentiable=differentiable)
        delta, m1n, m2n = _step_delta(H, g, m1, m2, float(it), optimizer=optimizer, lr=lr,
                                      lr_decay=lr_decay, b1=0.9, b2=0.999, dt=dt)
        T_new = se3.vec2tran(delta) @ T
        # `patience` CONSECUTIVE sub-tolerance steps: one step can dip below
        # by mini-batch luck
        streak_new = torch.where(torch.linalg.vector_norm(delta.detach(), dim=-1) < tolerance,
                                 streak + 1, torch.zeros_like(streak))
        cost_new = cost if it == 0 else ema_beta * cost_ema + (1.0 - ema_beta) * cost
        below = streak_new >= patience
        # convergence freezing (batch == serial)
        T = torch.where(done[:, None, None], T, T_new)
        streak = torch.where(done, streak, streak_new)
        cost_ema = torch.where(done, cost_ema, cost_new)
        m1 = torch.where(done[:, None], m1, m1n)
        m2 = torch.where(done[:, None], m2, m2n)
        num_it = torch.where(below & (num_it == 0), torch.full_like(num_it, it + 1.0), num_it)
        done = done | below
    num_it = torch.where(num_it == 0, torch.full_like(num_it, float(iterations)), num_it)
    return T, num_it, done, cost_ema


def register_sgd(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    key,
    weight: Optional[torch.Tensor] = None,
    *,
    icp_type: str = "pt2pl",
    minibatch: int = 512,
    iterations: int = 100,
    optimizer: str = "gn",
    lr: float = 0.1,
    lr_decay: float = 0.05,
    loss_name: Optional[str] = "huber",
    loss_metric: float = 1.0,
    trim_dist: Optional[float] = None,
    tolerance: float = 1e-6,
    ema_beta: float = 0.9,
    patience: int = 3,
    differentiable: bool = False,
    k_normals: int = 16,
    nn_method: str = "auto",
    cluster_group: int = 128,
    cluster_probes: int = 16,
) -> SGDICPResult:
    """Batched stochastic mini-batch ICP: (N, n, 3), (N, m, 3|6), (N, 4, 4)
    tensors on one device.

    ``key`` is the mini-batch source (module docstring): reproducible under
    a fixed key, one independent stream per batch element.  ``target``
    columns 3:6 are the normals for pt2pl when present, otherwise they are
    estimated (:func:`estimate_normals` with ``k_normals``).  ``optimizer``:
    ``'gn'``, ``'sgd'`` (lr/(1 + decay·t)) or ``'adam'``.  The stopping
    rule is ``patience`` consecutive steps below ``tolerance``.
    ``nn_method``: 'dense', 'cluster' or 'auto' (cluster for targets of
    16384 points or more).  ``differentiable=True`` selects the smooth robust and trim weights;
    gradients flow through the gathered values."""
    if source.dim() != 3 or target.dim() != 3 or T_init.dim() != 3:
        raise ValueError("register_sgd expects batched (N, n, 3), (N, m, 3|6), (N, 4, 4)")
    if icp_type not in ("pt2pt", "pt2pl"):
        raise ValueError(f"icp_type must be pt2pt|pt2pl, got {icp_type}")
    if optimizer not in ("gn", "sgd", "adam"):
        raise ValueError(f"optimizer must be gn|sgd|adam, got {optimizer}")
    if nn_method not in ("auto", "dense", "cluster"):
        raise ValueError(f"nn_method must be auto|dense|cluster, got {nn_method}")
    if nn_method == "auto":
        # the full solver's threshold: cluster pruning pays on large targets
        nn_method = "cluster" if target.shape[1] >= 16384 else "dense"
    dt = source.dtype
    src = source[..., :3]
    tgt = target[..., :3].to(dt)
    N = src.shape[0]
    sampler = minibatch_sampler(key, N)
    if icp_type == "pt2pl":
        if target.shape[-1] >= 6:
            tgt_n = target[..., 3:6].to(dt)
        else:
            tgt_n = estimate_normals(tgt, k=k_normals)
    else:
        tgt_n = torch.zeros_like(tgt)
    if weight is None:
        weight = torch.ones(src.shape[:-1], dtype=dt, device=src.device)
    T, it, done, cost = _solve(
        src, tgt, tgt_n, weight.to(dt), T_init.to(dt), sampler, icp_type=icp_type,
        loss_name=loss_name, loss_metric=float(loss_metric),
        trim_dist=None if trim_dist is None else float(trim_dist),
        differentiable=differentiable, minibatch=int(minibatch), iterations=int(iterations),
        optimizer=optimizer, lr=float(lr), lr_decay=float(lr_decay),
        tolerance=float(tolerance), ema_beta=float(ema_beta), patience=int(patience),
        nn_method=nn_method, cluster_group=int(cluster_group),
        cluster_probes=int(cluster_probes),
        cluster_fixup=min(int(minibatch), max(64, int(minibatch) // 16)))
    return SGDICPResult(T=T, iterations=it, converged=done, cost=cost)


# The JAX package's ``register_sgd_jit`` is ``jax.jit(register_sgd)``; PyTorch
# runs eagerly, so the port's is :func:`register_sgd` itself.
register_sgd_jit = register_sgd
