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
  every element is frozen: frozen elements would only carry forward, so the
  results are those of the full trip.  The loop is a masked body over a
  state held in tensors, run by :func:`jit.device_while` (a CUDA graph
  WHILE node in :data:`register_sgd_jit`'s captured program, a host loop
  that reads the flag once per iteration in :func:`register_sgd`); a
  captured solve on which autograd records takes a fixed trip of
  ``iterations`` autograd steps instead (:mod:`dicp_tpu_torch.fixed_trip`,
  JAX's scan), since a WHILE node would record one step;
* the mini-batch search is a dense (k, m) score-form pass
  |p|^2 + |t|^2 - 2 p·t^T, or the Hilbert cluster index built once per solve
  and queried with the plain group scan (``fused=False``, as JAX pins it:
  no kernel), uncertified queries past the fix-up dropped through the weight;
* gradients (``differentiable=True``) flow through the gathered source
  points, the smooth robust weights and the solves, never through the
  neighbour indices (hard-NN semantics).

Random draws.  ``key`` takes JAX's key forms and draws JAX's mini-batches:
element i of the batch draws ``randint(fold_in(key_i, it), (k,), 0, n)`` at
iteration ``it`` (int64, x64 on), on the tensors' device, at the loop's own
executed-iteration counter (:func:`knn.threefry_randint`: the kernel D2 on
the card), so nothing is drawn on the host.  The element keys are those
of JAX's ``_per_element_keys`` (:func:`knn.element_keys`): an int seed is
``jax.random.PRNGKey(seed)`` (a ``torch.Generator`` is read once for such
a seed) and (2,) uint32 key data (``jax.random.key_data(k)``, or a tensor)
is one key, each split N ways; (N, 2) key data is N element keys used as
they are; a sequence of N single keys gives one element key each.

The explicit sources stay: an object with

    indices(pair_ids, iteration, k, n, device) -> (len(pair_ids), k) int64

drawing uniformly from [0, n) with replacement (:class:`SeededSampler`, one
``torch.Generator`` per (batch element, iteration) stream; a test serves
JAX's own draws through it), or a sequence of N of those.  Their draws are
made ahead, on the host's request, before the loop: one ``indices`` call
per iteration for the whole trip (:func:`plan_solve`), indexed by the
loop's counter; iterations after the loop stops are drawn and never read.

The step-size schedule of the ``'sgd'`` and ``'adam'`` rules is computed on
the host in the solve's dtype (as JAX computes it on its iteration
counter) and read at the counter.  An :class:`SGDPlan` (the element keys
or the drawn indices, and the schedule) given as ``key`` is used as it is;
:data:`register_sgd_jit` and :func:`mapping.map_step` make it outside
their programs, so that a key's value never enters a program's cache key.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import torch

from dicp_tpu_torch import fixed_trip, knn, losses, se3
from dicp_tpu_torch.jit import capturing, device_while, jit, records
from dicp_tpu_torch.ops.cluster_knn import build_cluster_index, cluster_nn
from dicp_tpu_torch.ops.normals import estimate_normals
from dicp_tpu_torch.ops.smallsolve import solve_spd


class SGDICPResult(NamedTuple):
    T: torch.Tensor            # (N, 4, 4) source -> target
    iterations: torch.Tensor   # (N,) float: the iteration the streak crossed
    converged: torch.Tensor    # (N,) bool
    cost: torch.Tensor         # (N,) EMA of the mini-batch robust cost


class SGDPlan(NamedTuple):
    """What the host prepares for a solve (:func:`plan_solve`): the element
    keys the loop draws from, or the indices of an explicit source drawn
    ahead; and the schedule."""
    indices: Optional[torch.Tensor]   # (iterations, N, minibatch) int64; None with keys
    schedule: Optional[torch.Tensor]  # (iterations, 3) [lr_t, c1, c2]; None for 'gn'
    keys: Optional[torch.Tensor] = None   # (N, 2) int32 element key words


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


def minibatch_sampler(key, N: int):
    """The explicit mini-batch source of an N-element solve: an object with
    ``indices(...)``, or a sequence of N of those (one per element)."""
    if callable(getattr(key, "indices", None)):
        return key
    if isinstance(key, (list, tuple)) and len(key) == N and all(
            callable(getattr(k, "indices", None)) for k in key):
        return _PerElement(key)
    raise ValueError("key must be an int seed, a torch.Generator, (2,) or (N, 2) uint32 key "
                     "data, a sequence of N single keys, an object with an indices(pair_ids, "
                     f"iteration, k, n, device) method, or a sequence of {N} of those; got "
                     f"{type(key).__name__}")


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


def _schedule_row(it: float, *, lr, lr_decay, b1, b2, dt) -> list:
    """[lr_t, c1, c2] of iteration ``it``: computed in ``dt`` on the host, as
    JAX computes them on its iteration counter (the card's ``pow`` would
    give other bits)."""
    it = torch.tensor(it, dtype=dt)
    lr_t = (lr / (1.0 + lr_decay * it)).item()
    c1 = (1.0 - torch.pow(torch.tensor(b1, dtype=dt), it + 1.0)).item()
    c2 = (1.0 - torch.pow(torch.tensor(b2, dtype=dt), it + 1.0)).item()
    return [lr_t, c1, c2]


def _schedule(iterations: int, *, optimizer, lr, lr_decay, b1, b2, dt) -> Optional[torch.Tensor]:
    """(iterations, 3) rows of :func:`_schedule_row`; None for ``'gn'``."""
    if optimizer == "gn":
        return None
    rows = [_schedule_row(float(k), lr=lr, lr_decay=lr_decay, b1=b1, b2=b2, dt=dt)
            for k in range(iterations)]
    return torch.tensor(rows, dtype=dt).reshape(iterations, 3)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) with the value of the nearest float, as the card's ``sqrt``
    and JAX's give it.  torch's CPU ``sqrt`` (a vector library's) leaves
    about 0.7% of f32 results one ulp off; there the value is that of the
    f64 sqrt rounded to f32, which is the nearest (53 >= 2 * 24 + 2 bits:
    the double rounding is exact).  Only the value matches the card: the
    gradient stays that of the CPU's f32 ``sqrt``."""
    y = torch.sqrt(x)
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return y
    # one ulp or none, exact; 0 where y is inf or nan
    return y + (torch.sqrt(x.double()).float() - y).nan_to_num(0.0).detach()


def _step_delta(H, g, m1, m2, it, *, optimizer, lr, lr_decay, b1, b2, dt, sched=None):
    """One update delta (N, 6) and the new Adam moments, for the chosen rule.
    ``sched``: this iteration's [lr_t, c1, c2] as a tensor (the loop's,
    indexed on the device); by default computed from ``it`` on the host."""
    if optimizer == "gn":
        tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2] + H[..., 3, 3] + H[..., 4, 4] + H[..., 5, 5]
        lam = 1e-8 * tr / 6.0 + 1e-12
        eye = torch.eye(6, dtype=dt, device=H.device)
        return -solve_spd(H + lam[..., None, None] * eye, g), m1, m2
    if sched is None:
        lr_t, c1, c2 = _schedule_row(it, lr=lr, lr_decay=lr_decay, b1=b1, b2=b2, dt=dt)
    else:
        lr_t, c1, c2 = sched[0], sched[1], sched[2]
    if optimizer == "sgd":
        return -lr_t * g, m1, m2
    m1 = b1 * m1 + (1.0 - b1) * g
    m2 = b2 * m2 + (1.0 - b2) * g * g
    return -lr_t * (m1 / c1) / (_sqrt_rn(m2 / c2) + 1e-8), m1, m2


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


class _Rule(NamedTuple):
    """The options of one solve's iterations."""
    icp_type: str
    loss_name: Optional[str]
    loss_metric: float
    trim_dist: Optional[float]
    differentiable: bool
    iterations: int
    optimizer: str
    tolerance: float
    ema_beta: float
    patience: int


class _Draws:
    """What an iteration reads at its executed-iteration counter: the
    mini-batch indices, uniform with replacement, one stream per element
    and iteration (drawn on the device from the plan's element keys, or
    read from its indices drawn ahead), and the schedule row."""

    def __init__(self, plan: SGDPlan, iterations: int, minibatch: int, n: int):
        self.plan, self.iterations, self.minibatch, self.n = plan, iterations, minibatch, n
        if plan.keys is not None:
            # the draw's key words, contiguous once for every iteration
            self.k1, self.k2 = (w.contiguous() for w in plan.keys.unbind(1))

    def at(self, count):
        row = torch.clamp(count, max=max(self.iterations - 1, 0)).reshape(1).long()
        sched = (None if self.plan.schedule is None
                 else self.plan.schedule.index_select(0, row)[0])
        if self.plan.keys is None:
            return self.plan.indices.index_select(0, row)[0], sched
        return knn.threefry_randint(self.k1, self.k2, count, self.minibatch, self.n), sched


def _advance(s: dict, count, draws: _Draws, rule: _Rule, src, tgt, tgt_n, weight,
             nn_fn) -> dict:
    """The state (T, m1, m2, streak, cost_ema, done, num_it) after the
    iteration whose executed-iteration counter is ``count`` (0-dim int32):
    its draws and schedule row taken at ``count``, frozen elements carried
    forward."""
    dt = src.dtype
    idx, sched = draws.at(count)
    done = s["done"]
    H, g, cost = _minibatch_system(
        s["T"], idx, src, tgt, tgt_n, weight, nn_fn, icp_type=rule.icp_type,
        loss_name=rule.loss_name, loss_metric=rule.loss_metric, trim_dist=rule.trim_dist,
        differentiable=rule.differentiable)
    delta, m1n, m2n = _step_delta(H, g, s["m1"], s["m2"], None, optimizer=rule.optimizer,
                                  lr=None, lr_decay=None, b1=0.9, b2=0.999, dt=dt,
                                  sched=sched)
    T_new = se3.vec2tran(delta) @ s["T"]
    # `patience` CONSECUTIVE sub-tolerance steps: one step can dip below
    # by mini-batch luck
    streak_new = torch.where(torch.linalg.vector_norm(delta.detach(), dim=-1) < rule.tolerance,
                             s["streak"] + 1, torch.zeros_like(s["streak"]))
    cost_new = torch.where(count == 0, cost,
                           rule.ema_beta * s["cost_ema"] + (1.0 - rule.ema_beta) * cost)
    below = streak_new >= rule.patience
    # convergence freezing (batch == serial)
    return dict(T=torch.where(done[:, None, None], s["T"], T_new),
                m1=torch.where(done[:, None], s["m1"], m1n),
                m2=torch.where(done[:, None], s["m2"], m2n),
                streak=torch.where(done, s["streak"], streak_new),
                cost_ema=torch.where(done, s["cost_ema"], cost_new),
                done=done | below,
                num_it=torch.where(below & (s["num_it"] == 0), (count + 1).to(dt),
                                   s["num_it"]))


_ORDER = ("T", "m1", "m2", "cost_ema", "streak", "done", "num_it")


class _Trip(fixed_trip.Trip):
    """SGD-ICP's iterations in a fixed trip: inputs (src, tgt, tgt_n,
    weight), the carry of :data:`_ORDER` (T, the moments and the cost
    differentiable).  The draws are taken at the trip's executed-step
    counter (a recomputing backward draws the same bits again); the search
    is the mini-batch's 1-NN, saved as int32 indices beside the cluster
    tier's certificate gate."""

    n_inputs, n_grad = 4, 4

    def __init__(self, draws: _Draws, rule: _Rule, nn_fn, gated: bool):
        self.draws, self.rule, self.nn_fn, self.gated = draws, rule, nn_fn, gated

    def found(self, inputs):
        shape, device = (inputs[0].shape[0], self.draws.minibatch), inputs[0].device
        return [torch.zeros(shape, dtype=torch.int32, device=device),
                torch.zeros(shape, dtype=torch.bool, device=device) if self.gated else None]

    def search(self, p):
        return self.nn_fn(p)

    def step(self, inputs, carry, it, search):
        new = _advance(dict(zip(_ORDER, carry)), it, self.draws, self.rule, *inputs, search)
        return tuple(new[name] for name in _ORDER), ()


def _solve(src, tgt, tgt_n, weight, T0, plan: SGDPlan, *, icp_type, loss_name, loss_metric,
           trim_dist, differentiable, iterations, minibatch, optimizer, tolerance, ema_beta,
           patience, nn_method, cluster_group, cluster_probes, cluster_fixup):
    """The trip (:func:`_advance`): a masked body per iteration while
    ``count < iterations`` and an element is active (every field
    ``where(flag, new, old)``; where autograd records the loop, the state is
    rebound instead of overwritten).  A captured solve on which autograd
    records takes a fixed trip of ``iterations`` steps instead
    (:mod:`dicp_tpu_torch.fixed_trip`, JAX's ``lax.scan``), each skipped
    once every element is frozen."""
    dt, device = src.dtype, src.device
    N = src.shape[0]
    if nn_method == "cluster":
        nn_fn = _cluster_nn_fn(tgt, cluster_group, cluster_probes, cluster_fixup)
    else:
        nn_fn = _dense_nn_fn(tgt)
    rule = _Rule(icp_type, loss_name, loss_metric, trim_dist, differentiable, iterations,
                 optimizer, tolerance, ema_beta, patience)
    draws = _Draws(plan, iterations, minibatch, src.shape[1])

    # every field owns its storage: the body overwrites it in place
    s = dict(T=T0.clone(),
             m1=torch.zeros((N, 6), dtype=dt, device=device),
             m2=torch.zeros((N, 6), dtype=dt, device=device),
             streak=torch.zeros((N,), dtype=torch.int32, device=device),
             cost_ema=torch.full((N,), torch.inf, dtype=dt, device=device),
             done=torch.zeros((N,), dtype=torch.bool, device=device),
             num_it=torch.zeros((N,), dtype=dt, device=device))
    recorded = records((src, tgt, tgt_n, weight, T0))
    if recorded and capturing(src):
        # a WHILE node would record one body: the fixed trip records each step
        trip = _Trip(draws, rule, nn_fn, nn_method == "cluster")
        fields, _, _ = fixed_trip.run(trip, iterations, (src, tgt, tgt_n, weight),
                                      tuple(s[name] for name in _ORDER),
                                      lambda c: ~torch.all(c[_ORDER.index("done")]))
        s = dict(zip(_ORDER, fields))
    elif iterations > 0:
        count = torch.zeros((), dtype=torch.int32, device=device)
        flag = (count < iterations) & ~torch.all(s["done"])

        def body():
            new = _advance(s, count, draws, rule, src, tgt, tgt_n, weight, nn_fn)
            # masked: a body run after the flag fell changes no bit (the host
            # loop that autograd records runs the body only while the flag holds)
            for name, val in new.items():
                if recorded:
                    s[name] = val
                else:
                    s[name].copy_(torch.where(flag, val, s[name]))
            count.copy_(torch.where(flag, count + 1, count))
            flag.copy_((count < iterations) & ~torch.all(s["done"]))

        # uncaptured, or captured with nothing recorded: a WHILE node whose
        # body overwrites the state (the recorded host loop rebinds it instead)
        device_while(flag, body)
    num_it = torch.where(s["num_it"] == 0, float(iterations), s["num_it"])
    return s["T"], num_it, s["done"], s["cost_ema"]


def plan_solve(key, N: int, n: int, device, dtype, *, iterations: int, minibatch: int,
               optimizer: str = "gn", lr: float = 0.1, lr_decay: float = 0.05) -> SGDPlan:
    """The draws and schedule of an N-element solve over n source points on
    ``device``: a key's (N, 2) element keys (:func:`knn.element_keys`), which
    the loop draws from; or an explicit source (:func:`minibatch_sampler`)
    asked once per iteration for the whole trip."""
    if isinstance(key, SGDPlan):
        return key
    keys, indices = knn.element_keys(key, N, device), None
    if keys is None:
        sampler = minibatch_sampler(key, N)
        pair_ids = list(range(N))
        draws = [sampler.indices(pair_ids, it, minibatch, n, device).to(device=device,
                                                                        dtype=torch.int64)
                 for it in range(iterations)]
        indices = (torch.stack(draws) if draws
                   else torch.zeros((0, N, minibatch), dtype=torch.int64, device=device))
    schedule = _schedule(iterations, optimizer=optimizer, lr=float(lr),
                         lr_decay=float(lr_decay), b1=0.9, b2=0.999, dt=dtype)
    if schedule is not None and torch.device(device).type == "cuda":
        # from pinned memory: the copy is enqueued, no host wait
        schedule = schedule.pin_memory().to(device, non_blocking=True)
    elif schedule is not None:
        schedule = schedule.to(device)
    return SGDPlan(indices, schedule, keys)


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

    ``key`` seeds the mini-batch sampling, one independent stream per batch
    element, as in JAX (module docstring): an int seed (``PRNGKey(seed)``),
    a ``torch.Generator`` (read once for a seed), (2,) uint32 key data
    (``jax.random.key_data(k)``; split N ways), (N, 2) key data (one key per
    element), a sequence of N single keys; an explicit source (an object
    with ``indices(...)``, or a sequence of N); or an :class:`SGDPlan` made
    for this solve by :func:`plan_solve`.  A key draws JAX's mini-batches
    on the tensors' device; the results are reproducible under it.  ``target``
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
    N, n = src.shape[0], src.shape[1]
    plan = plan_solve(key, N, n, src.device, dt, iterations=int(iterations),
                      minibatch=int(minibatch), optimizer=optimizer, lr=lr, lr_decay=lr_decay)
    drawn = (tuple(plan.keys.shape) == (N, 2) if plan.keys is not None
             else tuple(plan.indices.shape) == (int(iterations), N, int(minibatch)))
    if not drawn or (plan.schedule is None) != (optimizer == "gn"):
        raise ValueError(f"an SGDPlan for this solve holds ({N}, 2) element keys or "
                         f"({iterations}, {N}, {minibatch}) indices, and "
                         f"{'no' if optimizer == 'gn' else 'a'} schedule")
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
        src, tgt, tgt_n, weight.to(dt), T_init.to(dt), plan, icp_type=icp_type,
        loss_name=loss_name, loss_metric=float(loss_metric),
        trim_dist=None if trim_dist is None else float(trim_dist),
        differentiable=differentiable, iterations=int(iterations),
        minibatch=int(minibatch), optimizer=optimizer,
        tolerance=float(tolerance), ema_beta=float(ema_beta), patience=int(patience),
        nn_method=nn_method, cluster_group=int(cluster_group),
        cluster_probes=int(cluster_probes),
        cluster_fixup=min(int(minibatch), max(64, int(minibatch) // 16)))
    return SGDICPResult(T=T, iterations=it, converged=done, cost=cost)


def _plan_arguments(a: dict) -> None:
    """``register_sgd_jit``'s host work: ``key`` becomes the solve's plan
    (a key its element keys, made on the device by fills)."""
    src = a["source"]
    a["key"] = plan_solve(a["key"], src.shape[0], src.shape[1], src.device, src.dtype,
                          iterations=int(a["iterations"]), minibatch=int(a["minibatch"]),
                          optimizer=a["optimizer"], lr=a["lr"], lr_decay=a["lr_decay"])


# The JAX package's ``register_sgd_jit`` is ``jax.jit(register_sgd)`` with every
# option static: on the card the port's is a captured CUDA graph whose loop is
# a WHILE node (see dicp_tpu_torch.jit) that draws the mini-batches from the
# plan's element keys (D2 at the loop's counter), or reads those an explicit
# source drew before the call; on the CPU it is register_sgd itself.
register_sgd_jit = jit(register_sgd, static_argnames=(
    "icp_type", "minibatch", "iterations", "optimizer", "lr", "lr_decay", "loss_name",
    "loss_metric", "trim_dist", "tolerance", "ema_beta", "patience", "differentiable",
    "k_normals", "nn_method", "cluster_group", "cluster_probes"),
    prepare=_plan_arguments, name="register_sgd_jit")
