"""GICP's and SGD-ICP's unrolled gradients as a captured program would run
them: the fixed trip (``dicp_tpu_torch.fixed_trip``, JAX's ``lax.scan``)
that a captured solve on which autograd records takes, forced on the CPU by
patching each module's ``capturing``; its run-once steps then read their
flags on the host.

Held to the host loop (the uncaptured solve, which autograd records) bit
for bit: T, iterations, convergence, cost and the gradients into source,
target (with its normals), weight and ``T_init``, with steps past the exit
and, for SGD, the cluster tier.  Held to ``jax.jit(jax.value_and_grad)`` of
the JAX package's ``register_gicp(differentiable=True)`` and
``register_sgd(differentiable=True)`` within 1e-10 in f64 (SGD on JAX's own
draws).  SVD-ICP's early exit raises under a recorded capture; Anderson
records nothing, captured or not."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import gicp as jgicp  # noqa: E402
from dicp_tpu import sgd_icp as jsgd  # noqa: E402

from dicp_tpu_torch import ICPConfig, anderson, gicp, register, registration  # noqa: E402
from dicp_tpu_torch import sgd_icp, svd_icp  # noqa: E402
from dicp_tpu_torch.ops.normals import estimate_normals  # noqa: E402

from tests.test_gicp import XI as XI_GICP  # noqa: E402
from tests.test_gicp import _pair as gicp_pair  # noqa: E402
from tests.test_sgd_icp import _pair as sgd_pair  # noqa: E402
from tests.test_torch_sgd_icp import JaxSampler  # noqa: E402

PROBE = np.linspace(0.5, 1.5, 16).reshape(4, 4)
KEY = 3


def _capturing(monkeypatch, module, on: bool = True) -> None:
    monkeypatch.setattr(module, "capturing", lambda x=None: on)


def _value(res):
    return torch.sum(res.T * torch.as_tensor(PROBE)) + 0.1 * torch.sum(res.cost)


def _solve_and_grad(entry, arrays, **kw):
    leaves = [torch.as_tensor(a).clone().requires_grad_(True) for a in arrays]
    res = entry(*leaves, **kw)
    value = _value(res)
    return res, value.detach(), torch.autograd.grad(value, leaves)


def _assert_equal(a, b, names):
    for name, x, y in zip(a[0]._fields, a[0], b[0]):
        assert torch.equal(x, y), name
    assert torch.equal(a[1], b[1])
    for name, x, y in zip(names, a[2], b[2]):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0, name


def _with_normals(tgt):
    """(N, m, 6): the target's points and their estimated normals."""
    return np.concatenate([tgt, estimate_normals(torch.as_tensor(tgt)).numpy()], axis=-1)


def _gicp_arrays():
    """Two saddle pairs with noise and prior weights: the target with its
    normals (6 columns), each element converging at its own step; and the
    source's normals."""
    rng = np.random.default_rng(7)
    srcs, tgts = [], []
    for b, xi in enumerate((XI_GICP, [-0.05, 0.04, -0.03, -0.02, 0.03, -0.02])):
        S, Tg, _, _ = gicp_pair(xi, n=90, seed=11 + b)
        srcs.append(np.asarray(S)[0] + rng.normal(scale=0.002, size=(90, 3)))
        tgts.append(np.asarray(Tg)[0])
    tgt6 = _with_normals(np.stack(tgts))
    ti = np.broadcast_to(np.eye(4), (2, 4, 4)).copy()
    w = rng.uniform(0.5, 1.5, size=(2, 90))
    src = np.stack(srcs)
    return (src, tgt6, ti, w), _with_normals(src)[..., 3:]


GICP_KW = dict(max_iterations=12, tolerance=1e-7, trim_dist=1.0, differentiable=True)
NAMES = ("source", "target", "T_init", "weight")


def test_gicp_fixed_trip_equals_host_loop_and_jax(monkeypatch):
    """Bit for bit to the host loop, steps past the exit included; within
    1e-10 of jax.jit(jax.value_and_grad) of JAX's scan driver."""
    arrays, src_n = _gicp_arrays()
    kw = dict(GICP_KW, source_normals=torch.as_tensor(src_n))
    host = _solve_and_grad(gicp.register_gicp, arrays, **kw)
    iters = host[0].iterations.tolist()
    assert max(iters) < GICP_KW["max_iterations"] and min(iters) < max(iters)
    _capturing(monkeypatch, gicp)
    trip = _solve_and_grad(gicp.register_gicp, arrays, **kw)
    _assert_equal(host, trip, NAMES)

    def value(s, t, ti, w):
        res = jgicp.register_gicp(s, t, ti, w, source_normals=jnp.asarray(src_n), **GICP_KW)
        return jnp.sum(res.T * jnp.asarray(PROBE)) + 0.1 * jnp.sum(res.cost)

    jval, jgrads = jax.jit(jax.value_and_grad(value, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, arrays))
    np.testing.assert_allclose(trip[1].numpy(), np.asarray(jval), rtol=0, atol=1e-10)
    for name, g, jg in zip(NAMES, trip[2], jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-10,
                                   err_msg=name)


def _sgd_arrays(n: int):
    S, Tg, Ti, _ = sgd_pair(n=n, seed=5)
    S, Tg = np.asarray(S), np.asarray(Tg)
    src = np.concatenate([S, S + 0.01], axis=0)
    tgt6 = _with_normals(np.concatenate([Tg, Tg], axis=0))
    ti = np.broadcast_to(np.eye(4), (2, 4, 4)).copy()
    w = np.random.default_rng(2).uniform(0.5, 1.5, size=(2, n))
    return src, tgt6, ti, w


SGD_CASES = {
    "gn dense": dict(optimizer="gn", nn_method="dense"),
    "adam dense": dict(optimizer="adam", nn_method="dense", lr=0.02),
    "gn cluster": dict(optimizer="gn", nn_method="cluster", cluster_group=32,
                       cluster_probes=2),
}


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_sgd_fixed_trip_equals_host_loop(case, monkeypatch):
    """Bit for bit to the host loop over 'gn' and 'adam' (the moments and
    the schedule read at the device counter) on the dense tier, and on the
    cluster tier, whose certificate gate the step saves beside the indices;
    the 'gn' trips run steps past the exit."""
    arrays = _sgd_arrays(300)
    kw = dict(minibatch=64, iterations=10, tolerance=2e-3, patience=2, differentiable=True,
              trim_dist=1.0, **SGD_CASES[case])
    keys = jax.random.split(jax.random.key(KEY), 2)
    host = _solve_and_grad(lambda *a, **k: sgd_icp.register_sgd(
        *a[:3], JaxSampler(keys), a[3], **k), arrays, **kw)
    if kw["optimizer"] == "gn":
        assert float(host[0].iterations.max()) < kw["iterations"]
    calls = []
    search = sgd_icp._minibatch_system
    monkeypatch.setattr(sgd_icp, "_minibatch_system",
                        lambda *a, **k: calls.append(1) or search(*a, **k))
    _capturing(monkeypatch, sgd_icp)
    trip = _solve_and_grad(lambda *a, **k: sgd_icp.register_sgd(
        *a[:3], JaxSampler(keys), a[3], **k), arrays, **kw)
    _assert_equal(host, trip, NAMES)
    # a step and its recomputed backward; none where every element is frozen
    assert len(calls) == 2 * int(host[0].iterations.max())


def test_sgd_fixed_trip_matches_jax(monkeypatch):
    """Within 1e-10 of jax.jit(jax.value_and_grad) of JAX's register_sgd on
    JAX's own draws (served through the sampler protocol)."""
    arrays = _sgd_arrays(300)
    kw = dict(minibatch=64, iterations=8, tolerance=2e-3, patience=2, differentiable=True,
              trim_dist=1.0, optimizer="gn", nn_method="dense")
    keys = jax.random.split(jax.random.key(KEY), 2)
    _capturing(monkeypatch, sgd_icp)
    trip = _solve_and_grad(lambda *a, **k: sgd_icp.register_sgd(
        *a[:3], JaxSampler(keys), a[3], **k), arrays, **kw)

    def value(s, t, ti, w):
        res = jsgd.register_sgd(s, t, ti, keys, w, **kw)
        return jnp.sum(res.T * jnp.asarray(PROBE)) + 0.1 * jnp.sum(res.cost)

    jval, jgrads = jax.jit(jax.value_and_grad(value, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, arrays))
    np.testing.assert_allclose(trip[1].numpy(), np.asarray(jval), rtol=0, atol=1e-10)
    for name, g, jg in zip(NAMES, trip[2], jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-10,
                                   err_msg=name)


def test_svd_early_exit_raises_under_a_recorded_capture(source_np, target_np, monkeypatch):
    """SVD-ICP's early exit (differentiable=False) under a capture on which
    autograd records raises and names differentiable=True, whose unrolled
    steps equal the uncaptured run in values and gradients."""
    src = torch.as_tensor(source_np[None, :, :3]).requires_grad_(True)
    tgt = torch.as_tensor(target_np[None, :, :3])
    ti = torch.eye(4, dtype=torch.float64)[None]
    kw = dict(max_iterations=6, tolerance=1e-10, trim_dist=5.0)
    host = svd_icp._svd_icp_impl(src, tgt, ti, None, differentiable=True, **kw)
    g_host = torch.autograd.grad(host.T.sum(), src)[0]
    _capturing(monkeypatch, svd_icp)
    with pytest.raises(ValueError, match="differentiable=True"):
        svd_icp._svd_icp_impl(src, tgt, ti, None, differentiable=False, **kw)
    with torch.no_grad():    # nothing records: the early exit is captured as it was
        svd_icp._svd_icp_impl(src, tgt, ti, None, differentiable=False, **kw)
    got = svd_icp._svd_icp_impl(src, tgt, ti, None, differentiable=True, **kw)
    assert torch.equal(got.T, host.T)
    assert torch.equal(torch.autograd.grad(got.T.sum(), src)[0], g_host)


def test_anderson_records_nothing_under_a_capture(source_np, target_np, monkeypatch):
    """Anderson under a forced capture with inputs that require grad equals
    its uncaptured run without grad, and its results carry no gradient
    (inference only, as JAX's while loop is)."""
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=10, tolerance=1e-8,
                    dim=2, trim_dist=5.0, loss_name="huber", anderson_m=3,
                    collect_histories=False)
    arrays = (source_np[None, :, :3], target_np[None], np.eye(4)[None])
    want = register(*(torch.as_tensor(a) for a in arrays), None, cfg)
    _capturing(monkeypatch, registration)
    leaves = [torch.as_tensor(a).clone().requires_grad_(True) for a in arrays]
    got = anderson.register_anderson(*leaves, None, cfg, m=3)
    via = register(*leaves, None, cfg)
    for res in (got, via):
        for name, x, y in zip(want._fields, want, res):
            assert torch.equal(x, y) and not y.requires_grad, name
