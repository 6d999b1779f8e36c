"""The unrolled gradient as a captured program: the fixed trip that a
captured solve on which autograd records takes (``registration.
_run_fixed_trip``, JAX's ``_run_scan``), forced on the CPU, where its
run-once steps become host checks.

Held to the host loop (``register`` uncaptured) bit for bit: values,
T, iterations, histories and the gradients into source, target, weight
and ``T_init``, over the ICP types, ``const_iter``, histories, ``remat``
and the dense and tiled tiers, with steps past the exit and a pair whose
residuals are exactly zero.  Held to ``jax.jit(jax.grad(...))`` of the
JAX package's ``register`` within 1e-10 in f64, hard NN and Gumbel with
JAX's key.  ``bench.unrolled_jit`` off the card equals ``bench.fwdbwd``
through ``register``."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.registration import register as jregister  # noqa: E402

from dicp_tpu_torch import ICP, ICPConfig, bench, knn, register, register_jit  # noqa: E402
from dicp_tpu_torch import registration  # noqa: E402
from dicp_tpu_torch.ops import tiled_knn  # noqa: E402

PROBE = np.linspace(0.5, 1.5, 16).reshape(4, 4)


def _capturing(monkeypatch, on: bool) -> None:
    """Solves take the branch of a capture (``on``): the fixed trip where
    autograd records, its run-once nodes then reading their flag on the
    host; or the host loop."""
    monkeypatch.setattr(registration, "capturing", lambda x=None: on)


def _inputs(source_np, target_np, icp_type, B=3):
    src = np.stack([source_np[:, :3] + o for o in (0.0, 0.05, -0.05)[:B]])
    if icp_type == "symmetric":
        src = np.concatenate([src, np.broadcast_to(target_np[:, 3:6], src.shape)], axis=-1)
    tgt = np.stack([target_np] * B)
    ti = np.stack([np.eye(4)] * B)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=src.shape[:2])
    return src, tgt, ti, w


def _value(res):
    return torch.sum(res.T * torch.as_tensor(PROBE)) + 0.01 * torch.sum(res.pc)


def _solve_and_grad(arrays, cfg, key=None, entry=register):
    leaves = [torch.as_tensor(a).clone().requires_grad_(True) for a in arrays]
    res = entry(*leaves, cfg=cfg, key=key)
    value = _value(res)
    grads = torch.autograd.grad(value, leaves)
    return res, value.detach(), grads


def _assert_equal(a, b):
    res_a, val_a, g_a = a
    res_b, val_b, g_b = b
    for name, x, y in zip(res_a._fields, res_a, res_b):
        assert torch.equal(x, y), name
    assert torch.equal(val_a, val_b)
    for name, x, y in zip(("source", "target", "T_init", "weight"), g_a, g_b):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name


CASES = list(itertools.product(("pt2pl", "pt2pt", "symmetric"), (False, True), (True, False),
                               (False, True)))


@pytest.mark.parametrize("icp_type,const_iter,histories,remat", CASES)
def test_fixed_trip_equals_host_loop(source_np, target_np, icp_type, const_iter, histories,
                                     remat, monkeypatch):
    """Bit for bit in every field and every gradient; the early-exit cases
    run steps past the exit (pt2pl converges in 6 of 8, symmetric's rows in
    3, 5 and 8)."""
    cfg = ICPConfig(icp_type=icp_type, max_iterations=8, tolerance=1e-4, differentiable=True,
                    dim=2 if icp_type == "pt2pl" else 3, trim_dist=5.0, loss_name="huber",
                    const_iter=const_iter, collect_histories=histories, remat=remat)
    arrays = _inputs(source_np, target_np, icp_type)
    host = _solve_and_grad(arrays, cfg)
    _capturing(monkeypatch, True)
    trip = _solve_and_grad(arrays, cfg)
    _assert_equal(host, trip)
    if icp_type == "pt2pl" and not const_iter:
        assert float(host[0].iterations.max()) < cfg.max_iterations


@pytest.mark.parametrize("icp_type", ["pt2pl", "pt2pt", "symmetric"])
def test_fixed_trip_on_the_tiled_tier(source_np, target_np, icp_type, monkeypatch):
    """The tiled tier (K1's plain version on the CPU): K1 runs once per
    executed step of the trip, none in a skipped step and none in the
    backward (it reuses the step's indices)."""
    cfg = ICPConfig(icp_type=icp_type, max_iterations=8, tolerance=1e-4, differentiable=True,
                    dim=3, trim_dist=5.0, loss_name="huber", nn_method="pallas")
    arrays = _inputs(source_np, target_np, icp_type)
    host = _solve_and_grad(arrays, cfg)
    calls = []
    search = tiled_knn.nn_indices
    monkeypatch.setattr(tiled_knn, "nn_indices", lambda *a: calls.append(1) or search(*a))
    _capturing(monkeypatch, True)
    trip = _solve_and_grad(arrays, cfg)
    _assert_equal(host, trip)
    assert len(calls) == int(host[0].iterations.max())


def test_exact_zero_residuals_stay_finite(target_np, monkeypatch):
    """A source that is its target's own points: every residual is exactly
    zero from the first step, which converges; the seven steps past it are
    skipped, and the gradients are finite and the host loop's."""
    tgt = np.stack([target_np] * 2)
    src = tgt[..., :3].copy()
    ti = np.stack([np.eye(4)] * 2)
    w = np.ones(src.shape[:2])
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=8, tolerance=1e-6, differentiable=True,
                    dim=3, trim_dist=5.0, loss_name="huber")
    _capturing(monkeypatch, True)
    trip = _solve_and_grad((src, tgt, ti, w), cfg)
    _capturing(monkeypatch, False)
    host = _solve_and_grad((src, tgt, ti, w), cfg)
    _assert_equal(host, trip)
    assert trip[0].iterations.tolist() == [1.0, 1.0]


def test_skipped_steps_draw_nothing(source_np, target_np, monkeypatch):
    """A Gumbel solve's fixed trip draws once per executed step forward and
    once more in its backward (the recomputed step), none in a skipped step;
    T, iterations, value and the source's gradient equal the host loop's
    bit for bit.  The target's gradient sums the step's two uses of the
    target inside the step before the trip adds it (the host loop adds
    them one by one): equal within rounding."""
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=8, tolerance=0.1, differentiable=True,
                    use_gumbel=True, gumbel_tau=0.01, dim=2, trim_dist=5.0, loss_name="huber")
    arrays = _inputs(source_np, target_np, "pt2pl")
    host = _solve_and_grad(arrays, cfg, key=7)
    draws = []
    draw = knn.threefry_uniform
    monkeypatch.setattr(knn, "threefry_uniform", lambda *a: draws.append(1) or draw(*a))
    _capturing(monkeypatch, True)
    trip = _solve_and_grad(arrays, cfg, key=7)
    executed = int(host[0].iterations.max())
    assert executed < cfg.max_iterations and len(draws) == 2 * executed
    for name, x, y in zip(host[0]._fields, host[0], trip[0]):
        assert torch.equal(x, y), name
    assert torch.equal(host[1], trip[1])
    assert torch.equal(host[2][0], trip[2][0])
    for g_h, g_t in zip(host[2][1:], trip[2][1:]):
        np.testing.assert_allclose(g_t.numpy(), g_h.numpy(), rtol=0, atol=1e-12)


def _jax_value_and_grads(arrays, cfg_kw, key):
    cfg = JConfig(**cfg_kw)

    def value(s, t, ti, w):
        res = jregister(s, t, ti, w, cfg=cfg, key=key)
        return jnp.sum(res.T * jnp.asarray(PROBE)) + 0.01 * jnp.sum(res.pc)

    fn = jax.jit(jax.value_and_grad(value, argnums=(0, 1, 2, 3)))
    val, grads = fn(*(jnp.asarray(a) for a in arrays))
    return np.asarray(val), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("nn", ["hard", "gumbel"])
def test_fixed_trip_matches_jax_jit_grad(source_np, target_np, nn, monkeypatch):
    """The fixed trip against jax.jit(jax.value_and_grad(...)) of JAX's
    register (its scan driver) in f64: the value and the gradients into
    source, target, T_init and weight within 1e-10; hard NN, and Gumbel
    with ``jax.random.key(s)`` against the port's ``key=s``."""
    cfg_kw = dict(icp_type="pt2pl", max_iterations=6, tolerance=1e-4, differentiable=True,
                  dim=2, trim_dist=5.0, loss_name="huber")
    key = None
    if nn == "gumbel":
        cfg_kw.update(use_gumbel=True, gumbel_tau=0.5)
        key = 5
    arrays = _inputs(source_np, target_np, "pt2pl")
    _capturing(monkeypatch, True)
    res, val, grads = _solve_and_grad(arrays, ICPConfig(**cfg_kw), key=key)
    jval, jgrads = _jax_value_and_grads(arrays, cfg_kw,
                                        None if key is None else jax.random.key(key))
    np.testing.assert_allclose(val.numpy(), jval, rtol=0, atol=1e-10)
    for name, g, jg in zip(("source", "target", "T_init", "weight"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-10, err_msg=name)
        assert np.abs(jg).max() > 0, name


def test_register_jit_and_icp_under_a_captured_grad(source_np, target_np, monkeypatch):
    """Inside a program that calls torch.autograd.grad, register_jit (an
    input that requires grad runs its function) and ICP.icp take the fixed
    trip; ICP.icp leaves its histories unsliced there, as JAX's does under
    tracing.  Their value and gradient equal the host loop's."""
    src, tgt, ti, _ = _inputs(source_np, target_np, "pt2pl")
    cfg = ICPConfig(**bench.HEAD).with_(max_iterations=8)
    _capturing(monkeypatch, True)
    s = torch.as_tensor(src).requires_grad_(True)
    res = register_jit(s, torch.as_tensor(tgt), torch.as_tensor(ti), None, cfg)
    g = torch.autograd.grad(res.T.sum(), s)[0]
    solver = ICP(icp_type="pt2pl", max_iterations=8, tolerance=1e-6, device="cpu")
    s2 = torch.as_tensor(src).requires_grad_(True)
    out = solver.icp(s2, tgt, ti, trim_dist=5.0, loss_fn={"name": "huber", "metric": 1.0},
                     dim=2)
    g2 = torch.autograd.grad(out["T"].sum(), s2)[0]
    assert out["costs"].shape[1] == 8
    _capturing(monkeypatch, False)
    s3 = torch.as_tensor(src).requires_grad_(True)
    host = register(s3, torch.as_tensor(tgt), torch.as_tensor(ti), None, cfg)
    g3 = torch.autograd.grad(host.T.sum(), s3)[0]
    assert float(host.iterations.max()) < 8
    assert torch.equal(res.T, host.T) and torch.equal(g, g3)
    assert torch.equal(out["T"], host.T) and torch.equal(g2, g3)


def test_unrolled_jit_off_the_card_equals_fwdbwd():
    """bench.unrolled_jit on CPU tensors runs its unit: bench.fwdbwd through
    register, bit for bit."""
    src, tgt, ti = bench.reference_batch(3, dtype=torch.float64, device="cpu")
    cfg = ICPConfig(**bench.HEAD).with_(max_iterations=8)
    want = bench.fwdbwd(register, cfg, src, tgt, ti)
    got = bench.unrolled_jit(src, tgt, ti, cfg)
    for name, a, b in zip(want[0]._fields, want[0], got[0]):
        assert torch.equal(a, b), name
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])
    assert bench.unrolled_jit.eager_reason(src, tgt, ti, cfg) == "no CUDA tensor"
