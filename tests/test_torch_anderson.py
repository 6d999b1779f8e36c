"""The port's Anderson-accelerated driver against the JAX package's,
mirroring ``tests/test_anderson.py``: the same fixed point as the plain
driver in fewer iterations on pt2pt, batch == serial, the safeguard, the
routing through ``register`` and the IFT forward.

f64 on the CPU.  Both packages run the same iteration arithmetic, so the
iteration counts are equal and T agrees to 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu.anderson import register_anderson_jit as jregister_anderson  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ift import register_ift as jregister_ift  # noqa: E402

from dicp_tpu_torch import ICPConfig, register, register_anderson, register_ift  # noqa: E402


def _kw(icp_type="pt2pt", dim=2, loss="huber", max_iterations=100):
    return dict(icp_type=icp_type, differentiable=False, driver="while",
                max_iterations=max_iterations, tolerance=1e-10, dim=dim, trim_dist=5.0,
                loss_name=loss, loss_metric=1.0, collect_histories=False)


@pytest.fixture
def pair(source_np, target_np):
    return source_np[None, :, :3], target_np[None], np.eye(4)[None]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _both(src, tgt, ti, kw, weight=None, **aa):
    res_t = register_anderson(_t(src), _t(tgt), _t(ti), None if weight is None else _t(weight),
                              ICPConfig(**kw), **aa)
    res_j = jregister_anderson(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti),
                               None if weight is None else jnp.asarray(weight),
                               cfg=JConfig(**kw), **aa)
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-12)
    for name in ("iterations", "converged"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)
    np.testing.assert_allclose(res_t.matched_ratio.numpy(), np.asarray(res_j.matched_ratio),
                               rtol=1e-12)
    np.testing.assert_allclose(res_t.costs.numpy(), np.asarray(res_j.costs), rtol=1e-9,
                               atol=1e-12)
    return res_t


@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_same_fixed_point_as_jax_and_the_plain_driver(pair, icp_type):
    """pt2pt: 25 -> 10 iterations (at most 0.6 of the plain driver's);
    pt2pl: at most 3 more.  Iterations and T equal JAX's."""
    src, tgt, ti = pair
    kw = _kw(icp_type)
    aa = _both(src, tgt, ti, kw)
    plain = register(_t(src), _t(tgt), _t(ti), None, ICPConfig(**kw))
    np.testing.assert_allclose(aa.T.numpy(), plain.T.numpy(), atol=1e-9)
    assert bool(aa.converged[0])
    if icp_type == "pt2pt":
        assert float(aa.iterations[0]) == 10.0 and float(plain.iterations[0]) == 25.0
        assert float(aa.iterations[0]) <= 0.6 * float(plain.iterations[0])
    else:
        assert float(aa.iterations[0]) <= float(plain.iterations[0]) + 3


def test_batch_equals_serial(pair):
    src, tgt, ti = pair
    kw = _kw("pt2pt")
    offs = [0.0, 0.3, -0.2]
    srcs = np.concatenate([src + o for o in offs])
    batch = _both(srcs, np.concatenate([tgt] * 3), np.concatenate([ti] * 3), kw)
    for i, o in enumerate(offs):
        solo = register_anderson(_t(src + o), _t(tgt), _t(ti), None, ICPConfig(**kw))
        np.testing.assert_allclose(batch.T[i].numpy(), solo.T[0].numpy(), atol=1e-12)
        assert float(batch.iterations[i]) == float(solo.iterations[0])


def test_3d_recovers_ground_truth():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(400, 3))
    pts[:, 2] = 0.3 * np.sin(pts[:, 0] * 2) + 0.2 * pts[:, 1] ** 2
    nrm = np.stack([-0.6 * np.cos(pts[:, 0] * 2), -0.4 * pts[:, 1], np.ones(400)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tgt = np.hstack([pts, nrm])[None]
    from dicp_tpu_torch import se3

    T_true = se3.vec2tran(torch.tensor([0.25, -0.2, 0.1, 0.05, -0.08, 0.3],
                                       dtype=torch.float64)).numpy()
    Ti = np.linalg.inv(T_true)
    src = (pts @ Ti[:3, :3].T + Ti[:3, 3])[None]
    for icp_type in ("pt2pt", "pt2pl"):
        aa = register_anderson(_t(src), _t(tgt), _t(np.eye(4)[None]), None,
                               ICPConfig(**_kw(icp_type, dim=3, loss="cauchy",
                                               max_iterations=200)))
        assert bool(aa.converged[0]), icp_type
        assert np.abs(aa.T[0].numpy() - T_true).max() < 1e-8, icp_type


def test_safeguard_far_initialization(pair):
    """A far initialization: the energy safeguard keeps AA convergent where
    plain ICP converges, to the same transform; equal to JAX's."""
    src, tgt, _ = pair
    T0 = np.eye(4)
    T0[:3, 3] = [1.5, -1.0, 0.0]
    kw = _kw("pt2pt", max_iterations=200)
    aa = _both(src, tgt, T0[None], kw)
    plain = register(_t(src), _t(tgt), _t(T0[None]), None, ICPConfig(**kw))
    assert bool(plain.converged[0]) and bool(aa.converged[0])
    np.testing.assert_allclose(aa.T.numpy(), plain.T.numpy(), atol=1e-8)


def test_differentiable_cfg_rejected(pair):
    src, tgt, ti = pair
    cfg = ICPConfig(icp_type="pt2pt", differentiable=True, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)
    with pytest.raises(ValueError, match="inference driver"):
        register_anderson(_t(src), _t(tgt), _t(ti), None, cfg)
    with pytest.raises(ValueError, match="batched"):
        register_anderson(_t(src[0]), _t(tgt), _t(ti), None, ICPConfig(**_kw()))


def test_ift_with_anderson_forward(pair):
    """anderson_m routes the IFT forward through the AA driver: same fixed
    point, fewer forward iterations, the same implicit gradient (and JAX's)."""
    src, tgt, ti = pair
    base = dict(_kw("pt2pt"), differentiable=True)
    grads, iters = {}, {}
    for m in (0, 4):
        cfg = ICPConfig(**base, anderson_m=m)
        s = _t(src).requires_grad_(True)
        res = register_ift(s, _t(tgt), _t(ti), None, cfg)
        iters[m] = float(res.iterations[0])
        grads[m] = torch.autograd.grad(res.T.sum(), s)[0]
    assert iters[4] < iters[0]
    g = grads[4]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    np.testing.assert_allclose(g.numpy(), grads[0].numpy(), rtol=1e-6, atol=1e-12)
    g_j = jax.grad(lambda a: jnp.sum(jregister_ift(
        a, jnp.asarray(tgt), jnp.asarray(ti), None, JConfig(**base, anderson_m=4)).T))(
            jnp.asarray(src))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-12)


def test_register_routes_anderson(pair):
    """register() with anderson_m > 0 runs the AA driver, without autograd."""
    src, tgt, ti = pair
    direct = register_anderson(_t(src), _t(tgt), _t(ti), None, ICPConfig(**_kw()))
    s = _t(src).requires_grad_(True)
    routed = register(s, _t(tgt), _t(ti), None, ICPConfig(**_kw(), anderson_m=4))
    assert torch.equal(routed.T, direct.T) and torch.equal(routed.iterations, direct.iterations)
    assert not routed.T.requires_grad


def test_weighted_and_stats(pair):
    src, tgt, ti = pair
    w = np.ones(src.shape[:2])
    w[:, :5] = 0.0
    aa = _both(src, tgt, ti, _kw("pt2pl"), weight=w)
    assert bool(aa.converged[0]) and float(aa.matched_ratio[0]) > 0.5
    assert bool(torch.isfinite(aa.pc).all())


def test_converging_step_is_applied(pair):
    """A tolerance the first step meets: the AA driver applies that step, as
    the plain driver does, and does not freeze at T_init."""
    src, tgt, ti = pair
    kw = dict(_kw("pt2pl", max_iterations=5), tolerance=10.0)
    plain = register(_t(src), _t(tgt), _t(ti), None, ICPConfig(**kw))
    aa = _both(src, tgt, ti, kw)
    assert float(aa.iterations[0]) == float(plain.iterations[0]) == 1.0
    np.testing.assert_allclose(aa.T.numpy(), plain.T.numpy(), atol=1e-12)
    assert not np.allclose(aa.T.numpy(), ti, atol=1e-6)


def test_costs_never_rejection_sentinel(pair):
    """costs are the last evaluated energy, never the rejection sentinel, also
    with an aggressive cap and a budget that ends unconverged."""
    src, tgt, ti = pair
    aa = _both(src, tgt, ti, _kw("pt2pt", max_iterations=3), cap=100.0)
    c = aa.costs.numpy()
    assert np.all(np.isfinite(c)) and np.all(c < 1e12)
