"""Second derivatives through the port's solves against the JAX package's:
each case a Hessian-vector product (HVP), the gradient of
sum_i <grad_i(loss), v_i> taken again, where the port takes
``torch.autograd.grad(..., create_graph=True)`` and then a second
``torch.autograd.grad`` and JAX takes ``jax.grad`` of ``jax.grad``.

f64 on the CPU; inputs and directions drawn from seeded numpy generators.
Every HVP is checked finite and nonzero.

* ``register_ift`` (the IFT backward differentiated again, through the
  saved fixed point): within 1e-10 x scale of JAX's, and within the
  first-order tests' 1e-6 x scale of the port's own unrolled HVP.
* ``register`` on the host loop and on the fixed trip of its capture
  (forced here by patching ``registration.capturing``: the run-once steps
  read their flags on the host), hard NN and Gumbel NN on JAX's key;
  ``register_gicp`` and ``register_sgd`` (JAX's key) on their forced trips:
  within 1e-10 (x scale where entries pass 1) of ``jax.jit`` of JAX's
  HVP, taken forward over reverse (``jax.jvp`` of ``jax.grad``: the same
  quantity, which reverse over reverse, the port's, meets only within
  rounding), whose solves run their ``lax.scan`` drivers.

The map-sharded and ring HVPs, and the sharded IFT's refusal, run on the
gloo world of ``tests/test_torch_parallel.py``; a double backward through a
program pair in ``tests/test_torch_jit_backward.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import gicp as jgicp  # noqa: E402
from dicp_tpu import sgd_icp as jsgd  # noqa: E402
from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ift import register_ift as jregister_ift  # noqa: E402
from dicp_tpu.registration import register as jregister  # noqa: E402

from dicp_tpu_torch import ICPConfig, gicp, register, register_ift, registration  # noqa: E402
from dicp_tpu_torch import sgd_icp  # noqa: E402

from tests.test_torch_unrolled_solvers import GICP_KW, _gicp_arrays, _sgd_arrays  # noqa: E402

PROBE = np.linspace(0.5, 1.5, 16).reshape(4, 4)
IFT = dict(icp_type="pt2pl", differentiable=True, max_iterations=60, tolerance=1e-12,
           dim=2, trim_dist=5.0, loss_metric=1.0)


def _directions(arrays, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(a)) for a in arrays]


def _hvp(solve, value, arrays, vs):
    """The port's HVP of value(solve(*leaves)) along ``vs``, one direction
    per array, every array differentiated."""
    leaves = [torch.as_tensor(a).clone().requires_grad_(True) for a in arrays]
    grads = torch.autograd.grad(value(solve(*leaves)), leaves, create_graph=True)
    inner = sum(torch.sum(g * torch.as_tensor(v)) for g, v in zip(grads, vs))
    return [h.numpy() for h in torch.autograd.grad(inner, leaves)]


def _jax_hvp(solve, value, arrays, vs, forward=True):
    """JAX's, under jax.jit: with ``forward``, jax.jvp of jax.grad along
    ``vs`` (forward over reverse: the same HVP, at a third of the compile
    time of reverse over reverse); else jax.grad of sum <jax.grad, v> (the
    IFT's custom_vjp admits no jax.jvp)."""
    argnums = tuple(range(len(arrays)))
    grad = jax.grad(lambda *a: value(solve(*a)), argnums=argnums)
    if forward:
        def fn(*a):
            return jax.jvp(grad, a, tuple(map(jnp.asarray, vs)))[1]
    else:
        fn = jax.grad(lambda *a: sum(jnp.sum(g * v) for g, v in zip(grad(*a), vs)),
                      argnums=argnums)
    return [np.asarray(h) for h in jax.jit(fn)(*map(jnp.asarray, arrays))]


def _live(hs):
    for h in hs:
        assert np.all(np.isfinite(h)) and np.abs(h).max() > 0
    return hs


def _close(ours, theirs, rel):
    for a, b in zip(ours, theirs):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _sum_T(res):
    return res.T.sum()


def _jsum_T(res):
    return jnp.sum(res.T)


def _value(res):
    return torch.sum(res.T * torch.as_tensor(PROBE)) + 0.01 * torch.sum(res.pc)


def _jvalue(res):
    return jnp.sum(res.T * jnp.asarray(PROBE)) + 0.01 * jnp.sum(res.pc)


@pytest.mark.parametrize("loss_name", ["huber", "cauchy", None])
def test_ift_hvp_2d(source_np, target_np, loss_name):
    """The 65-point pair, dim 2, with planar noise on the target (the fixed
    point balances nonzero residuals, so the weight's derivatives are no
    rounding noise): the HVP with respect to source, target and weight
    within 1e-10 x scale of JAX's and 1e-6 x scale of the port's unrolled
    HVP."""
    rng = np.random.default_rng(3)
    tgt = target_np.copy()
    tgt[:, :2] += rng.normal(scale=0.05, size=(tgt.shape[0], 2))
    metric = 0.5 if loss_name == "cauchy" else 1.0
    kw = {**IFT, "loss_name": loss_name, "loss_metric": metric}
    arrays = (source_np[None, :, :3], tgt[None], np.ones((1, 65)))
    ti = np.eye(4)[None]
    vs = _directions(arrays, 5)
    cfg = ICPConfig(**kw)

    def ours(entry):
        return _hvp(lambda s, t, w: entry(s, t, torch.as_tensor(ti), w, cfg), _sum_T, arrays, vs)

    got = _live(ours(register_ift))
    theirs = _jax_hvp(lambda s, t, w: jregister_ift(s, t, jnp.asarray(ti), w, JConfig(**kw)),
                      _jsum_T, arrays, vs, forward=False)
    _close(got, theirs, 1e-10)
    _close(got, ours(register), 1e-6)


def test_ift_hvp_3d_planes():
    """Three noisy planes of 60 points each, dim 3, moved by a twist: the
    HVP with respect to source and target within 1e-10 x scale of JAX's
    and 1e-6 x scale of the port's unrolled HVP."""
    rng = np.random.default_rng(0)
    normals = np.eye(3)[[2, 0, 1]]
    pts, nrms = [], []
    for k in range(3):
        uv = rng.uniform(-2, 2, size=(60, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (0.5 + k))
        nrms.append(np.tile(normals[k], (60, 1)))
    target = np.hstack([np.vstack(pts) + rng.normal(scale=0.01, size=(180, 3)),
                        np.vstack(nrms)])
    T_st = np.asarray(jse3.vec2tran(jnp.asarray([0.05, -0.04, 0.03, 0.02, -0.01, 0.03])))
    source = (np.vstack(pts) @ T_st[:3, :3].T + T_st[:3, 3])[None]
    arrays = (source, target[None])
    ti = np.eye(4)[None]
    kw = {**IFT, "dim": 3, "max_iterations": 80, "trim_dist": None, "loss_name": "huber"}
    cfg = ICPConfig(**kw)
    vs = _directions(arrays, 6)

    def ours(entry):
        return _hvp(lambda s, t: entry(s, t, torch.as_tensor(ti), None, cfg), _sum_T, arrays, vs)

    got = _live(ours(register_ift))
    theirs = _jax_hvp(lambda s, t: jregister_ift(s, t, jnp.asarray(ti), None, JConfig(**kw)),
                      _jsum_T, arrays, vs, forward=False)
    _close(got, theirs, 1e-10)
    _close(got, ours(register), 1e-6)


def _batch(source_np, target_np):
    src = np.stack([source_np[:, :3] + o for o in (0.0, 0.05, -0.05)])
    tgt = np.stack([target_np] * 3)
    ti = np.stack([np.eye(4)] * 3)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=src.shape[:2])
    return src, tgt, ti, w


@pytest.mark.parametrize("nn", ["hard", "gumbel"])
def test_register_hvp_host_loop_and_fixed_trip(source_np, target_np, nn, monkeypatch):
    """register's unrolled HVP with respect to source, target, T_init and
    weight, on the host loop and on the forced fixed trip (the steps' VJPs
    differentiated again, a skipped step passing its cotangents through),
    each within 1e-10 of jax.jit of JAX's second-order function; Gumbel NN
    with the port's key=5 against jax.random.key(5)."""
    kw = dict(icp_type="pt2pl", max_iterations=6, tolerance=1e-4, differentiable=True,
              dim=2, trim_dist=5.0, loss_name="huber")
    key = None
    if nn == "gumbel":
        kw.update(use_gumbel=True, gumbel_tau=0.5)
        key = 5
    arrays = _batch(source_np, target_np)
    vs = _directions(arrays, 7)
    jkey = None if key is None else jax.random.key(key)
    theirs = _jax_hvp(lambda *a: jregister(*a, cfg=JConfig(**kw), key=jkey), _jvalue, arrays, vs)
    cfg = ICPConfig(**kw)
    for trip in (False, True):
        monkeypatch.setattr(registration, "capturing", lambda x=None, on=trip: on)
        got = _live(_hvp(lambda *a: register(*a, cfg=cfg, key=key), _value, arrays, vs))
        for name, a, b in zip(("source", "target", "T_init", "weight"), got, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=f"{name}, trip {trip}")


def _gicp_sgd_value(res):
    return torch.sum(res.T * torch.as_tensor(PROBE)) + 0.1 * torch.sum(res.cost)


def _jgicp_sgd_value(res):
    return jnp.sum(res.T * jnp.asarray(PROBE)) + 0.1 * jnp.sum(res.cost)


def test_gicp_hvp_fixed_trip(monkeypatch):
    """GICP's forced fixed trip (two saddle pairs, each converging at its
    own step): the HVP with respect to source, target (with its normals)
    and weight within 1e-10 x scale of jax.jit of JAX's (its entries reach
    ~750)."""
    arrays, src_n = _gicp_arrays()
    arrays = (arrays[0], arrays[1], arrays[3])
    ti = np.broadcast_to(np.eye(4), (2, 4, 4)).copy()
    vs = _directions(arrays, 8)
    monkeypatch.setattr(gicp, "capturing", lambda x=None: True)
    got = _live(_hvp(lambda s, t, w: gicp.register_gicp(
        s, t, torch.as_tensor(ti), w, source_normals=torch.as_tensor(src_n), **GICP_KW),
        _gicp_sgd_value, arrays, vs))
    theirs = _jax_hvp(lambda s, t, w: jgicp.register_gicp(
        s, t, jnp.asarray(ti), w, source_normals=jnp.asarray(src_n), **GICP_KW),
        _jgicp_sgd_value, arrays, vs)
    _close(got, theirs, 1e-10)


def test_sgd_hvp_fixed_trip(monkeypatch):
    """SGD-ICP's forced fixed trip, drawing JAX's mini-batches from the int
    seed 3 (JAX: jax.random.key(3)) in the step and again in its recomputed
    VJPs: the HVP with respect to source, target and weight within 1e-10 x
    scale of jax.jit of JAX's.  The source carries noise: on the exact pair
    the solve reaches residuals of ~1e-16, where the trim gate's |e| has a
    second derivative of ~1e16 and rounding alone decides the HVP (JAX's
    and the port's then differ by 6% in one step)."""
    src, tgt, ti, w = _sgd_arrays(200)
    src = src + np.random.default_rng(4).normal(scale=0.01, size=src.shape)
    arrays = (src, tgt, w)
    kw = dict(minibatch=64, iterations=6, tolerance=2e-3, patience=2, differentiable=True,
              trim_dist=1.0, optimizer="gn", nn_method="dense")
    vs = _directions(arrays, 9)
    monkeypatch.setattr(sgd_icp, "capturing", lambda x=None: True)
    got = _live(_hvp(lambda s, t, w_: sgd_icp.register_sgd(s, t, torch.as_tensor(ti), 3, w_,
                                                           **kw),
                     _gicp_sgd_value, arrays, vs))
    theirs = _jax_hvp(lambda s, t, w_: jsgd.register_sgd(s, t, jnp.asarray(ti),
                                                         jax.random.key(3), w_, **kw),
                      _jgicp_sgd_value, arrays, vs)
    _close(got, theirs, 1e-10)
