"""Parity of the port's solver on the cluster correspondence tier with the
JAX package's: ``register`` with ``nn_method='cluster'`` on both sides (the
JAX package's auto picks the cluster tier on a CPU for any size above the
dense tier, the port's does not), f64 on the CPU.

Both run the same non-kernel search path here (the XLA path in JAX, its
counterpart in the port), so the selected groups, the certificates and the
correspondences are identical and the iterates agree to f64 rounding: T to
1e-10, iterations, convergence and matched ratio exactly.  Few probes and a
small fix-up budget leave uncertified correspondences, so the certificate
gate is exercised."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.registration import register as jregister_eager  # noqa: E402
from dicp_tpu.registration import register_jit as jregister  # noqa: E402

from dicp_tpu_torch import ICPConfig, register  # noqa: E402

BASE = dict(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-10,
            dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0,
            nn_method="cluster", cluster_group=64)


def _t(a):
    return torch.as_tensor(np.array(a))


def _pairs(scene, count, seed):
    """``count`` (source, target) pairs: the scene with per-pair noise as the
    target, the scene with other noise, moved by a per-pair transform, as the
    source.  Independent noise keeps the final distances away from 0, where
    the certificate of a query inside a non-selected group's ball (bound 0)
    would hang on whether its d2 rounds to exactly 0."""
    rng = np.random.default_rng(seed)
    sources, targets = [], []
    for _ in range(count):
        tgt = scene.copy()
        tgt[:, :3] += rng.normal(scale=0.01, size=(len(scene), 3))
        pts = scene[:, :3] + rng.normal(scale=0.01, size=(len(scene), 3))
        xi = rng.uniform(-1, 1, size=6) * [0.2, 0.2, 0.2, 0.04, 0.04, 0.04]
        T = np.asarray(jse3.vec2tran(jnp.asarray(xi)))
        sources.append(pts @ T[:3, :3].T + T[:3, 3])
        targets.append(tgt)
    return np.stack(sources), np.stack(targets)


def _solve_both(src, tgt, **kw):
    cfg = {**BASE, **kw}
    ti = np.broadcast_to(np.eye(4), (len(src), 4, 4))
    res_j = jregister(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), None,
                      cfg=JConfig(**cfg))
    res_t = register(_t(src), _t(tgt), _t(ti), None, ICPConfig(**cfg))
    return res_j, res_t


def _assert_same(res_j, res_t):
    np.testing.assert_allclose(res_t.T.numpy(), np.asarray(res_j.T), rtol=0, atol=1e-10)
    for name in ("iterations", "converged", "matched_ratio"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)


@pytest.mark.parametrize("probes,fixup", [(4, 4), (16, None)])
def test_single_cloud_branch_matches_jax(planes_scene, probes, fixup):
    """One target cloud: the queries are curve-sorted once, at T_init."""
    src, tgt = _pairs(planes_scene, 1, seed=0)
    res_j, res_t = _solve_both(src, tgt, cluster_probes=probes, cluster_fixup=fixup)
    _assert_same(res_j, res_t)
    # the gate leaves uncertified correspondences out of the weights
    if fixup is not None:
        assert bool((res_t.weights == 0).any())


def test_batched_branch_matches_jax(planes_scene):
    """Several target clouds: the queries are re-sorted on every call."""
    src, tgt = _pairs(planes_scene, 3, seed=1)
    res_j, res_t = _solve_both(src, tgt, cluster_probes=4, cluster_fixup=4)
    _assert_same(res_j, res_t)
    assert bool(res_t.converged.all()) and bool((res_t.weights == 0).any())


def test_batch_chunk_matches_unchunked_and_jax(planes_scene):
    """Chunks of 2 over a batch of 3 (edge-padded to 4, as in JAX) equal the
    unchunked solve; chunks of 1 take the single-cloud branch in both
    packages."""
    src, tgt = _pairs(planes_scene, 3, seed=2)
    ti = _t(np.broadcast_to(np.eye(4), (3, 4, 4)))
    cfg = ICPConfig(**BASE, cluster_probes=4, cluster_fixup=4)
    whole = register(_t(src), _t(tgt), ti, None, cfg)
    chunked = register(_t(src), _t(tgt), ti, None, cfg.with_(batch_chunk=2))
    for a, b, name in zip(whole, chunked, whole._fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12, err_msg=name)
    res_j, res_t = _solve_both(src, tgt, cluster_probes=4, cluster_fixup=4, batch_chunk=1)
    _assert_same(res_j, res_t)


def test_gradients_match_jax_scan_driver(planes_scene):
    """Autograd of sum(T) through the cluster tier against jax.grad through
    the JAX scan driver: finite, nonzero, equal to 1e-8 (hard-NN semantics:
    the gradient flows through the gathered target rows only)."""
    src, tgt = _pairs(planes_scene, 1, seed=3)
    cfg = {**BASE, "differentiable": True, "max_iterations": 12, "cluster_probes": 4}
    ti = np.eye(4)[None]

    def loss_j(s, t):
        return jnp.sum(jregister_eager(s, t, jnp.asarray(ti), None, cfg=JConfig(**cfg)).T)

    gs_j, gt_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(src), jnp.asarray(tgt))
    s, t = _t(src).requires_grad_(True), _t(tgt).requires_grad_(True)
    res = register(s, t, _t(ti), None, ICPConfig(**cfg))
    gs, gt = torch.autograd.grad(res.T.sum(), (s, t))
    for g, g_j in ((gs, gs_j), (gt, gt_j)):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=1e-8)
