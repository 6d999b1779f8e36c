"""The port's closed-form pt2pt ICP (``dicp_tpu_torch.svd_icp``) against the
JAX package's, f64 on the CPU: the SVD cases of ``tests/test_icp.py`` run
on the port, and ``_kabsch`` and ``pt2pt_svd_icp`` are held to JAX's on
the same inputs."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dicp_tpu import svd_icp as jsvd  # noqa: E402

from dicp_tpu_torch import pt2pt_svd_icp, se3  # noqa: E402
from dicp_tpu_torch.svd_icp import _kabsch  # noqa: E402

from tests.conftest import DATA_DIR  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a))


def _truth():
    """The reference pair's truth: inv(vec2tran([1, 1, 0, 0, 0, 0.1]))."""
    return se3.tran_inv(se3.vec2tran(_t([1.0, 1.0, 0.0, 0.0, 0.0, 0.1])))


def _err_norm(T_true, T_pred):
    return float(torch.linalg.vector_norm(se3.tran2vec(T_true @ torch.linalg.inv(T_pred))))


@pytest.fixture(scope="module")
def pair():
    return (np.load(os.path.join(DATA_DIR, "points_scan.npy"))[:, :3],
            np.load(os.path.join(DATA_DIR, "points_map.npy"))[:, :3])


def test_pt2pt_svd(pair):
    source, target = pair
    res = pt2pt_svd_icp(_t(source), _t(target), max_iterations=200, tolerance=1e-18,
                        differentiable=False)
    assert res.T.shape == (4, 4)
    assert _err_norm(_truth(), res.T) < 1e-5
    np.testing.assert_allclose(res.pc.numpy(), target, atol=1e-4)


def test_pt2pt_svd_batched_and_diff(pair):
    source = _t(np.stack([pair[0]] * 3))
    target = _t(np.stack([pair[1]] * 3))
    res = pt2pt_svd_icp(source, target, max_iterations=100, tolerance=1e-16,
                        differentiable=True)
    for i in range(3):
        assert _err_norm(_truth(), res.T[i]) < 1e-4
    src = source.clone().requires_grad_(True)
    out = pt2pt_svd_icp(src, target, max_iterations=10, tolerance=1e-16, differentiable=True)
    (g,) = torch.autograd.grad(out.T.sum(), src)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_svd_degenerate_inputs_no_nan(pair):
    """All-trimmed and coincident clouds return finite transforms, not NaN."""
    src = _t(pair[0])
    res = pt2pt_svd_icp(src, src + 5.0, trim_dist=0.1, differentiable=False,
                        max_iterations=10)
    assert bool(torch.isfinite(res.T).all())
    # a negative trim is ignored (parity with the GN path)
    res2 = pt2pt_svd_icp(src, src, trim_dist=-1.0, differentiable=False, max_iterations=5)
    assert bool(torch.isfinite(res2.T).all())
    np.testing.assert_allclose(res2.T.numpy(), np.eye(4), atol=1e-6)


def test_svd_180_degree_alignment():
    rng = np.random.default_rng(0)
    p = _t(rng.normal(size=(1, 200, 3)))
    Rz = _t(np.diag([-1.0, -1.0, 1.0]))  # 180 deg about z
    C, r = _kabsch(p, p @ Rz.T, torch.ones((1, 200), dtype=torch.float64))
    np.testing.assert_allclose(C[0].numpy(), Rz.numpy(), atol=1e-6)
    np.testing.assert_allclose(r[0].numpy(), 0.0, atol=1e-8)


def test_svd_180_degree_blind_axes():
    """180-degree rotations about axes orthogonal to both [1,0,0,0] and
    [0,1,1,1]: the other vector-part seeds recover them."""
    rng = np.random.default_rng(1)
    p = _t(rng.normal(size=(1, 200, 3)))
    for u in ([1.0, -1.0, 0.0], [1.0, 0.0, -1.0], [0.0, 1.0, -1.0], [1.0, 1.0, -2.0]):
        u = np.asarray(u) / np.linalg.norm(u)
        R = _t(2.0 * np.outer(u, u) - np.eye(3))
        C, r = _kabsch(p, p @ R.T, torch.ones((1, 200), dtype=torch.float64))
        np.testing.assert_allclose(C[0].numpy(), R.numpy(), atol=1e-6, err_msg=f"axis {u}")
        np.testing.assert_allclose(r[0].numpy(), 0.0, atol=1e-8)


def _rotations(rng, count, deg):
    """``count`` rotation matrices of ``deg`` degrees about random axes."""
    out = []
    for _ in range(count):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        out.append(se3.exp_so3(_t(axis * np.deg2rad(deg))).numpy())
    return out


def _kabsch_both(p, q, w):
    C_j, r_j = jsvd._kabsch(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    C_t, r_t = _kabsch(_t(p), _t(q), _t(w))
    return (C_t.numpy(), r_t.numpy()), (np.asarray(C_j), np.asarray(r_j))


def test_kabsch_matches_jax():
    """Weighted noisy alignments by the increments ICP asks for (5 degrees),
    a 180-degree one, a blind-axis one and a degenerate (all-zero weight)
    element in one batch: within 1e-12 of JAX."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(6, 50, 3))
    q = np.empty_like(p)
    for i, R in enumerate(_rotations(rng, 3, 5.0)):
        q[i] = p[i] @ R.T + rng.normal(size=3) + rng.normal(scale=0.01, size=(50, 3))
    q[3] = p[3] @ np.diag([-1.0, -1.0, 1.0])
    u = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    q[4] = p[4] @ (2.0 * np.outer(u, u) - np.eye(3)).T
    q[5] = p[5]
    w = rng.uniform(0.1, 1.0, size=(6, 50))
    w[5] = 0.0
    (C_t, r_t), (C_j, r_j) = _kabsch_both(p, q, w)
    np.testing.assert_allclose(C_t, C_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(C_t[5], np.eye(3))


def test_kabsch_large_noisy_rotations_match_jax():
    """Noisy 20-90 degree alignments.  Their 32 power-iteration steps stop
    short of convergence, and two seeds end with Rayleigh quotients that tie
    to rounding, so which one wins is decided by the last bits of the sums
    (their order differs between XLA and PyTorch), and the two answers differ
    by what is left unconverged: ~1e-9 here, in JAX as in the port.  With
    200 steps they agree to 1e-15."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(12, 50, 3))
    q = np.empty_like(p)
    for i, R in enumerate(_rotations(rng, 4, 20.0) + _rotations(rng, 4, 45.0)
                          + _rotations(rng, 4, 90.0)):
        q[i] = p[i] @ R.T + rng.normal(size=3) + rng.normal(scale=0.01, size=(50, 3))
    w = rng.uniform(0.1, 1.0, size=(12, 50))
    (C_t, r_t), (C_j, r_j) = _kabsch_both(p, q, w)
    np.testing.assert_allclose(C_t, C_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-7)
    C_j, r_j = jsvd._kabsch(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w), 200)
    C_t, r_t = _kabsch(_t(p), _t(q), _t(w), 200)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("differentiable, trim", [(False, None), (True, 2.0)])
def test_pt2pt_svd_icp_matches_jax(pair, differentiable, trim):
    """A batch of three moved copies of the reference pair, with prior
    weights: T, iterations and convergence as JAX's."""
    rng = np.random.default_rng(4)
    source = np.stack([pair[0]] * 3) + rng.normal(scale=0.01, size=(3,) + pair[0].shape)
    target = np.stack([pair[1]] * 3)
    T_init = np.stack([np.eye(4)] * 3)
    T_init[1, :3, 3] = [0.2, -0.1, 0.0]
    weight = rng.uniform(0.5, 1.0, size=source.shape[:2])
    kw = dict(max_iterations=40, tolerance=1e-10, trim_dist=trim,
              differentiable=differentiable)
    ref = jsvd.pt2pt_svd_icp(jnp.asarray(source), jnp.asarray(target), jnp.asarray(T_init),
                             jnp.asarray(weight), **kw)
    got = pt2pt_svd_icp(_t(source), _t(target), _t(T_init), _t(weight), **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.pc.numpy(), np.asarray(ref.pc), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
