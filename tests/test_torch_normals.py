"""Parity of the PyTorch port's PCA normals (``dicp_tpu_torch.ops.normals``)
with ``dicp_tpu/ops/normals.py``: the closed-form 3x3 eigenvector, plane and
2-D contour normals, the k-NN backends and their tie order, the weighted
(cluster-candidate) normals on a curved surface, and scale invariance.  The
tests of tests/test_normals.py, each also held against the JAX function on
the same numpy inputs.

Tolerances: both packages run the same closed form in the same order, so
they differ only by libm (arccos, cos) and summation order, a few f64 ulps;
the eigenvector amplifies that by the inverse eigenvalue gap, hence 1e-9 on
unit vectors (1e-5 in f32).  Orientation is compared with the sign, from a
viewpoint off the surface (from the origin, a normal of the z ~ 0 surface
is nearly perpendicular to the view ray, and the sign is a coin toss).

The weighted normals sum 2,048 weighted moments per point in a matmul whose
order differs between the packages.  Where a point's kernel holds one other
point (a rank-1 covariance, two eigenvalues tied at 0) the normal is
undetermined and any rounding picks another; so 99.5% of the points are
held to the tolerance above, and in f32 (1e-6 rounding of the moments,
amplified by the gap) 99% to 1e-3."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu.ops import normals as jn  # noqa: E402

from dicp_tpu_torch.ops import normals as tn  # noqa: E402

# JAX's functions under one jit each: eager, every op compiles on its own
_jweighted = jax.jit(jn.estimate_normals_weighted)
_jnormals = jax.jit(jn.estimate_normals, static_argnames=("k", "method"))
_jnormals_2d = jax.jit(jn.estimate_normals_2d, static_argnames=("k",))
_jknn = jax.jit(jn.knn_indices, static_argnames=("k", "method", "cluster_probes"))
_jeigvec = jax.jit(jn.smallest_eigvec_sym3)
VIEW = np.array([0.0, 0.0, 10.0])  # above the test surfaces


def _agree(a, b, atol, share):
    """At least ``share`` of the unit vectors a, b agree to ``atol``."""
    close = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) <= atol
    assert close.mean() >= share, close.mean()


def _t(a):
    return torch.as_tensor(np.array(a))


def _angular_err(n_est, n_true):
    """Angle between unit vectors, sign-agnostic (degrees)."""
    cos = np.clip(np.abs(np.sum(np.asarray(n_est) * np.asarray(n_true), axis=-1)), 0, 1)
    return np.degrees(np.arccos(cos))


def test_smallest_eigvec_matches_eigh_and_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(128, 3, 3))
    a = m @ np.swapaxes(m, -1, -2)
    v = tn.smallest_eigvec_sym3(_t(a)).numpy()
    _, vecs = np.linalg.eigh(a)
    assert np.max(_angular_err(v, vecs[..., 0])) < 1e-4
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-9)
    np.testing.assert_allclose(v, np.asarray(_jeigvec(jnp.asarray(a))),
                               rtol=0, atol=1e-9)


def test_smallest_eigvec_degenerate():
    """Isotropic matrices fall back to +z, finite and unit, as in JAX."""
    a = np.broadcast_to(np.eye(3) * 2.5, (4, 3, 3))
    v = tn.smallest_eigvec_sym3(_t(a)).numpy()
    assert np.all(np.isfinite(v))
    np.testing.assert_array_equal(v, np.asarray(_jeigvec(jnp.asarray(a))))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0)


def test_plane_normals():
    """Noisy samples of a plane recover its normal, oriented toward the
    origin, and equal JAX's (dense k-NN backend)."""
    rng = np.random.default_rng(1)
    n_true = np.array([1.0, 2.0, -0.5])
    n_true /= np.linalg.norm(n_true)
    basis = np.linalg.svd(n_true[None])[2][1:]
    pts = rng.uniform(-5, 5, size=(400, 2)) @ basis + 10.0 * n_true
    pts += 0.005 * rng.normal(size=pts.shape)
    normals = tn.estimate_normals(_t(pts), k=12).numpy()
    assert np.percentile(_angular_err(normals, n_true[None]), 95) < 2.0
    assert np.all(np.sum(normals * (0.0 - pts), axis=-1) >= 0.0)
    np.testing.assert_allclose(normals, np.asarray(_jnormals(jnp.asarray(pts), k=12)),
                               rtol=0, atol=1e-9)


def test_normals_batched():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, size=(3, 64, 3))
    out = tn.estimate_normals(_t(pts), k=8)
    assert out.shape == (3, 64, 3) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(_jnormals(jnp.asarray(pts), k=8)),
                               rtol=0, atol=1e-9)
    for b in range(3):
        assert torch.equal(out[b], tn.estimate_normals(_t(pts[b]), k=8))


def test_2d_contour_normals(target_np):
    """Estimated in-plane contour normals agree with the map's stored ones
    and with JAX's."""
    est = tn.estimate_normals_2d(_t(target_np[:, :3]), k=4).numpy()
    assert np.allclose(est[:, 2], 0.0)
    assert np.median(_angular_err(est, target_np[:, 3:6])) < 10.0
    np.testing.assert_allclose(est, np.asarray(_jnormals_2d(jnp.asarray(target_np[:, :3]),
                                                                      k=4)),
                               rtol=0, atol=1e-9)


def test_knn_indices_self_first_and_stable_ties():
    """Self first; on duplicated points (exact ties) the lowest index comes
    first, as lax.top_k orders them; the cluster backend returns the same
    neighbours as the dense one and as JAX's."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3))
    idx = tn.knn_indices(_t(pts), 5)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(50))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(_jknn(jnp.asarray(pts), 5)))
    dup = np.concatenate([pts, pts, pts])
    idx = tn.knn_indices(_t(dup), 4).numpy()
    np.testing.assert_array_equal(idx, np.asarray(_jknn(jnp.asarray(dup), 4)))
    np.testing.assert_array_equal(idx[:50, :3], np.arange(50)[:, None] + [0, 50, 100])
    cloud = rng.uniform(-3, 3, size=(1500, 3))
    dense = tn.knn_indices(_t(cloud), 8, method="dense").numpy()
    clust = tn.knn_indices(_t(cloud), 8, method="cluster", cluster_probes=16).numpy()
    np.testing.assert_array_equal(clust, np.asarray(
        _jknn(jnp.asarray(cloud), 8, method="cluster", cluster_probes=16)))
    agree = (np.sort(clust, axis=1) == np.sort(dense, axis=1)).all(axis=1)
    assert agree.mean() > 0.9


def _surface(n, seed=3):
    """z = 0.3 sin(x) cos(y) and its analytic unit normals."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-3, 3, size=(n, 2))
    pts = np.column_stack([uv[:, 0], uv[:, 1], 0.3 * np.sin(uv[:, 0]) * np.cos(uv[:, 1])])
    gx = 0.3 * np.cos(uv[:, 0]) * np.cos(uv[:, 1])
    gy = -0.3 * np.sin(uv[:, 0]) * np.sin(uv[:, 1])
    true_n = np.column_stack([-gx, -gy, np.ones(n)])
    return pts, true_n / np.linalg.norm(true_n, axis=1, keepdims=True)


def test_weighted_normals_curved_surface():
    """The weighted (no k-NN) normals: within 2 deg of the analytic normals
    at the median, consistent with dense k-NN normals, equal to JAX's; the
    public dispatch batched; the cluster k-NN backend equal to JAX's."""
    pts, true_n = _surface(3000)
    nw = tn.estimate_normals_weighted(_t(pts)).numpy()
    np.testing.assert_allclose(np.linalg.norm(nw, axis=1), 1.0, atol=1e-6)
    dots = np.abs(np.sum(nw * true_n, axis=-1))
    assert np.median(dots) > np.cos(np.radians(2.0))
    assert dots.mean() > np.cos(np.radians(8.0))
    _agree(tn.estimate_normals_weighted(_t(pts), viewpoint=_t(VIEW)),
           _jweighted(jnp.asarray(pts), viewpoint=jnp.asarray(VIEW)), 1e-9, 0.995)
    nd = tn.estimate_normals(_t(pts), k=16, method="dense").numpy()
    assert np.median(np.abs(np.sum(nw * nd, axis=-1))) > np.cos(np.radians(3.0))
    nb = tn.estimate_normals(_t(np.stack([pts, pts])), method="weighted").numpy()
    assert nb.shape == (2, 3000, 3)
    np.testing.assert_array_equal(nb[0], nb[1])
    nc = tn.estimate_normals(_t(pts), k=12, viewpoint=_t(VIEW), method="cluster").numpy()
    np.testing.assert_allclose(nc, np.asarray(_jnormals(
        jnp.asarray(pts), k=12, viewpoint=jnp.asarray(VIEW), method="cluster")), rtol=0, atol=1e-9)
    assert np.median(_angular_err(nc, true_n)) < 2.0


def test_weighted_normals_f32_and_gradient():
    """f32 (the card's dtype) against JAX's f32 result, the same median
    error against the analytic normals; gradient reaches the points through
    the candidate gather, finite and nonzero."""
    pts, true_n = _surface(1500, seed=4)
    pts32 = pts.astype(np.float32)
    nw = tn.estimate_normals_weighted(_t(pts32), viewpoint=_t(VIEW.astype(np.float32)))
    nj = _jweighted(jnp.asarray(pts32), viewpoint=jnp.asarray(VIEW, jnp.float32))
    assert nw.dtype == torch.float32
    _agree(nw, nj, 1e-3, 0.99)
    assert abs(np.median(_angular_err(nw, true_n)) - np.median(_angular_err(nj, true_n))) < 0.01
    p = _t(pts).requires_grad_(True)
    (g,) = torch.autograd.grad(tn.estimate_normals_weighted(p)[:, 2].sum(), p)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


@pytest.mark.parametrize("shape", [(4, 6), (3, 5), (2, 128)])
def test_median_is_jnp_median(shape):
    """jnp.median of an even count is the mean of the two middle values
    (torch.median returns the lower one); NaN rows give NaN."""
    x = np.random.default_rng(5).normal(size=shape)
    x[0, 1] = np.nan
    np.testing.assert_array_equal(tn._median(_t(x)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=-1, keepdims=True)))


def test_eigvec_scale_invariant():
    """f32 cm-scale neighbourhoods in metre coordinates must not trip the
    degeneracy guard (the +z fallback); equal to JAX in f32."""
    rng = np.random.default_rng(0)
    n_true = np.array([0.0, 1.0, 1.0]) / np.sqrt(2)
    basis = np.linalg.svd(np.eye(3) - np.outer(n_true, n_true))[0][:, :2]
    for r in (0.002, 0.03, 5.0):
        uv = rng.uniform(-r, r, (64, 2)).astype(np.float32)
        pts = (uv @ basis.T).astype(np.float32)
        c = pts - pts.mean(0)
        cov = (c.T @ c / 64).astype(np.float32)
        v = tn.smallest_eigvec_sym3(_t(cov)).numpy()
        assert np.degrees(np.arccos(min(1.0, abs(float(v @ n_true))))) < 1.0, r
        np.testing.assert_allclose(v, np.asarray(_jeigvec(jnp.asarray(cov))),
                                   rtol=0, atol=1e-5)
