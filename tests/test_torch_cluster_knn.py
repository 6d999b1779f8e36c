"""Parity of the PyTorch port's cluster index and searches with the JAX
package (``dicp_tpu/ops/cluster_knn.py``, ``ops/pallas_cluster.py``): the
Hilbert keys and the built index, the plain (non-kernel) search path in f64,
the plain versions of the CUDA kernels K2, K5 and K3 against the Pallas
kernels in interpret mode, the certificate, the brute-force fix-up and its
tie rule, batch == serial, and an index carried across from JAX.  Same numpy
inputs, made from a seed, through both packages.

Small sizes (m of 1-3k, g of 32-64, 2-8 probes) leave many queries
uncertified, so the fix-up runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu.ops import cluster_knn as jck  # noqa: E402
from dicp_tpu.ops import pallas_cluster as jpc  # noqa: E402

from dicp_tpu_torch import convert  # noqa: E402
from dicp_tpu_torch.ops import cluster_knn as tck  # noqa: E402
from dicp_tpu_torch.ops import cluster_search  # noqa: E402

# a bound this large is a Pallas sentinel-padded center (pallas_cluster.py:223-231)
SENTINEL_BOUND = 1e29

# JAX's index functions under one jit each: eager, every op compiles on its own
_jbuild = jax.jit(jck.build_cluster_index, static_argnums=1)
_jbuild_batch = jax.jit(jax.vmap(jck.build_cluster_index, in_axes=(0, None)),
                        static_argnums=1)
_jhilbert = jax.jit(jck.hilbert_keys)
_jmorton = jax.jit(jck.morton_keys)
_jquery_order = jax.jit(jck.query_order)


def _blocks(index, x, probes):
    """The query blocks and selected groups cluster_nn hands its kernels."""
    xb, _, _ = jck._sorted_blocks(index, x, qblock=jck._FUSED_QBLOCK)
    return xb, jck._block_select(index, xb, probes)[0]


_jblocks = jax.jit(_blocks, static_argnums=2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _dense_nn(x, y):
    d2 = np.sum((np.asarray(x)[:, None, :] - np.asarray(y)[None, :, :]) ** 2, axis=-1)
    return np.argmin(d2, axis=1), np.min(d2, axis=1)


def _cloud(seed, m, n, scale=10.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (m, 3)).astype(dtype),
            rng.uniform(-scale, scale, (n, 3)).astype(dtype))


def _both_indexes(y, g):
    return _jbuild(jnp.asarray(y), g), tck.build_cluster_index(_t(y), g)


def _assert_index_equal(ij, it):
    """Keys decide the groups: points and order identical; the float
    summaries to rtol 1e-12 (f64 sums taken in another order)."""
    np.testing.assert_array_equal(it.points.numpy(), np.asarray(ij.points))
    np.testing.assert_array_equal(it.order.numpy(), np.asarray(ij.order))
    assert it.order.dtype == torch.int32 and it.frame.dtype == torch.float32
    for name in ("centers", "radius", "frame"):
        np.testing.assert_allclose(getattr(it, name).numpy(), np.asarray(getattr(ij, name)),
                                   rtol=1e-12, atol=0, err_msg=name)


# ---------------------------------------------------------------- keys and index

@pytest.mark.parametrize("m,g", [(2500, 64), (777, 128), (300, 32)])
def test_keys_and_index_match_jax(m, g):
    y, _ = _cloud(m, m, 1)
    y[:40] = y[40:80]  # duplicate points: equal keys, so the sort must be stable
    np.testing.assert_array_equal(tck.hilbert_keys(_t(y)).numpy(),
                                  np.asarray(_jhilbert(jnp.asarray(y))))
    np.testing.assert_array_equal(tck.morton_keys(_t(y)).numpy(),
                                  np.asarray(_jmorton(jnp.asarray(y))).astype(np.int64))
    ij, it = _both_indexes(y, g)
    _assert_index_equal(ij, it)
    assert it.points.shape == (-(-m // g), g, 3)
    # the query order in the index's frame
    x = _cloud(m + 1, 10, 400)[1] * 1.3
    np.testing.assert_array_equal(tck.query_order(it, _t(x)).numpy(),
                                  np.asarray(_jquery_order(ij, jnp.asarray(x))))


def test_batched_index_equals_vmap_build():
    y = np.stack([_cloud(s, 900, 1)[0] for s in range(3)])
    _assert_index_equal(_jbuild_batch(jnp.asarray(y), 64), tck.build_cluster_index(_t(y), 64))


def test_degenerate_cloud_index():
    """All points identical: the extent guard keeps the keys finite, every
    key is 0 and every radius 0, as in JAX."""
    y = np.ones((300, 3)) * 5.0
    ij, it = _both_indexes(y, 64)
    _assert_index_equal(ij, it)
    x = np.array([[5.0, 5.0, 5.0], [6.0, 5.0, 5.0]])
    idx, d2, cert = tck.cluster_nn(it, _t(x), probes=8)
    assert bool(cert.all()) and idx.max() < 300
    np.testing.assert_allclose(d2.numpy(), [0.0, 1.0], atol=1e-12)


# ---------------------------------------------------------------- plain search path, f64

@pytest.mark.parametrize("probes,fixup", [(4, 0), (4, 1000), (8, 200)])
def test_cluster_nn_matches_jax(probes, fixup):
    """The non-kernel path (fused=False, JAX's path on the CPU): idx and cert
    identical, d2 to rtol 1e-12 (f64 sums in another order)."""
    y, x = _cloud(0, 3000, 1000)
    ij, it = _both_indexes(y, 64)
    idx_j, d2_j, cert_j = jck.cluster_nn(ij, jnp.asarray(x), probes=probes, fixup=fixup)
    idx_t, d2_t, cert_t = tck.cluster_nn(it, _t(x), probes=probes, fixup=fixup)
    assert idx_t.dtype == torch.int32 and cert_t.dtype == torch.bool
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(cert_t.numpy(), np.asarray(cert_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-12, atol=0)
    ref_idx, ref_d2 = _dense_nn(x, y)
    cert = cert_t.numpy()
    assert 0 < cert.sum() and (fixup or not cert.all())  # the certificate is exercised
    np.testing.assert_array_equal(idx_t.numpy()[cert], ref_idx[cert])
    if fixup >= len(x):
        assert cert.all()
    # order= is only a locality hint: a precomputed order gives the same answers
    order = tck.query_order(it, _t(x))
    for a, b in zip(tck.cluster_nn(it, _t(x), probes=probes, fixup=fixup, order=order),
                    (idx_t, d2_t, cert_t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,probes", [(1, 4), (8, 8), (40, 12)])
def test_cluster_knn_matches_jax(k, probes):
    """k <= 32: the argmin-and-mask passes; k = 40: JAX's lax.top_k, here a
    stable sort.  idx and cert identical, d2 to rtol 1e-12."""
    y, x = _cloud(2, 2000, 500)
    ij, it = _both_indexes(y, 64)
    idx_j, d2_j, cert_j = jck.cluster_knn(ij, jnp.asarray(x), k=k, probes=probes)
    idx_t, d2_t, cert_t = tck.cluster_knn(it, _t(x), k=k, probes=probes)
    assert idx_t.shape == (500, k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(cert_t.numpy(), np.asarray(cert_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-12, atol=0)
    d2 = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    ref = np.sort(d2, axis=1)[:, :k]
    cert = cert_t.numpy()
    assert 0 < cert.sum() < len(x)
    np.testing.assert_allclose(d2_t.numpy()[cert], ref[cert], rtol=1e-12)


def test_cluster_knn_rejects_k_above_candidates():
    y, x = _cloud(3, 300, 10)
    it = tck.build_cluster_index(_t(y), 32)
    with pytest.raises(ValueError, match="candidates"):
        tck.cluster_knn(it, _t(x), k=2 * 32 + 1, probes=2)


def test_cluster_nn_verified_matches_dense_and_jax():
    y, x = _cloud(4, 1000, 200)
    idx_t, d2_t = tck.cluster_nn_verified(_t(y), _t(x), group_size=64, probes=4)
    idx_j, d2_j = jck.cluster_nn_verified(jnp.asarray(y), jnp.asarray(x), group_size=64,
                                          probes=4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t.numpy(), _dense_nn(x, y)[0])
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-12)


# ---------------------------------------------------------------- certificate and fix-up

def test_certificate_is_sound_adversarial():
    """Many tight distant clusters and one probe: wrong answers must be
    flagged uncertified, and the port flags exactly what JAX flags."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-100, 100, size=(64, 3))
    y = (centers[:, None, :] + rng.normal(0, 0.1, (64, 32, 3))).reshape(-1, 3)
    x = rng.uniform(-100, 100, size=(500, 3))
    ij, it = _both_indexes(y, 32)
    idx_t, d2_t, cert_t = tck.cluster_nn(it, _t(x), probes=1)
    _, _, cert_j = jck.cluster_nn(ij, jnp.asarray(x), probes=1)
    _, ref_d2 = _dense_nn(x, y)
    wrong = d2_t.numpy() > ref_d2 * (1 + 1e-9)
    assert wrong.any() and not np.any(wrong & cert_t.numpy())
    np.testing.assert_array_equal(cert_t.numpy(), np.asarray(cert_j))


def test_fixup_tie_rule_duplicate_points():
    """Every target point duplicated: the brute-force fix-up resolves ties to
    the lowest ORIGINAL row (the dense reference's rule), as JAX does."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-10, 10, (1000, 3))
    y = np.concatenate([base, base])
    x = base + rng.normal(scale=1e-3, size=base.shape)
    ref_idx, _ = _dense_nn(x, y)
    assert ref_idx.max() < 1000
    ij, it = _both_indexes(y, 64)
    idx_t, _, cert_t = tck.cluster_nn(it, _t(x), probes=1, fixup=len(x))
    idx_j, _, cert_j = jck.cluster_nn(ij, jnp.asarray(x), probes=1, fixup=len(x))
    assert bool(cert_t.all())
    np.testing.assert_array_equal(idx_t.numpy(), ref_idx)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # a partial budget: the overflow keeps certified=False, as in JAX
    idx_t, _, cert_t = tck.cluster_nn(it, _t(x), probes=1, fixup=50)
    idx_j, _, cert_j = jck.cluster_nn(ij, jnp.asarray(x), probes=1, fixup=50)
    np.testing.assert_array_equal(cert_t.numpy(), np.asarray(cert_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert 0 < (~cert_t).sum()


# ---------------------------------------------------------------- batch == serial

@pytest.mark.parametrize("fused", [False, True])
def test_batch_equals_serial(fused):
    """A batched index answers each cloud's queries as that cloud's own index
    does, on the plain path and on the kernel path (plain K2/K3 on the CPU)."""
    rng = np.random.default_rng(5)
    y = rng.uniform(-5, 5, size=(3, 800, 3))
    x = rng.uniform(-5, 5, size=(3, 300, 3))
    ib = tck.build_cluster_index(_t(y), 64)
    nn_b = tck.cluster_nn(ib, _t(x), probes=3, fixup=40, fused=fused)
    knn_b = tck.cluster_knn(ib, _t(x), k=6, probes=3, fused=fused)
    for b in range(3):
        ix = tck.build_cluster_index(_t(y[b]), 64)
        for got, want in zip(nn_b, tck.cluster_nn(ix, _t(x[b]), probes=3, fixup=40,
                                                  fused=fused)):
            assert torch.equal(got[b], want)
        for got, want in zip(knn_b, tck.cluster_knn(ix, _t(x[b]), k=6, probes=3, fused=fused)):
            assert torch.equal(got[b], want)
    # the batched search equals JAX's vmap of the same search
    ij = _jbuild_batch(jnp.asarray(y), 64)
    idx_j, _, cert_j = jax.vmap(lambda i, q: jck.cluster_nn(i, q, probes=3, fixup=40,
                                                            fused=fused))(ij, jnp.asarray(x))
    np.testing.assert_array_equal(nn_b[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(nn_b[2].numpy(), np.asarray(cert_j))


# ---------------------------------------------------------------- kernels' plain versions

def _kernel_inputs(m, n, g, probes, seed=21):
    """f32 index and query blocks built by JAX, as cluster_nn builds them
    for its kernels, and the same arrays as tensors."""
    y, x = _cloud(seed, m, n, dtype=np.float32)
    ij = _jbuild(jnp.asarray(y), g)
    xb, bsel = _jblocks(ij, jnp.asarray(x), probes)
    jax_args = (ij.points, ij.centers, ij.radius, xb, bsel)
    return jax_args, tuple(_t(a) for a in jax_args)


def _assert_bound(bound_t, bound_j, xb, centers):
    """The bound is max(|x - c|(1 - 8 eps) - r, 0)^2.  XLA-CPU may contract
    the interpret-mode body's multiply-adds (|x - c|(1 - 8 eps) - r into one
    FMA), the port's plain version does not; the subtraction of r then
    cancels, so the two agree to a few ulps of |x - c| and not to a relative
    tolerance of the bound.  Compared as distances, sqrt(bound), to 4 f32 ulps
    of the largest |x - c|.  A Pallas bound >= 1e29 is its sentinel-padded
    center and counts as inf."""
    bound_j = np.where(np.asarray(bound_j) >= SENTINEL_BOUND, np.inf, np.asarray(bound_j))
    reach = (np.abs(np.asarray(xb)).max() + np.abs(np.asarray(centers)).max()) * np.sqrt(3)
    np.testing.assert_allclose(np.sqrt(bound_t.numpy()), np.sqrt(bound_j), rtol=0,
                               atol=4 * np.finfo(np.float32).eps * reach)


# (m, n, g, probes): the slice's layout, m not a multiple of g, P = G
KERNEL_CASES = [(3000, 1000, 64, 8), (1000, 300, 64, 4), (300, 200, 64, 8)]


@pytest.mark.parametrize("m,n,g,probes", KERNEL_CASES)
def test_search_plain_versions_match_pallas(m, n, g, probes):
    """fused_search_plain (K2) and block_search_plain (K5) against the Pallas
    kernels in interpret mode: rows identical, d2 and bound to rtol 1e-6."""
    jax_args, args = _kernel_inputs(m, n, g, probes)
    best_j, row_j, bound_j = jpc.fused_search_pallas(*jax_args, interpret=True)
    best_t, row_t, bound_t = cluster_search.fused_search_plain(*args)
    assert row_t.dtype == torch.int32 and best_t.dtype == torch.float32
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j), rtol=1e-6, atol=0)
    _assert_bound(bound_t, bound_j, jax_args[3], jax_args[1])
    if probes >= -(-m // g):
        assert bool(torch.isinf(bound_t).all())  # every group selected
    best5_j, row5_j = jpc.block_search_pallas(jax_args[0], jax_args[3], jax_args[4],
                                             interpret=True)
    best5_t, row5_t = cluster_search.block_search_plain(args[0], args[3], args[4])
    np.testing.assert_array_equal(row5_t.numpy(), np.asarray(row5_j))
    np.testing.assert_allclose(best5_t.numpy(), np.asarray(best5_j), rtol=1e-6, atol=0)
    # the wrappers route CPU tensors to the plain versions
    for a, b in zip(cluster_search.fused_search(*args), (best_t, row_t, bound_t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_topk_plain_version_matches_pallas(k):
    """fused_topk_plain (K3) against the Pallas kernel in interpret mode."""
    jax_args, args = _kernel_inputs(2000, 500, 64, 4, seed=22)
    d2_j, rows_j, bound_j = jpc.fused_topk_pallas(*jax_args, k, interpret=True)
    d2_t, rows_t, bound_t = cluster_search.fused_topk_plain(*args, k)
    assert d2_t.shape == (4, 128, k)  # 500 queries in 4 blocks, the last padded
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-6, atol=0)
    _assert_bound(bound_t, bound_j, jax_args[3], jax_args[1])


def test_topk_plain_keeps_duplicate_distances():
    """Duplicate targets give equal d2 at several columns: each rank takes the
    lowest remaining column, as the Pallas passes do."""
    rng = np.random.default_rng(23)
    base = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    y = np.concatenate([base, base, base])
    x = base[:200] + rng.normal(scale=1e-3, size=(200, 3)).astype(np.float32)
    ij = _jbuild(jnp.asarray(y), 32)
    xb, bsel = _jblocks(ij, jnp.asarray(x), 4)
    jax_args = (ij.points, ij.centers, ij.radius, xb, bsel)
    d2_j, rows_j, _ = jpc.fused_topk_pallas(*jax_args, 4, interpret=True)
    d2_t, rows_t, _ = cluster_search.fused_topk_plain(*(_t(a) for a in jax_args), 4)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    assert bool((d2_t[..., 0] == d2_t[..., 1]).any())


@pytest.mark.parametrize("kind", ["nn", "knn"])
def test_fused_path_matches_jax_interpret(kind):
    """cluster_nn / cluster_knn with fused=True: the port runs the kernels'
    plain versions, JAX the Pallas kernels in interpret mode.  idx and cert
    identical, d2 to rtol 1e-6."""
    y, x = _cloud(24, 2500, 700, dtype=np.float32)
    ij, it = _both_indexes(y, 64)
    if kind == "nn":
        out_j = jck.cluster_nn(ij, jnp.asarray(x), probes=4, fused=True, fixup=100)
        out_t = tck.cluster_nn(it, _t(x), probes=4, fused=True, fixup=100)
    else:
        out_j = jck.cluster_knn(ij, jnp.asarray(x), k=8, probes=4, fused=True)
        out_t = tck.cluster_knn(it, _t(x), k=8, probes=4, fused=True)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=1e-6, atol=0)
    # the kernel path selects the same groups as the plain path: same answers
    if kind == "nn":
        plain = tck.cluster_nn(it, _t(x), probes=4, fused=False, fixup=100)
        assert torch.equal(plain[0], out_t[0]) and torch.equal(plain[2], out_t[2])


def test_wrappers_route_by_device_and_count_only_kernels():
    """CPU tensors take the plain versions and count no launch; shapes,
    dtypes and devices are checked."""
    _, args = _kernel_inputs(500, 100, 32, 2)
    before = (cluster_search.fused_search.launches, cluster_search.block_search.launches,
              cluster_search.fused_topk.launches)
    cluster_search.fused_search(*args)
    cluster_search.block_search(args[0], args[3], args[4])
    cluster_search.fused_topk(*args, 3)
    assert before == (cluster_search.fused_search.launches,
                      cluster_search.block_search.launches,
                      cluster_search.fused_topk.launches) == (0, 0, 0)
    points, centers, radius, xb, bsel = args
    with pytest.raises(ValueError, match="points"):
        cluster_search.fused_search(points[..., :2], centers, radius, xb, bsel)
    with pytest.raises(ValueError, match="bsel"):
        cluster_search.fused_search(points, centers, radius, xb, bsel[:-1])
    with pytest.raises(TypeError, match="int32 or int64"):
        cluster_search.fused_search(points, centers, radius, xb, bsel.float())
    with pytest.raises(ValueError, match=r"k=65"):
        cluster_search.fused_topk(*args, 65)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cluster_search.fused_search(*(a.to("meta") for a in args))


# ---------------------------------------------------------------- index carried across

@pytest.mark.parametrize("batched", [False, True])
def test_index_carried_from_jax(batched):
    """convert.cluster_index_from_numpy of a JAX-built index searches like
    JAX's own: the same groups, so the same answers."""
    rng = np.random.default_rng(31)
    y = rng.uniform(-8, 8, size=(2, 1500, 3))
    x = rng.uniform(-8, 8, size=(2, 400, 3))
    if batched:
        ij = _jbuild_batch(jnp.asarray(y), 64)
        out_j = jax.vmap(lambda i, q: jck.cluster_nn(i, q, probes=3, fixup=64))(
            ij, jnp.asarray(x))
    else:
        y, x = y[0], x[0]
        ij = _jbuild(jnp.asarray(y), 64)
        out_j = jck.cluster_nn(ij, jnp.asarray(x), probes=3, fixup=64)
    it = convert.cluster_index_from_numpy([np.asarray(f) for f in ij])
    _assert_index_equal(ij, it)
    out_t = tck.cluster_nn(it, _t(x), probes=3, fixup=64)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=1e-12)
    back = convert.cluster_index_to_numpy(it)
    for a, b in zip(back, ij):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="order"):
        convert.cluster_index_from_numpy([back.points, back.centers, back.radius,
                                          back.order[..., :-1], back.frame])
