"""Parity of the PyTorch port's nearest-neighbour search with the JAX
package: the dense tier against ``dicp_tpu.knn``, and the plain version of
the CUDA kernel K1 against the Pallas kernel it replaces, run in interpret
mode as tests/test_pallas_knn.py runs it.  Same numpy inputs through both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import knn as jknn  # noqa: E402
from dicp_tpu.nn import nn as jnn_shim  # noqa: E402
from dicp_tpu.ops.pallas_knn import nn_distances_pallas  # noqa: E402

from dicp_tpu_torch import knn as tknn  # noqa: E402
from dicp_tpu_torch.nn import nn as tnn_shim  # noqa: E402
from dicp_tpu_torch.ops import tiled_knn  # noqa: E402

POINTS = [(5.0, 4.0, 0.0), (2.0, 6.0, 0.0), (13.0, 3.0, 0.0), (8.0, 7.0, 0.0), (3.0, 1.0, 0.0)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------- dense tier

def test_dense_hard_nn_matches_jax():
    """Indices and gathered rows equal; the gradient into the targets equals
    JAX's VJP (exactly: a scatter-add of the same cotangent rows)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 70, 3)) * 3
    y = np.concatenate([rng.normal(size=(2, 90, 3)) * 3, rng.normal(size=(2, 90, 3))], -1)
    ct = rng.normal(size=(2, 70, 6))

    idx_t = tknn.nn_indices(_t(x), _t(y))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(jknn.nn_indices(x, y)))
    assert idx_t.dtype == torch.int32

    yt = _t(y).requires_grad_(True)
    out_t = tknn.hard_nn(_t(x), yt)
    out_j, vjp = jax.vjp(lambda y_: jknn.hard_nn(jnp.asarray(x), y_), jnp.asarray(y))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    (g_t,) = torch.autograd.grad(out_t, yt, _t(ct))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))
    np.testing.assert_allclose(tknn.pairwise_sq_dist(_t(x), _t(y[..., :3])).numpy(),
                               np.asarray(jknn.pairwise_sq_dist(x, y[..., :3])),
                               rtol=1e-12, atol=1e-12)


def test_reference_nn_points_and_query_gets_no_gradient():
    pts = torch.tensor(POINTS, dtype=torch.float64, requires_grad=True)
    q = torch.tensor([[9.0, 4.0, 0.0]], dtype=torch.float64, requires_grad=True)
    out = tknn.find_nn(q, pts, differentiable=True, use_gumbel=False)
    np.testing.assert_array_equal(out.detach().numpy()[0, 0], [8.0, 7.0, 0.0])
    gq, gp = torch.autograd.grad(out.sum(), (q, pts), allow_unused=True)
    assert gq is None  # the selection is an integer: no gradient to the query
    expected = np.zeros((5, 3))
    expected[3] = 1.0
    np.testing.assert_array_equal(gp.numpy(), expected)


@pytest.mark.parametrize("xs,ys", [((5, 3), (7, 6)), ((3, 5), (6, 7)), ((2, 5, 3), (2, 7, 3)),
                                   ((2, 3, 5), (2, 3, 7)), ((3, 3), (3, 3)),
                                   ((6, 4), (4, 6))])
def test_handle_dimensions_matches_jax(xs, ys):
    """Every accepted layout, including the reference's 3x3 ambiguity (read
    as transposed) and 6-row clouds."""
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=xs), rng.normal(size=ys)
    xt, yt = tknn._handle_dimensions(_t(x), _t(y))
    xj, yj = jknn._handle_dimensions(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    out_t = tknn.find_nn(_t(x), _t(y))
    out_j = jknn.find_nn(jnp.asarray(x), jnp.asarray(y), use_pallas=False)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_handle_dimensions_rejects_bad_columns():
    with pytest.raises(ValueError, match="3 or 6 columns"):
        tknn._handle_dimensions(torch.zeros(5, 3), torch.zeros(5, 4))


# ---------------------------------------------------------------- K1 plain version

def _pallas(x, y, tq=64, tm=256):
    idx, d2 = nn_distances_pallas(jnp.asarray(x), jnp.asarray(y), tq=tq, tm=tm,
                                  interpret=True)
    return np.asarray(idx), np.asarray(d2)


def _assert_matches_pallas(x, y, **tiles):
    """Indices equal; d2 within 1e-6 relative (XLA-CPU may contract the
    Pallas body's multiply-adds differently from unfused PyTorch ops)."""
    idx_t, d2_t = tiled_knn.nn_distances(_t(x), _t(y))
    idx_j, d2_j = _pallas(x, y, **tiles)
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=1e-6, atol=0)
    return idx_t


@pytest.mark.parametrize("n,m", [(65, 65), (130, 300), (257, 2049)])
def test_tiled_plain_matches_pallas(n, m):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3)).astype(np.float32) * 5
    y = rng.normal(size=(m, 3)).astype(np.float32) * 5
    _assert_matches_pallas(x, y)


def test_tiled_plain_batched_matches_pallas():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 3)).astype(np.float32)
    y = rng.normal(size=(3, 50, 3)).astype(np.float32)
    idx = _assert_matches_pallas(x, y, tm=64)
    assert idx.shape == (3, 40)


def test_tiled_plain_padding_never_wins():
    """A far query against a small near cloud: the Pallas kernel pads the
    targets with 1e30 rows, the port masks the edge; both pick a real row."""
    x = np.array([[1e4, 1e4, 1e4]], dtype=np.float32)
    y = np.zeros((5, 3), dtype=np.float32)
    idx = _assert_matches_pallas(x, y, tq=8, tm=256)
    assert int(idx[0]) in range(5)


def test_tiled_plain_ties_resolve_to_first():
    x = np.zeros((1, 3), dtype=np.float32)
    y = np.ones((300, 3), dtype=np.float32)
    idx = _assert_matches_pallas(x, y, tq=8, tm=64)
    assert int(idx[0]) == 0
    # the same across the plain version's own chunks (strict '<' between them)
    idx_c, d2_c = tiled_knn.nn_distances_plain(_t(x), _t(y), chunk=7)
    assert int(idx_c[0]) == 0 and float(d2_c[0]) == 3.0


def test_tiled_plain_chunking_and_f64_inputs_are_exact():
    """Any chunking gives bit-identical results, and f64 inputs are cast to
    f32 first, like the Pallas kernel (pallas_knn.py:95-96)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 33, 3)) * 4
    y = np.round(rng.normal(size=(2, 257, 3)) * 4, 1)  # repeated values: near-ties
    ref = tiled_knn.nn_distances_plain(_t(x).float(), _t(y).float(), chunk=257)
    for chunk in (1, 16, 100, None):
        idx, d2 = tiled_knn.nn_distances_plain(_t(x), _t(y), chunk=chunk)
        assert torch.equal(idx, ref[0]) and torch.equal(d2, ref[1])
    dense = tknn.nn_indices(_t(x).float(), _t(y).float())
    assert torch.equal(ref[0], dense)


def test_tiled_wrapper_checks_and_cpu_launch_count():
    """CPU tensors take the plain version and never count a kernel launch;
    shapes, batch shapes, empty targets, dtypes and devices are checked."""
    before = tiled_knn.launches
    rng = np.random.default_rng(6)
    x, y = _t(rng.normal(size=(4, 20, 3))), _t(rng.normal(size=(4, 30, 6)))
    out = tknn.find_nn_normalized(x, y, use_pallas=True)
    assert out.shape == (4, 20, 6)
    tiled_knn.nn_indices(x, y[..., :3])
    assert tiled_knn.launches == before == 0
    with pytest.raises(ValueError, match=r"\(\.\.\., n, 3\)"):
        tiled_knn.nn_distances(torch.zeros(5, 2), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="batch shapes"):
        tiled_knn.nn_distances(torch.zeros(2, 5, 3), torch.zeros(3, 5, 3))
    with pytest.raises(ValueError, match="at least one target"):
        tiled_knn.nn_distances(torch.zeros(5, 3), torch.zeros(0, 3))
    with pytest.raises(TypeError, match="floating-point"):
        tiled_knn.nn_distances(torch.zeros(5, 3, dtype=torch.int64), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tiled_knn.nn_distances(torch.zeros(5, 3, device="meta"),
                               torch.zeros(5, 3, device="meta"))


def test_tiled_tier_gradient_equals_dense_tier():
    """The tiled tier computes its index without gradient: the targets'
    gradient equals the dense tier's, and the query gets none."""
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(2, 40, 3))).requires_grad_(True)
    y = _t(rng.normal(size=(2, 60, 6))).requires_grad_(True)
    ct = _t(rng.normal(size=(2, 40, 6)))
    outs = [tknn.find_nn_normalized(x, y, use_pallas=p) for p in (True, False)]
    np.testing.assert_array_equal(outs[0].detach().numpy(), outs[1].detach().numpy())
    grads = [torch.autograd.grad(o, (x, y), ct, allow_unused=True) for o in outs]
    assert grads[0][0] is None and grads[1][0] is None
    np.testing.assert_array_equal(grads[0][1].numpy(), grads[1][1].numpy())


class _JaxStream:
    """The port's noise protocol serving JAX's draws for one unbatched dense
    call: uniform(key) of the logits' shape, as ``dicp_tpu.knn.gumbel_nn``
    draws it."""

    def __init__(self, key):
        self.key = key

    def uniform(self, pair_ids, iteration, chunk, shape, dtype, device):
        assert pair_ids is None and iteration is None and chunk is None
        u = jax.random.uniform(self.key, tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(u), dtype=dtype, device=device)


def test_gumbel_raises_and_nn_shim():
    """The shim's defaults are the JAX shim's: Gumbel soft NN with eps 1e-20
    and tau 0.1.  With JAX's default key's draws injected the soft neighbour
    equals JAX's; without a key the port's seed 0 gives a finite soft
    neighbour inside the targets' box, the same on every call."""
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(6, 3)), rng.normal(size=(9, 6))
    want = np.asarray(jnn_shim().find_nn(jnp.asarray(x), jnp.asarray(y)))
    got = tnn_shim().find_nn(_t(x), _t(y), key=_JaxStream(jax.random.key(0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    soft = tnn_shim().find_nn(_t(x), _t(y))
    assert soft.shape == want.shape and bool(torch.isfinite(soft).all())
    assert torch.equal(soft, tnn_shim().find_nn(_t(x), _t(y)))
    assert bool((soft >= _t(y).amin(0) - 1e-12).all() and (soft <= _t(y).amax(0) + 1e-12).all())
    out = tnn_shim(differentiable=True, use_gumbel=False).find_nn(
        torch.tensor([[9.0, 4.0, 0.0]]), torch.tensor(POINTS))
    np.testing.assert_array_equal(out.numpy()[0, 0], [8.0, 7.0, 0.0])
    # non-differentiable mode is hard NN whatever use_gumbel says
    out = tnn_shim(differentiable=False).find_nn(torch.tensor([[9.0, 4.0, 0.0]]),
                                                 torch.tensor(POINTS))
    np.testing.assert_array_equal(out.numpy()[0, 0], [8.0, 7.0, 0.0])
