"""The port's streaming pipeline (``dicp_tpu_torch.pipeline``) against the
JAX package's, f64 on the CPU: the cases of ``tests/test_pipeline.py`` run
on the port, ``stream_odometry`` is held to JAX's ``stream_odometry`` for
three windows, and ``dequantize_scan`` to JAX's bit for bit."""

import dataclasses
import os
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import pipeline as jpipe  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.odometry import odometry  # noqa: E402
from dicp_tpu_torch.pipeline import (_quantize_host, dequantize_scan,  # noqa: E402
                                     stream_odometry, stream_registrations)

from tests.conftest import DATA_DIR  # noqa: E402
from tests.test_odometry import CFG as JCFG  # noqa: E402
from tests.test_odometry import _make_sequence  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
CPU = "cpu"


def _sequence(n_scans):
    scans, poses = _make_sequence(np.load(os.path.join(DATA_DIR, "points_map.npy")),
                                  n_scans=n_scans)
    return np.asarray(scans), np.asarray(poses)


@pytest.fixture(scope="module")
def seq8():
    return _sequence(8)


def _as_stream(scans):
    """(S, n, c) array -> the (points, weight) numpy iterator the pipeline
    consumes (all-ones weights, the solver's default)."""
    for s in scans:
        yield s, np.ones((s.shape[0],), s.dtype)


def _rel_err(a, b):
    """|log(a b^-1)| per pair for (K, 4, 4) tensors."""
    return torch.linalg.vector_norm(se3.tran2vec(a @ torch.linalg.inv(b)), dim=-1)


# --- tests/test_pipeline.py on the port -------------------------------------

def test_stream_matches_batched_odometry(seq8):
    """Windowed streaming equals the one-shot batched odometry solve, incl.
    a ragged tail window (identity init: warm_start=False)."""
    scans = seq8[0]
    ref = odometry(torch.as_tensor(scans), CFG)
    for window in (3, 8, 16):    # 7 pairs: multi-window + tail, exact, pad
        out = stream_odometry(_as_stream(scans), CFG, window=window, warm_start=False,
                              device=CPU)
        np.testing.assert_allclose(out.rel_transforms.numpy(), ref.rel_transforms.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(out.poses.numpy(), ref.poses.numpy(), atol=1e-12)
        np.testing.assert_array_equal(out.converged.numpy(), ref.converged.numpy())
        np.testing.assert_array_equal(out.iterations.numpy(), ref.iterations.numpy())


def test_stream_registrations_window_boundaries():
    """Window seams reuse the boundary scan: no dropped or duplicated pairs."""
    scans, poses_true = _sequence(6)
    chunks = list(stream_registrations(_as_stream(scans), CFG, window=2, device=CPU))
    ks = [c[0].shape[0] for c in chunks]
    assert sum(ks) == 5 and all(k <= 2 for k in ks)
    rel = torch.cat([c[0] for c in chunks])
    T_true = torch.as_tensor(np.stack([np.linalg.inv(poses_true[i]) @ poses_true[i + 1]
                                       for i in range(5)]))
    assert float(_rel_err(rel, T_true).max()) < 1e-8


def test_stream_warm_start_same_fixed_point(seq8):
    """The warm start reaches the relative transforms of identity init, to
    solver tolerance, in no more total iterations."""
    scans = seq8[0]
    cold = stream_odometry(_as_stream(scans), CFG, window=4, warm_start=False, device=CPU)
    for window in (1, 4):
        warm = stream_odometry(_as_stream(scans), CFG, window=window, warm_start=True,
                               device=CPU)
        errs = _rel_err(warm.rel_transforms, cold.rel_transforms)
        assert float(errs.max()) < 1e-6, (window, errs)
        assert bool(torch.all(warm.converged))
        assert float(warm.iterations.sum()) <= float(cold.iterations.sum())


def test_stream_needs_two_scans():
    scans = _sequence(2)[0]
    assert list(stream_registrations(_as_stream(scans[:1]), CFG, window=4, device=CPU)) == []
    with pytest.raises(ValueError, match="two scans"):
        stream_odometry(_as_stream(scans[:1]), CFG, device=CPU)


def test_quantized_weightless_stream_matches(seq8):
    """The quantized transfer with weights left out matches the
    full-precision stream to well under the quantization step."""
    scans = seq8[0]
    cfg = CFG.with_(tolerance=1e-6)
    full = stream_odometry(_as_stream(scans), cfg, window=4, device=CPU)
    quant = stream_odometry(((s, None) for s in scans), cfg, window=4, quantize=True,
                            device=CPU)
    assert bool(torch.all(quant.converged))
    errs = _rel_err(quant.rel_transforms.to(torch.float64), full.rel_transforms)
    assert float(errs.max()) < 1e-4, errs


def test_stream_rejects_mixed_weights():
    scans = _sequence(4)[0]

    def mixed():
        yield scans[0], np.ones((scans[0].shape[0],), scans[0].dtype)
        yield scans[1], None
        yield scans[2], None

    with pytest.raises(ValueError, match="weights"):
        stream_odometry(mixed(), CFG, window=2, device=CPU)


# --- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("window", [3, 8, 16])
def test_stream_odometry_matches_jax(seq8, window):
    """JAX's stream_odometry and the port's, warm-started (the default): the
    same relative transforms, iterations and convergence."""
    scans = seq8[0]
    ref = jpipe.stream_odometry(_as_stream(scans), JCFG, window=window)
    got = stream_odometry(_as_stream(scans), CFG, window=window, device=CPU)
    np.testing.assert_allclose(got.rel_transforms.numpy(), np.asarray(ref.rel_transforms),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


def test_dequantize_scan_matches_jax_bits():
    """The same packed arrays dequantise to the f32 bits of JAX's
    ``dequantize_scan`` as its pipeline runs it (jitted): 3- and 6-column
    scans of the reference cloud, of a wide random cloud, of georeferenced
    clouds far from the origin (f32 coordinates near 1e5-1e6 m with a small
    extent), and every third int8 value on each normal axis.  The uint16
    array may also arrive as int16 (the pipeline's view of the same
    bytes)."""
    rng = np.random.default_rng(0)
    nrm = rng.normal(size=(20000, 3))
    unit = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    v = np.arange(-127, 128, 3)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3) / 127.0
    clouds = [np.load(os.path.join(DATA_DIR, "points_map.npy")),
              np.hstack([rng.uniform(-40, 40, size=(20000, 3)), unit]),
              np.hstack([rng.uniform(-5, 5, size=(len(grid), 3)), grid]),
              *(np.hstack([origin + rng.uniform(-ext, ext, size=(20000, 3)), unit])
                for origin, ext in (((4.5e5, 5.4e6, 120.0), 60.0), ((-3e6, 2e5, 1e3), 1.0)))]
    jdeq = jax.jit(jpipe.dequantize_scan)
    for cloud in clouds:
        for cols in (3, 6):
            parts, deq = _quantize_host(cloud[:, :cols])
            ref = np.asarray(jdeq(tuple(jnp.asarray(p) for p in parts), jnp.asarray(deq)))
            for view in (None, np.int16):
                qt = tuple(torch.as_tensor(p.view(view) if view and p.dtype == np.uint16
                                           else p) for p in parts)
                got = dequantize_scan(qt, torch.as_tensor(deq)).numpy()
                assert got.dtype == np.float32 and got.shape == (len(cloud), cols)
                np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c of f32 values in exact arithmetic, rounded once to f32
    (to nearest, ties to even)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(y)) - x) for y in near]
    best = [y for y, d in zip(near, dist) if d == min(dist)]
    return min(best, key=lambda y: int(np.array(y).view(np.uint32)) & 1)


def test_fma_rounds_once():
    """``_fma`` equals a fused multiply-add: on random f32 triples spread over
    60 binades, and on a sum that f64 rounds to an f32 midpoint
    (1 + 2^-23 + 2^-24 - 2^-70, which rounds down once and up twice)."""
    from dicp_tpu_torch.pipeline import _fma

    rng = np.random.default_rng(3)
    a, b, c = ((rng.uniform(1, 2, 3000) * rng.choice([-1, 1], 3000)
                * 2.0 ** rng.integers(-30, 30, 3000)).astype(np.float32) for _ in range(3))
    a = np.append(a, np.float32(1 + 2**-23))
    b = np.append(b, np.float32((1 - 2**-23) * 2**-24))
    c = np.append(c, np.float32(1 + 2**-23))
    got = _fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    ref = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert ref[-1] == np.float32(1 + 2**-23)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_one_packed_buffer_per_scan():
    """Each scan's arrays (points and weights, or quantized parts, constants
    and weights) come back from one packed buffer with their values and
    dtypes."""
    from dicp_tpu_torch.pipeline import _Uploader

    up = _Uploader(torch.device(CPU), slots=3)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(7, 4)).astype(np.float32)
    parts, deq = _quantize_host(np.hstack([pts[:, :3], rng.normal(size=(7, 3))]))
    arrays = [pts, np.ones(7, np.float32), *parts, deq]
    views = up(arrays)
    bases = {v.untyped_storage().data_ptr() for v in views}
    assert len(bases) == 1
    for a, v in zip(arrays, views):
        assert tuple(v.shape) == a.shape
        if a.dtype == np.uint16:
            np.testing.assert_array_equal(v.numpy().view(np.uint16), a)
        else:
            np.testing.assert_array_equal(v.numpy(), a)
