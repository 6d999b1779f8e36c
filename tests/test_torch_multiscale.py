"""The port's coarse-to-fine registration (``dicp_tpu_torch.multiscale``)
against the JAX package's, f64 on the CPU.

The contracts of ``tests/test_multiscale.py`` run on the port alone, on the
same three-plane scene.  The parity cases feed the same numpy inputs
through both packages: the re-packing and the voxel levels (indices and
values bit-equal), the three-level pyramid of the JAX suite, weighted and
batched (poses within 1e-10, iterations per level equal), and a Gumbel
pyramid whose per-level noise sources serve JAX's own split keys."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import multiscale as jms  # noqa: E402

from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.multiscale import (ScaleLevel, _downsample_cloud,  # noqa: E402
                                       register_multiscale, subsample_packed)
from dicp_tpu_torch.registration import register  # noqa: E402

from tests.test_multiscale import _CFG as JCFG  # noqa: E402
from tests.test_multiscale import _LEVELS as J_LEVELS  # noqa: E402
from tests.test_multiscale import _pair  # noqa: E402
from tests.test_torch_gumbel import JaxNoise  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
LEVELS = tuple(ScaleLevel(*lv) for lv in J_LEVELS)
XI = [0.3, -0.2, 0.4, 0.15, -0.1, 0.2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes that share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a))


def _batch(xi, seed=7):
    src, tgt, T_true = _pair(xi, seed)
    return _t(src[None]), _t(tgt[None]), torch.eye(4, dtype=torch.float64)[None], T_true


def _close_to_eye(T, T_true, atol=1e-9):
    np.testing.assert_allclose(T.detach().numpy() @ T_true, np.eye(4), atol=atol)


# --- tests/test_multiscale.py on the port ------------------------------------

def test_subsample_under_capacity():
    pts = torch.arange(30, dtype=torch.float64).reshape(10, 3)
    w = torch.arange(1.0, 11.0, dtype=torch.float64)
    p, ww = subsample_packed(pts, w, torch.tensor(4), 6)
    assert torch.equal(p[:4], pts[:4])
    assert torch.equal(p[4:], pts[3].expand(2, 3))
    np.testing.assert_array_equal(ww.numpy(), [1, 2, 3, 4, 0, 0])


def test_subsample_over_capacity():
    pts = torch.arange(60, dtype=torch.float64).reshape(20, 3)
    w = torch.arange(1.0, 21.0, dtype=torch.float64)
    p, ww = subsample_packed(pts, w, torch.tensor(17), 8)
    assert bool(torch.all(ww > 0))
    rows = {tuple(r) for r in p.tolist()}
    assert len(rows) == 8
    assert rows <= {tuple(r) for r in pts[:17].tolist()}
    assert tuple(pts[0].tolist()) in rows
    assert max(int(r[0]) for r in rows) >= 12 * 3


def test_voxel_weight_sum_exact():
    rng = np.random.default_rng(0)
    cloud = torch.as_tensor(rng.uniform(-2, 2, size=(200, 3)))
    w = torch.as_tensor(rng.uniform(0.1, 3.0, size=(200,)))
    _, wl = _downsample_cloud(cloud, w, 0.5, 256)
    np.testing.assert_allclose(float(wl.sum()), float(w.sum()), rtol=1e-12)


def test_normals_renormalized():
    cloud = np.zeros((4, 6))
    cloud[:, :3] = [[0.1, 0.1, 0], [0.15, 0.12, 0], [3.0, 3.0, 0], [3.1, 3.05, 0]]
    cloud[0, 3:] = [1, 0, 0]
    cloud[1, 3:] = [0, 1, 0]
    cloud[2, 3:] = [0, 0, 1]
    cloud[3, 3:] = [0, 0, -1]
    pts, w = _downsample_cloud(torch.as_tensor(cloud), None, 1.0, 4)
    lens = torch.linalg.vector_norm(pts[:, 3:6], dim=1).numpy()
    occupied = (w > 0).numpy()
    assert occupied.sum() == 2
    np.testing.assert_allclose(sorted(lens[occupied]), [0.0, 1.0], atol=1e-12)


def test_pyramid_matches_single_scale_fixed_point():
    S, Tg, Ti, T_true = _batch(XI)
    ms = register_multiscale(S, Tg, Ti, None, CFG, LEVELS)
    ss = register(S, Tg, Ti, None, CFG)
    for T in (ms.result.T[0], ss.T[0]):
        _close_to_eye(T, T_true)
    assert float(ms.level_iterations[-1, 0]) < float(ss.iterations[0])
    assert tuple(ms.level_T.shape) == (3, 1, 4, 4)
    assert bool(ms.result.converged[0])


def test_batched_independent():
    src0, tgt, T0 = _pair(XI)
    src1, _, T1 = _pair([-0.25, 0.3, -0.1, -0.05, 0.12, -0.15])
    ms = register_multiscale(_t(np.stack([src0, src1])), _t(np.stack([tgt, tgt])),
                             torch.eye(4, dtype=torch.float64).expand(2, 4, 4), None, CFG,
                             LEVELS)
    _close_to_eye(ms.result.T[0], T0)
    _close_to_eye(ms.result.T[1], T1)


def test_weighted_pyramid():
    S, Tg, Ti, T_true = _batch([0.2, -0.1, 0.3, 0.1, -0.05, 0.15])
    w = _t(np.random.default_rng(1).uniform(0.5, 2.0, size=(1, S.shape[1])))
    ms = register_multiscale(S, Tg, Ti, w, CFG, LEVELS)
    _close_to_eye(ms.result.T[0], T_true)


def test_gradients_warmup_stop():
    """With the warm-up detach, the gradient is the last level's own,
    started from the handed-over pose."""
    S, Tg, Ti, _ = _batch([0.15, -0.1, 0.2, 0.05, -0.03, 0.08])
    cfg = CFG.with_(differentiable=True, driver="scan", max_iterations=12, tolerance=1e-12)
    levels = (ScaleLevel(0.8, 128, 128, 6, 1e-5, trim_dist=20.0),
              ScaleLevel(0.0, 0, 0, 8, 1e-12))
    a = S.clone().requires_grad_(True)
    torch.sum(register_multiscale(a, Tg, Ti, None, cfg, levels).result.T).backward()
    g = a.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
    warm = register_multiscale(S, Tg, Ti, None, cfg.with_(differentiable=False, driver="while"),
                               levels[:1]).result.T
    b = S.clone().requires_grad_(True)
    fcfg = cfg.with_(max_iterations=8, tolerance=1e-12)
    torch.sum(register(b, Tg, warm.detach(), None, fcfg).T).backward()
    np.testing.assert_allclose(g, b.grad.numpy(), rtol=1e-6, atol=1e-12)


def test_gradients_full_unroll():
    S, Tg, Ti, _ = _batch([0.1, -0.05, 0.1, 0.03, -0.02, 0.05])
    cfg = CFG.with_(differentiable=True, driver="scan", max_iterations=6, tolerance=1e-12)
    levels = (ScaleLevel(0.8, 128, 128, 4, 1e-5, trim_dist=20.0),
              ScaleLevel(0.0, 0, 0, 6, 1e-12))
    a = S.clone().requires_grad_(True)
    torch.sum(register_multiscale(a, Tg, Ti, None, cfg, levels,
                                  warmup_stop_gradient=False).result.T).backward()
    g = a.grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_validation():
    S = torch.zeros((1, 8, 3), dtype=torch.float64)
    Tg = torch.zeros((1, 8, 6), dtype=torch.float64)
    Ti = torch.eye(4, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="non-empty"):
        register_multiscale(S, Tg, Ti, None, CFG, ())
    with pytest.raises(ValueError, match="slot budgets"):
        register_multiscale(S, Tg, Ti, None, CFG, (ScaleLevel(1.0, 0, 0, 5, 1e-4),))
    gumbel = CFG.with_(differentiable=True, use_gumbel=True, driver="scan")
    with pytest.raises(ValueError, match="PRNG key"):
        register_multiscale(S, Tg, Ti, None, gumbel, (ScaleLevel(0.0, 0, 0, 5, 1e-4),))
    with pytest.raises(ValueError, match="noise sources"):
        register_multiscale(S, Tg, Ti, None, gumbel, (ScaleLevel(0.0, 0, 0, 5, 1e-4),),
                            key=[1, 2])


# --- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("count, cap", [(4, 6), (17, 8), (0, 5), (20, 20)])
def test_subsample_packed_matches_jax(count, cap):
    rng = np.random.default_rng(count)
    pts, w = rng.normal(size=(20, 3)), rng.uniform(0.5, 2.0, 20)
    got = subsample_packed(_t(pts), _t(w), torch.tensor(count, dtype=torch.int32), cap)
    ref = jms.subsample_packed(jnp.asarray(pts), jnp.asarray(w),
                               jnp.asarray(count, jnp.int32), cap)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cols, weighted, voxel, cap", [
    (6, True, 0.5, 32),      # stride past the budget, normals renormalised
    (6, False, 0.5, 512),    # padding past the occupied voxels
    (3, True, 0.3, 64),
])
def test_downsample_cloud_matches_jax(cols, weighted, voxel, cap):
    """The re-packed centroids and summed weights, bit for bit (points
    placed a few ulps around cell boundaries included)."""
    rng = np.random.default_rng(cols + cap)
    cloud = rng.uniform(-2, 2, size=(300, cols))
    # cell boundaries but 0, whose neighbour is a denormal (XLA flushes those)
    edge = np.concatenate([np.arange(-6, 0), np.arange(1, 7)]) * voxel
    cloud[:12, 0] = np.nextafter(edge, -np.inf)
    cloud[12:24, 1] = np.nextafter(edge, np.inf)
    w = rng.uniform(0.1, 3.0, 300) if weighted else None
    got = _downsample_cloud(_t(cloud), None if w is None else _t(w), voxel, cap)
    ref = jms._downsample_cloud(jnp.asarray(cloud), None if w is None else jnp.asarray(w),
                                voxel, cap)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# jitted (the whole pyramid traces into one program; eager dispatch of its
# voxel levels takes ~6x longer); on these inputs its cells and poses equal
# the eager call's
_J_PYRAMID = jax.jit(jms.register_multiscale, static_argnames=("cfg", "levels"))


@pytest.fixture(scope="module")
def pyramid_refs():
    """JAX's three-level pyramid on two pairs, with prior weights."""
    src0, tgt, _ = _pair(XI)
    src1, _, _ = _pair([-0.25, 0.3, -0.1, -0.05, 0.12, -0.15])
    S, Tg = np.stack([src0, src1]), np.stack([tgt, tgt])
    Ti = np.broadcast_to(np.eye(4), (2, 4, 4)).copy()
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=(2, S.shape[1]))
    ref = _J_PYRAMID(jnp.asarray(S), jnp.asarray(Tg), jnp.asarray(Ti), jnp.asarray(w),
                     cfg=JCFG, levels=J_LEVELS)
    return (S, Tg, Ti, w), jax.tree_util.tree_map(np.asarray, ref)


def test_register_multiscale_matches_jax(pyramid_refs):
    (S, Tg, Ti, w), ref = pyramid_refs
    got = register_multiscale(_t(S), _t(Tg), _t(Ti), _t(w), CFG, LEVELS)
    np.testing.assert_allclose(got.level_T.numpy(), ref.level_T, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.level_iterations.numpy(), ref.level_iterations)
    np.testing.assert_allclose(got.result.pc.numpy(), ref.result.pc, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.result.converged.numpy(), ref.result.converged)
    np.testing.assert_allclose(got.result.matched_ratio.numpy(), ref.result.matched_ratio,
                               rtol=0, atol=1e-12)


def test_gumbel_pyramid_matches_jax():
    """JAX splits one key across the levels; the port takes one noise source
    per level, here serving JAX's split keys."""
    src, tgt, _ = _pair([0.1, -0.05, 0.1, 0.03, -0.02, 0.05])
    cfg_kw = dict(differentiable=True, use_gumbel=True, driver="scan", max_iterations=6,
                  tolerance=1e-12)
    levels = (ScaleLevel(0.8, 96, 96, 4, 1e-5, trim_dist=20.0), ScaleLevel(0.0, 0, 0, 4, 1e-12))
    key = jax.random.key(11)
    Ti = np.eye(4)[None]
    ref = _J_PYRAMID(jnp.asarray(src[None]), jnp.asarray(tgt[None]), jnp.asarray(Ti), None,
                     cfg=JCFG.with_(**cfg_kw), levels=tuple(jms.ScaleLevel(*lv) for lv in levels),
                     key=key)
    noise = [JaxNoise(k) for k in jax.random.split(key, len(levels))]
    got = register_multiscale(_t(src[None]), _t(tgt[None]), _t(Ti), None, CFG.with_(**cfg_kw),
                              levels, key=noise)
    np.testing.assert_allclose(got.level_T.numpy(), np.asarray(ref.level_T), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(got.level_iterations.numpy(),
                                  np.asarray(ref.level_iterations))
