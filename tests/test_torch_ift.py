"""The port's implicit-function-theorem gradients (``register_ift``)
against the JAX package's and against the port's own unrolled gradient
(autograd through the loop), mirroring ``tests/test_ift.py``.

f64 on the CPU.  Tolerances as in the JAX tests: T to 1e-12 against the
unrolled solve, gradients to 1e-6 * scale (1e-5 * scale on the 3-D scenes).
Every gradient is checked finite and nonzero."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.config import ICPConfig as JConfig  # noqa: E402
from dicp_tpu.ift import register_ift as jregister_ift  # noqa: E402

from dicp_tpu_torch import ICPConfig, register, register_ift  # noqa: E402
from dicp_tpu_torch import registration as treg  # noqa: E402
from dicp_tpu_torch.ops import fused_gn  # noqa: E402

BASE = dict(icp_type="pt2pl", differentiable=True, max_iterations=60, tolerance=1e-12,
            dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _live(g):
    g = g.detach()
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    return g


def _grads(fn, *args):
    """Gradients of sum(fn(*args).T) with respect to every tensor argument."""
    leaves = [a.clone().requires_grad_(True) for a in args]
    return [_live(g) for g in torch.autograd.grad(fn(*leaves).T.sum(), leaves)]


def _close(a, b, rel):
    scale = max(float(np.abs(np.asarray(b)).max()), 1.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=rel * scale)


def _moved_scene(planes_scene, noise_seed, noise):
    """Source: the planes scene moved by a fixed twist; target: the scene with
    optional noise (so the fixed point balances nonzero residuals)."""
    T_st = np.asarray(jse3.vec2tran(jnp.asarray([0.05, -0.04, 0.03, 0.02, -0.01, 0.03])))
    scene = planes_scene.copy()
    if noise:
        scene[:, :3] += np.random.default_rng(noise_seed).normal(scale=noise,
                                                                 size=(len(scene), 3))
    return planes_scene, scene, T_st


@pytest.mark.parametrize("icp_type,loss_name,loss_metric", [
    ("pt2pl", "huber", 1.0), ("pt2pl", "cauchy", 0.5), ("pt2pt", "huber", 1.0),
    ("pt2pl", None, 1.0), ("pt2pl", "welsch", 10.0), ("pt2pl", "gm", 10.0)])
def test_ift_matches_jax_and_unrolled(source_np, target_np, icp_type, loss_name,
                                      loss_metric):
    """Source and target gradients: the port's IFT against JAX's IFT and
    against the port's unrolled gradient."""
    kw = {**BASE, "icp_type": icp_type, "loss_name": loss_name, "loss_metric": loss_metric}
    cfg = ICPConfig(**kw)
    src = source_np[None, :, :3]
    tgt = target_np[None] if icp_type == "pt2pl" else target_np[None, :, :3]
    ti = np.eye(4)[None]

    def ift(s, t):
        return register_ift(s, t, _t(ti), None, cfg)

    def unrolled(s, t):
        return register(s, t, _t(ti), None, cfg)

    T_i = ift(_t(src), _t(tgt)).T
    np.testing.assert_allclose(T_i.numpy(), unrolled(_t(src), _t(tgt)).T.numpy(), atol=1e-12)
    gs_i, gt_i = _grads(ift, _t(src), _t(tgt))
    gs_u, gt_u = _grads(unrolled, _t(src), _t(tgt))
    _close(gs_i, gs_u, 1e-6)
    _close(gt_i, gt_u, 1e-6)

    jcfg = JConfig(**kw)
    gs_j, gt_j = jax.grad(lambda a, b: jnp.sum(jregister_ift(a, b, jnp.asarray(ti), None,
                                                             jcfg).T),
                          argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    _close(gs_i, gs_j, 1e-6)
    _close(gt_i, gt_j, 1e-6)


def test_ift_3d():
    """Full 6-DOF problem on three planes: the IFT gradient against the
    unrolled one (the planar pair is gauge-degenerate in 3-D)."""
    rng = np.random.default_rng(0)
    normals = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    pts, nrms = [], []
    for k in range(3):
        uv = rng.uniform(-2, 2, size=(30, 2))
        basis = np.eye(3)[[i for i in range(3) if i != np.argmax(normals[k])]]
        pts.append(uv @ basis + normals[k] * (0.5 + k))
        nrms.append(np.tile(normals[k], (30, 1)))
    target = np.hstack([np.vstack(pts), np.vstack(nrms)])
    xi = np.array([0.05, -0.04, 0.03, 0.02, -0.01, 0.03])
    T_st = np.asarray(jse3.vec2tran(jnp.asarray(xi)))
    source = (target[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    cfg = ICPConfig(**{**BASE, "dim": 3, "max_iterations": 80, "trim_dist": None})
    ti = _t(np.eye(4)[None])
    T_u = register(_t(source), _t(target[None]), ti, None, cfg).T
    assert np.abs(T_u[0].numpy() - np.linalg.inv(T_st)).max() < 1e-6
    (g_u,) = _grads(lambda s: register(s, _t(target[None]), ti, None, cfg), _t(source))
    (g_i,) = _grads(lambda s: register_ift(s, _t(target[None]), ti, None, cfg), _t(source))
    _close(g_i, g_u, 1e-5)


def test_ift_weight_gradients(source_np, target_np):
    """d T*/d weight on a perturbed target (on the clean pair it vanishes):
    IFT against the unrolled gradient and against JAX's IFT."""
    rng = np.random.default_rng(3)
    tgt_np = target_np.copy()
    tgt_np[:, :3] += rng.normal(scale=0.05, size=(tgt_np.shape[0], 3))
    tgt_np[:, 2] = 0.0
    cfg = ICPConfig(**BASE)
    src, tgt, ti = _t(source_np[None, :, :3]), _t(tgt_np[None]), _t(np.eye(4)[None])
    w = torch.ones(src.shape[:2], dtype=torch.float64)
    (g_u,) = _grads(lambda w_: register(src, tgt, ti, w_, cfg), w)
    (g_i,) = _grads(lambda w_: register_ift(src, tgt, ti, w_, cfg), w)
    assert float(g_u.abs().max()) > 1e-8
    np.testing.assert_allclose(g_i.numpy(), g_u.numpy(), atol=1e-6 * float(g_u.abs().max()))
    g_j = jax.grad(lambda w_: jnp.sum(jregister_ift(
        jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy()), jnp.asarray(ti.numpy()), w_,
        JConfig(**BASE)).T))(jnp.asarray(w.numpy()))
    np.testing.assert_allclose(g_i.numpy(), np.asarray(g_j), atol=1e-6 * float(g_u.abs().max()))


def test_ift_batched_and_chunked(source_np, target_np):
    """B = 3: finite nonzero gradients equal to each element's own, and
    batch_chunk=2 (edge-padded to 4, as in JAX) gives the same."""
    offs = np.array([0.0, 0.2, -0.1])
    src = np.stack([source_np[:, :3] + o * np.array([1.0, 1.0, 0.0]) for o in offs])
    tgt, ti = _t(np.stack([target_np] * 3)), _t(np.stack([np.eye(4)] * 3))
    cfg = ICPConfig(**BASE)
    (g,) = _grads(lambda s: register_ift(s, tgt, ti, None, cfg), _t(src))
    (g_c,) = _grads(lambda s: register_ift(s, tgt, ti, None, cfg.with_(batch_chunk=2)), _t(src))
    np.testing.assert_allclose(g_c.numpy(), g.numpy(), rtol=0, atol=1e-12)
    for b in range(3):
        (g_b,) = _grads(lambda s: register_ift(s, tgt[:1], ti[:1], None, cfg), _t(src[b:b + 1]))
        np.testing.assert_allclose(g[b].numpy(), g_b[0].numpy(), rtol=0, atol=1e-12)


def test_ift_rejects_gumbel(source_np, target_np):
    """JAX's own refusals: register_ift takes no Gumbel NN (differentiable or
    not), and Anderson acceleration with Gumbel NN is an invalid config."""
    args = (source_np[None, :, :3], target_np[None], np.eye(4)[None])
    for diff in (True, False):
        kw = {**BASE, "differentiable": diff, "use_gumbel": True}
        with pytest.raises(ValueError, match="hard"):
            jregister_ift(*map(jnp.asarray, args), None, JConfig(**kw))
        with pytest.raises(ValueError, match="hard"):
            register_ift(*map(_t, args), None, ICPConfig(**kw))
    kw = {**BASE, "use_gumbel": True, "anderson_m": 4, "collect_histories": False,
          "driver": "while"}
    with pytest.raises(ValueError, match="deterministic"):
        JConfig(**kw)
    with pytest.raises(ValueError, match="deterministic"):
        ICPConfig(**kw)


def test_ift_symmetric(planes_scene):
    """Symmetric ICP: (N, n, 6) source cotangents including the normal
    columns, against the unrolled gradient and JAX's IFT."""
    scene, noisy, T_st = _moved_scene(planes_scene, 5, 0.01)
    src6 = np.hstack([scene[:, :3] @ T_st[:3, :3].T + T_st[:3, 3],
                      scene[:, 3:6] @ T_st[:3, :3].T])[None]
    tgt, ti = noisy[None], np.eye(4)[None]
    kw = {**BASE, "icp_type": "symmetric", "dim": 3, "max_iterations": 80, "trim_dist": None}
    cfg = ICPConfig(**kw)
    np.testing.assert_allclose(
        register_ift(_t(src6), _t(tgt), _t(ti), None, cfg).T.numpy(),
        register(_t(src6), _t(tgt), _t(ti), None, cfg).T.numpy(), atol=1e-12)
    gs_u, gt_u = _grads(lambda s, t: register(s, t, _t(ti), None, cfg), _t(src6), _t(tgt))
    gs_i, gt_i = _grads(lambda s, t: register_ift(s, t, _t(ti), None, cfg), _t(src6), _t(tgt))
    _close(gs_i, gs_u, 1e-5)
    _close(gt_i, gt_u, 1e-5)
    assert float(gs_u[..., 3:6].abs().max()) > 1e-8
    gs_j = jax.grad(lambda a: jnp.sum(jregister_ift(a, jnp.asarray(tgt), jnp.asarray(ti), None,
                                                    JConfig(**kw)).T))(jnp.asarray(src6))
    _close(gs_i, gs_j, 1e-5)


def test_ift_matches_finite_differences(source_np, target_np):
    """Central differences of the converged T* against the IFT gradient on
    source, target and weight entries: a check against the solver itself."""
    rng = np.random.default_rng(11)
    tgt_np = target_np.copy()
    tgt_np[:, :3] += rng.normal(scale=0.05, size=(tgt_np.shape[0], 3))
    tgt_np[:, 2] = 0.0
    cfg = ICPConfig(**{**BASE, "max_iterations": 80, "tolerance": 1e-13})
    arrays = [source_np[None, :, :3].copy(), tgt_np[None].copy(), np.ones((1, 65))]
    ti = _t(np.eye(4)[None])
    cot = _t(rng.normal(size=(1, 4, 4)))

    def f(s, t, w):
        return register_ift(s, t, ti, w, cfg).T

    leaves = [_t(a).requires_grad_(True) for a in arrays]
    grads = [_live(g) for g in torch.autograd.grad((f(*leaves) * cot).sum(), leaves)]
    eps, checked = 1e-6, 0
    for pos, (arr, grad) in enumerate(zip(arrays, grads)):
        for fi in rng.choice(arr.size, size=6, replace=False):
            idx = np.unravel_index(fi, arr.shape)
            if pos == 1 and idx[-1] == 2:
                continue  # the z column is masked in dim 2: 0 both ways
            plus, minus = [a.copy() for a in arrays], [a.copy() for a in arrays]
            plus[pos][idx] += eps
            minus[pos][idx] -= eps
            with torch.no_grad():
                fd = float(((f(*map(_t, plus)) - f(*map(_t, minus))) * cot).sum()) / (2 * eps)
            ad = float(grad[idx])
            assert abs(fd - ad) / max(abs(fd), abs(ad), 1e-6) < 1e-4, (pos, idx, fd, ad)
            checked += 1
    assert checked >= 12


def test_ift_const_iter(source_np, target_np):
    """const_iter: the forward runs a fixed iteration count; T and gradients
    equal the early-exit forward's once both have converged."""
    cfg_w = ICPConfig(**BASE)
    cfg_f = cfg_w.with_(const_iter=True, max_iterations=20, driver="scan", scan_unroll=4)
    src, tgt, ti = _t(source_np[None, :, :3]), _t(target_np[None]), _t(np.eye(4)[None])
    res_f = register_ift(src, tgt, ti, None, cfg_f)
    assert float(res_f.iterations[0]) == 20.0
    np.testing.assert_allclose(res_f.T.numpy(), register_ift(src, tgt, ti, None, cfg_w).T.numpy(),
                               atol=1e-10)
    (g_w,) = _grads(lambda s: register_ift(s, tgt, ti, None, cfg_w), src)
    (g_f,) = _grads(lambda s: register_ift(s, tgt, ti, None, cfg_f), src)
    np.testing.assert_allclose(g_f.numpy(), g_w.numpy(), atol=1e-8)


def test_ift_cluster_backend(planes_scene):
    """nn_method='cluster': the backward takes its correspondences from the
    forward's cluster closure; gradients equal the dense tier's and JAX's
    cluster-tier IFT."""
    scene, noisy, T_st = _moved_scene(planes_scene, 6, 0.01)
    src = (noisy[:, :3] @ T_st[:3, :3].T + T_st[:3, 3])[None]
    tgt, ti = noisy[None], np.eye(4)[None]
    kw = {**BASE, "dim": 3, "trim_dist": None}
    grads = {}
    for method in ("dense", "cluster"):
        cfg = ICPConfig(**kw, nn_method=method, cluster_group=64)
        (grads[method],) = _grads(lambda s: register_ift(s, _t(tgt), _t(ti), None, cfg), _t(src))
    np.testing.assert_allclose(grads["cluster"].numpy(), grads["dense"].numpy(), atol=1e-10)
    g_j = jax.grad(lambda s: jnp.sum(jregister_ift(
        s, jnp.asarray(tgt), jnp.asarray(ti), None,
        JConfig(**kw, nn_method="cluster", cluster_group=64)).T))(jnp.asarray(src))
    np.testing.assert_allclose(grads["cluster"].numpy(), np.asarray(g_j), atol=1e-10)


def test_ift_with_fused_forward(source_np, target_np, monkeypatch):
    """fused_small=True with histories off: the forward is the whole-solve
    path (K4's plain version here), once per call; value and gradient
    match the loop forward's (cos > 0.9999) and JAX's fused-forward IFT."""
    calls = []

    def spy(*args):
        calls.append(1)
        return fused_gn.fused_gn_solve(*args)

    monkeypatch.setattr(treg, "fused_gn_solve", spy)
    src = np.repeat(source_np[None, :, :3], 2, axis=0).astype(np.float32)
    src[1, :, :2] += 0.1
    tgt = np.repeat(target_np[None], 2, axis=0).astype(np.float32)
    ti = np.repeat(np.eye(4, dtype=np.float32)[None], 2, axis=0)
    kw = dict(icp_type="pt2pl", differentiable=True, max_iterations=80, tolerance=1e-6,
              dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0,
              collect_histories=False, nn_method="dense")
    out = {}
    for fused in (False, True):
        cfg = ICPConfig(**kw, fused_small=fused)
        s = _t(src).requires_grad_(True)
        val = register_ift(s, _t(tgt), _t(ti), None, cfg).T.sum()
        out[fused] = (float(val.detach()), _live(torch.autograd.grad(val, s)[0]).numpy())
        assert len(calls) == int(fused)
    (v0, g0), (v1, g1) = out[False], out[True]
    assert abs(v0 - v1) < 1e-4 * max(1.0, abs(v0))
    cos = float(np.sum(g0 * g1) / (np.linalg.norm(g0) * np.linalg.norm(g1)))
    assert cos > 0.9999, cos
    g_j = np.asarray(jax.grad(lambda s: jnp.sum(jregister_ift(
        s, jnp.asarray(tgt), jnp.asarray(ti), None, JConfig(**kw, fused_small=True)).T))(
            jnp.asarray(src)))
    cos_j = float(np.sum(g_j * g1) / (np.linalg.norm(g_j) * np.linalg.norm(g1)))
    assert cos_j > 0.9999, cos_j
