"""The port's scan-to-map odometry (``dicp_tpu_torch.mapping``) against the
JAX package's, f64 on the CPU.

The contracts of ``tests/test_mapping.py`` run on the port alone (the
noisy-drift case against the port's own ``odometry``).  The parity cases
feed the same numpy scans through both packages: at most 4 scans of 1,500
points against a 4,096-row map (a 512-row one for LRU eviction), each JAX
reference computed once per module.

Weighted PCA normals of such sparse scans have a few points whose 3x3
covariance is nearly degenerate: there even JAX's eager and jitted
``estimate_normals_weighted`` differ (by 0.65 in n n^T on one point of
these scans), and so does the port.  The parity cases therefore give the
port JAX's own jitted normals (:func:`jax_normals`), so that they hold the
merge, the target and the solves; ``tests/test_torch_normals.py`` holds
the normals themselves."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import mapping as jm  # noqa: E402
from dicp_tpu.ops.normals import estimate_normals_weighted as j_weighted  # noqa: E402
from dicp_tpu.pipeline import _quantize_host  # noqa: E402
from dicp_tpu.pipeline import dequantize_scan as j_dequantize  # noqa: E402

from dicp_tpu_torch import mapping as tm  # noqa: E402
from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.mapping import (LocalMap, empty_map, map_merge, map_step,  # noqa: E402
                                    map_target, scan_to_map_odometry)
from dicp_tpu_torch.odometry import ate, odometry  # noqa: E402

from tests.test_mapping import CFG as JCFG  # noqa: E402
from tests.test_mapping import _scene, _sequence  # noqa: E402
from tests.test_torch_sgd_icp import JaxSampler  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
CFG_S2S = CFG.with_(icp_type="pt2pt")
CPU = "cpu"


def _np_seq(n_scans, **kw):
    scans, poses = _sequence(n_scans, **kw)
    return scans, np.asarray(poses)


def _final_err(res_poses, poses_true):
    d = torch.linalg.inv(torch.as_tensor(poses_true[-1])) @ res_poses[-1].double()
    return float(torch.linalg.vector_norm(se3.tran2vec(d)))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes that share the host's cores, where more threads per worker
    only share the same cores and slow the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# --- tests/test_mapping.py on the port ---------------------------------------

def test_scan_to_map_recovers_clean_trajectory():
    scans, poses_true = _np_seq(6)
    res = scan_to_map_odometry(((s, None) for s in scans), CFG, capacity=8192, voxel=0.25,
                               device=CPU)
    assert bool(torch.all(res.converged))
    err = float(ate(res.poses, poses_true, align=False))
    assert err < 1e-3, err
    re = res.poses[:-1] @ res.rel_transforms
    np.testing.assert_allclose(re.numpy(), res.poses[1:].numpy(), atol=1e-10)


@pytest.mark.slow
def test_scan_to_map_bounds_drift_under_noise():
    """With sensor noise, scan-to-scan chaining random-walks while the map
    keeps every scan anchored to one world frame.  Slow: 72 scans of GN
    solves against an 8,192-row map on the dense tier take ~60 s alone and
    several minutes beside the other workers; scan_to_map_odometry keeps its
    fast parity cases in tier-1 (test_scan_to_map_odometry_matches_jax)."""
    scans, poses_true = _np_seq(72, noise=0.045, seed=3, n=1000)
    s2s = odometry(np.stack(scans), CFG_S2S, device=CPU)
    s2m = scan_to_map_odometry(((s, None) for s in scans), CFG, capacity=8192, voxel=0.25,
                               device=CPU)
    e_s2s = _final_err(s2s.poses, poses_true)
    e_s2m = _final_err(s2m.poses, poses_true)
    assert e_s2m < e_s2s, (e_s2m, e_s2s)


def test_sgd_front_end_tracks_trajectory():
    scans, poses_true = _np_seq(6)
    cfg = CFG.with_(tolerance=1e-5)
    kw = dict(capacity=8192, voxel=0.25, solver="sgd", sgd_minibatch=512,
              sgd_iterations=40, seed=7, device=CPU)
    res = scan_to_map_odometry(((s, None) for s in scans), cfg, **kw)
    assert bool(torch.all(res.converged)), res.converged
    err = float(ate(res.poses, poses_true, align=False))
    assert err < 5e-3, err
    res2 = scan_to_map_odometry(((s, None) for s in scans), cfg, **kw)
    assert torch.equal(res.poses, res2.poses)
    with pytest.raises(ValueError, match="PRNG key"):
        map_step(empty_map(64), torch.as_tensor(scans[0].astype(np.float32)),
                 torch.eye(4), None, cfg, 0.25, solver="sgd")


def test_merge_subsample_tracks_trajectory():
    scans, poses_true = _np_seq(6)
    res = scan_to_map_odometry(((s, None) for s in scans), CFG, capacity=8192, voxel=0.25,
                               merge_subsample=700, device=CPU)
    assert bool(torch.all(res.converged))
    err = float(ate(res.poses, poses_true, align=False))
    assert err < 3e-3, err


def test_quantized_scan_transfer():
    scans, poses_true = _np_seq(6)
    scans32 = [s.astype(np.float32) for s in scans]
    cfg = CFG.with_(tolerance=1e-6)
    res_f = scan_to_map_odometry(((s, None) for s in scans32), cfg, capacity=8192, voxel=0.25,
                                 device=CPU)
    res_q = scan_to_map_odometry(((s, None) for s in scans32), cfg, capacity=8192, voxel=0.25,
                                 quantize=True, device=CPU)
    assert bool(torch.all(res_q.converged))
    err = float(ate(res_q.poses, poses_true.astype(np.float32), align=False))
    err_f = float(ate(res_f.poses, poses_true.astype(np.float32), align=False))
    assert err < max(5 * err_f, 2e-3), (err, err_f)
    with pytest.raises(ValueError, match="weightless"):
        scan_to_map_odometry(((s, np.ones(s.shape[0], np.float32)) for s in scans32), cfg,
                             capacity=8192, voxel=0.25, quantize=True, device=CPU)


def test_merge_modes_agree_on_clean_data():
    scans, poses_true = _np_seq(5)
    for mode in ("mean", "freeze"):
        res = scan_to_map_odometry(((s, None) for s in scans), CFG, capacity=8192,
                                   voxel=0.25, merge_mode=mode, device=CPU)
        err = float(ate(res.poses, poses_true, align=False))
        assert err < 1e-3, (mode, err)


def test_map_merge_semantics():
    m = empty_map(256, dtype=torch.float64)
    a = torch.tensor([[0.1, 0.1, 0.1], [0.12, 0.11, 0.09], [3.0, 3.0, 3.0]],
                     dtype=torch.float64)
    m1 = map_merge(m, a, 0.5, with_normals=False, mode="mean")
    occ = m1.count > 0
    assert int(occ.sum()) == 2
    fused = m1.pos[occ]
    i = int(torch.argmin(fused[:, 0]))
    np.testing.assert_allclose(fused[i].numpy(), [0.11, 0.105, 0.095], atol=1e-12)
    assert float(m1.count[occ][i]) == 2.0
    m2 = map_merge(m1, a, 0.5, with_normals=False, mode="mean")
    occ2 = m2.count > 0
    assert int(occ2.sum()) == 2
    np.testing.assert_allclose(np.sort(m2.pos[occ2][:, 0].numpy()),
                               np.sort(fused[:, 0].numpy()), atol=1e-12)
    assert float(m2.count.max()) == 4.0
    b = a.clone()
    b[:2] += 0.2
    m3 = map_merge(m1, b[:2], 0.5, with_normals=False, mode="freeze")
    occ3 = m3.count > 0
    fused3 = m3.pos[occ3]
    i3 = int(torch.argmin(fused3[:, 0]))
    np.testing.assert_allclose(fused3[i3].numpy(), [0.11, 0.105, 0.095], atol=1e-12)
    assert float(m3.pos[~occ3].min()) > float(m3.pos[occ3].max())


def test_lru_eviction():
    m = empty_map(64, dtype=torch.float64)
    for c in (0.0, 100.0, 200.0):
        pts = torch.as_tensor(c + np.arange(60)[:, None] * 1.0 + np.zeros((60, 3)))
        m = map_merge(m, pts, 0.5, with_normals=False, mode="mean")
    occ = m.count > 0
    assert int(occ.sum()) == 64
    pos = m.pos[occ]
    assert int(((pos[:, 0] - 200.0).abs() < 60).sum()) == 60
    assert int((pos[:, 0].abs() < 60).sum()) == 0


def test_map_normals_match_surface():
    scans, _ = _np_seq(1)
    m = map_merge(empty_map(8192, dtype=torch.float64), torch.as_tensor(scans[0]), 0.25,
                  with_normals=True)
    t = map_target(m, True).numpy()
    v = (m.count > 0).numpy()
    x, y, nrm = t[v, 0], t[v, 1], t[v, 3:6]
    gx = 1.5 * 0.6 * np.cos(0.6 * x) * np.cos(0.5 * y)
    gy = -1.5 * 0.5 * np.sin(0.6 * x) * np.sin(0.5 * y)
    true_n = np.stack([-gx, -gy, np.ones_like(gx)], axis=1)
    true_n /= np.linalg.norm(true_n, axis=1, keepdims=True)
    dots = np.abs(np.sum(nrm * true_n, axis=1))
    assert np.median(dots) > 0.99, np.median(dots)


def test_rejects_bad_types_and_short_streams():
    with pytest.raises(ValueError):
        scan_to_map_odometry(iter(()), CFG.with_(icp_type="symmetric"), device=CPU)
    with pytest.raises(ValueError):
        scan_to_map_odometry(((s, None) for s in [_scene()[:100]]), CFG, device=CPU)
    with pytest.raises(ValueError):
        map_merge(empty_map(64), torch.zeros((8, 3)), 0.5, with_normals=False,
                  mode="nonsense")


# --- parity with the JAX package ----------------------------------------------

CAP = 4096
N_PAR = 1500
_J_WEIGHTED = jax.jit(j_weighted)


@pytest.fixture
def jax_normals(monkeypatch):
    """The port's merge takes JAX's jitted weighted normals (module docstring)."""
    def weighted(pts):
        out = _J_WEIGHTED(jnp.asarray(pts.detach().cpu().numpy()))
        return torch.as_tensor(np.array(out), device=pts.device)
    monkeypatch.setattr(tm, "estimate_normals_weighted", weighted)


@pytest.fixture(scope="module")
def par_seq():
    return _np_seq(4, n=N_PAR)


def _to_port(m) -> LocalMap:
    return LocalMap(*(torch.as_tensor(np.array(a)) for a in m))


def _cell_order(pos: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Rows sorted by position (occupied rows first): a row order that does
    not depend on the merge's internal order."""
    return np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0], count <= 0))


def _assert_maps_match(mt: LocalMap, mj, atol=1e-12, atol_m2=None):
    """Positions within ``atol`` and m2 within ``atol_m2`` (default the
    same) after sorting rows by cell; count, last and step exactly equal."""
    pj, pt = np.asarray(mj.pos), mt.pos.numpy()
    oj, ot = _cell_order(pj, np.asarray(mj.count)), _cell_order(pt, mt.count.numpy())
    np.testing.assert_allclose(pt[ot], pj[oj], rtol=0, atol=atol)
    np.testing.assert_allclose(mt.m2.numpy()[ot], np.asarray(mj.m2)[oj], rtol=0,
                               atol=atol if atol_m2 is None else atol_m2)
    np.testing.assert_array_equal(mt.count.numpy()[ot], np.asarray(mj.count)[oj])
    np.testing.assert_array_equal(mt.last.numpy()[ot], np.asarray(mj.last)[oj])
    assert int(mt.step) == int(mj.step)


def _boundary_points(voxel: float) -> np.ndarray:
    """(k, 3) points whose coordinates lie a few ulps around cell boundaries
    k * voxel, where floor(x / voxel) and floor(x * (1 / voxel)) differ."""
    base = np.arange(-50, 50) * voxel
    near = [base]
    for direction in (np.inf, -np.inf):
        x = base
        for _ in range(3):
            x = np.nextafter(x, direction)
            near.append(x)
    x = np.concatenate(near)
    x = x[np.floor(x / voxel) != np.floor(x * (1.0 / voxel))]
    return np.stack([x, np.roll(x, 1), np.roll(x, 2)], axis=1)


@pytest.mark.parametrize("mode", ["mean", "freeze"])
def test_map_merge_matches_jax(par_seq, jax_normals, mode):
    """Three merges into a 512-row map (LRU eviction past capacity) at a
    voxel of 0.35, whose divisions and reciprocal products floor differently
    at the boundary points appended to each scan: equal to JAX's jitted
    map_merge."""
    scans, _ = par_seq
    voxel = 0.35
    edge = _boundary_points(voxel)
    assert len(edge) > 0
    mj = jm.empty_map(512, jnp.float64)
    mt = empty_map(512, torch.float64)
    for s in scans[:3]:
        pts = np.concatenate([s, edge])
        mj = jm.map_merge(mj, jnp.asarray(pts), voxel, with_normals=True, mode=mode)
        mt = map_merge(mt, torch.as_tensor(pts), voxel, with_normals=True, mode=mode)
        _assert_maps_match(mt, mj)
    assert int((mt.count > 0).sum()) == 512          # evicted past capacity
    assert int((mt.last == 1).sum()) < int((mt.last == 3).sum())
    np.testing.assert_allclose(map_target(mt).numpy(), np.asarray(jm.map_target(mj)),
                               rtol=0, atol=1e-12)


def test_map_target_matches_jax(par_seq):
    """map_target of a JAX map: the principal normals of the fused outer
    products, zero for empty rows (and with_normals=False)."""
    scans, _ = par_seq
    mj = jm.empty_map(CAP, jnp.float64)
    for s in scans[:2]:
        mj = jm.map_merge(mj, jnp.asarray(s), 0.25, with_normals=True, mode="mean")
    mt = _to_port(mj)
    for with_normals in (True, False):
        ref = np.asarray(jm.map_target(mj, with_normals))
        got = map_target(mt, with_normals).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.all(got[(mt.count == 0).numpy(), 3:] == 0)


def _jax_chain(seed):
    """JAX's per-scan streams: fold_in(key(seed), k), split once (N = 1)."""
    base = jax.random.key(seed)
    return lambda k: JaxSampler(jax.random.split(jax.random.fold_in(base, k), 1))


STEP_CASES = {
    # the main path: GN on the cluster tier, whose target holds ~3,000 sentinel rows
    "gn cluster": dict(cfg=dict(nn_method="cluster"), kw={}),
    "sgd subsample": dict(cfg=dict(tolerance=1e-5),
                          kw=dict(solver="sgd", sgd_minibatch=256, sgd_iterations=30,
                                  merge_subsample=700)),
    "gn quantized": dict(cfg=dict(tolerance=1e-6), kw={}, quantized=True),
}


@pytest.fixture(scope="module")
def step_refs(par_seq):
    """One JAX map_step per case from the map of scan 0, at the truth moved."""
    scans, poses = par_seq
    t_pred = poses[1].copy()
    t_pred[:3, 3] += [0.02, -0.01, 0.005]
    out = {}
    for name, case in STEP_CASES.items():
        quant = case.get("quantized", False)
        dt = np.float32 if quant else np.float64
        m0 = jm.map_merge(jm.empty_map(CAP, dt), jnp.asarray(scans[0].astype(dt)), 0.25,
                          mode="mean")
        cfg = JCFG.with_(**case["cfg"])
        kw = dict(case["kw"])
        if quant:
            parts, deq = _quantize_host(scans[1].astype(np.float32))
            scan_j, deq_j = tuple(jnp.asarray(p) for p in parts), jnp.asarray(deq)
        else:
            scan_j, deq_j = jnp.asarray(scans[1]), None
        key = jax.random.fold_in(jax.random.key(7), 1) if kw.get("solver") == "sgd" else None
        res = jm.map_step(m0, scan_j, jnp.asarray(t_pred.astype(dt)), None, cfg, 0.25,
                          merge_mode="mean", key=key, deq=deq_j, **kw)
        extra = None
        if quant:
            # the decode inside the jitted step gives the bits of the jitted
            # dequantize_scan alone
            alone = jm.map_step(m0, jax.jit(j_dequantize)(scan_j, deq_j),
                                jnp.asarray(t_pred.astype(dt)), None, cfg, 0.25,
                                merge_mode="mean")
            extra = (parts, deq, jax.tree_util.tree_map(np.asarray, alone))
        out[name] = (jax.tree_util.tree_map(np.asarray, m0), t_pred.astype(dt),
                     jax.tree_util.tree_map(np.asarray, res), extra)
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_map_step_matches_jax(par_seq, step_refs, jax_normals, name):
    scans, _ = par_seq
    m0, t_pred, ref, extra = step_refs[name]
    case = STEP_CASES[name]
    kw = dict(case["kw"])
    if kw.get("solver") == "sgd":
        kw["key"] = _jax_chain(7)(1)
    cfg = CFG.with_(**case["cfg"])
    if extra is not None:
        parts, deq, alone = extra
        for a, b in zip(ref[3], alone[3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ref[0], alone[0])
        scan = tuple(torch.as_tensor(p.view(np.int16) if p.dtype == np.uint16 else p)
                     for p in parts)
        kw["deq"] = torch.as_tensor(deq)
    else:
        scan = torch.as_tensor(scans[1])
    pose, ok, it, m1 = map_step(_to_port(m0), scan, torch.as_tensor(t_pred), None, cfg, 0.25,
                                merge_mode="mean", **kw)
    assert bool(ok) == bool(ref[1]) and bool(ok)
    assert float(it) == float(ref[2])
    if extra is None:
        np.testing.assert_allclose(pose.numpy(), ref[0], rtol=0, atol=1e-10)
        # XLA fuses the normals inside the jitted step otherwise than in the
        # jitted normals alone: a few n n^T entries differ by ~4e-12
        _assert_maps_match(m1, ref[3], atol_m2=1e-10)
    else:   # f32 (the decoded scan): rounding of the f32 solve and sums; the
        # f32 weighted normals' eigenvectors differ by up to ~3e-3 in n n^T
        np.testing.assert_allclose(pose.numpy(), ref[0], rtol=0, atol=1e-6)
        _assert_maps_match(m1, ref[3], atol=2e-6, atol_m2=5e-3)


@pytest.fixture(scope="module")
def s2m_refs(par_seq):
    scans, _ = par_seq
    gn = jm.scan_to_map_odometry(((s, None) for s in scans), JCFG, capacity=CAP, voxel=0.25)
    sgd = jm.scan_to_map_odometry(((s, None) for s in scans), JCFG.with_(tolerance=1e-5),
                                  capacity=CAP, voxel=0.25, solver="sgd", sgd_minibatch=256,
                                  sgd_iterations=30, seed=7)
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in (("gn", gn), ("sgd", sgd))}


@pytest.mark.parametrize("solver", ["gn", "sgd"])
def test_scan_to_map_odometry_matches_jax(par_seq, s2m_refs, jax_normals, solver):
    """4 scans: poses within 1e-9, iterations and convergence equal; the SGD
    stream draws JAX's per-scan chain through the callable ``seed``."""
    scans, _ = par_seq
    ref = s2m_refs[solver]
    if solver == "gn":
        res = scan_to_map_odometry(((s, None) for s in scans), CFG, capacity=CAP, voxel=0.25,
                                   device=CPU)
    else:
        res = scan_to_map_odometry(((s, None) for s in scans), CFG.with_(tolerance=1e-5),
                                   capacity=CAP, voxel=0.25, solver="sgd", sgd_minibatch=256,
                                   sgd_iterations=30, seed=_jax_chain(7), device=CPU)
    np.testing.assert_allclose(res.poses.numpy(), ref.poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.rel_transforms.numpy(), ref.rel_transforms, rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(res.converged.numpy(), ref.converged)


@pytest.mark.parametrize("mode", ["mean", "freeze"])
@pytest.mark.parametrize("with_normals", [False, True])
def test_map_merge_promotes_dtypes_like_jax(par_seq, jax_normals, mode, with_normals):
    """An f32 map merged with f64 scans (x64): JAX promotes the union, its
    cells and the returned pos, m2 and count to f64 (last and step stay
    int32).  Each scan carries 200 points 1e-9 below a cell boundary, where
    cells of f32 and f64 coordinates differ.  Fields and dtypes as JAX's,
    within 1e-10."""
    scans, _ = par_seq
    rng = np.random.default_rng(9)
    below = np.round(rng.uniform(-30, 30, (200, 3))) * 0.25 - 1e-9
    mj, mt = jm.empty_map(4096), empty_map(4096)
    assert mt.pos.dtype == torch.float32
    for s in scans[:2]:
        pts = np.concatenate([s, below])
        mj = jm.map_merge(mj, jnp.asarray(pts), 0.25, with_normals=with_normals, mode=mode)
        mt = map_merge(mt, torch.as_tensor(pts), 0.25, with_normals=with_normals, mode=mode)
        for a, b in zip(mt, mj):
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        _assert_maps_match(mt, mj, atol=1e-10)


# SHA-256 of every field after each of three merges into a 512-row map (voxel
# 0.35, LRU eviction), recorded from map_merge as it was before it promoted
# dtypes: a merge whose map and scan share a dtype must keep those bits.
SAME_DTYPE_DIGESTS = {
    ("float32", "mean"): "4e6f9f2658d97ded9220d42b1368cd97f9a29319e8ad36e21cd9611012737d3c",
    ("float32", "freeze"): "cd7a64d6aa63288afe6eacc42ebb5d9e5d98e31971dd72575aa1dd1434f8e0ba",
    ("float64", "mean"): "4aa4afdbac611bf676ca2b0583c7248e931fe7b05e55453125a14fffe86c4759",
    ("float64", "freeze"): "c5df3c6e907a9f82f315c187df4e4ad28525f48eecc829639d7009ab87339c7c",
}


@pytest.mark.parametrize("dtype, mode", list(SAME_DTYPE_DIGESTS))
def test_map_merge_same_dtype_bits_unchanged(dtype, mode):
    import hashlib

    rng = np.random.default_rng(5)
    h = hashlib.sha256()
    m = empty_map(512, getattr(torch, dtype))
    for k in range(3):
        p = rng.uniform(-6, 6, (900, 3))
        p[:, 2] = np.sin(p[:, 0] * 0.6) * np.cos(p[:, 1] * 0.5)
        m = map_merge(m, torch.as_tensor((p + 0.3 * k).astype(dtype)), 0.35,
                      with_normals=True, mode=mode)
        assert m.pos.dtype == m.m2.dtype == m.count.dtype == getattr(torch, dtype)
        for f in m:
            h.update(f.numpy().tobytes())
    assert h.hexdigest() == SAME_DTYPE_DIGESTS[(dtype, mode)]
