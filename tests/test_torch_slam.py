"""The port's closed-loop SLAM (``dicp_tpu_torch.slam``) against the JAX
package's, f64 on the CPU.

The front end's drift is a random walk that follows last-ulp rounding
(tests/test_slam.py:24-30), so two trajectories cannot be held to each
other at 1e-10.  Instead:

* each piece is held to JAX within 1e-10 on JAX's own inputs: the two-stage
  closure solve, the keyframe anchor, the pose graph, the robust refinement
  and the map rebuild (f64 points merged into an f32 map, which promotes);
* the contracts of ``tests/test_slam.py`` (all but the mesh back end, which
  comes with ``dicp_tpu_torch.parallel``) hold on the port's own run of the
  suite's circuit generator, built once per module.  The circuit is two
  laps, the deployment the card's smoke run drives at full scan size;
  the refined ATE is held below the front end's and below 0.2 m (JAX's
  refined ATE is ~0.11-0.13 m) rather than the >= 5x ratio, which holds
  only for one rounding realization.

Weighted PCA normals of these sparse scans have a few ill-conditioned
points (``tests/test_torch_mapping.py``'s docstring): where a parity case
meets them, the port is handed JAX's jitted normals."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import slam as js  # noqa: E402
from dicp_tpu.ops.normals import estimate_normals_weighted as j_weighted  # noqa: E402

from dicp_tpu_torch import mapping as tm  # noqa: E402
from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch import slam as ts  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.odometry import PoseGraph, ate  # noqa: E402
from dicp_tpu_torch.slam import (Closure, build_pose_graph, rebuild_map,  # noqa: E402
                                 refine_robust, slam_odometry)

from tests.test_slam import CFG as JCFG  # noqa: E402
from tests.test_slam import SLAM_KW, VOXEL, _make_scans  # noqa: E402
from tests.test_torch_mapping import _assert_maps_match  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
CPU = "cpu"
LAPS = 2
_J_WEIGHTED = jax.jit(j_weighted)


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


def _weighted_from_jax(pts):
    out = _J_WEIGHTED(jnp.asarray(pts.detach().cpu().numpy()))
    return torch.as_tensor(np.array(out), device=pts.device)


@pytest.fixture
def jax_normals(monkeypatch):
    """The port's anchors and merges take JAX's jitted weighted normals."""
    monkeypatch.setattr(ts, "estimate_normals_weighted", _weighted_from_jax)
    monkeypatch.setattr(tm, "estimate_normals_weighted", _weighted_from_jax)


def _rel_err(T_a, T_b) -> float:
    """|log(T_a^-1 T_b)|."""
    d = torch.linalg.inv(torch.as_tensor(np.asarray(T_a, np.float64))) @ torch.as_tensor(
        np.asarray(T_b, np.float64))
    return float(torch.linalg.vector_norm(se3.tran2vec(d)))


def _rebuild_height_error(scans, poses, T0, with_normals=True):
    """(median |z - surface(x, y)| of the map rebuilt at ``poses``, in the
    world frame the analytic surface lives in; the map's dtype).  The fused
    positions do not depend on the normals, which ``with_normals=False``
    skips."""
    m = rebuild_map(scans, torch.as_tensor(np.asarray(poses)), capacity=16384, voxel=VOXEL,
                    with_normals=with_normals)
    live = (m.count > 0).numpy()
    pos = m.pos.numpy()[live] @ T0[:3, :3].T + T0[:3, 3]
    z_true = np.sin(pos[:, 0] * 0.6) * np.cos(pos[:, 1] * 0.5) * 1.5
    return float(np.median(np.abs(pos[:, 2] - z_true))), m.pos.dtype


# --- the port's own circuit (tests/test_slam.py's contracts) -------------------

@pytest.fixture(scope="module")
def circuit():
    scans, poses_true, T0 = _make_scans(laps=LAPS)
    res = slam_odometry(((s, None) for s in scans), CFG, device=CPU, **SLAM_KW)
    return scans, poses_true, T0, res


def test_closures_fire_on_revisits(circuit):
    scans, poses_true, _, res = circuit
    assert len(res.closures) >= 10
    for c in res.closures:
        assert c.scan_idx - c.anchor_idx >= SLAM_KW["closure_gap"]
        assert c.matched_ratio >= SLAM_KW["accept_ratio"]
    # each closure measures the true relative pose far better than the drift
    errs = [_rel_err(np.linalg.inv(poses_true[c.anchor_idx]) @ poses_true[c.scan_idx],
                     c.T_rel) for c in res.closures]
    assert float(np.median(errs)) < 0.03, errs


def test_refinement_recovers_drift(circuit):
    _, poses_true, _, res = circuit
    truth = torch.as_tensor(poses_true)
    a_front = float(ate(res.poses_front, truth, align=False))
    a_ref = float(ate(res.poses, truth, align=False))
    assert a_ref < a_front and a_ref < 0.2, (a_ref, a_front)


def test_no_revisit_no_closures():
    scans, _, _ = _make_scans(laps=0.5, partial=True)
    res = slam_odometry(((s, None) for s in scans), CFG, device=CPU, **SLAM_KW)
    assert len(res.closures) == 0
    assert torch.equal(res.poses, res.poses_front)


def test_rebuild_map_lands_on_world(circuit):
    """The map rebuilt at the refined poses lies nearer the true surface than
    the one rebuilt at the drifted front-end poses, and within 0.12 m (median
    height error).  JAX's bound is 0.1 m on its six-lap run (refined ATE
    ~0.11 m).  On two laps the refined ATE is 0.06-0.24 m and the error
    follows it: over noise seeds 3-10 JAX's runs give 0.039-0.119 m (median
    0.084) and the port's 0.046-0.120 m (median 0.072), the port's 0.110 at
    this seed (test_circuit_over_seeds_against_jax, slow)."""
    scans, _, T0, res = circuit
    refined, dtype = _rebuild_height_error(scans, res.poses, T0)
    assert dtype == torch.float64      # f64 scans promote the f32 map
    drifted, _ = _rebuild_height_error(scans, res.poses_front, T0, with_normals=False)
    assert refined < drifted and refined < 0.12, (refined, drifted)


def test_build_pose_graph_shapes(circuit):
    scans, _, _, res = circuit
    S = len(scans)
    g = build_pose_graph(res.poses_front, res.closures)
    E = S - 1 + len(res.closures)
    assert tuple(g.edges_i.shape) == (E,)
    assert tuple(g.t_meas.shape) == (E, 4, 4)
    assert bool(torch.all(g.edges_j[S - 1:] - g.edges_i[S - 1:] >= SLAM_KW["closure_gap"]))


def test_mesh_back_end_is_not_ported_yet(circuit):
    _, _, _, res = circuit
    graph = build_pose_graph(res.poses_front, res.closures)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        refine_robust(res.poses_front, graph, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        slam_odometry(iter(()), CFG, mesh=object(), device=CPU)


@pytest.mark.slow
def test_circuit_over_seeds_against_jax():
    """Slow (~15 min on one thread): the two-lap circuit at eight noise seeds
    (3-10), run by the port and by JAX.  Their trajectories part after a few
    scans (last-ulp rounding), so the test compares the two packages'
    distributions: the port's median refined ATE and median rebuilt-map
    height error over the seeds within 0.03 m of JAX's.  Prints both per
    seed."""
    from dicp_tpu.odometry import ate as j_ate

    rows = []
    for seed in range(3, 11):
        scans, poses_true, T0 = _make_scans(laps=LAPS, seed=seed)
        truth = torch.as_tensor(poses_true)
        res_t = slam_odometry(((s, None) for s in scans), CFG, device=CPU, **SLAM_KW)
        res_j = js.slam_odometry(((s, None) for s in scans), JCFG, **SLAM_KW)
        row = {"seed": seed}
        for name, res, front, ref in (
                ("port", res_t, ate(res_t.poses_front, truth, align=False),
                 ate(res_t.poses, truth, align=False)),
                ("jax", res_j, j_ate(res_j.poses_front, jnp.asarray(poses_true), align=False),
                 j_ate(res_j.poses, jnp.asarray(poses_true), align=False))):
            row[name] = dict(closures=len(res.closures), front=float(front), refined=float(ref),
                             rebuild=_rebuild_height_error(scans, res.poses, T0, False)[0])
        rows.append(row)
        print(row)
    for key in ("refined", "rebuild"):
        port = np.median([r["port"][key] for r in rows])
        jax_ = np.median([r["jax"][key] for r in rows])
        print(f"median {key}: port {port:.4f}, JAX {jax_:.4f}")
        assert port < jax_ + 0.03, (key, port, jax_)


# --- parity with the JAX package ----------------------------------------------

@pytest.fixture(scope="module")
def lap():
    """One lap of the circuit (33 scans; scan 32 revisits scan 0) and its
    truth."""
    scans, poses_true, _ = _make_scans(laps=1)
    return scans, poses_true


def _moved(T, dxyz, dyaw=0.0):
    out = np.array(T, np.float64)
    c, s = np.cos(dyaw), np.sin(dyaw)
    out[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ out[:3, :3]
    out[:3, 3] += dxyz
    return out


@pytest.mark.parametrize("with_normals", [True, False])
def test_make_anchor_matches_jax(lap, jax_normals, with_normals):
    scans, poses_true = lap
    pose = _moved(poses_true[5], [0.1, -0.05, 0.02], 0.03)
    ref = np.asarray(js._make_anchor(jnp.asarray(scans[5]), jnp.asarray(pose), with_normals))
    got = ts._make_anchor(_t(scans[5]), _t(pose), with_normals).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    if not with_normals:
        assert np.all(got[:, 3:] == 0)


@pytest.mark.parametrize("scan_idx", [32, 30, 12])
def test_closure_solve_matches_jax(lap, scan_idx):
    """Scan 32 against the drifted anchor of scan 0 (the revisit), scan 30
    (two steps short of it) and scan 12 (a third of a lap away): the
    relative pose within 1e-10, the convergence flag and the tight ratio
    equal."""
    scans, poses_true = lap
    t_anchor = _moved(poses_true[0], [0.15, -0.1, 0.0], 0.02)
    anchor = js._make_anchor(jnp.asarray(scans[0]), jnp.asarray(t_anchor), True)
    t_pred = _moved(poses_true[scan_idx], [0.12, 0.2, 0.0], -0.03)
    cfg_c = JCFG.with_(trim_dist=JCFG.trim_dist * 4.0)
    ref = js._closure_solve(anchor, jnp.asarray(t_anchor), jnp.asarray(scans[scan_idx]),
                            jnp.asarray(t_pred), cfg_c, JCFG)
    got = ts._closure_solve(_t(anchor), _t(t_anchor), _t(scans[scan_idx]), _t(t_pred),
                            config_from_dict(dataclasses.asdict(cfg_c)), CFG)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-10)
    assert bool(got[1]) == bool(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=0, atol=1e-12)
    if scan_idx == 32:
        # the anchor's drift cancels out of T_rel up to the tight solve's noise
        T_true = np.linalg.inv(poses_true[0]) @ poses_true[scan_idx]
        assert _rel_err(T_true, got[0]) < 0.03


def _graph_inputs(poses_true):
    """A drifted front end (a random walk of small steps), four closures at
    the true relative poses, two front-end solves that did not converge."""
    rng = np.random.default_rng(4)
    S = poses_true.shape[0]
    drift = np.cumsum(rng.normal(scale=0.01, size=(S, 3)), axis=0)
    yaw = np.cumsum(rng.normal(scale=0.003, size=S))
    poses = np.stack([_moved(poses_true[k], drift[k], yaw[k]) for k in range(S)])
    poses[0] = poses_true[0]
    pairs = [(0, 32), (4, 30), (8, 31), (2, 29)]
    rel = [np.linalg.inv(poses_true[i]) @ poses_true[j] for i, j in pairs]
    converged = np.ones(S, bool)
    converged[[7, 19]] = False
    return poses, pairs, rel, converged


def test_build_pose_graph_matches_jax(lap):
    _, poses_true = lap
    poses, pairs, rel, converged = _graph_inputs(poses_true)
    ref = js.build_pose_graph(jnp.asarray(poses),
                              [js.Closure(i, j, jnp.asarray(r), 0.9)
                               for (i, j), r in zip(pairs, rel)],
                              30.0, converged=converged, nonconverged_info=0.1)
    got = build_pose_graph(_t(poses), [Closure(i, j, _t(r), 0.9) for (i, j), r in zip(pairs, rel)],
                           30.0, converged=torch.as_tensor(converged), nonconverged_info=0.1)
    for a, b in zip(got, ref):
        assert a.dtype == {np.dtype("int32"): torch.int32,
                           np.dtype("float64"): torch.float64}[np.asarray(b).dtype]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    assert float(got.info[6]) == float(np.float32(0.1))     # edge 6 -> 7 rides on solve 7


def test_refine_robust_matches_jax(lap):
    """Huber IRLS around the median edge residual (the mean of the two middle
    values, as jnp.median takes it: the graph has an even edge count)."""
    _, poses_true = lap
    poses, pairs, rel, converged = _graph_inputs(poses_true)
    rel[1] = _moved(rel[1], [0.4, -0.3, 0.0], 0.1)        # one outlier closure
    graph = js.build_pose_graph(jnp.asarray(poses),
                                [js.Closure(i, j, jnp.asarray(r), 0.9)
                                 for (i, j), r in zip(pairs, rel)],
                                30.0, converged=converged)
    assert graph.edges_i.shape[0] % 2 == 0
    ref = np.asarray(js.refine_robust(jnp.asarray(poses), graph, iterations=10, irls_passes=3))
    got = refine_robust(_t(poses), PoseGraph(*(_t(a) for a in graph)), iterations=10,
                        irls_passes=3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_rebuild_map_matches_jax(lap, jax_normals):
    """Four f64 scans at f64 poses merged into empty_map(capacity), f32 in
    both packages: the map promotes to f64 at the first merge, as JAX's."""
    scans, poses_true = lap
    idx = [0, 3, 6, 9]
    poses = np.stack([_moved(poses_true[k], [0.01 * k, 0.0, 0.0]) for k in idx])
    sel = [scans[k] for k in idx]
    ref = js.rebuild_map(sel, jnp.asarray(poses), capacity=2048, voxel=VOXEL)
    got = rebuild_map(sel, _t(poses), capacity=2048, voxel=VOXEL)
    for a, b in zip(got, ref):
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
    _assert_maps_match(got, ref, atol=1e-10)
