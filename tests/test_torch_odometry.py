"""The port's odometry layer (``dicp_tpu_torch.odometry``, ``ops.voxel``,
``utils.checkpoint``) against the JAX package's, f64 on the CPU: the cases
of ``tests/test_odometry.py`` and the checkpoint and voxel cases of
``tests/test_utils.py`` run on the port, and parity cases feed the same
numpy inputs through both packages.

The JAX references are computed once per module (fixtures) and the
sequences are the JAX suite's (at most 9 scans of the 65-point reference
cloud), so the JAX side compiles little."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import odometry as jodo  # noqa: E402
from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu.ops.voxel import voxel_downsample as jvoxel  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.config import ICPConfig  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.odometry import (PoseGraph, ate, compose_chain,  # noqa: E402
                                     edge_residual_and_jac, odometry,
                                     odometry_pose_graph, pose_graph_optimize,
                                     resumable_odometry)
from dicp_tpu_torch.ops.voxel import voxel_downsample  # noqa: E402
from dicp_tpu_torch.registration import register_jit  # noqa: E402
from dicp_tpu_torch.utils.checkpoint import (load_odometry_state,  # noqa: E402
                                             save_odometry_state)

from tests.conftest import DATA_DIR  # noqa: E402
from tests.test_odometry import CFG as JCFG  # noqa: E402
from tests.test_odometry import _make_sequence  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))
STEP = (0.05, 0.08, 0, 0, 0, 0.02)


def _t(a):
    return torch.as_tensor(np.array(a))


def _sequence(n_scans):
    """(scans (S, 65, 6), true poses (S, 4, 4)) as numpy, the JAX suite's."""
    scans, poses = _make_sequence(np.load(os.path.join(DATA_DIR, "points_map.npy")),
                                  n_scans=n_scans)
    return np.asarray(scans), np.asarray(poses)


@pytest.fixture(scope="module")
def seq6():
    return _sequence(6)


@pytest.fixture(scope="module")
def seq5():
    return _sequence(5)


@pytest.fixture(scope="module")
def jax_odo6(seq6):
    res = jodo.odometry(jnp.asarray(seq6[0]), JCFG)
    return jax.tree_util.tree_map(np.asarray, res)


def _rel_err(a, b):
    """|log(a b^-1)| per pair for (K, 4, 4) tensors."""
    return torch.linalg.vector_norm(se3.tran2vec(a @ torch.linalg.inv(b)), dim=-1)


# --- tests/test_odometry.py on the port -----------------------------------

def test_compose_chain():
    rng = np.random.default_rng(0)
    rel = se3.vec2tran(_t(rng.normal(size=(5, 6)) * 0.1))
    poses = compose_chain(rel)
    expect = np.eye(4)
    np.testing.assert_allclose(poses[0].numpy(), expect, atol=1e-14)
    for i in range(5):
        expect = expect @ rel[i].numpy()
        np.testing.assert_allclose(poses[i + 1].numpy(), expect, atol=1e-12)


def test_odometry_recovers_trajectory(seq6):
    scans, poses_true = seq6
    res = odometry(_t(scans), CFG)
    assert bool(torch.all(res.converged))
    err = ate(res.poses, _t(poses_true), align=False)
    assert float(err) < 1e-6, float(err)


def test_ate_alignment_invariance(seq6):
    scans, poses_true = seq6
    res = odometry(_t(scans), CFG)
    # a global rigid offset of the prediction is absorbed by alignment
    off = se3.vec2tran(_t([5.0, -2.0, 0, 0, 0, 0.7]))
    shifted = torch.einsum("ij,sjk->sik", off, res.poses)
    assert float(ate(shifted, _t(poses_true), align=True)) < 1e-5
    assert float(ate(shifted, _t(poses_true), align=False)) > 1.0


def _drift_graph(res, poses_true):
    """The odometry edges with edge 2 corrupted and down-weighted, plus a
    strong loop-closure edge 0 -> S-1 at the truth (numpy)."""
    S = res.poses.shape[0]
    bad = res.rel_transforms.clone()
    bad[2] = bad[2] @ se3.vec2tran(_t([0.1, 0.05, 0, 0, 0, 0.03]))
    i_odo = np.arange(S - 1)
    ei = np.concatenate([i_odo, [0]])
    ej = np.concatenate([i_odo + 1, [S - 1]])
    t_truth = np.linalg.inv(poses_true[0]) @ poses_true[S - 1]
    t_meas = np.concatenate([bad.numpy(), t_truth[None]])
    info = np.concatenate([np.ones(S - 1), [100.0]])
    info[2] = 0.01
    return bad, (ei, ej, t_meas, info)


def test_pose_graph_closes_drift(seq5):
    """Inject drift into an odometry edge; a loop-closure edge pulls the
    trajectory back, in f64 and in f32."""
    scans, poses_true = seq5
    res = odometry(_t(scans), CFG)
    bad, (ei, ej, t_meas, info) = _drift_graph(res, poses_true)
    poses_bad = compose_chain(bad)
    before = float(ate(poses_bad, _t(poses_true), align=False))
    assert before > 0.05
    graph = PoseGraph(_t(ei), _t(ej), _t(t_meas), _t(info))
    poses_opt, _ = pose_graph_optimize(poses_bad, graph, iterations=15)
    assert float(ate(poses_opt, _t(poses_true), align=False)) < before * 0.2
    # in f32 too (the card's dtype): the Jacobians stay f32
    graph32 = graph._replace(t_meas=graph.t_meas.float(), info=graph.info.float())
    poses32, cost32 = pose_graph_optimize(poses_bad.float(), graph32, iterations=15)
    assert poses32.dtype == torch.float32 and cost32.dtype == torch.float32
    assert float(ate(poses32.double(), _t(poses_true), align=False)) < before * 0.2


def test_odometry_pose_graph_with_loop_closures(seq5):
    scans, poses_true = seq5
    res = odometry_pose_graph(_t(scans), CFG, loop_closures=(_t([0]), _t([4])))
    assert float(ate(res.poses, _t(poses_true), align=False)) < 1e-5


def test_voxel_downsample_basic():
    pts = _t([[0.1, 0.1, 0.1],
              [0.2, 0.2, 0.2],   # same voxel as above at size 0.5
              [1.1, 0.0, 0.0],   # different voxel
              [1.2, 0.1, 0.0],   # same voxel as previous
              [5.0, 5.0, 5.0]])
    out = voxel_downsample(pts, 0.5)
    assert int(out.count) == 3
    w = out.weight.numpy()
    assert sorted(w[:3].tolist()) == [1.0, 2.0, 2.0]
    assert np.all(w[3:] == 0)
    p = out.points[:3].numpy()
    assert np.any(np.all(np.isclose(p, [0.15, 0.15, 0.15]), axis=-1))


def test_voxel_downsample_feeds_register():
    pts = _t(np.load(os.path.join(DATA_DIR, "points_map.npy"))[:, :3])
    out = voxel_downsample(pts, 0.4)
    assert int(out.count) <= pts.shape[0]
    assert bool(torch.isfinite(out.points).all())
    cfg = CFG.with_(icp_type="pt2pt", max_iterations=10, tolerance=1e-8)
    res = register_jit(out.points[None], pts[None], torch.eye(4, dtype=pts.dtype)[None],
                       out.weight[None], cfg=cfg)
    assert bool(torch.isfinite(res.T).all())


def _f32_sequence(S):
    mp = np.load(os.path.join(DATA_DIR, "points_map.npy")).astype(np.float32)
    step = np.asarray(jse3.vec2tran(jnp.asarray(STEP, jnp.float32)))
    T = np.eye(4, dtype=np.float32)
    scans = []
    for _ in range(S):
        Ti = np.linalg.inv(T)
        scans.append(np.hstack([mp[:, :3] @ Ti[:3, :3].T + Ti[:3, 3],
                                mp[:, 3:6] @ Ti[:3, :3].T]).astype(np.float32))
        T = T @ step
    return torch.as_tensor(np.stack(scans))


def test_resumable_odometry_matches_oneshot(tmp_path):
    """Kill-and-resume produces the trajectory of one shot."""
    scans = _f32_sequence(9)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, max_iterations=30,
                    tolerance=1e-6, dim=2, trim_dist=5.0,
                    loss_name="huber", loss_metric=1.0)
    oneshot = odometry(scans, cfg)
    # an interrupted run: 2 chunks of 3 of the 8 pairs, then resume
    ckpt = os.path.join(tmp_path, "odo.npz")
    resumable_odometry(scans[:7], cfg, checkpoint_path=ckpt, chunk=3)
    assert int(np.load(ckpt)["step"]) == 6
    resumed = resumable_odometry(scans, cfg, checkpoint_path=ckpt, chunk=3)
    np.testing.assert_allclose(resumed.poses.numpy(), oneshot.poses.numpy(), atol=1e-6)
    assert bool(torch.all(resumed.converged))


def test_odometry_symmetric(planes_scene):
    """Symmetric ICP through the odometry entry point keeps the source
    normals it needs."""
    scene = np.asarray(planes_scene)
    T_step = se3.vec2tran(_t([0.02, 0.01, 0.005, 0.002, 0.001, 0.004])).numpy()
    scans, T = [], np.eye(4)
    for _ in range(4):
        Ti = np.linalg.inv(T)
        scans.append(np.hstack([scene[:, :3] @ Ti[:3, :3].T + Ti[:3, 3],
                                scene[:, 3:6] @ Ti[:3, :3].T]))
        T = T @ T_step
    cfg = ICPConfig(icp_type="symmetric", differentiable=False, max_iterations=40,
                    tolerance=1e-12, dim=3, trim_dist=2.0, loss_name="huber",
                    loss_metric=1.0)
    res = odometry(_t(np.stack(scans)), cfg)
    errs = _rel_err(res.rel_transforms, _t(T_step).expand(3, 4, 4))
    assert float(errs.max()) < 1e-8, errs


# --- tests/test_utils.py's checkpoint and voxel cases on the port ----------

def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "odo.npz")
    poses = torch.eye(4, dtype=torch.float64).repeat(5, 1, 1)   # tensors are accepted
    rel = np.tile(np.eye(4), (4, 1, 1))
    save_odometry_state(path, poses, rel_transforms=rel,
                        edges_i=np.arange(4), edges_j=torch.arange(1, 5),
                        t_meas=rel, info=np.ones(4), step=7)
    state = load_odometry_state(path)
    np.testing.assert_array_equal(state["poses"], poses.numpy())
    np.testing.assert_array_equal(state["rel_transforms"], rel)
    np.testing.assert_array_equal(state["edges_j"], np.arange(1, 5))
    assert int(state["step"]) == 7
    # overwrite is atomic and idempotent
    save_odometry_state(path, poses[:2])
    state2 = load_odometry_state(path)
    assert state2["poses"].shape == (2, 4, 4)
    assert "step" not in state2
    with pytest.raises(ValueError, match="unloadable"):
        save_odometry_state(path, poses, edges_i=np.arange(4))
    assert load_odometry_state(path)["poses"].shape == (2, 4, 4)


def test_voxel_large_extent_no_overflow():
    """Linearised int32 cell keys would overflow at 4 km / 5 cm and merge
    unrelated voxels; the lexicographic sort must not."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    b = a + np.array([4000.0, 4000.0, 2000.0], np.float32)
    out = voxel_downsample(torch.as_tensor(np.vstack([a, b])), 0.05)
    cents = out.points[:int(out.count)].numpy()
    d_a = np.linalg.norm(cents - np.mean(a, 0), axis=1)
    d_b = np.linalg.norm(cents - np.mean(b, 0), axis=1)
    assert np.all((d_a < 10) | (d_b < 10)), "voxel key overflow merged clusters"


# --- parity with the JAX package --------------------------------------------

def test_compose_chain_matches_jax():
    rng = np.random.default_rng(1)
    for K in (1, 6, 13):
        rel = np.asarray(jax.vmap(jse3.vec2tran)(jnp.asarray(rng.normal(size=(K, 6)) * 0.3)))
        ref = np.asarray(jodo.compose_chain(jnp.asarray(rel)))
        got = compose_chain(_t(rel)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=f"K={K}")


def test_odometry_matches_jax_dense(seq6, jax_odo6):
    res = odometry(_t(seq6[0]), CFG)
    np.testing.assert_allclose(res.rel_transforms.numpy(), jax_odo6.rel_transforms,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.poses.numpy(), jax_odo6.poses, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res.iterations.numpy(), jax_odo6.iterations)
    np.testing.assert_array_equal(res.converged.numpy(), jax_odo6.converged)


def test_odometry_matches_jax_cluster(planes_scene):
    """The cluster tier on both sides (K2's plain version here)."""
    scene = np.asarray(planes_scene)
    T_step = np.asarray(jse3.vec2tran(jnp.asarray([0.03, 0.02, 0.01, 0.003, 0.002, 0.01])))
    scans, T = [], np.eye(4)
    for _ in range(4):
        Ti = np.linalg.inv(T)
        scans.append(np.hstack([scene[:, :3] @ Ti[:3, :3].T + Ti[:3, 3],
                                scene[:, 3:6] @ Ti[:3, :3].T]))
        T = T @ T_step
    scans = np.stack(scans)
    kw = dict(icp_type="pt2pl", differentiable=False, max_iterations=30, tolerance=1e-10,
              dim=3, trim_dist=2.0, loss_name="huber", loss_metric=1.0,
              nn_method="cluster", cluster_group=64)
    from dicp_tpu.config import ICPConfig as JConfig

    ref = jodo.odometry(jnp.asarray(scans), JConfig(**kw))
    res = odometry(_t(scans), ICPConfig(**kw))
    np.testing.assert_allclose(res.rel_transforms.numpy(), np.asarray(ref.rel_transforms),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    assert float(_rel_err(res.rel_transforms, _t(T_step).expand(3, 4, 4)).max()) < 1e-8


def test_pose_graph_optimize_matches_jax(seq5):
    scans, poses_true = seq5
    res = odometry(_t(scans), CFG)
    bad, (ei, ej, t_meas, info) = _drift_graph(res, poses_true)
    poses_bad = compose_chain(bad).numpy()
    ref_p, ref_c = jodo.pose_graph_optimize(
        jnp.asarray(poses_bad), jodo.PoseGraph(jnp.asarray(ei, jnp.int32),
                                               jnp.asarray(ej, jnp.int32),
                                               jnp.asarray(t_meas), jnp.asarray(info)),
        iterations=4)
    got_p, got_c = pose_graph_optimize(_t(poses_bad), PoseGraph(_t(ei), _t(ej), _t(t_meas),
                                                                _t(info)), iterations=4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-9)
    assert abs(float(got_c) - float(ref_c)) <= 1e-9 * abs(float(ref_c))
    # the shared linearisation itself
    r_j, Ji_j, Jj_j = jax.jit(jodo.edge_residual_and_jac, static_argnums=3)(
        jnp.asarray(poses_bad[1]), jnp.asarray(poses_bad[3]), jnp.asarray(t_meas[2]),
        jnp.float64)
    r_t, Ji_t, Jj_t = edge_residual_and_jac(_t(poses_bad[1]), _t(poses_bad[3]),
                                            _t(t_meas[2]), torch.float64)
    for a, b in ((r_t, r_j), (Ji_t, Ji_j), (Jj_t, Jj_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_voxel_downsample_matches_jax():
    """Points, weight and count equal, bit for bit (the same lexicographic
    order and the same in-order segment sums)."""
    rng = np.random.default_rng(2)
    for dtype, size in ((np.float64, 0.7), (np.float32, 0.5)):
        pts = (rng.normal(size=(3000, 6)) * 2).astype(dtype)
        ref = jvoxel(jnp.asarray(pts), size)
        got = voxel_downsample(torch.as_tensor(pts), size)
        np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
        assert int(got.count) == int(ref.count) and got.count.dtype == torch.int32
