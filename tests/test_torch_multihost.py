"""``dicp_tpu_torch.parallel.multihost``: the single-process fallbacks of
``tests/test_parallel.py::test_multihost_single_process_fallbacks`` and the two
modes of ``tests/test_multiprocess.py``, f64 and f32 on the CPU.

The recipe (``initialize_distributed`` -> ``make_pod_mesh`` ->
``process_local_slice`` -> ``host_local_batch`` -> the batch-sharded solve)
runs in this process alone (a world of one), in a world of 8 gloo ranks on
one host (``tests/_torch_world.py``; the counterpart of JAX's 8 devices in one
process) and in a world of two hosts of one rank each (``LOCAL_WORLD_SIZE=1``;
JAX's two processes of 4 devices).  Each is held to the single-process solve
and to JAX's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dicp_tpu import parallel as jp  # noqa: E402
from dicp_tpu.config import ICPConfig as JICPConfig  # noqa: E402
from dicp_tpu.parallel.multihost import make_pod_mesh as j_make_pod_mesh  # noqa: E402
from dicp_tpu.odometry import pose_graph_optimize as j_pose_graph_optimize  # noqa: E402
from dicp_tpu.parallel.pose_graph import (  # noqa: E402
    pose_graph_optimize_partitioned as j_partitioned)
from dicp_tpu.registration import register_jit as j_register  # noqa: E402

from dicp_tpu_torch import se3  # noqa: E402
from dicp_tpu_torch.config import ICPConfig  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.odometry import PoseGraph, ate, pose_graph_optimize  # noqa: E402
from dicp_tpu_torch.parallel import register_batch_sharded  # noqa: E402
from dicp_tpu_torch.parallel.multihost import (host_local_batch,  # noqa: E402
                                               initialize_distributed, make_pod_mesh,
                                               process_local_slice)
from dicp_tpu_torch.registration import register  # noqa: E402

from tests._torch_world import World  # noqa: E402
from tests.test_parallel import CFG as JCFG  # noqa: E402

CFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def world8():
    w = World(8)
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2():
    w = World(2, local_world_size=1)
    yield w
    w.close()


def _t_true():
    xi = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.1], dtype=torch.float64)
    return se3.tran_inv(se3.vec2tran(xi)).numpy()


def _err(T_a, T_b) -> float:
    d = torch.as_tensor(np.asarray(T_a)) @ torch.linalg.inv(torch.as_tensor(np.asarray(T_b)))
    return float(torch.linalg.vector_norm(se3.tran2vec(d)))


def test_multihost_single_process_fallbacks(world8, monkeypatch, source_np, target_np):
    """The recipe runs unchanged in one process (initialization is a no-op,
    the mesh a world of one) and, in one host of 8 ranks, on the (4, 2) mesh
    that make_pod_mesh(map_per_host=2) builds; both recover the truth."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    B = 8
    src = np.stack([source_np[:, :3]] * B)
    tgt = np.stack([target_np] * B)
    ti = np.stack([np.eye(4)] * B)

    assert initialize_distributed() is False          # one process: a no-op
    assert not dist.is_initialized()
    sl = process_local_slice(B)
    assert sl == slice(0, B)                           # one process owns everything
    try:
        mesh = make_pod_mesh(devices="cpu")            # a world of one, gloo
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
        srcg, tgtg, tig = host_local_batch(mesh, src[sl], tgt[sl], ti[sl])
        assert tuple(srcg.shape) == (B,) + source_np[:, :3].shape
        res = register_batch_sharded(mesh, srcg, tgtg, tig, cfg=CFG)
        for i in range(B):
            assert _err(_t_true(), res.T[i].numpy()) < 1e-6
        with pytest.raises(ValueError, match="divide"):
            make_pod_mesh(map_per_host=3, devices="cpu")
    finally:
        dist.destroy_process_group()

    ranks = world8.run("pod_recipe", None, map_per_host=2, source=src, target=tgt, T_init=ti,
                       cfg=CFG)
    ref = jp.register_batch_sharded(j_make_pod_mesh(map_per_host=2),
                                    jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), cfg=JCFG)
    for rank, r in enumerate(ranks):
        assert r["distributed"] and r["world"] == 8
        assert r["shape"] == (4, 2) and r["names"] == ("batch", "map")
        assert r["slice"] == (0, B) and r["global_shape"] == (B,) + source_np[:, :3].shape
        assert r["rows"] == [2 * (rank // 2), 2 * (rank // 2) + 1]   # the batch row's pairs
        assert r["solve_counts"] == [] and r["psum"] == B
        for i, T in zip(r["rows"], r["T"]):
            assert _err(_t_true(), T) < 1e-6
            np.testing.assert_allclose(T, np.asarray(ref.T[i]), atol=1e-10)


def _posegraph_case():
    """tests/_mp_worker.py's deterministic noisy chain (V = 16, seed 3) and
    its loop closure (2, 13)."""
    rng = np.random.default_rng(3)
    V = 16
    xi_steps = rng.normal(scale=0.1, size=(V - 1, 6))
    poses_true = [np.eye(4)]
    for k in range(V - 1):
        poses_true.append(poses_true[-1] @ se3.vec2tran(torch.as_tensor(xi_steps[k])).numpy())
    poses_true = np.stack(poses_true)
    edges_i = np.array([*range(V - 1), 2], np.int32)
    edges_j = np.array([*range(1, V), 13], np.int32)
    t_meas = np.stack([np.linalg.solve(poses_true[i], poses_true[j])
                       for i, j in zip(edges_i, edges_j)])
    noise = rng.normal(scale=0.05, size=(V, 6))
    noise[0] = 0.0
    poses_init = poses_true @ se3.vec2tran(torch.as_tensor(noise)).numpy()
    return poses_true, poses_init, edges_i, edges_j, t_meas, np.ones(len(edges_i))


@pytest.mark.parametrize("mode", ["batch", "posegraph"])
def test_two_process_batch_sharded_registration(world2, mode):
    """Two hosts of one rank each: the batch axis (and with it the pose
    graph's partition axis) crosses the host boundary, so the all-reduces
    cross processes."""
    if mode == "posegraph":
        poses_true, poses_init, ei, ej, tm, info = _posegraph_case()
        ranks = world2.run("pose_graph", None, poses=poses_init, edges_i=ei, edges_j=ej,
                           t_meas=tm, info=info, iterations=8, axis="batch", pod_map_per_host=1)
        part = ranks[0]["poses"]
        np.testing.assert_array_equal(ranks[1]["poses"], part)
        graph = PoseGraph(*(torch.as_tensor(a) for a in (ei, ej, tm, info)))
        dense, _ = pose_graph_optimize(torch.as_tensor(poses_init), graph, iterations=8)
        np.testing.assert_allclose(part, dense.numpy(), atol=1e-6)
        assert float(ate(torch.as_tensor(part), torch.as_tensor(poses_true))) < 1e-5
        jgraph = type(graph)(*(jnp.asarray(a) for a in (ei, ej, tm, info)))
        theirs = j_partitioned(jnp.asarray(poses_init), jgraph, jp.make_mesh((2, 4)),
                               iterations=8, axis="batch")
        np.testing.assert_allclose(part, np.asarray(theirs), atol=1e-10)
        j_dense, _ = j_pose_graph_optimize(jnp.asarray(poses_init), jgraph, iterations=8)
        np.testing.assert_allclose(part, np.asarray(j_dense), atol=1e-6)
        return

    base = "tests/data/"
    scan = np.load(base + "points_scan.npy").astype(np.float32)
    mp = np.load(base + "points_map.npy").astype(np.float32)
    B = 4
    rng = np.random.RandomState(7)            # the same stream as the JAX worker's
    src = np.stack([scan[:, :3] + 0.01 * rng.randn(1, 3).astype(np.float32) for _ in range(B)])
    tgt = np.stack([mp] * B)
    ti = np.stack([np.eye(4, dtype=np.float32)] * B)
    cfg = ICPConfig(icp_type="pt2pl", differentiable=False, driver="while", max_iterations=60,
                    tolerance=1e-6, dim=2, trim_dist=5.0, loss_name="huber", loss_metric=1.0)
    ranks = world2.run("pod_recipe", None, map_per_host=1, source=src, target=tgt, T_init=ti,
                       cfg=cfg)
    ref = register(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti), None, cfg)
    j_ref = j_register(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti), None,
                       cfg=JICPConfig(**dataclasses.asdict(cfg)))
    for rank, r in enumerate(ranks):
        assert r["distributed"] and r["world"] == 2 and r["shape"] == (2, 1)
        assert r["slice"] == (2 * rank, 2 * rank + 2) and r["rows"] == [2 * rank, 2 * rank + 1]
        assert r["solve_counts"] == [] and r["psum"] == B
        np.testing.assert_allclose(r["T"], ref.T.numpy()[r["rows"]], atol=1e-5)
        np.testing.assert_allclose(r["T"], np.asarray(j_ref.T)[r["rows"]], atol=1e-5)
        np.testing.assert_array_equal(r["converged"], ref.converged.numpy()[r["rows"]])
