"""``parallel/``'s programs: ``map_sharded_fn`` (the counterpart of JAX's
jitted ``shard_map`` of the same name) and the partitioned pose graph's
program, in a world of 2 gloo ranks (``tests/_torch_world.py``), f64.

On the CPU a program is its function: the map-sharded solve runs its host
loop, and the pose graph's fixed-trip loop as written.  The fixed trip that
the map-sharded solve's capture takes (run uncaptured: max_iterations + 1
all-reduces; on the ring its shifts in every step, its folds only in the
steps that run) is held to the host loop bit for bit in T, iterations,
convergence and cost; the host loop runs one all-reduce per iteration plus
the cost pass.  The pose graph is held to the dense ``pose_graph_optimize``
within 1e-4."""

import inspect
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dicp_tpu.parallel import sharding as j_sharding  # noqa: E402

from dicp_tpu_torch import ICPConfig  # noqa: E402
from dicp_tpu_torch.odometry import PoseGraph, pose_graph_optimize  # noqa: E402
from dicp_tpu_torch.parallel import sharding  # noqa: E402
from dicp_tpu_torch.parallel.pose_graph import _block_mask  # noqa: E402

from tests._torch_world import World  # noqa: E402
from tests.test_pose_graph_partitioned import _chain_graph  # noqa: E402


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def test_map_sharded_fn_has_jax_parameters():
    """JAX's parameter names, defaults and order."""
    ours = inspect.signature(sharding.map_sharded_fn).parameters
    theirs = inspect.signature(j_sharding.map_sharded_fn).parameters
    assert [(p.name, p.default) for p in ours.values()] == \
        [(p.name, p.default) for p in theirs.values()]


CASES = {
    # (entry, source rows, cfg): replicated target, padded source (n_real),
    # the cluster tier (the certificate gate in the all-reduce), the ring
    "replicated": ("register_map_sharded", 64,
                   ICPConfig(icp_type="pt2pl", max_iterations=30, tolerance=1e-8, trim_dist=5.0,
                             loss_name="huber", dim=2, nn_method="dense")),
    "padded": ("register_map_sharded", 63,
               ICPConfig(icp_type="pt2pt", max_iterations=30, tolerance=1e-8, dim=3,
                         nn_method="dense")),
    "cluster": ("register_map_sharded", 63,
                ICPConfig(icp_type="pt2pl", max_iterations=30, tolerance=1e-8, trim_dist=5.0,
                          nn_method="cluster", cluster_group=16, cluster_probes=4)),
    "ring": ("register_ring_sharded", 63,
             ICPConfig(icp_type="pt2pl", max_iterations=30, tolerance=1e-8, trim_dist=5.0)),
    "ift forward": ("register_map_sharded_ift", 64,
                    ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=30,
                              tolerance=1e-10, trim_dist=5.0, dim=2, nn_method="dense")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_equals_the_host_loop(world, source_np, target_np, case):
    """The fixed trip that map_sharded_fn's capture takes gives the host
    loop's bits (T, iterations, converged, cost) on every rank.  The host
    loop runs one all-reduce per iteration and one in the cost pass (the
    ring adds its shifts); the fixed trip runs max_iterations + 1
    all-reduces, and on the ring as many shifts.  Equal arguments give one
    cached callable."""
    entry, n, cfg = CASES[case]
    res = world.run("map_sharded_loops", (1, 2), source=source_np[:n, :3], target=target_np,
                    cfg=cfg, entry=entry)
    for r in res:
        trip, host = r["trip"], r["host"]
        np.testing.assert_array_equal(trip["T"], host["T"])
        assert (trip["iterations"], trip["converged"], trip["cost"]) == \
            (host["iterations"], host["converged"], host["cost"])
        np.testing.assert_array_equal(host["T"], res[0]["host"]["T"])
        for got, want in ((host, host["iterations"] + 1), (trip, cfg.max_iterations + 1)):
            counts = Counter({k: v for k, v in got["counts"]})
            assert sum(v for (kind, _, _), v in counts.items() if kind == "all_reduce") == want
            if case == "ring":   # K - 1 = 1 shift per pass
                assert sum(v for (kind, _, _), v in counts.items()
                           if kind == "ring_shift") == want
        assert host["converged"] and r["cached"]


def _partitioned(world, V, closures, iterations):
    rng = np.random.default_rng(V)
    _, poses_init, graph = _chain_graph(V, rng, closures)
    g = {name: np.array(getattr(graph, name)) for name in graph._fields}
    res = world.run("pose_graph", (1, 2), poses=np.asarray(poses_init), iterations=iterations,
                    **g)
    dense, _ = pose_graph_optimize(torch.as_tensor(np.array(poses_init)),
                                   PoseGraph(*(torch.as_tensor(g[n]) for n in graph._fields)),
                                   iterations=iterations)
    return res, dense.numpy()


@pytest.mark.parametrize("gauge", ["interior", "separator"])
def test_partitioned_program_equals_dense(world, gauge):
    """The partitioned program (fixed-trip loop, solve_ex, gauge masks by
    comparison) equals the dense back end within 1e-4 on every rank, pose 0
    an interior of rank 0 or (a closure (0, V-1)) a separator, with two
    all-reduces per iteration."""
    closures = [(2, 9)] if gauge == "interior" else [(0, 11), (2, 9)]
    iterations = 4
    res, dense = _partitioned(world, 12, closures, iterations)
    for r in res:
        np.testing.assert_allclose(r["poses"], dense, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(r["poses"], res[0]["poses"])
        assert sum(v for (kind, _, _), v in r["counts"] if kind == "all_reduce") == \
            2 * iterations


@pytest.mark.parametrize("size,block", [(30, 0), (30, 2), (30, 4), (18, -1)])
def test_gauge_masks_equal_the_slice_stores(size, block):
    """The gauge masks built by a comparison on the device equal the masks
    the slice stores built: 1.0 on the block's 6 entries (none for -1)."""
    want = torch.zeros((size,), dtype=torch.float64)
    if block >= 0:
        want[block * 6:(block + 1) * 6] = 1.0
    assert torch.equal(_block_mask(size, block, torch.float64, "cpu"), want)
