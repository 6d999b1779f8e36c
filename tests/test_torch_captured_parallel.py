"""``parallel/``'s programs: ``map_sharded_fn`` (the counterpart of JAX's
jitted ``shard_map`` of the same name) and the partitioned pose graph's
program, in a world of 2 gloo ranks (``tests/_torch_world.py``), f64.

On the CPU a program is its function: the map-sharded solve runs its host
loop, and the pose graph's fixed-trip loop as written.  The fixed trip that
the map-sharded solve's capture takes (run uncaptured: max_iterations + 1
all-reduces; on the ring its shifts in every step, its folds only in the
steps that run) is held to the host loop bit for bit in T, iterations,
convergence and cost; the host loop runs one all-reduce per iteration plus
the cost pass.  Differentiated (the trip that a program pair or a program
calling ``torch.autograd.grad`` records), the trip's gradients into the
source, the target and the weight equal the host loop's bit for bit, and
its backward runs one all-reduce of the pose's cotangent per step (on the
ring also one reverse shift per ring call, every step's).  The pose graph
is held to the dense ``pose_graph_optimize`` within 1e-4."""

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
            counts = Counter({k: v for k, v in got["counts_fwd"]})
            assert sum(v for (kind, _, _), v in counts.items() if kind == "all_reduce") == want
            if case == "ring":   # K - 1 = 1 shift per pass
                assert sum(v for (kind, _, _), v in counts.items()
                           if kind == "ring_shift") == want
        assert host["converged"] and r["cached"]


GRAD_CASES = {
    # (entry, source rows, cfg, the inputs differentiated): the dense tier at
    # pt2pl, the cluster tier with a padded source (n_real; the certificate
    # gate in the all-reduce), and the ring (its target padded by a sentinel
    # row; the target's cotangent through the reverse ring)
    "pt2pl": ("register_map_sharded", 64,
              ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=30, tolerance=1e-10,
                        trim_dist=5.0, loss_name="huber", dim=2, nn_method="dense"),
              ("source", "target", "weight")),
    "cluster": ("register_map_sharded", 63,
                ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=30,
                          tolerance=1e-10, trim_dist=5.0, loss_name="huber",
                          nn_method="cluster", cluster_group=16, cluster_probes=4),
                ("source", "target", "weight")),
    "ring": ("register_ring_sharded", 64,
             ICPConfig(icp_type="pt2pl", differentiable=True, max_iterations=30, tolerance=1e-8,
                       trim_dist=5.0, loss_name="huber", dim=2),
             ("source", "target", "weight")),
}


def _all_reduces(counts, kind_wanted: str = "all_reduce") -> int:
    return sum(v for (kind, _, _), v in counts if kind == kind_wanted)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_fixed_trip_gradient_equals_the_host_loop(world, source_np, target_np, case):
    """The differentiable fixed trip (what a captured map-sharded solve on
    which autograd records runs) gives the host loop's T, cost and
    gradients into the source, the target and the weight bit for bit on
    every rank, the loss sum(T * probe) + 0.1 cost.  All-reduces: forward
    max_iterations + 1 for the trip and iterations + 1 for the host loop;
    backward max_iterations and iterations plus one for each input
    differentiated: the pose's cotangent once per step after the first
    (whose pose is T_init's) and in the cost pass, and each input's (the
    ring's target too: register_ring_sharded sums its cotangent over the
    ranks, so that each holds the global gradient).  The ring's backward
    adds K - 1 = 1 reverse shift per ring call: max_iterations + 1 for the
    trip (a skipped step's shifts a zero buffer), iterations + 1 for the
    host loop, as many as its forward's shifts."""
    entry, n, cfg, names = GRAD_CASES[case]
    rng = np.random.default_rng(5)
    src = source_np[:n, :3] + rng.normal(scale=2e-2, size=(n, 3)) * [1, 1, 0]
    res = world.run("map_sharded_loops", (1, 2), source=src, target=target_np, cfg=cfg,
                    entry=entry, weight=rng.uniform(0.5, 1.5, n), grad_wrt=names,
                    probe=np.linspace(0.5, 1.5, 16).reshape(4, 4), cost_scale=0.1)
    for r in res:
        trip, host = r["trip"], r["host"]
        it = host["iterations"]
        assert host["converged"] and 1 < it < cfg.max_iterations
        np.testing.assert_array_equal(trip["T"], host["T"])
        assert (trip["iterations"], trip["converged"], trip["cost"]) == \
            (it, host["converged"], host["cost"])
        for name in names:
            np.testing.assert_array_equal(trip["grads"][name], host["grads"][name])
            np.testing.assert_array_equal(trip["grads"][name], res[0]["trip"]["grads"][name])
            assert np.abs(trip["grads"][name]).max() > 0, name
        assert _all_reduces(host["counts_fwd"]) == it + 1
        assert _all_reduces(trip["counts_fwd"]) == cfg.max_iterations + 1
        assert _all_reduces(host["counts_bwd"]) == it + len(names)
        assert _all_reduces(trip["counts_bwd"]) == cfg.max_iterations + len(names)
        kinds = {"all_reduce"}
        if case == "ring":
            kinds.add("ring_shift_reverse")
            for got, want in ((host, it + 1), (trip, cfg.max_iterations + 1)):
                assert _all_reduces(got["counts_bwd"], "ring_shift_reverse") == want
                assert _all_reduces(got["counts_fwd"], "ring_shift") == want
        assert {kind for (kind, _, _), _ in trip["counts_bwd"]} == kinds


def test_captured_ring_target_gradient_equals_the_host_loop(world, source_np, target_np):
    """The differentiable trip of a captured ring-sharded solve gives the
    host loop's gradient into the target alone (no other input requires
    grad; the loss sum(T), so the cost pass is not differentiated) bit for
    bit on both ranks: nonzero, of the caller's 65 rows (the sentinel row's
    share dropped), the same on both.  Reverse shifts: one per step's ring
    call, max_iterations for the trip (the skipped steps' add nothing) and
    iterations for the host loop."""
    cfg = GRAD_CASES["ring"][2]
    res = {}
    for form, trip in (("host", False), ("trip", True)):
        res[form] = world.run("map_sharded", (1, 2), source=source_np[:64, :3],
                              target=target_np, cfg=cfg, entry="register_ring_sharded",
                              grad_wrt=("target",), fixed_trip=trip)
    for host, trip in zip(res["host"], res["trip"]):
        g = trip["grads"]["target"]
        np.testing.assert_array_equal(g, host["grads"]["target"])
        np.testing.assert_array_equal(g, res["trip"][0]["grads"]["target"])
        assert g.shape == target_np.shape and np.abs(g).max() > 0
        np.testing.assert_array_equal(trip["T"], host["T"])
        assert _all_reduces(host["counts_bwd"], "ring_shift_reverse") == host["iterations"]
        assert _all_reduces(trip["counts_bwd"], "ring_shift_reverse") == cfg.max_iterations


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
