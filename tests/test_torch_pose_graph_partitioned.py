"""The port's partitioned (Schur-complement, all-reduce) pose-graph solve
against its dense one and against JAX's partitioned solve: the cases of
``tests/test_pose_graph_partitioned.py``, f64.

``partition_graph`` is a numpy copy of JAX's, and its arrays must equal
JAX's exactly.  The solve runs in a world of 8 gloo ranks
(``tests/_torch_world.py``) on the meshes of the JAX cases; it must match the
port's dense back end within 1e-6, JAX's partitioned solve within 1e-10, and
run two all-reduces per Gauss-Newton step (the reduced separator system and
the (V, 6) update)."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dicp_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from dicp_tpu.parallel.pose_graph import (partition_graph as j_partition_graph,  # noqa: E402
                                          pose_graph_optimize_partitioned as j_partitioned)

from dicp_tpu_torch.odometry import PoseGraph, pose_graph_optimize  # noqa: E402
from dicp_tpu_torch.parallel.pose_graph import partition_graph  # noqa: E402

from tests._torch_world import World  # noqa: E402
from tests.test_pose_graph_partitioned import _chain_graph  # noqa: E402


@pytest.fixture(scope="module")
def world():
    w = World(8)
    yield w
    w.close()


def _numpy_graph(graph):
    return {name: np.array(getattr(graph, name)) for name in graph._fields}


def _assert_partitions_equal(ours, theirs):
    for name in ours._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _solve_both(world, poses_init, graph, shape, iterations):
    """(the port's partitioned poses, equal on every rank; the port's dense
    poses; JAX's partitioned poses) and the ranks' collective counts."""
    g = _numpy_graph(graph)
    res = world.run("pose_graph", shape, poses=np.asarray(poses_init), iterations=iterations,
                    **g)
    for r in res[1:]:
        np.testing.assert_array_equal(r["poses"], res[0]["poses"])
        assert r["counts"] == res[0]["counts"]
    dense, _ = pose_graph_optimize(torch.as_tensor(np.array(poses_init)),
                                   PoseGraph(*(torch.as_tensor(g[n]) for n in graph._fields)),
                                   iterations=iterations)
    theirs = j_partitioned(poses_init, graph, j_make_mesh(shape), iterations=iterations)
    return res[0]["poses"], dense.numpy(), np.asarray(theirs), res[0]["counts"]


def _two_per_step(counts, V, n_parts, S, iterations):
    want = Counter({("all_reduce", n_parts, (6 * S) ** 2 + 6 * S): iterations})
    want[("all_reduce", n_parts, 6 * V)] += iterations
    assert dict(counts) == dict(want), counts


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitioned_matches_dense(world, n_parts):
    rng = np.random.default_rng(0)
    V = 16
    poses_true, poses_init, graph = _chain_graph(V, rng, loop_closures=[(2, 13)])
    ours = partition_graph(V, np.asarray(graph.edges_i), np.asarray(graph.edges_j), n_parts)
    _assert_partitions_equal(ours, j_partition_graph(V, np.asarray(graph.edges_i),
                                                     np.asarray(graph.edges_j), n_parts))
    part, dense, theirs, counts = _solve_both(world, poses_init, graph, (8 // n_parts, n_parts),
                                              iterations=8)
    np.testing.assert_allclose(part, dense, atol=1e-6)
    err = np.max(np.abs(part - np.asarray(poses_true)))
    assert err < 1e-5, f"pose error {err}"
    np.testing.assert_allclose(part, theirs, atol=1e-10)
    _two_per_step(counts, V, n_parts, ours.sep_ids.shape[0], 8)


def test_partition_structure():
    """Separators = endpoints of cross-partition edges; interiors disjoint;
    the arrays equal JAX's."""
    V = 12
    edges_i = np.array([*range(V - 1), 1])
    edges_j = np.array([*range(1, V), 10])
    part = partition_graph(V, edges_i, edges_j, 4)
    _assert_partitions_equal(part, j_partition_graph(V, edges_i, edges_j, 4))

    ints = part.int_ids[part.int_ids >= 0]
    assert len(set(ints.tolist())) == len(ints), "interior owned twice"
    assert set(ints.tolist()).isdisjoint(set(part.sep_ids.tolist()))
    # chain boundaries at 2|3, 5|6, 8|9 plus loop closure 1-10
    for v in (1, 10):
        assert v in part.sep_ids.tolist()
    assert int(part.e_valid.sum()) == len(edges_i)


def test_partitioned_no_loop_closures(world):
    """Pure chain: separators are just the partition boundary poses."""
    rng = np.random.default_rng(1)
    V = 9
    _, poses_init, graph = _chain_graph(V, rng)
    part, dense, theirs, counts = _solve_both(world, poses_init, graph, (2, 4), iterations=6)
    np.testing.assert_allclose(part, dense, atol=1e-6)
    np.testing.assert_allclose(part, theirs, atol=1e-10)
    S = partition_graph(V, np.asarray(graph.edges_i), np.asarray(graph.edges_j),
                        4).sep_ids.shape[0]
    _two_per_step(counts, V, 4, S, 6)


def test_partitioned_gauge_on_a_separator(world):
    """Pose 0 as a separator (a closure 0 -> 9 crosses the partition): the
    gauge is fixed in the reduced system, after the all-reduce."""
    rng = np.random.default_rng(2)
    V = 12
    poses_true, poses_init, graph = _chain_graph(V, rng, loop_closures=[(0, 9)])
    assert partition_graph(V, np.asarray(graph.edges_i), np.asarray(graph.edges_j),
                           4).gauge_sep >= 0
    part, dense, theirs, _ = _solve_both(world, poses_init, graph, (2, 4), iterations=8)
    np.testing.assert_allclose(part, dense, atol=1e-6)
    np.testing.assert_allclose(part, theirs, atol=1e-10)
    np.testing.assert_array_equal(part[0], np.asarray(poses_init)[0])
    assert np.max(np.abs(part - np.asarray(poses_true))) < 1e-5
