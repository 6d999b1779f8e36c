"""The odometry back end and the other solvers as programs that run captured
on the card: batched ``odometry`` (``odometry._odometry_program``), the dense
pose graph (``odometry._pose_graph_program``), ``register_gicp_jit`` and
``register_sgd_jit``, and ``map_step(solver="sgd")``.

On the CPU each runs uncaptured, its early-exit loops the device-loop
bodies (a masked body over a state held in tensors, run by
``jit.device_while`` in a host loop; chip_smoke.py phase 25 holds the
captured programs to these on the card).  Held here, in f64, to JAX's
compiled programs (T within 1e-10; iterations and convergence equal;
GICP's and SGD's costs within 1e-12) and to the eager forms they replaced
bit for bit: the batched solve on ``register``'s host loop, the GICP loop
that checked its exit on the host, SGD's per-iteration draws.  One more
masked body changes no bit; the loops' counters are 0-dim int32 tensors.
Sizes stay small: the JAX suite's 65-point sequences, 300-600-point GICP
pairs, 1,500-point SGD scenes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dicp_tpu import gicp as jg  # noqa: E402
from dicp_tpu import mapping as jm  # noqa: E402
from dicp_tpu import odometry as jodo  # noqa: E402
from dicp_tpu import se3 as jse3  # noqa: E402
from dicp_tpu import sgd_icp as jsgd  # noqa: E402
from dicp_tpu.ops.normals import estimate_normals_weighted as j_weighted  # noqa: E402

from dicp_tpu_torch import gicp, odometry, register, sgd_icp  # noqa: E402
from dicp_tpu_torch import jit as jit_mod  # noqa: E402
from dicp_tpu_torch import mapping as tm  # noqa: E402
from dicp_tpu_torch.convert import config_from_dict  # noqa: E402
from dicp_tpu_torch.gicp import register_gicp, register_gicp_jit  # noqa: E402
from dicp_tpu_torch.mapping import LocalMap, map_step  # noqa: E402
from dicp_tpu_torch.odometry import PoseGraph, pose_graph_optimize  # noqa: E402
from dicp_tpu_torch.sgd_icp import (SeededSampler, plan_solve, register_sgd,  # noqa: E402
                                    register_sgd_jit)

from tests.test_gicp import XI, _pair  # noqa: E402
from tests.test_mapping import CFG as JCFG_MAP  # noqa: E402
from tests.test_mapping import _sequence  # noqa: E402
from tests.test_odometry import CFG as JCFG_ODO  # noqa: E402
from tests.test_odometry import _make_sequence  # noqa: E402
from tests.test_torch_captured_solvers import _assert_bit_equal, _one_more  # noqa: E402
from tests.test_torch_gicp import _noisy_case  # noqa: E402
from tests.test_torch_mapping import _assert_maps_match  # noqa: E402
from tests.test_torch_sgd_icp import JaxSampler, _np_pair  # noqa: E402

DATA = "tests/data/points_map.npy"


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


# --- batched odometry and the dense pose graph ------------------------------

ODO_CFG = config_from_dict(dataclasses.asdict(JCFG_ODO))
ODO_CASES = {"dense": {}, "cluster": dict(nn_method="cluster", cluster_group=16,
                                          cluster_probes=4)}


@pytest.fixture(scope="module")
def seq():
    scans, poses = _make_sequence(np.load(DATA), n_scans=6)
    return np.asarray(scans), np.asarray(poses)


@pytest.mark.parametrize("case", list(ODO_CASES))
def test_odometry_program_matches_jax_and_the_eager_loop(seq, monkeypatch, case):
    """odometry() through its program (the batched solve's device-loop body,
    then the prefix product) against JAX's jitted odometry, and against the
    same program on register's host loop, bit for bit."""
    kw = ODO_CASES[case]
    ref = jodo.odometry(jnp.asarray(seq[0]), JCFG_ODO.with_(**kw))
    got = odometry.odometry(seq[0], ODO_CFG.with_(**kw), device="cpu")
    for name in ("poses", "rel_transforms"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    for name in ("iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    monkeypatch.setattr(odometry, "_register_program", register)
    _assert_bit_equal(odometry.odometry(seq[0], ODO_CFG.with_(**kw), device="cpu"), got)


def _graph(V: int = 9, seed: int = 5):
    """A chain of V noisy poses with 4 loop edges (f64 numpy)."""
    rng = np.random.default_rng(seed)
    truth = np.asarray(jax.vmap(jse3.vec2tran)(jnp.asarray(rng.normal(scale=0.4, size=(V, 6)))))
    ei = np.concatenate([np.arange(V - 1), [0, 2, 4, 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, V), [5, 7, 8, 6]]).astype(np.int32)
    noise = np.asarray(jax.vmap(jse3.vec2tran)(jnp.asarray(
        rng.normal(scale=0.02, size=(ei.shape[0], 6)))))
    t_meas = np.linalg.inv(truth[ei]) @ truth[ej] @ noise
    poses = truth @ np.asarray(jax.vmap(jse3.vec2tran)(jnp.asarray(
        rng.normal(scale=0.05, size=(V, 6)))))
    poses[0] = truth[0]
    info = rng.uniform(0.5, 2.0, size=ei.shape[0])
    return poses, (ei, ej, t_meas, info)


def _pose_graph_unmasked(poses, graph, iterations, damping=1e-6):
    """The eager loop the program replaced: the gauge mask by an indexed
    store and torch.linalg.solve, which checks its result on the host."""
    V = poses.shape[0]
    dtype = poses.dtype
    ei, ej = graph.edges_i.long(), graph.edges_j.long()
    rj = torch.func.vmap(lambda a, b, c: odometry.edge_residual_and_jac(a, b, c, dtype))
    m = torch.zeros((V * 6,), dtype=dtype)
    m[:6] = 1.0
    keep, eye, w = 1.0 - m, torch.eye(V * 6, dtype=dtype), graph.info[:, None, None]
    for _ in range(iterations):
        r, J_i, J_j = rj(poses[ei], poses[ej], graph.t_meas)
        H = torch.zeros((V, V, 6, 6), dtype=dtype)
        b = torch.zeros((V, 6), dtype=dtype)
        for rows, J_row, J_col, cols in ((ei, J_i, J_i, ei), (ei, J_i, J_j, ej),
                                         (ej, J_j, J_i, ei), (ej, J_j, J_j, ej)):
            H.index_put_((rows, cols), torch.einsum("eab,eac->ebc", J_row * w, J_col),
                         accumulate=True)
        b.index_put_((ei,), torch.einsum("eab,ea->eb", J_i * w, r), accumulate=True)
        b.index_put_((ej,), torch.einsum("eab,ea->eb", J_j * w, r), accumulate=True)
        Hd = H.permute(0, 2, 1, 3).reshape(V * 6, V * 6) + damping * eye
        Hd = Hd * keep[:, None] * keep[None, :] + torch.diag(m)
        delta = -torch.linalg.solve(Hd, b.reshape(V * 6) * keep).reshape(V, 6)
        poses = poses @ odometry.se3.vec2tran(delta)
    r, _, _ = rj(poses[ei], poses[ej], graph.t_meas)
    return poses, torch.sum(graph.info * torch.sum(r * r, dim=-1))


@pytest.mark.parametrize("iterations", [1, 6])
def test_pose_graph_program_matches_jax_and_the_eager_loop(iterations):
    """pose_graph_optimize (solve_ex, the gauge mask built as a comparison)
    against JAX's within 1e-10, against the loop it replaced bit for bit,
    and against pose_graph_optimize_partitioned in a world of one rank."""
    poses, (ei, ej, t_meas, info) = _graph()
    ref_p, ref_c = jodo.pose_graph_optimize(
        jnp.asarray(poses), jodo.PoseGraph(*(jnp.asarray(a) for a in (ei, ej, t_meas, info))),
        iterations=iterations)
    graph = PoseGraph(_t(ei), _t(ej), _t(t_meas), _t(info))
    got_p, got_c = pose_graph_optimize(_t(poses), graph, iterations=iterations)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-10)
    assert abs(float(got_c) - float(ref_c)) <= 1e-10 * abs(float(ref_c))
    old_p, old_c = _pose_graph_unmasked(_t(poses), graph, iterations)
    assert torch.equal(got_p, old_p) and torch.equal(got_c, old_c)

    import torch.distributed as dist

    from dicp_tpu_torch.parallel import make_mesh
    from dicp_tpu_torch.parallel.pose_graph import pose_graph_optimize_partitioned

    mesh = make_mesh((1, 1), devices="cpu")
    try:
        part = pose_graph_optimize_partitioned(_t(poses), graph, mesh, iterations=iterations)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(part.numpy(), got_p.numpy(), rtol=0, atol=1e-10)


# --- GICP ---------------------------------------------------------------------

def _gicp_unmasked(src, tgt, tgt_n, src_n, T0, weight, *, epsilon, trim2, max_iterations,
                   tolerance):
    """The loop the masked body replaced: a step per iteration while an
    element is active, checked on the host."""
    N = src.shape[0]
    T, it = T0, src.new_zeros((N,))
    done = torch.zeros((N,), dtype=torch.bool)
    cost = torch.full((N,), torch.inf, dtype=src.dtype)
    for _ in range(max_iterations):
        active = ~done
        if not bool(torch.any(active)):
            break
        T_new, dn, cost_new = gicp._gicp_step(T, src, src_n, tgt, tgt_n, weight, epsilon, trim2)
        T = torch.where(active[:, None, None], T_new, T)
        cost = torch.where(active, cost_new, cost)
        it = torch.where(active, it + 1.0, it)
        done = done | (active & (dn < tolerance))
    return T, it, done, cost


def _gicp_inputs(case):
    if case == "clean":
        S, Tg, Ti, _ = _pair(XI, n=300)
        return (np.asarray(S), np.asarray(Tg), np.asarray(Ti), None,
                dict(max_iterations=60, tolerance=1e-12))
    S, Tg, Ti, w = _noisy_case()
    return S, Tg, Ti, w, dict(max_iterations=30, tolerance=1e-10, trim_dist=1.0, epsilon=2e-3)


GICP_CASES = {"clean": ("clean", {}), "noisy": ("noisy", {}),
              "noisy, capped at 2": ("noisy", dict(max_iterations=2))}


@pytest.mark.parametrize("case", list(GICP_CASES))
def test_register_gicp_jit_matches_jax_and_the_unmasked_loop(case):
    """register_gicp_jit (estimated normals of a 3-column target inside the
    program) against JAX's within tests/test_torch_gicp.py's tolerances;
    register_gicp gives its bits, and so does the loop the body replaced."""
    inputs, extra = GICP_CASES[case]
    S, Tg, Ti, w, kw = _gicp_inputs(inputs)
    kw = {**kw, **extra}
    ref = jg.register_gicp_jit(jnp.asarray(S), jnp.asarray(Tg), jnp.asarray(Ti),
                               None if w is None else jnp.asarray(w), **kw)
    args = (_t(S), _t(Tg), _t(Ti), None if w is None else _t(w))
    got = register_gicp_jit(*args, **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=0, atol=1e-12)
    if "capped" in case:
        assert not bool(torch.any(got.converged)) and got.iterations.tolist() == [2.0, 2.0]
    _assert_bit_equal(register_gicp(*args, **kw), got)
    src, tgt, tgt_n, src_n, weight, T0 = gicp._prepare(*args[:3], args[3], None, 16, "gicp")
    trim = kw.get("trim_dist")
    old = _gicp_unmasked(src, tgt, tgt_n, src_n, T0, weight, epsilon=kw.get("epsilon", 1e-3),
                         trim2=float("inf") if trim is None else trim ** 2,
                         max_iterations=kw["max_iterations"], tolerance=kw["tolerance"])
    _assert_bit_equal(got, gicp.GICPResult(*old))


def test_gicp_extra_masked_body_changes_no_bit(monkeypatch):
    S, Tg, Ti, w, kw = _gicp_inputs("noisy")
    args = (_t(S), _t(Tg), _t(Ti), _t(w))
    plain = register_gicp(*args, **kw)
    seen = []
    monkeypatch.setattr(gicp, "device_while", _one_more(seen))
    _assert_bit_equal(register_gicp(*args, **kw), plain)
    (state,) = seen
    count, flag = state["count"], state["flag"]
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(plain.iterations.max()) and not bool(flag)


# --- SGD-ICP ------------------------------------------------------------------

N_SGD, KEY = 1500, 3
SGD_CASES = {
    "gn dense pt2pl": dict(tolerance=1e-8),
    "gn cluster pt2pl": dict(tolerance=1e-8, nn_method="cluster", cluster_group=64),
    "adam pt2pt": dict(icp_type="pt2pt", optimizer="adam", lr=0.05, tolerance=0.0),
}


@pytest.fixture(scope="module")
def sgd_pair():
    return _np_pair(n=N_SGD)


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_register_sgd_jit_matches_jax_on_its_draws(sgd_pair, case):
    """register_sgd_jit on JAX's randint(fold_in(key, it)) draws, served
    through the sampler protocol and drawn ahead by the call's host work:
    T within 1e-10, iterations and convergence equal, cost within 1e-12;
    register_sgd gives its bits."""
    src, tgt, ti, _ = sgd_pair
    kw = dict(minibatch=256, iterations=40, **SGD_CASES[case])
    ref = jsgd.register_sgd(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ti),
                            jax.random.key(KEY), **kw)
    args = (torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti))
    sampler = JaxSampler(jax.random.split(jax.random.key(KEY), 1))
    got = register_sgd_jit(*args, sampler, **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=0, atol=1e-12)
    assert sampler.calls == 40
    plan = plan_solve(sampler, 1, src.shape[1], "cpu", torch.float64, iterations=40,
                      minibatch=256, optimizer=kw.get("optimizer", "gn"), lr=kw.get("lr", 0.1))
    _assert_bit_equal(register_sgd(*args, plan, **kw), got)


def test_drawn_ahead_block_equals_per_iteration_draws():
    """plan_solve asks the source once per iteration: its block equals the
    per-iteration draws of SeededSampler (and of a sequence of sources);
    the schedule's rows are _step_delta's host scalars of the parent."""
    n, k, its = 700, 33, 6
    for key in (SeededSampler(7), [SeededSampler(1), SeededSampler(2)]):
        plan = plan_solve(key, 2, n, "cpu", torch.float64, iterations=its, minibatch=k)
        sampler = sgd_icp.minibatch_sampler(key, 2)
        assert plan.indices.shape == (its, 2, k) and plan.indices.dtype == torch.int64
        assert plan.schedule is None
        for it in range(its):
            assert torch.equal(plan.indices[it], sampler.indices([0, 1], it, k, n, "cpu"))
    plan = plan_solve(7, 1, n, "cpu", torch.float32, iterations=its, minibatch=k,
                      optimizer="adam", lr=0.05, lr_decay=0.1)
    for it in range(its):
        t = torch.tensor(float(it), dtype=torch.float32)
        lr_t = (0.05 / (1.0 + 0.1 * t)).item()
        c1 = (1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), t + 1.0)).item()
        c2 = (1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), t + 1.0)).item()
        assert plan.schedule[it].tolist() == [lr_t, c1, c2]


def test_sgd_extra_masked_body_changes_no_bit(sgd_pair, monkeypatch):
    src, tgt, ti, _ = sgd_pair
    args = (torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(ti), 5)
    kw = dict(minibatch=128, iterations=40, tolerance=1e-8)
    plain = register_sgd(*args, **kw)
    assert bool(plain.converged[0]) and float(plain.iterations[0]) < 40
    seen = []
    monkeypatch.setattr(sgd_icp, "device_while", _one_more(seen))
    _assert_bit_equal(register_sgd(*args, **kw), plain)
    (state,) = seen
    count = state["count"]
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(plain.iterations[0])


# --- map_step(solver="sgd") ---------------------------------------------------

MAP_CFG = config_from_dict(dataclasses.asdict(JCFG_MAP.with_(tolerance=1e-5)))
_J_WEIGHTED = jax.jit(j_weighted)


@pytest.fixture
def jax_normals(monkeypatch):
    """The port's merge takes JAX's jitted weighted normals
    (tests/test_torch_mapping.py)."""
    def weighted(pts):
        return torch.as_tensor(np.array(_J_WEIGHTED(jnp.asarray(pts.numpy()))))
    monkeypatch.setattr(tm, "estimate_normals_weighted", weighted)


def test_sgd_map_step_matches_jax_on_its_draws(jax_normals):
    """map_step(solver="sgd") draws its plan before the call (not part of
    the cache key) and equals JAX's map_step on JAX's draws (pose within
    1e-10; maps as tests/test_torch_mapping.py holds them), and map_step.fn
    drawing inside register_sgd gives its bits."""
    scans, poses = _sequence(3, n=N_SGD)
    m0 = jm.map_merge(jm.empty_map(2048, jnp.float64), jnp.asarray(scans[0]), 0.25,
                      mode="mean")
    t_pred = np.array(poses[1])
    t_pred[:3, 3] += [0.02, -0.01, 0.005]
    key = jax.random.fold_in(jax.random.key(7), 1)
    kw = dict(merge_mode="mean", solver="sgd", sgd_minibatch=256, sgd_iterations=30)
    ref = jax.tree_util.tree_map(np.asarray, jm.map_step(
        m0, jnp.asarray(scans[1]), jnp.asarray(t_pred), None, JCFG_MAP.with_(tolerance=1e-5),
        0.25, key=key, **kw))
    args = (LocalMap(*(_t(a) for a in m0)), torch.as_tensor(np.asarray(scans[1])),
            torch.as_tensor(t_pred), None, MAP_CFG, 0.25)
    got = map_step(*args, key=JaxSampler(jax.random.split(key, 1)), **kw)
    assert bool(got[1]) == bool(ref[1]) and float(got[2]) == float(ref[2])
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=1e-10)
    _assert_maps_match(got[3], ref[3], atol_m2=1e-10)
    eager = map_step.fn(*args, key=JaxSampler(jax.random.split(key, 1)), **kw)
    for a, b in zip(jax.tree_util.tree_leaves(eager), jax.tree_util.tree_leaves(got)):
        assert torch.equal(a, b)
    keys = {map_step.cache_key(*args, key=seed, **{**kw, "sgd_iterations": 2})
            for seed in (1, 2)}
    assert len(keys) == 1


def test_these_programs_take_tensors_only(monkeypatch):
    """The wrappers hand their programs tensors (numpy inputs would make a
    call eager, and the device a part of the key); the SGD source is not
    part of register_sgd_jit's key."""
    for prog in (odometry._odometry_program, odometry._pose_graph_program, register_gicp_jit,
                 register_sgd_jit, map_step):
        assert isinstance(prog, jit_mod._Jitted), prog
    scans = _make_sequence(np.load(DATA), n_scans=3)[0]
    seen = []
    fn = odometry._odometry_program.fn
    monkeypatch.setattr(odometry._odometry_program, "fn",
                        lambda *a, **k: seen.append(a) or fn(*a, **k))
    odometry.odometry(np.asarray(scans), ODO_CFG.with_(max_iterations=2), device="cpu")
    (a,) = seen
    assert isinstance(a[0], torch.Tensor) and a[1] is None
    src = torch.zeros((1, 10, 3), dtype=torch.float64)
    ti = torch.eye(4, dtype=torch.float64)[None]
    for sources in ((1, 2, np.array([0, 2], np.uint32)), (SeededSampler(1), SeededSampler(2))):
        keys = {register_sgd_jit.cache_key(src, src, ti, key, minibatch=4, iterations=2)
                for key in sources}
        assert len(keys) == 1
